"""The deferred-graph engine behind ``static`` (counterpart of the
reference's ``static/graph.py``).

A ``Program`` records ops: an op of the port's namespaces called on a
symbolic ``Variable`` (through ``framework.dispatch``'s static bridge)
becomes a node holding the function and its arguments, and its shape and
dtype are inferred at build time by running the function on ``meta``
tensors (the reference's ``jax.eval_shape``).  A ``-1`` (open) leading
dimension is traced as 1 and reported as -1 again.  ``Executor.run``
evaluates the fetched nodes op by op on its place (the card unless given
a CPU place), with values in a ``Scope``; ``gradients``/``append_backward``
nodes evaluate ``torch.autograd.grad`` of the deferred computation, and an
optimizer's ``minimize`` on a Variable appends an update that ``run``
applies in place after the fetches.  ``CompiledProgram`` runs the same
program (the port has no whole-program compiler to hand it to).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError
from ..framework import dispatch

__all__ = [
    "Variable", "Program", "Scope", "Executor", "CompiledProgram",
    "BuildStrategy", "ExecutionStrategy", "data", "program_guard",
    "default_main_program", "default_startup_program", "global_scope",
    "scope_guard", "name_scope", "create_global_var", "create_parameter",
    "gradients", "append_backward", "py_func", "Print", "device_guard",
    "WeightNormParamAttr", "cpu_places", "cuda_places", "xpu_places",
]


class Variable:
    """A symbolic graph node.  ``kind``: ``data`` (a feed placeholder),
    ``op`` (a deferred op), ``persist`` (a parameter or global variable in
    a Scope), ``grad`` (the gradient of targets with respect to
    variables), ``py_func`` (a host function)."""

    # a private counter: names stay unique for the process's lifetime
    _name_counter = itertools.count()

    def __init__(self, kind: str, name: Optional[str], shape, dtype,
                 program: "Program", op=None, inputs=((), {}), meta=None):
        if name is None:
            name = "_generated_var_%d" % next(Variable._name_counter)
        self.kind = kind
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = convert_dtype(dtype)
        self.program = program
        self.op = op
        self.inputs = inputs
        self.meta = meta or {}
        self.persistable = kind == "persist"
        self.stop_gradient = kind != "persist" \
            and not self.meta.get("trainable", False)
        if program is not None:
            program._vars[self.name] = self

    @property
    def ndim(self):
        return len(self.shape)

    def astype(self, dtype):
        from .. import tensor as T

        return T.cast(self, dtype)

    def __repr__(self):
        return "static.Variable(name=%s, kind=%s, shape=%s, dtype=%s)" % (
            self.name, self.kind, list(self.shape),
            str(self.dtype).replace("torch.", ""))

    __str__ = __repr__


def _install_variable_operators():
    """Arithmetic and the common methods on Variables build graph ops."""
    from .. import tensor as T

    table = {
        "__add__": T.add, "__radd__": lambda a, b: T.add(b, a),
        "__sub__": T.subtract, "__rsub__": lambda a, b: T.subtract(b, a),
        "__mul__": T.multiply, "__rmul__": lambda a, b: T.multiply(b, a),
        "__truediv__": T.divide,
        "__rtruediv__": lambda a, b: T.divide(b, a),
        "__pow__": T.pow, "__neg__": T.neg, "__matmul__": T.matmul,
        "__lt__": T.less_than, "__le__": T.less_equal,
        "__gt__": T.greater_than, "__ge__": T.greater_equal,
    }
    for name, fn in table.items():
        setattr(Variable, name, (lambda f: lambda *a: f(*a))(fn))
    for method in ("sum", "mean", "max", "min", "reshape", "transpose",
                   "cast", "flatten", "matmul", "sqrt", "exp", "log",
                   "abs", "clip", "unsqueeze", "squeeze"):
        setattr(Variable, method, (lambda f: lambda self, *a, **k:
                                   f(self, *a, **k))(getattr(T, method)))


class Program:
    """A recording context for ops, with one implicit block."""

    def __init__(self):
        self._vars: Dict[str, Variable] = {}
        # (persist variable, its new value) applied after each run
        self._updates: List[Tuple[Variable, Variable]] = []
        # (optimizer, parameter variables, gradient variables)
        self._optimize: List[tuple] = []
        self._initializers: List[Tuple[Variable, Callable]] = []
        self.random_seed = 0

    def global_block(self):
        return self

    def var(self, name: str) -> Variable:
        if name not in self._vars:
            raise InvalidArgumentError("program has no variable %r" % name)
        return self._vars[name]

    def all_parameters(self) -> List[Variable]:
        return [v for v in self._vars.values()
                if v.kind == "persist" and v.meta.get("trainable")]

    def list_vars(self):
        return list(self._vars.values())

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p._vars = dict(self._vars)
        p._initializers = list(self._initializers)
        if not for_test:
            p._updates = list(self._updates)
            p._optimize = list(self._optimize)
        return p

    def state_dict(self, mode: str = "all"):
        scope = global_scope()
        return {v.name: scope._values[v.name] for v in self._vars.values()
                if v.kind == "persist" and v.name in scope._values}

    def set_state_dict(self, state):
        global_scope().set_all(state)


class Scope:
    """Name to value store (torch tensors on the executor's place)."""

    def __init__(self):
        self._values: Dict[str, Any] = {}

    def find_var(self, name: str):
        if name not in self._values:
            return None
        value = self._values[name]

        class _Var:
            def get_tensor(self):
                return _to_numpy(value)

        return _Var()

    def set(self, name: str, value) -> None:
        old = self._values.get(name)
        device = old.device if torch.is_tensor(old) else None
        self._values[name] = _as_tensor(value, device)

    def set_all(self, state) -> None:
        for k, v in state.items():
            self.set(k, v)


def _as_tensor(value, device=None) -> torch.Tensor:
    t = value if torch.is_tensor(value) else torch.as_tensor(
        np.asarray(value))
    return t.to(device) if device is not None else t


def _to_numpy(value) -> np.ndarray:
    if torch.is_tensor(value):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


_state = threading.local()


def _tls():
    if not hasattr(_state, "main"):
        _state.main = Program()
        _state.startup = Program()
        _state.scope = Scope()
    return _state


def default_main_program() -> Program:
    return _tls().main


def default_startup_program() -> Program:
    return _tls().startup


def global_scope() -> Scope:
    return _tls().scope


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    st = _tls()
    prev = (st.main, st.startup)
    st.main = main_program
    st.startup = startup_program if startup_program is not None \
        else st.startup
    try:
        yield
    finally:
        st.main, st.startup = prev


@contextlib.contextmanager
def scope_guard(scope: Scope):
    st = _tls()
    prev = st.scope
    st.scope = scope
    try:
        yield scope
    finally:
        st.scope = prev


@contextlib.contextmanager
def name_scope(prefix: str = ""):
    yield  # naming sugar: variable names are unique already


@contextlib.contextmanager
def device_guard(device: Optional[str] = None):
    """Accepted: a program runs on its executor's place."""
    yield


def cpu_places(device_count: Optional[int] = None):
    return [torch.device("cpu")] * (device_count or 1)


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else [0]
    return [torch.device("cuda", i) for i in ids]


xpu_places = cuda_places


class WeightNormParamAttr:
    """The reference's ParamAttr marker for a weight-norm parameter."""

    def __init__(self, dim=None, name=None, initializer=None, **kwargs):
        self.dim = dim
        self.name = name
        self.initializer = initializer


# -- graph construction -----------------------------------------------------

def data(name: str, shape, dtype="float32", lod_level: int = 0) -> Variable:
    """A feed placeholder (``None``/-1 dims are open)."""
    shape = [(-1 if s is None else int(s)) for s in shape]
    return Variable("data", name, shape, dtype, default_main_program())


def _pick(bundle: Variable, index: int, shape, dtype) -> Variable:
    """Element ``index`` of a tuple-valued node."""
    return Variable("op", None, shape, dtype, bundle.program,
                    op=(lambda t, _i=index: t[_i]), inputs=((bundle,), {}),
                    meta={"op_name": "tuple_get_%d" % index})


def _meta_of(v):
    if isinstance(v, Variable):
        return torch.empty(tuple(1 if s == -1 else s for s in v.shape),
                           dtype=v.dtype, device="meta")
    if torch.is_tensor(v):
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    if isinstance(v, (list, tuple)):
        return type(v)(_meta_of(x) for x in v)
    if isinstance(v, dict):
        return {k: _meta_of(x) for k, x in v.items()}
    return v


def _variables(tree) -> list:
    if isinstance(tree, Variable):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _variables(t)]
    if isinstance(tree, dict):
        return [v for t in tree.values() for v in _variables(t)]
    return []


def _symbolic_apply(fn, op_name, args, kwargs):
    """Record ``fn(*args, **kwargs)`` as graph node(s); a multi-output op
    gives a bundle node and one selector per output, in the op's own
    structure."""
    ins = _variables((args, kwargs))
    prog = ins[0].program
    dyn = any(v.shape and v.shape[0] == -1 for v in ins)
    out = fn(*_meta_of(list(args)), **_meta_of(dict(kwargs)))

    def shape_of(t):
        shape = tuple(t.shape)
        if dyn and shape and shape[0] == 1:
            shape = (-1,) + shape[1:]
        return shape

    if torch.is_tensor(out):
        return Variable("op", None, shape_of(out), out.dtype, prog, op=fn,
                        inputs=(args, kwargs), meta={"op_name": op_name})
    leaves = list(out)
    bundle = Variable("op", None, shape_of(leaves[0]), leaves[0].dtype,
                      prog, op=(lambda *a, _fn=fn, **k: tuple(_fn(*a, **k))),
                      inputs=(args, kwargs), meta={"op_name": op_name})
    picks = [_pick(bundle, i, shape_of(t), t.dtype)
             for i, t in enumerate(leaves)]
    return type(out)(picks) if isinstance(out, (tuple, list)) else picks


def create_global_var(shape, value, dtype, persistable: bool = False,
                      force_cpu: bool = False, name: Optional[str] = None
                      ) -> Variable:
    v = Variable("persist", name, shape, dtype, default_main_program(),
                 meta={"trainable": False})
    default_startup_program()._initializers.append(
        (v, lambda device: torch.full(v.shape, value, dtype=v.dtype,
                                      device=device)))
    return v


def create_parameter(shape, dtype, name: Optional[str] = None, attr=None,
                     is_bias: bool = False, default_initializer=None
                     ) -> Variable:
    """A trainable persistable variable, made when the startup program
    runs."""
    from ..nn import initializer as I

    init = default_initializer or (
        I.Constant(0.0) if is_bias else I.XavierUniform())
    v = Variable("persist", name, shape, dtype, default_main_program(),
                 meta={"trainable": True})
    v.stop_gradient = False

    def make(device, v=v, init=init):
        return init(v.shape, v.dtype, device)

    default_startup_program()._initializers.append((v, make))
    return v


def gradients(targets, inputs, target_gradients=None, no_grad_set=None
              ) -> List[Variable]:
    """d(sum of targets)/d(inputs): one joint gradient node computes every
    partial, with a selector per input."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    bundle = Variable("grad", None, inputs[0].shape, inputs[0].dtype,
                      inputs[0].program,
                      meta={"targets": tuple(targets),
                            "wrt_list": tuple(inputs)})
    if len(inputs) == 1:
        return [bundle]
    return [_pick(bundle, i, x.shape, x.dtype) for i, x in enumerate(inputs)]


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None) -> List[Tuple[Variable, Variable]]:
    """Gradients of ``loss`` for every trainable parameter of its
    program (or ``parameter_list``)."""
    params = parameter_list or loss.program.all_parameters()
    params = [loss.program.var(p) if isinstance(p, str) else p
              for p in params]
    return list(zip(params, gradients([loss], params)))


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python function as a graph node, called with numpy arrays
    of the evaluated inputs; ``out`` (a Variable or a list) gives the
    outputs' shapes and dtypes.  Forward only."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    single = not isinstance(out, (list, tuple))
    outs = [out] if single else list(out)
    prog = xs[0].program

    def host_fn(*vals):
        res = func(*[_to_numpy(v) for v in vals])
        res = [res] if single else res
        if not isinstance(res, (list, tuple)) or len(res) != len(outs):
            raise InvalidArgumentError(
                "py_func declared %d outputs but returned %r"
                % (len(outs), type(res)))
        device = vals[0].device if vals and torch.is_tensor(vals[0]) \
            else None
        got = tuple(_as_tensor(np.asarray(r), device).to(t.dtype)
                    for r, t in zip(res, outs))
        return got[0] if single else got

    node = Variable("py_func", None, outs[0].shape, outs[0].dtype, prog,
                    op=host_fn, inputs=(tuple(xs), {}), meta={"host": True})
    if single:
        return node
    return [_pick(node, i, t.shape, t.dtype) for i, t in enumerate(outs)]


def Print(input: Variable, first_n: int = -1, message: Optional[str] = None,
          summarize: int = 20, **kwargs) -> Variable:
    """A pass-through node that prints its value when evaluated."""

    def printing(v):
        flat = _to_numpy(v).reshape(-1)
        head = flat[:summarize] if summarize and summarize > 0 else flat
        print("%s %s" % (message or "Variable:", head))
        return v

    return Variable("py_func", None, input.shape, input.dtype, input.program,
                    op=printing, inputs=((input,), {}), meta={"host": True})


# -- evaluation -------------------------------------------------------------

class _Evaluator:
    """Evaluates the deferred graph op by op."""

    def __init__(self, feed: Dict[str, Any], scope: Scope,
                 device: torch.device, overrides=None):
        self.feed = feed
        self.scope = scope
        self.device = device
        self.overrides = overrides or {}
        self.memo: Dict[int, Any] = {}

    def tree(self, t):
        if isinstance(t, Variable):
            return self.value_of(t)
        if isinstance(t, (list, tuple)):
            return type(t)(self.tree(x) for x in t)
        if isinstance(t, dict):
            return {k: self.tree(x) for k, x in t.items()}
        return t

    def value_of(self, v: Variable):
        key = id(v)
        if key not in self.memo:
            self.memo[key] = self._compute(v)
        return self.memo[key]

    def _compute(self, v: Variable):
        if v.name in self.overrides:
            return self.overrides[v.name]
        if v.kind == "data":
            if v.name not in self.feed:
                raise InvalidArgumentError(
                    "feed is missing input variable %r" % v.name)
            return _as_tensor(self.feed[v.name], self.device)
        if v.kind == "persist":
            if v.name not in self.scope._values:
                raise InvalidArgumentError(
                    "variable %r is uninitialized; run the startup program "
                    "first (exe.run(paddle.static.default_startup_program()))"
                    % v.name)
            return self.scope._values[v.name]
        if v.kind in ("op", "py_func"):
            args, kwargs = v.inputs
            return v.op(*self.tree(list(args)), **self.tree(dict(kwargs)))
        if v.kind == "grad":
            return self._grad(v)
        raise InvalidArgumentError("unknown variable kind %r" % v.kind)

    def _grad(self, gvar: Variable):
        wrt = gvar.meta["wrt_list"]
        leaves = []
        for w in wrt:
            base = self.value_of(w)
            if not base.is_floating_point():
                raise InvalidArgumentError(
                    "cannot differentiate w.r.t. non-float variable %r"
                    % w.name)
            leaves.append(base.detach().requires_grad_(True))
        overrides = dict(self.overrides)
        overrides.update({w.name: x for w, x in zip(wrt, leaves)})
        ev = _Evaluator(self.feed, self.scope, self.device, overrides)
        with torch.enable_grad():
            total = sum(ev.value_of(t).sum() for t in gvar.meta["targets"])
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = tuple(torch.zeros_like(x) if g is None else g
                      for x, g in zip(leaves, grads))
        return grads[0] if len(wrt) == 1 else grads


class BuildStrategy:
    """The reference's fusion and memory knobs: an attribute bag."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class CompiledProgram:
    """A program handed to ``Executor.run``: run as the program is."""

    def __init__(self, program: Program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        return self


class Executor:
    """Runs programs on ``place``: the card when None (raises without one),
    ``"cpu"`` or a CPU place on the CPU."""

    def __init__(self, place=None):
        from ..core.device import resolve_device

        self.place = resolve_device(place)

    def close(self):
        return None

    def run(self, program=None, feed=None, fetch_list=None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            **kwargs):
        scope = scope or global_scope()
        prog = program.program if isinstance(program, CompiledProgram) \
            else (program or default_main_program())
        if prog._initializers and not fetch_list:
            # the startup program: make every initialized variable
            for v, init in prog._initializers:
                scope._values[v.name] = init(self.place)
            return []
        fetch_vars = [prog.var(f) if isinstance(f, str) else f
                      for f in fetch_list or []]
        ev = _Evaluator(feed or {}, scope, self.place)
        outs = [ev.value_of(v) for v in fetch_vars]
        new_values = [(p.name, ev.value_of(nv)) for p, nv in prog._updates]
        steps = [(opt, params, [ev.value_of(g) for g in grads])
                 for opt, params, grads in prog._optimize]
        for name, val in new_values:
            scope._values[name] = val
        for opt, params, grads in steps:
            _apply_update(opt, params, grads, scope)
        if return_numpy:
            outs = [_to_numpy(o) for o in outs]
        return outs


def _apply_update(opt, params, grads, scope: Scope) -> None:
    """One optimizer update of the scope's parameter tensors, in place;
    the optimizer's state slots appear in the scope as
    ``<param>__<slot>``."""
    tensors = []
    for p in params:
        t = scope._values[p.name]
        t.param_name = p.name
        tensors.append(t)
    with torch.no_grad():
        opt._functional_step(tensors, [g.detach() for g in grads],
                             opt.get_lr())
    for p in params:
        for slot, v in opt._states.get(p.name, {}).items():
            scope._values["%s__%s" % (p.name, slot)] = v


def minimize(optimizer, loss: Variable, parameters=None):
    """Append ``optimizer``'s update of ``loss``'s parameters to its
    program (the static branch of ``Optimizer.minimize``)."""
    pairs = append_backward(loss, parameter_list=parameters)
    loss.program._optimize.append(
        (optimizer, [p for p, _ in pairs], [g for _, g in pairs]))
    return None, pairs


_install_variable_operators()
dispatch.register_symbolic(Variable, _symbolic_apply)

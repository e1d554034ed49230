"""Structured control flow: ``while_loop``, ``cond``, ``case`` and
``switch_case`` (counterpart of the reference's ``tensor/control_flow.py``,
after ``fluid/layers/control_flow.py``).

On eager tensors each runs as plain Python: the predicate is read back
once per decision and only the chosen branch runs, so autograd records
exactly the work done.  While ``torch.export`` traces (``jit.to_static``,
``jit.save``) a predicate is a traced value that cannot be read, so the
calls become ``torch.cond`` and ``torch.while_loop`` and the exported
program branches and loops on the card without a data-dependent guard.
Under a trace both branches of a ``cond`` are traced and must return the
same structure, shapes and dtypes, as the reference's ``lax.cond``; a
``while_loop``'s carry keeps its shapes and dtypes from step to step, and
a Python number in the carry becomes a 0-d tensor.  ``while_loop`` is
forward-only under a trace, as the reference's XLA loop.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["while_loop", "cond", "case", "switch_case"]


def _tracing() -> bool:
    """Whether ``torch.export`` (or ``torch.compile``) is tracing."""
    return torch.compiler.is_compiling()


def _scalar_pred(p):
    if callable(p):
        raise InvalidArgumentError(
            "pred must be a boolean tensor/scalar, got a callable")
    if not torch.is_tensor(p):
        return bool(p)
    if tuple(p.shape) not in ((), (1,)):
        raise InvalidArgumentError(
            "pred must be a scalar boolean, got shape %s" % (tuple(p.shape),))
    return p.reshape(()).to(torch.bool)


def _flat(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flat(t)]
    if isinstance(tree, dict):
        return [leaf for t in tree.values() for leaf in _flat(t)]
    return [tree]


def _traced(*values) -> bool:
    """A trace is running and a predicate among ``values`` is a tensor."""
    return _tracing() and any(torch.is_tensor(v) for v in _flat(values))


def _fresh(tree, device=None):
    """``tree`` with every tensor cloned (a traced branch may not return
    its inputs, or a closed-over tensor, as they are) and every Python
    number made a 0-d tensor on ``device`` (as the reference's traced
    branches make them arrays)."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, (bool, int, float)):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_fresh(t, device) for t in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fresh(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: _fresh(v, device) for k, v in tree.items()}
    return tree


def _carry_leaf(v, like=None):
    """A loop-carried value as a tensor (a Python number becomes 0-d, of
    the dtype it had when it entered the loop)."""
    if torch.is_tensor(v):
        return v if like is None else v.to(like.dtype)
    if like is not None:
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence,
               is_test: bool = False, name: Optional[str] = None) -> List:
    """Run ``body_fn`` on ``loop_vars`` while ``cond_fn`` holds; returns the
    final variables as a list."""
    if not callable(cond_fn) or not callable(body_fn):
        raise InvalidArgumentError("while_loop cond and body must be callable")
    if not loop_vars:
        raise InvalidArgumentError("while_loop needs loop_vars")
    n = len(loop_vars)

    def step(vs):
        out = body_fn(*vs)
        out = list(out) if isinstance(out, (tuple, list)) else [out]
        if len(out) != n:
            raise InvalidArgumentError(
                "while_loop body returned %d vars, expected %d"
                % (len(out), n))
        return out

    if not _tracing():
        vs = list(loop_vars)
        while bool(_scalar_pred(cond_fn(*vs))):
            vs = step(vs)
        return vs
    from .array import TensorArray

    # TensorArrays travel as their (buffer, length) pair
    kinds = [isinstance(v, TensorArray) for v in loop_vars]

    def pack(vs):
        flat = []
        for v, ta in zip(vs, kinds):
            flat.extend((v.buffer, v.length) if ta else (v,))
        return flat

    def unpack(flat):
        vs, i = [], 0
        for ta in kinds:
            if ta:
                vs.append(TensorArray(flat[i], flat[i + 1]))
                i += 2
            else:
                vs.append(flat[i])
                i += 1
        return vs

    init = [_carry_leaf(v) for v in pack(loop_vars)]

    def raw_cond(*flat):
        return _scalar_pred(cond_fn(*unpack(list(flat))))

    def raw_body(*flat):
        # the body sees copies: an in-place update (``i += 1``, which is
        # functional in the reference) may not write the loop's inputs
        out = pack(step(unpack([f.clone() for f in flat])))
        return tuple(_fresh(_carry_leaf(o, like)) for o, like
                     in zip(out, init))

    from torch._higher_order_ops.while_loop import while_loop as _wl

    return unpack(list(_wl(raw_cond, raw_body, tuple(init))))


def _traced_cond(pred, true_fn: Callable, false_fn: Callable):
    p = _scalar_pred(pred)
    return torch.cond(p, lambda: _fresh(true_fn(), p.device),
                      lambda: _fresh(false_fn(), p.device), ())


def cond(pred, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name: Optional[str] = None):
    """``true_fn()`` if ``pred`` else ``false_fn()``."""
    if true_fn is None or false_fn is None:
        raise InvalidArgumentError("cond needs both true_fn and false_fn")
    if _traced(pred):
        return _traced_cond(pred, true_fn, false_fn)
    return true_fn() if bool(_scalar_pred(pred)) else false_fn()


def case(pred_fn_pairs: Sequence[Tuple], default: Optional[Callable] = None,
         name: Optional[str] = None):
    """The function of the first true predicate, else ``default`` (the last
    pair's function when None)."""
    if not pred_fn_pairs:
        raise InvalidArgumentError("case needs pred_fn_pairs")
    for pair in pred_fn_pairs:
        if not (isinstance(pair, (tuple, list)) and len(pair) == 2
                and callable(pair[1])):
            raise InvalidArgumentError(
                "case pairs must be (bool_tensor, callable), got %r" % (pair,))
    if default is None:
        default = pred_fn_pairs[-1][1]
        pred_fn_pairs = pred_fn_pairs[:-1]
    if not _traced(*[p for p, _ in pred_fn_pairs]):
        for pred, fn in pred_fn_pairs:
            if bool(_scalar_pred(pred)):
                return fn()
        return default()

    def build(i):
        if i == len(pred_fn_pairs):
            return default
        pred, fn = pred_fn_pairs[i]
        rest = build(i + 1)
        return lambda: _traced_cond(pred, fn, rest)

    return build(0)()


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name: Optional[str] = None):
    """The branch keyed by ``branch_index``; ``branch_fns`` is a dict
    {int: fn}, a list of (int, fn) or a list of fns.  An index with no
    branch runs ``default`` (the last branch when None)."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        pairs = sorted((int(k), f) for k, f in branch_fns)
    else:
        pairs = list(enumerate(branch_fns))
    if default is None:
        default = pairs[-1][1]
    if not _traced(branch_index):
        table = dict(pairs)
        idx = branch_index.reshape(()) if torch.is_tensor(branch_index) \
            else branch_index
        return table.get(int(idx), default)()
    idx = branch_index.reshape(()).to(torch.int64)
    return case([(idx == k, f) for k, f in pairs], default)


# these take callables and manage their own tensors: the namespace-wide op
# shim (``framework.dispatch.install_ops``) leaves them as they are
for _f in (while_loop, cond, case, switch_case):
    _f.__paddle_tpu_op__ = True  # type: ignore[attr-defined]

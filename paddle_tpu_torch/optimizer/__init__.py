"""Optimizers (counterpart of the reference's ``optimizer/__init__.py``):
``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``, ``Adadelta``,
``Adamax``, ``RMSProp``, ``Lamb``, ``Lars``, ``Ftrl``, and the wrappers
``Lookahead`` and ``ModelAverage``.

The update formulas and their rounding order, the state names
(``moment1``, ``beta1_pow``, ``velocity``, ``master_weight``, ...),
``lr_ratio``, ``apply_decay_param_fun``, ``multi_precision`` and the
``state_dict`` keys (``"<param>__<slot>"``) are the reference's.  Where the
reference's update is a pure function over one parameter, the port
updates every parameter and its state tensors in place under
``torch.no_grad()``, a few tensor lists at a time (``torch._foreach_*``):
one update over all parameters takes a few launches per list operation
whatever the parameter count, each parameter keeps its storage, and no
second copy of the weights or moments exists.  ``torch.optim`` is not used
-- its state layout and decay hooks are not the reference's.

One update rule (clip -> regularize, non-decoupled decay only ->
update), two ways in:

- eager: ``loss.backward(); opt.step(); opt.clear_grad()`` reads
  ``p.grad`` and skips parameters without one, as the reference's
  dygraph ``step()``;
- functional: ``_functional_step(params, grads, lr)``, which
  ``jit.TrainStep`` calls with a dense gradient for every parameter (zeros
  where the loss does not reach it), as the reference's train step.

The parameters of one update are grouped by what varies between them --
device and dtype, master weight or not, ``optimize_attr["learning_rate"]``,
the regularizer, and each optimizer's own per-parameter terms
(``apply_decay_param_fun``, ``lr_ratio``, Lamb's and Lars's exclusions)
-- and each group is one list update.  The learning rate is a device
scalar: a Python float is uploaded once per update, and ``TrainStep``
passes the scalar it rewrites before each call, so a captured step reads
the scheduler's current value.  Per-parameter state scalars (the beta
powers) stay per parameter, as the reference keeps them.

Per-parameter attributes are read where the reference reads them on its
``Parameter``: ``optimize_attr`` (``{"learning_rate": ratio}``),
``regularizer`` and ``need_clip``, each optional.  A parameter's name (the
key of its state and the argument of ``apply_decay_param_fun``) is
:func:`param_name`: ``torch.Tensor.name`` is reserved by torch, so the
name lives in the ``param_name`` attribute, ``"param_<n>"`` by default.

Not ported yet: sparse (row) updates (``framework/sparse.py``) and the
static-graph branch of ``minimize``.
"""
from __future__ import annotations

import contextlib
import itertools
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from ..regularizer import L1Decay, L2Decay, WeightDecayRegularizer
from . import lr as lr_sched
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "Adadelta", "Adamax", "RMSProp", "Lamb", "Lars", "Ftrl",
           "Lookahead", "ModelAverage", "lr", "param_name"]

lr = lr_sched

_names = itertools.count()


def param_name(p: torch.Tensor) -> str:
    """The parameter's optimizer name, given on first use as the reference
    names a ``Parameter``: ``"param_<n>"`` from a process-wide counter."""
    name = getattr(p, "param_name", None)
    if name is None:
        name = "param_%d" % next(_names)
        p.param_name = name
    return name


# -- list helpers -------------------------------------------------------------


def _as(ts, dtypes):
    """Each tensor of ``ts`` in the matching dtype (no copy where equal;
    the casts as one list copy)."""
    out = [t if t.dtype == d else torch.empty_like(t, dtype=d)
           for t, d in zip(ts, dtypes)]
    cast = [i for i, (t, o) in enumerate(zip(ts, out)) if o is not t]
    if cast:
        torch._foreach_copy_([out[i] for i in cast], [ts[i] for i in cast])
    return out


def _f32(ts):
    return _as(ts, [torch.float32] * len(ts))


def _one_minus(ts):
    """``1 - t`` for each (0-dim) tensor, rounded as the reference's."""
    out = torch._foreach_mul(ts, -1.0)
    torch._foreach_add_(out, 1.0)
    return out


def _slot(states, name):
    return [st[name] for st in states]


def _masters(params, states):
    """The tensors an update writes: each master weight, else the
    parameter itself."""
    return [st.get("master_weight", p) for p, st in zip(params, states)]


def _write_back(params, states, new):
    """Commit ``new`` (float32, one per parameter): into the master weight
    and the model-dtype parameter, or into the parameter alone; skipped
    where ``new`` already is the tensor written."""
    for p, st, n in zip(params, states, new):
        m = st.get("master_weight")
        if m is not None:
            if n is not m:
                m.copy_(n)
            p.copy_(m)
        elif n is not p:
            p.copy_(n)


def _finish(params, states):
    """Write every master weight back into its model-dtype parameter."""
    pairs = [(p, st["master_weight"]) for p, st in zip(params, states)
             if "master_weight" in st]
    if pairs:
        torch._foreach_copy_([p for p, _ in pairs], [m for _, m in pairs])


# An update's temporaries (a float32 copy of bf16 gradients, Adam's mhat
# and denominator) are as large as the lists they are made from: a group
# is updated in chunks of at most this many elements (1 GiB of float32),
# so they stay a few GiB whatever the model's size, at a few more
# launches.
_CHUNK_ELEMS = 1 << 28


def _chunks(params):
    """Index lists covering ``params`` in order, each summing to at most
    ``_CHUNK_ELEMS`` elements (a larger parameter alone)."""
    part, n = [], 0
    for i, p in enumerate(params):
        if part and n + p.numel() > _CHUNK_ELEMS:
            yield part
            part, n = [], 0
        part.append(i)
        n += p.numel()
    if part:
        yield part


def _norms(ts):
    """[N] float32: each tensor's L2 norm."""
    return torch.stack(torch._foreach_norm(ts, dtype=torch.float32))


def _moment_state(state, p):
    """Adam's and Lamb's slots: float32 moments of the master's shape and
    the two bias-correction powers."""
    m = state.get("master_weight", p)
    state["moment1"] = torch.zeros_like(m, dtype=torch.float32)
    state["moment2"] = torch.zeros_like(m, dtype=torch.float32)
    state["beta1_pow"] = _pow_scalar(p)
    state["beta2_pow"] = _pow_scalar(p)
    return state


def _moments(opt, grads, states):
    """Adam's and Lamb's moments and powers, advanced in place; returns
    ``(mhat, sqrt(vhat) + eps)``, float32 lists."""
    g = _f32(grads)
    m1, m2 = _slot(states, "moment1"), _slot(states, "moment2")
    b1p, b2p = _slot(states, "beta1_pow"), _slot(states, "beta2_pow")
    torch._foreach_mul_(m1, opt._beta1)
    torch._foreach_add_(m1, g, alpha=1 - opt._beta1)
    torch._foreach_mul_(m2, opt._beta2)
    torch._foreach_addcmul_(m2, g, g, value=1 - opt._beta2)
    del g  # a float32 copy of bf16 gradients: free before mhat and denom
    torch._foreach_mul_(b1p, opt._beta1)
    torch._foreach_mul_(b2p, opt._beta2)
    mhat = torch._foreach_div(m1, _one_minus(b1p))
    denom = torch._foreach_div(m2, _one_minus(b2p))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt._epsilon)
    return mhat, denom


def _pow_scalar(p):
    return torch.ones((), dtype=torch.float32, device=p.device)


class Optimizer:
    """Base optimizer."""

    def __init__(self, learning_rate=0.001,
                 parameters: Optional[Sequence[torch.Tensor]] = None,
                 weight_decay=None, grad_clip=None,
                 multi_precision: bool = False, name: Optional[str] = None):
        if parameters is not None:
            parameters = list(parameters)
            for p in parameters:
                if not isinstance(p, torch.Tensor):
                    raise InvalidArgumentError(
                        "optimizer parameters must be tensors, got %r"
                        % type(p))
        self._parameter_list = parameters
        self._learning_rate = learning_rate
        if isinstance(weight_decay, float):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._states: Dict[str, dict] = {}
        self._name = name or type(self).__name__

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise InvalidArgumentError(
                "cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- state ------------------------------------------------------------
    def _state_for(self, p) -> dict:
        key = param_name(p)
        if key not in self._states:
            self._states[key] = self._init_state(p)
        return self._states[key]

    def _init_state(self, p) -> dict:
        state: dict = {}
        if self._multi_precision and p.dtype != torch.float32:
            state["master_weight"] = p.detach().float().clone()
        return state

    # -- the update -------------------------------------------------------
    def _group_terms(self, p) -> tuple:
        """Per-parameter terms of this optimizer's rule (hashable), besides
        the ones every optimizer groups by."""
        return ()

    def _apply_group(self, params, grads, states, lr, terms):
        """Update ``params`` (and ``states``) in place from ``grads``:
        one group, ``lr`` a float32 device scalar."""
        raise NotImplementedError  # pragma: no cover - abstract

    @property
    def _decoupled_decay(self) -> bool:
        return False  # AdamW overrides

    def _regularizer(self, p):
        reg = getattr(p, "regularizer", None)
        if reg is None:
            reg = self._weight_decay
        return reg if isinstance(reg, WeightDecayRegularizer) else None

    @staticmethod
    def _regularized(params, grads, reg):
        """``grad + coeff * f(param)`` over a group, the parameter (not its
        master) in the gradient's dtype, as the reference's regularizers."""
        vals = _as([p.detach() for p in params], [g.dtype for g in grads])
        if isinstance(reg, L1Decay):
            vals = torch._foreach_sign(vals)
        elif not isinstance(reg, L2Decay):
            return [reg(v, g) for v, g in zip(vals, grads)]
        return torch._foreach_add(grads, torch._foreach_mul(vals,
                                                            reg.coeff))

    @torch.no_grad()
    def _update(self, params_grads, lr) -> None:
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        groups: Dict[tuple, list] = {}
        for p, g in params_grads:
            if g is None:
                continue
            st = self._state_for(p)
            reg = None if self._decoupled_decay else self._regularizer(p)
            key = (p.device, p.dtype, g.dtype, "master_weight" in st,
                   float(getattr(p, "optimize_attr", {}).get(
                       "learning_rate", 1.0)),
                   None if reg is None else (type(reg), reg.coeff),
                   self._group_terms(p))
            ps, gs, sts = groups.setdefault(key, ([], [], []))
            ps.append(p)
            gs.append(g)
            sts.append(st)
        lr_dev = {}
        for key, (ps, gs, sts) in groups.items():
            device, ratio, terms = key[0], key[4], key[6]
            reg = None if key[5] is None else self._regularizer(ps[0])
            if device not in lr_dev:  # a fill, not a host-to-device copy
                lr_dev[device] = (lr.to(device, torch.float32)
                                  if torch.is_tensor(lr) else torch.full(
                                      (), float(lr), dtype=torch.float32,
                                      device=device))
            plr = lr_dev[device] if ratio == 1.0 else lr_dev[device] * ratio
            for part in _chunks(ps):
                cgs = [gs[i] for i in part]
                cps = [ps[i] for i in part]
                if reg is not None:
                    cgs = self._regularized(cps, cgs, reg)
                self._apply_group(cps, cgs, [sts[i] for i in part], plr,
                                  terms)

    def step(self) -> None:
        """Eager update from ``p.grad``; parameters without a gradient are
        skipped."""
        if self._parameter_list is None:
            raise InvalidArgumentError(
                "this optimizer was constructed without a parameters list; "
                "pass parameters=model.parameters()")
        self._update([(p, p.grad) for p in self._parameter_list
                      if p.requires_grad and p.grad is not None],
                     self.get_lr())

    def _functional_step(self, params, grads, lr) -> None:
        """The train-step update: every parameter gets its gradient (dense,
        so an unused parameter still decays and advances its moments).
        ``lr`` is a float or a float32 device scalar."""
        self._update(list(zip(params, grads)), lr)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every parameter's gradient (its memory is freed), or with
        ``set_to_zero`` zero it in place."""
        if self._parameter_list is None:
            return
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Dygraph minimize: backward + step.  Returns ``(None, None)``
        as the reference's dygraph branch."""
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    # -- checkpoint -------------------------------------------------------
    def state_dict(self) -> dict:
        """``{"<param>__<slot>": tensor}`` (the live state tensors) and,
        with a scheduler, ``"LR_Scheduler"``: the reference's keys."""
        sd: dict = {}
        for pname, state in self._states.items():
            for k, v in state.items():
                sd["%s__%s" % (pname, k)] = v
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict) -> None:
        """Load a :meth:`state_dict` (tensors or arrays).  Values are
        written into the existing state tensors (``copy_``), so a captured
        train step keeps reading them; names from another process map onto
        this optimizer's parameters by position when only their counters
        differ, with the reference's refusals."""
        sched = state_dict.get("LR_Scheduler")
        if sched is not None and isinstance(self._learning_rate,
                                            LRScheduler):
            self._learning_rate.set_state_dict(dict(sched))
        grouped: dict = {}
        for key, v in state_dict.items():
            if key == "LR_Scheduler" or "__" not in key:
                continue
            pname, slot = key.rsplit("__", 1)
            grouped.setdefault(pname, {})[slot] = (
                v.detach() if torch.is_tensor(v)
                else torch.as_tensor(np.asarray(v)))
        mapping = {n: n for n in grouped}
        trainable = [p for p in (self._parameter_list or [])
                     if p.requires_grad]
        current = [param_name(p) for p in trainable]
        if current and set(grouped) != set(current):
            if len(grouped) != len(current):
                raise InvalidArgumentError(
                    "optimizer state has %d parameter entries %r but this "
                    "optimizer tracks %d parameters %r"
                    % (len(grouped), sorted(grouped), len(current),
                       sorted(current)))
            # positional mapping is safe only when the names differ by the
            # counter alone: shapes cannot tell equal-shaped parameters
            # apart, so a looser match could silently swap moments
            def stem(n):
                return n.rstrip("0123456789")

            saved_names = list(grouped.keys())
            if [stem(n) for n in saved_names] != [stem(n) for n in current]:
                raise InvalidArgumentError(
                    "optimizer state parameter names %r do not positionally "
                    "match this optimizer's parameters %r (structural stems "
                    "differ) — refusing positional state mapping"
                    % (saved_names, current))
            for sname, tname in zip(saved_names, current):
                have = self._states.get(tname)
                if have and frozenset(have) != frozenset(grouped[sname]):
                    raise InvalidArgumentError(
                        "optimizer state entry %r carries slots %r but "
                        "target parameter %r already has slots %r — "
                        "refusing positional state mapping"
                        % (sname, sorted(grouped[sname]), tname,
                           sorted(have)))
            mapping = dict(zip(saved_names, current))
        by_name = {param_name(p): p for p in trainable}
        for pname, slots in grouped.items():
            tgt = mapping[pname]
            p = by_name.get(tgt)
            if p is not None:
                for slot, val in slots.items():
                    if val.ndim > 0 and tuple(val.shape) != tuple(p.shape):
                        raise InvalidArgumentError(
                            "optimizer state %r slot %r has shape %s but "
                            "parameter %r has shape %s — state_dict does "
                            "not match this optimizer's parameters"
                            % (pname, slot, tuple(val.shape), tgt,
                               tuple(p.shape)))
            state = self._states.setdefault(tgt, {})
            for slot, val in slots.items():
                have = state.get(slot)
                if have is not None and have.shape == val.shape:
                    have.copy_(val)
                else:
                    state[slot] = (val if p is None else val.to(p.device)
                                   ).clone()

    set_dict = set_state_dict


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _apply_group(self, params, grads, states, lr, terms):
        m = _masters(params, states)
        torch._foreach_sub_(m, torch._foreach_mul(
            _as(grads, [t.dtype for t in m]), lr))
        _finish(params, states)


class Momentum(Optimizer):
    """Momentum with optional Nesterov: v = mu v + g; p -= lr v (or
    lr (g + mu v))."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_state(self, p):
        state = super()._init_state(p)
        state["velocity"] = torch.zeros_like(state.get("master_weight", p))
        return state

    def _apply_group(self, params, grads, states, lr, terms):
        m = _masters(params, states)
        g = _as(grads, [t.dtype for t in m])
        v = _slot(states, "velocity")
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, g)
        if self._use_nesterov:
            step = torch._foreach_mul(v, self._momentum)
            torch._foreach_add_(step, g)
            torch._foreach_mul_(step, lr)
        else:
            step = torch._foreach_mul(v, lr)
        torch._foreach_sub_(m, step)
        _finish(params, states)


class Adam(Optimizer):
    """Bias-corrected Adam with fp32 moments and optional multi-precision
    master weights."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        # lazy_mode selects row updates for row-sparse gradients; the
        # port's gradients are dense, where it changes nothing

    def _init_state(self, p):
        return _moment_state(super()._init_state(p), p)

    def _adam_delta(self, grads, states, lr):
        """``lr * mhat / (sqrt(vhat) + eps)``: the step to subtract."""
        delta, denom = _moments(self, grads, states)
        torch._foreach_mul_(delta, lr)
        torch._foreach_div_(delta, denom)
        return delta

    def _apply_group(self, params, grads, states, lr, terms):
        m = _masters(params, states)
        delta = self._adam_delta(grads, states, lr)
        torch._foreach_sub_(m, _as(delta, [t.dtype for t in m]))
        _finish(params, states)


class AdamW(Adam):
    """Adam with decoupled weight decay: p = p (1 - lr decay) - step."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = (weight_decay if isinstance(weight_decay, float)
                       else getattr(weight_decay, "coeff", 0.01))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    @property
    def _decoupled_decay(self):
        return True

    def _group_terms(self, p):
        decay = self._coeff
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(param_name(p)):
            decay = 0.0
        ratio = 1.0 if self._lr_ratio is None else float(self._lr_ratio(p))
        return (ratio, float(decay))

    def _apply_group(self, params, grads, states, lr, terms):
        ratio, decay = terms
        if ratio != 1.0:
            lr = lr * ratio
        m = _masters(params, states)
        delta = self._adam_delta(grads, states, lr)
        if decay != 0.0:
            torch._foreach_mul_(m, torch.rsub(lr * decay, 1.0))
        torch._foreach_sub_(m, _as(delta, [t.dtype for t in m]))
        _finish(params, states)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        state = super()._init_state(p)
        state["moment"] = torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)
        return state

    def _apply_group(self, params, grads, states, lr, terms):
        g = _f32(grads)
        acc = _slot(states, "moment")
        torch._foreach_addcmul_(acc, g, g)
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, self._epsilon)
        step = torch._foreach_mul(g, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(params, _as(step, [p.dtype for p in params]))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, p):
        state = super()._init_state(p)
        state["avg_squared_grad"] = torch.zeros_like(p, dtype=torch.float32)
        state["avg_squared_update"] = torch.zeros_like(p,
                                                       dtype=torch.float32)
        return state

    def _apply_group(self, params, grads, states, lr, terms):
        g = _f32(grads)
        asg = _slot(states, "avg_squared_grad")
        asu = _slot(states, "avg_squared_update")
        torch._foreach_mul_(asg, self._rho)
        torch._foreach_addcmul_(asg, g, g, value=1 - self._rho)
        update = torch._foreach_add(asu, self._epsilon)
        torch._foreach_div_(update, torch._foreach_add(asg, self._epsilon))
        torch._foreach_sqrt_(update)
        torch._foreach_neg_(update)
        torch._foreach_mul_(update, g)
        torch._foreach_mul_(asu, self._rho)
        torch._foreach_addcmul_(asu, update, update, value=1 - self._rho)
        step = torch._foreach_mul(update, lr)
        torch._foreach_add_(params, _as(step, [p.dtype for p in params]))


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        state = super()._init_state(p)
        state["moment"] = torch.zeros_like(p, dtype=torch.float32)
        state["inf_norm"] = torch.zeros_like(p, dtype=torch.float32)
        state["beta1_pow"] = _pow_scalar(p)
        return state

    def _apply_group(self, params, grads, states, lr, terms):
        g = _f32(grads)
        m, u = _slot(states, "moment"), _slot(states, "inf_norm")
        b1p = _slot(states, "beta1_pow")
        torch._foreach_mul_(m, self._beta1)
        torch._foreach_add_(m, g, alpha=1 - self._beta1)
        torch._foreach_mul_(u, self._beta2)
        a = torch._foreach_abs(g)
        torch._foreach_add_(a, self._epsilon)
        torch._foreach_maximum_(u, a)
        torch._foreach_mul_(b1p, self._beta1)
        # lr / (1 - b1p), one per parameter
        rate = torch.div(lr, torch.stack(_one_minus(b1p))).unbind(0)
        step = torch._foreach_mul(m, list(rate))
        torch._foreach_div_(step, u)
        torch._foreach_sub_(params, _as(step, [p.dtype for p in params]))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        state = super()._init_state(p)
        state["mean_square"] = torch.zeros_like(p, dtype=torch.float32)
        state["momentum"] = torch.zeros_like(p, dtype=torch.float32)
        if self._centered:
            state["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def _apply_group(self, params, grads, states, lr, terms):
        g = _f32(grads)
        ms, mom = _slot(states, "mean_square"), _slot(states, "momentum")
        torch._foreach_mul_(ms, self._rho)
        torch._foreach_addcmul_(ms, g, g, value=1 - self._rho)
        if self._centered:
            mg = _slot(states, "mean_grad")
            torch._foreach_mul_(mg, self._rho)
            torch._foreach_add_(mg, g, alpha=1 - self._rho)
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, self._epsilon)
        else:
            denom = torch._foreach_add(ms, self._epsilon)
        torch._foreach_sqrt_(denom)
        step = torch._foreach_mul(g, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, step)
        torch._foreach_sub_(params, _as(mom, [p.dtype for p in params]))


class Lamb(Optimizer):
    """Layer-adaptive Adam: each parameter's step is scaled by its trust
    ratio ||w|| / ||r||."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return _moment_state(super()._init_state(p), p)

    def _group_terms(self, p):
        excluded = self._exclude_fn is not None and self._exclude_fn(p)
        return (0.0 if excluded else float(self._lamb_decay),)

    def _apply_group(self, params, grads, states, lr, terms):
        (decay,) = terms
        w = _f32(_masters(params, states))
        r, denom = _moments(self, grads, states)
        torch._foreach_div_(r, denom)
        if decay != 0.0:
            torch._foreach_add_(r, torch._foreach_mul(w, decay))
        wn, rn = _norms(w), _norms(r)
        trust = torch.where((wn > 0) & (rn > 0), wn / rn, 1.0)
        torch._foreach_mul_(r, list((lr * trust).unbind(0)))
        new = torch._foreach_sub(w, r)
        _write_back(params, states, new)


class Lars(Optimizer):
    """LARS momentum: a layer-wise local learning rate
    coeff ||w|| / (||g|| + decay ||w||)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_decay = lars_weight_decay
        self._exclude = exclude_from_weight_decay or []

    def _init_state(self, p):
        state = super()._init_state(p)
        m = state.get("master_weight", p)
        state["velocity"] = torch.zeros_like(m, dtype=torch.float32)
        return state

    def _group_terms(self, p):
        name = param_name(p)
        excluded = any(tag in name for tag in self._exclude)
        return (0.0 if excluded else float(self._lars_decay),)

    def _apply_group(self, params, grads, states, lr, terms):
        (decay,) = terms
        w = _f32(_masters(params, states))
        g = _f32(grads)
        wn, gn = _norms(w), _norms(g)
        local = torch.where((wn > 0) & (gn > 0), self._lars_coeff * wn
                            / (gn + decay * wn + 1e-12), 1.0)
        step = torch._foreach_add(g, torch._foreach_mul(w, decay))
        torch._foreach_mul_(step, list((lr * local).unbind(0)))
        v = _slot(states, "velocity")
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, step)
        _write_back(params, states, torch._foreach_sub(w, v))


class Ftrl(Optimizer):
    """FTRL-proximal: squared and linear accumulators and the closed-form
    update ``w = -linear_clipped / (l2 + sqrt(new_sq) / lr)`` with the l1
    soft threshold."""

    def __init__(self, learning_rate=0.001, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _init_state(self, p):
        state = super()._init_state(p)
        state["squared"] = torch.zeros_like(p, dtype=torch.float32)
        state["linear"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def _apply_group(self, params, grads, states, lr, terms):
        g = _f32(grads)
        w = _f32(params)
        sq, lin = _slot(states, "squared"), _slot(states, "linear")
        new_sq = torch._foreach_addcmul(sq, g, g)
        pw = -self._lr_power
        now = torch._foreach_pow(new_sq, pw)
        sigma = torch._foreach_sub(now, torch._foreach_pow(sq, pw))
        torch._foreach_div_(sigma, lr)
        torch._foreach_add_(lin, g)
        torch._foreach_sub_(lin, torch._foreach_mul(sigma, w))
        torch._foreach_copy_(sq, new_sq)
        quad = torch._foreach_div(now, lr)
        torch._foreach_add_(quad, 2.0 * self._l2)
        pre = torch._foreach_clamp_min(lin, -self._l1)
        torch._foreach_clamp_max_(pre, self._l1)
        torch._foreach_sub_(pre, lin)
        torch._foreach_div_(pre, quad)
        for p, n, l in zip(params, pre, lin):
            p.copy_(torch.where(l.abs() > self._l1, n, 0.0))


class Lookahead:
    """The inner (fast) optimizer steps normally; every ``k`` steps the
    slow weights move ``alpha`` of the way toward the fast weights and the
    fast weights are reset onto them (written in place).  Unknown
    attributes delegate to the inner optimizer.  The slow-weight sync is
    host-side state, so ``TrainStep`` refuses the wrapper itself: pass
    ``opt.inner_opt`` and call :meth:`sync` every ``k`` steps."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5):
        if inner_optimizer is None:
            raise InvalidArgumentError("Lookahead needs an inner optimizer")
        if not 0.0 <= alpha <= 1.0:
            raise InvalidArgumentError("alpha must be in [0, 1]")
        if k < 1:
            raise InvalidArgumentError("k must be a positive integer")
        self._inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step_count = 0
        # keyed by position in the inner parameter list: auto-generated
        # names differ across processes, positions do not
        self._slow: dict = {}
        # the slow weights start at the weights of construction time
        self._seed_slow()

    def _seed_slow(self) -> None:
        for i, p in enumerate(self._inner._parameter_list or ()):
            if p.requires_grad and i not in self._slow:
                self._slow[i] = p.detach().clone()

    @property
    def inner_opt(self):
        return self._inner

    @property
    def _parameter_list(self):
        return self._inner._parameter_list

    @_parameter_list.setter
    def _parameter_list(self, params):
        # TrainStep assigns this when the optimizer got no parameters=
        self._inner._parameter_list = params
        self._seed_slow()

    def __getattr__(self, name):
        if name == "_inner":  # guard: deepcopy/pickle probe pre-__init__
            raise AttributeError(name)
        return getattr(self._inner, name)

    def _functional_step(self, *args, **kwargs):
        raise NotImplementedError(
            "Lookahead's k-step slow-weight sync is host-side state and "
            "does not compose with the captured TrainStep; give TrainStep "
            "the inner optimizer (TrainStep(model, loss_fn, opt.inner_opt)) "
            "and call opt.sync() every k steps, or train eagerly via "
            "backward()/opt.step()")

    @torch.no_grad()
    def _pull(self, warn_unseeded: bool) -> None:
        for i, p in enumerate(self._inner._parameter_list or ()):
            if not p.requires_grad:
                continue
            slow = self._slow.get(i)
            if slow is None:
                if warn_unseeded:
                    warnings.warn(
                        "Lookahead slow weights were never seeded for param "
                        "%d (parameters attached after construction); first "
                        "sync is a no-op for it. Pass parameters= to the "
                        "inner optimizer before wrapping." % i)
                slow = self._slow[i] = p.detach().clone()
            slow.add_(self.alpha * (p - slow))
            p.copy_(slow)

    def sync(self) -> None:
        """Force a slow-weight sync now (for captured training loops that
        step the inner optimizer directly)."""
        self._step_count = 0
        self._pull(warn_unseeded=True)

    def step(self) -> None:
        self._seed_slow()  # params attached after __init__: pre-step
        self._inner.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            self._pull(warn_unseeded=False)

    def clear_grad(self, *args, **kwargs) -> None:
        self._inner.clear_grad(*args, **kwargs)

    def state_dict(self) -> dict:
        sd = self._inner.state_dict()
        sd["__lookahead_step__"] = torch.tensor(self._step_count)
        for i, slow in self._slow.items():
            sd["__lookahead_slow__%d" % i] = slow
        return sd

    def set_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        step = state_dict.pop("__lookahead_step__", None)
        if step is not None:
            self._step_count = int(np.asarray(
                step.cpu() if torch.is_tensor(step) else step))
        self._slow = {}
        params = self._inner._parameter_list or ()
        for key in [k for k in state_dict
                    if k.startswith("__lookahead_slow__")]:
            i = int(key[len("__lookahead_slow__"):])
            v = state_dict.pop(key)
            v = v.detach() if torch.is_tensor(v) else torch.as_tensor(
                np.asarray(v))
            self._slow[i] = (v.to(params[i].device) if i < len(params)
                             else v).clone()
        if state_dict:  # stateless inner optimizers (SGD) save no slots
            self._inner.set_state_dict(state_dict)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, None


class ModelAverage:
    """A running average of the parameters: ``apply()`` writes the
    averaged weights into the parameters for evaluation (in place) and
    ``restore()`` writes the trained ones back.  The window follows the
    reference: ``min(max(num_updates * rate, min_window), max_window)``."""

    def __init__(self, average_window_rate: float = 0.15,
                 parameters: Optional[Sequence] = None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        if parameters is None:
            raise InvalidArgumentError(
                "ModelAverage needs parameters=model.parameters()")
        self._params = [p for p in parameters if p.requires_grad]
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sums = {param_name(p): torch.zeros_like(p).detach()
                      for p in self._params}
        self._count = 0.0
        self._updates = 0
        self._saved: Optional[dict] = None

    @torch.no_grad()
    def step(self) -> None:
        """Accumulate the current weights (call after optimizer.step())."""
        self._updates += 1
        window = min(max(self._updates * self._rate, self._min_w),
                     self._max_w)
        decay = 1.0 if self._count < window else float(window) / (window + 1)
        for p in self._params:
            self._sums[param_name(p)].mul_(decay).add_(p)
        self._count = self._count * decay + 1 if self._count >= window \
            else self._count + 1

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        if self._count == 0:
            raise InvalidArgumentError(
                "ModelAverage.apply before any accumulation step()")
        with torch.no_grad():
            self._saved = {param_name(p): p.detach().clone()
                           for p in self._params}
            for p in self._params:
                p.copy_(self._sums[param_name(p)] / self._count)
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None) -> None:
        if self._saved is None:
            return
        for p in self._params:
            p.copy_(self._saved[param_name(p)])
        self._saved = None

"""Optimizers (counterpart of the reference's ``optimizer/__init__.py``):
``Optimizer``, ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``.

The update formulas, the state names (``moment1``, ``moment2``,
``beta1_pow``, ``beta2_pow``, ``velocity``, ``master_weight``),
``lr_ratio``, ``apply_decay_param_fun`` and ``multi_precision`` are the
reference's.  Where the reference's update is a pure function returning new
arrays, the port updates each parameter and its state tensors in place
under ``torch.no_grad()``: no second copy of the weights or moments exists
at any time.  ``torch.optim`` is not used -- its state layout and decay
hooks are not the reference's.

Two ways in, one update rule (clip -> regularize -> per-parameter
update):

- eager: ``loss.backward(); opt.step(); opt.clear_grad()`` reads
  ``p.grad`` and skips parameters without one, as the reference's
  dygraph ``step()``;
- functional: ``_functional_step(params, grads, lr)``, which
  ``jit.TrainStep`` calls with a dense gradient for every parameter (zeros
  where the loss does not reach it), as the reference's train step.

Per-parameter attributes are read where the reference reads them on its
``Parameter``: ``optimize_attr`` (``{"learning_rate": ratio}``),
``regularizer`` and ``need_clip``, each optional.  A parameter's name (the
key of its state and the argument of ``apply_decay_param_fun``) is
:func:`param_name`: ``torch.Tensor.name`` is reserved by torch, so the
name lives in the ``param_name`` attribute, ``"param_<n>"`` by default.

Not ported yet: Adagrad, Adadelta, Adamax, RMSProp, Lamb, Lars, Ftrl,
Lookahead, ModelAverage, sparse (row) updates, ``minimize`` and
``state_dict``.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import torch

from ..core.errors import InvalidArgumentError
from ..regularizer import L2Decay, WeightDecayRegularizer
from . import lr as lr_sched
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr",
           "param_name"]

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

    @staticmethod
    def _master(p, state):
        return state.get("master_weight", p.data)

    @staticmethod
    def _finish(p, state):
        """Write a master weight back into the model-dtype parameter."""
        if "master_weight" in state:
            p.data.copy_(state["master_weight"].to(p.dtype))

    # -- the update -------------------------------------------------------
    def _apply_one(self, p, grad, state, lr):  # pragma: no cover - abstract
        """Update ``p`` (and ``state``) in place from ``grad``."""
        raise NotImplementedError

    def _regularized(self, p, grad):
        reg = getattr(p, "regularizer", None)
        if reg is None:
            reg = self._weight_decay
        if isinstance(reg, WeightDecayRegularizer):
            return reg(p.detach().to(grad.dtype), grad)
        return grad

    @property
    def _decoupled_decay(self) -> bool:
        return False  # AdamW overrides

    @torch.no_grad()
    def _update(self, params_grads, lr_val: float) -> None:
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        for p, g in params_grads:
            if g is None:
                continue
            if not self._decoupled_decay:
                g = self._regularized(p, g)
            plr = lr_val * getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0)
            self._apply_one(p, g, self._state_for(p), plr)

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

    def _functional_step(self, params, grads, lr_val: float) -> None:
        """The train-step update: every parameter gets its gradient (dense,
        so an unused parameter still decays and advances its moments)."""
        self._update(list(zip(params, grads)), lr_val)

    def clear_grad(self) -> None:
        """Drop every parameter's gradient (its memory is freed)."""
        if self._parameter_list is None:
            return
        for p in self._parameter_list:
            p.grad = None


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _apply_one(self, p, grad, state, lr):
        m = self._master(p, state)
        m.sub_(lr * grad.to(m.dtype))
        self._finish(p, state)


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

    def _apply_one(self, p, grad, state, lr):
        m = self._master(p, state)
        g = grad.to(m.dtype)
        v = state["velocity"]
        v.mul_(self._momentum).add_(g)
        if self._use_nesterov:
            m.sub_(lr * (g + self._momentum * v))
        else:
            m.sub_(lr * v)
        self._finish(p, state)


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
        state = super()._init_state(p)
        m = state.get("master_weight", p)
        state["moment1"] = torch.zeros_like(m, dtype=torch.float32)
        state["moment2"] = torch.zeros_like(m, dtype=torch.float32)
        state["beta1_pow"] = torch.ones((), dtype=torch.float32,
                                        device=p.device)
        state["beta2_pow"] = torch.ones((), dtype=torch.float32,
                                        device=p.device)
        return state

    def _adam_delta(self, grad, state, lr):
        """Advance the moments and powers in place; the step to subtract."""
        g = grad.float()
        state["moment1"].mul_(self._beta1).add_((1 - self._beta1) * g)
        state["moment2"].mul_(self._beta2).add_(
            (1 - self._beta2) * torch.square(g))
        state["beta1_pow"].mul_(self._beta1)
        state["beta2_pow"].mul_(self._beta2)
        mhat = state["moment1"] / (1 - state["beta1_pow"])
        vhat = state["moment2"] / (1 - state["beta2_pow"])
        return lr * mhat / (torch.sqrt(vhat) + self._epsilon)

    def _apply_one(self, p, grad, state, lr):
        m = self._master(p, state)
        m.sub_(self._adam_delta(grad, state, lr).to(m.dtype))
        self._finish(p, state)


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

    def _apply_one(self, p, grad, state, lr):
        m = self._master(p, state)
        if self._lr_ratio is not None:
            lr = lr * self._lr_ratio(p)
        decay = self._coeff
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(param_name(p)):
            decay = 0.0
        delta = self._adam_delta(grad, state, lr)
        m.mul_(1.0 - lr * decay).sub_(delta.to(m.dtype))
        self._finish(p, state)

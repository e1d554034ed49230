"""Strategy-driven optimizer wrappers (counterpart of the reference's
``fleet/meta_optimizers.py``): ``GradientMergeOptimizer``,
``apply_lamb_lars``, ``DGCOptimizer``, ``FP16AllreduceOptimizer`` and
``LocalSGDOptimizer``.

Each wraps an optimizer (the rest of its surface delegates) and changes
the gradients it is given, in ``step()`` (from ``p.grad``) and in
``_functional_step`` (a ``TrainStep``'s update).  DGC and the fp16
all-reduce are the reference's *math* wrappers: they act on the already
summed gradient; the step whose wire is compressed is
``distributed.CompressedAllReduceStep``.  Gradient merge and DGC's
ramp-up decide on the host which step updates, so a captured step would
freeze that choice: build their ``TrainStep`` with ``capture=False``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...core.errors import InvalidArgumentError
from ...optimizer import param_name

__all__ = ["GradientMergeOptimizer", "apply_lamb_lars", "DGCOptimizer",
           "FP16AllreduceOptimizer", "LocalSGDOptimizer"]


class _Wrapper:
    """Delegation of the optimizer surface to ``_inner``; subclasses
    define ``_transform(params, grads) -> grads or None`` (None: no
    update this call)."""

    def __init__(self, inner):
        self._inner = inner

    @property
    def inner_opt(self):
        return self._inner

    def _transform(self, params, grads):
        return grads

    def _functional_step(self, params, grads, lr) -> None:
        grads = self._transform(list(params), list(grads))
        if grads is not None:
            self._inner._functional_step(params, grads, lr)
            self._after_update()

    def _after_update(self) -> None:
        pass

    @torch.no_grad()
    def step(self) -> None:
        params = [p for p in (self._inner._parameter_list or [])
                  if p.requires_grad and p.grad is not None]
        grads = self._transform(params, [p.grad for p in params])
        if grads is None:
            for p in params:
                p.grad = None  # consumed into the merge buffers
            return
        for p, g in zip(params, grads):
            p.grad = g
        self._inner.step()
        self._after_update()

    def clear_grad(self, *a, **k) -> None:
        self._inner.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    def state_dict(self) -> dict:
        return self._inner.state_dict()

    def set_state_dict(self, sd: dict) -> None:
        self._inner.set_state_dict(sd)

    def __getattr__(self, name):
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)


class GradientMergeOptimizer(_Wrapper):
    """Accumulate ``k_steps`` calls' gradients into buffers and update on
    the k-th with their sum (``avg``: mean)."""

    def __init__(self, inner, k_steps: int = 1, avg: bool = True):
        if k_steps < 1:
            raise InvalidArgumentError(
                "k_steps must be >= 1, got %d" % k_steps)
        super().__init__(inner)
        self.k_steps = int(k_steps)
        self.avg = bool(avg)
        self._acc: Dict[str, torch.Tensor] = {}
        self._count = 0

    def _transform(self, params, grads):
        if self._inner._parameter_list is None:
            raise InvalidArgumentError(
                "GradientMergeOptimizer needs an inner optimizer "
                "constructed with parameters=")
        self._count += 1
        apply_now = self._count >= self.k_steps
        out = []
        for p, g in zip(params, grads):
            name = param_name(p)
            acc = self._acc.get(name)
            acc = g.clone() if acc is None else acc + g
            if apply_now:
                out.append(acc / self.k_steps if self.avg else acc)
                self._acc.pop(name, None)
            else:
                self._acc[name] = acc
        if not apply_now:
            return None
        self._count = 0
        return out


def apply_lamb_lars(optimizer, strategy):
    """The optimizer class swap of ``strategy.lamb``/``lars``: Lamb over
    Adam/AdamW, Lars over Momentum; any other optimizer is left as it is
    (the reference disables the meta-optimizer)."""
    from ...optimizer import Adam, AdamW, Lamb, Lars, Momentum

    if getattr(strategy, "lamb", False) and type(optimizer) in (Adam, AdamW):
        cfg = getattr(strategy, "lamb_configs", None) or {}
        return Lamb(learning_rate=optimizer._learning_rate,
                    lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
                    beta1=optimizer._beta1, beta2=optimizer._beta2,
                    epsilon=optimizer._epsilon,
                    parameters=optimizer._parameter_list,
                    grad_clip=optimizer._grad_clip)
    if getattr(strategy, "lars", False) and type(optimizer) is Momentum:
        cfg = getattr(strategy, "lars_configs", None) or {}
        return Lars(learning_rate=optimizer._learning_rate,
                    momentum=optimizer._momentum,
                    lars_coeff=cfg.get("lars_coeff", 0.001),
                    lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
                    parameters=optimizer._parameter_list,
                    grad_clip=optimizer._grad_clip)
    return optimizer


class DGCOptimizer(_Wrapper):
    """Deep gradient compression's update math: per parameter a
    momentum-corrected, error-fed residual, of which the top
    ``1 - sparsity`` fraction by magnitude is applied and the rest kept
    for later steps; compression starts after ``rampup_begin_step``
    steps."""

    def __init__(self, inner, momentum: float = 0.9,
                 sparsity: float = 0.999, rampup_begin_step: int = 0):
        super().__init__(inner)
        self.momentum = float(momentum)
        self.sparsity = float(sparsity)
        self.rampup_begin_step = int(rampup_begin_step)
        self._u: Dict[str, torch.Tensor] = {}
        self._v: Dict[str, torch.Tensor] = {}
        self._step_count = 0

    def _transform(self, params, grads):
        self._step_count += 1
        if self._step_count <= self.rampup_begin_step:
            return grads
        out = []
        for p, g in zip(params, grads):
            name = param_name(p)
            u = self._u.get(name)
            u = g if u is None else self.momentum * u + g
            v = self._v.get(name)
            v = u if v is None else v + u
            k = max(1, int(round(v.numel() * (1.0 - self.sparsity))))
            # every entry at least the k-th magnitude (the reference's
            # threshold: ties may send a few more than k)
            thresh = torch.topk(v.reshape(-1).abs(), k).values[-1]
            mask = v.abs() >= thresh
            zero = torch.zeros((), dtype=v.dtype, device=v.device)
            out.append(torch.where(mask, v, zero))
            self._u[name] = torch.where(mask, zero, u)
            self._v[name] = torch.where(mask, zero, v)
        return out


class FP16AllreduceOptimizer(_Wrapper):
    """The fp16 all-reduce's numerics on the summed gradient: a float32
    gradient rounded to fp16 and back."""

    def _transform(self, params, grads):
        return [g.half().float() if g.dtype == torch.float32 else g
                for g in grads]


class LocalSGDOptimizer(_Wrapper):
    """Step locally, average the parameters every ``k_steps``.  One
    controller holds every replica of a single-controller program, so
    they never diverge there: the average is the identity and this is the
    inner optimizer, counting its syncs.  In a launched world (the
    launcher's or ``spawn``'s processes) each process steps its own
    replica and the sync is the mean across the processes, as the
    reference's ``c_allreduce_sum`` and scale."""

    def __init__(self, inner, k_steps: int = 1):
        if k_steps < 1:
            raise InvalidArgumentError("k_steps must be >= 1")
        super().__init__(inner)
        self.k_steps = int(k_steps)
        self._since_sync = 0
        self.syncs = 0

    def _after_update(self) -> None:
        self._since_sync += 1
        if self._since_sync >= self.k_steps:
            self._since_sync = 0
            self.syncs += 1
            self._sync_params()

    @torch.no_grad()
    def _sync_params(self) -> None:
        """The mean of each parameter over the launched processes (nothing
        to average under a single controller)."""
        from .. import collective

        world = collective._default_group
        if world is None or not world.process_backed:
            return
        for p in self._inner._parameter_list or []:
            collective.all_reduce(p.data, collective.ReduceOp.AVG,
                                  group=world)

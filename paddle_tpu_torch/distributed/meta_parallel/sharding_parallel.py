"""Sharding (ZeRO) parallelism (counterpart of the reference's
``meta_parallel/sharding_parallel.py``): ``ShardingOptimizerStage2``
(optimizer states and gradients split over a ``sharding`` group),
``GroupShardedParallel`` (stage 3: parameters too) and
``group_sharded_parallel``.

The reference places each state tensor split on dim 0 over the group's
axis (replicated when dim 0 does not divide) and lets the partitioner
write ZeRO's reduce-scatter and all-gather.  Here the ranks share one
device: every tensor stays whole -- the optimizer's state, the
parameter, its gradient -- and rank r owns rows ``[r R/n, (r+1) R/n)``
of each, as views.  A step clips the whole gradients once (a global norm
is the whole gradient's), then runs each rank's update on its views in
rank order: an element-wise rule (AdamW, SGD, ...) on row slices is the
arithmetic of the unsharded update, so the parameters, and the losses
after, are bit-equal to it.  A tensor whose dim 0 does not divide (a
scalar, a [3] bias) is replicated, as in the reference: each rank keeps
its own copy of the scalars it updates (Adam's bias-correction powers),
and the first rank alone updates a parameter that does not divide.

``offload=True`` keeps the states in pinned host memory (the
reference's ``pinned_host`` placement): each rank's update copies its
rows to a device staging buffer the size of one rank's share, updates
them there and copies them back, all on the step's stream, so a
captured step replays the copies too.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...core.errors import InvalidArgumentError
from ...nn.layer.layers import Layer
from ...optimizer import param_name
from ..collective import Group

__all__ = ["ShardingOptimizerStage2", "GroupShardedParallel",
           "group_sharded_parallel"]

_PARAM_ATTRS = ("param_name", "optimize_attr", "regularizer", "need_clip")


def _divides(shape, n: int) -> bool:
    return len(shape) > 0 and shape[0] % n == 0 and shape[0] >= n


def _rows(p, n: int, r: int) -> slice:
    k = p.shape[0] // n
    return slice(r * k, (r + 1) * k)


def _view(p, rows):
    """Rows of ``p`` as a plain tensor view carrying ``p``'s optimizer
    attributes (its name, lr ratio, regularizer, clip flag)."""
    v = p.detach()[rows]
    for a in _PARAM_ATTRS:
        if hasattr(p, a):
            setattr(v, a, getattr(p, a))
    return v


class ShardingOptimizerStage2:
    """ZeRO-2 over ``group`` (the default group when None): wraps an
    optimizer made with ``parameters=``; the optimizer surface delegates
    to it (``TrainStep`` reads its ``_states``), and the update runs rank
    by rank on row views.  ``rank_state_bytes()`` counts what each rank
    owns."""

    def __init__(self, optimizer, group: Optional[Group] = None,
                 offload: bool = False):
        from ..collective import _get_default_group

        if optimizer._parameter_list is None:
            raise InvalidArgumentError(
                "ShardingOptimizerStage2 needs an optimizer constructed with "
                "parameters=")
        self._inner = optimizer
        self.group = group or _get_default_group()
        self.offload = bool(offload)
        self._params = [p for p in optimizer._parameter_list
                        if p.requires_grad]
        for p in self._params:
            optimizer._state_for(p)
        self._reshard_states()

    # -- placement ------------------------------------------------------
    def _reshard_states(self) -> None:
        """Each rank's (param view, state dict) pairs: row views of the
        divisible tensors, own copies of the replicated scalars; with
        ``offload`` the states move to pinned host memory and each gets a
        device staging buffer of one rank's share."""
        n = self.group.nranks
        inner = self._inner
        self._ranks: List[list] = [[] for _ in range(n)]
        self._staging: Dict[int, dict] = {}
        self._addresses = [p.data_ptr() for p in self._params]
        for p in self._params:
            st = inner._state_for(p)
            if inner._multi_precision and p.dtype != torch.float32 \
                    and "master_weight" not in st:
                # amp.decorate cast the parameter after the states were
                # made: they start again, with a master, as decorate first
                st = inner._states[param_name(p)] = inner._init_state(p)
            if self.offload:
                for k, v in list(st.items()):
                    if torch.is_tensor(v) and v.ndim > 0 \
                            and v.device.type != "cpu":
                        st[k] = v.detach().to("cpu").pin_memory()
            split = _divides(tuple(p.shape), n)
            owners = range(n) if split else range(1)
            for r in owners:
                rows = _rows(p, n, r) if split else slice(None)
                rank_st = {}
                for k, v in st.items():
                    if torch.is_tensor(v) and v.ndim > 0:
                        rank_st[k] = v[rows]
                    elif torch.is_tensor(v) and r > 0:
                        rank_st[k] = v.clone()  # each rank's own scalar
                    else:
                        rank_st[k] = v
                self._ranks[r].append((p, rows, _view(p, rows), rank_st))
                if self.offload:
                    self._staging.setdefault(id(p), {
                        k: torch.empty(v.shape, dtype=v.dtype,
                                       device=p.device)
                        for k, v in rank_st.items()
                        if torch.is_tensor(v) and v.ndim > 0})

    def rank_state_bytes(self) -> List[int]:
        """The optimizer-state bytes each rank owns (its rows of the split
        states, its copies of the replicated ones)."""
        return [sum(v.numel() * v.element_size()
                    for _, _, _, st in entries for v in st.values()
                    if torch.is_tensor(v)) for entries in self._ranks]

    def state_bytes(self) -> int:
        """The optimizer-state bytes of the whole (unsharded) state."""
        return sum(v.numel() * v.element_size()
                   for st in self._inner._states.values()
                   for v in st.values() if torch.is_tensor(v))

    # -- the update -----------------------------------------------------
    def _functional_step(self, params, grads, lr) -> None:
        inner = self._inner
        if self._addresses != [p.data_ptr() for p in self._params]:
            self._reshard_states()  # the parameters were replaced (O2)
        pairs = list(zip(params, grads))
        if inner._grad_clip is not None:
            pairs = inner._grad_clip(pairs)
        grad_of = {id(p): g for p, g in pairs}
        for entries in self._ranks:
            sub, state_of = [], {}
            for p, rows, view, st in entries:
                g = grad_of.get(id(p))
                if g is None:
                    continue
                if self.offload:
                    st = self._stage_in(p, st)
                sub.append((view, g[rows]))
                state_of[id(view)] = st
            inner._update(sub, lr, state_of=lambda v: state_of[id(v)],
                          clip=False)
            if self.offload:
                self._stage_out(entries, grad_of)

    def _stage_in(self, p, st) -> dict:
        stage = self._staging[id(p)]
        out = dict(st)
        for k, buf in stage.items():
            buf.copy_(st[k], non_blocking=True)
            out[k] = buf
        return out

    def _stage_out(self, entries, grad_of) -> None:
        for p, _, _, st in entries:
            if id(p) in grad_of:
                for k, buf in self._staging[id(p)].items():
                    st[k].copy_(buf, non_blocking=True)

    @torch.no_grad()
    def step(self) -> None:
        """Eager update from ``p.grad`` (parameters without one are
        skipped)."""
        live = [p for p in self._params if p.grad is not None]
        self._functional_step(live, [p.grad for p in live],
                              self._inner.get_lr())

    def clear_grad(self, *a, **k) -> None:
        self._inner.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    def state_dict(self) -> dict:
        if self.offload and torch.cuda.is_available():
            torch.cuda.synchronize()  # the staged copies back to the host
        return self._inner.state_dict()

    def set_state_dict(self, sd: dict) -> None:
        self._inner.set_state_dict(sd)
        self._reshard_states()

    def get_lr(self) -> float:
        return self._inner.get_lr()

    def set_lr(self, v: float) -> None:
        self._inner.set_lr(v)

    def __getattr__(self, name):
        # guard lookups before __init__ (copy, pickle) against recursion;
        # private names delegate too: TrainStep reads _states/_state_for
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    def state_sharding_of(self, pname: str) -> dict:
        """State slot -> ``("sharding",)`` when split over the group's
        ranks on dim 0, ``()`` when replicated (the reference's
        PartitionSpec, by axis name)."""
        n = self.group.nranks
        return {k: (self.group.axis_name,) if torch.is_tensor(v)
                and _divides(tuple(v.shape), n) else ()
                for k, v in self._inner._states.get(pname, {}).items()}


class GroupShardedParallel(Layer):
    """ZeRO-3: the parameters split over the group too.  They stay whole
    (rank r owns rows ``[r R/n, (r+1) R/n)`` of each that divides, the
    first rank the others), so the forward reads the gathered parameter
    as it is; with an ``optimizer`` it is wrapped in
    ``ShardingOptimizerStage2`` (``offload`` moves its states to the
    host, the parameters stay on the card).  The layer surface delegates
    to the model."""

    def __init__(self, model, optimizer=None, group: Optional[Group] = None,
                 offload: bool = False):
        from ..collective import _get_default_group

        super().__init__()
        self.model = model
        self.group = group or _get_default_group()
        for p in model.parameters():
            p.is_distributed = True
        self.optimizer = (
            ShardingOptimizerStage2(optimizer, self.group, offload=offload)
            if optimizer is not None else None)

    def forward(self, *a, **k):
        return self.model(*a, **k)

    def rank_param_bytes(self) -> List[int]:
        """The parameter bytes each rank owns."""
        n = self.group.nranks
        out = [0] * n
        for p in self.model.parameters():
            nbytes = p.numel() * p.element_size()
            if _divides(tuple(p.shape), n):
                for r in range(n):
                    out[r] += nbytes // n
            else:
                out[0] += nbytes
        return out

    def parameters(self, include_sublayers: bool = True, recurse=None):
        return list(self.model.parameters(include_sublayers))

    def named_parameters(self, prefix: str = "", include_sublayers=True,
                         remove_duplicate: bool = True, recurse=None):
        return self.model.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self.model.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self.model.set_state_dict(state_dict, *args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            model = self._modules.get("model")
            if model is None or name.startswith("_"):
                raise
            return getattr(model, name)


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           group: Optional[Group] = None,
                           offload: bool = False, **kwargs):
    """``paddle.distributed.sharding.group_sharded_parallel``: level
    ``"os"``/``"os_g"`` is stage 2 (optimizer states [and gradients]),
    ``"p_g_os"`` stage 3 (the parameters too).  Returns ``(model,
    optimizer, None)``."""
    if level in ("os", "os_g"):
        return model, ShardingOptimizerStage2(optimizer, group=group,
                                              offload=offload), None
    if level == "p_g_os":
        wrapped = GroupShardedParallel(model, optimizer, group=group,
                                       offload=offload)
        return wrapped, wrapped.optimizer, None
    raise InvalidArgumentError(
        "group_sharded_parallel level must be os/os_g/p_g_os, got %r"
        % level)

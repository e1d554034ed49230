"""Compressed gradient communication in the data-parallel step
(counterpart of the reference's ``distributed/comm_hooks.py``):
``CompressedAllReduceStep``.

The reference writes the step as a ``shard_map`` over the dp axis: each
device's forward and backward on its batch shard, then a hand-written
gradient sync that changes what crosses the wire -- ``"fp16"``: the sum
of the fp16-cast gradients, cast back and divided by dp; ``"dgc"``: each
device's momentum-corrected, error-fed residual, its top-k (index,
value) pairs all-gathered (2k words a device instead of n) and
scatter-added into a dense mean, the residuals kept per device.  The
port's dp ranks share one device: each rank's forward and backward run
in rank order on its rows of the batch (``torch.autograd.grad``), and
the sync is written out over the ranks' gradients -- sums in float32 in
rank order.  A floating buffer (BatchNorm's running statistics) is
advanced from each rank's shard and averaged over the ranks, as the
reference's ``pmean``.  It is a ``jit.TrainStep``: captured on the card,
one graph per batch shape and compression phase (before and after
``rampup_begin_step``).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.errors import InvalidArgumentError
from ..jit.train_step import TrainStep
from .collective import all_gather, rank_sum
from .qcollectives import psum_wire_bytes

__all__ = ["CompressedAllReduceStep", "wire_bytes"]


def wire_bytes(numel: int, n: int, compression: str,
               sparsity: float = 0.999) -> int:
    """Per-device bytes one gradient of ``numel`` float32 elements puts on
    the wire in a step over ``n`` dp ranks: the dense ring all-reduce's
    ``2(n-1)/n`` of 4-byte elements (``"none"``) or 2-byte ones
    (``"fp16"``); DGC's all-gather of each rank's k int32 indices and k
    float32 values to its ``n-1`` peers."""
    if compression == "dgc":
        k = max(1, int(round(numel * (1.0 - sparsity))))
        return (n - 1) * k * 8 if n > 1 else 0
    return psum_wire_bytes((numel,), n,
                           {"none": 4, "fp16": 2}[compression])


def dgc_compress(g, u, v, momentum: float, sparsity: float):
    """DGC's encode (momentum correction, error feedback, top-k by
    magnitude): returns ``(idx, vals, new_u, new_v)``, the k flat indices
    and values sent and the residuals kept."""
    u = momentum * u + g
    v = v + u
    flat = v.reshape(-1)
    k = max(1, int(round(flat.numel() * (1.0 - sparsity))))
    _, idx = torch.topk(flat.abs(), k)
    vals = flat[idx]
    # index_fill_, not keep[idx] = False: a captured step may not copy
    # the host's False to the device
    keep = torch.ones_like(flat, dtype=torch.bool).index_fill_(0, idx, False)
    keep = keep.reshape(v.shape)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return idx, vals, torch.where(keep, u, zero), torch.where(keep, v, zero)


class CompressedAllReduceStep(TrainStep):
    """One data-parallel step with compressed gradient communication over
    ``group`` (the default group when None): ``step(*batch) -> loss`` with
    ``loss_fn(model, *batch) -> scalar``, every batch input split on dim 0
    over the ranks.  ``compression``: ``"fp16"`` or ``"dgc"``;
    ``sparsity``: DGC's fraction NOT sent; ``momentum``: its momentum
    correction; compression starts after ``rampup_begin_step`` steps (a
    plain float32 mean before)."""

    def __init__(self, model, loss_fn: Callable, optimizer, group=None,
                 compression: str = "fp16", sparsity: float = 0.999,
                 momentum: float = 0.9, rampup_begin_step: int = 0,
                 capture: bool = True):
        from .collective import init_parallel_env

        if compression not in ("fp16", "dgc"):
            raise InvalidArgumentError(
                "compression must be 'fp16' or 'dgc', got %r" % compression)
        self.group = group or init_parallel_env()
        self.dp = self.group.nranks
        self.compression = compression
        self.sparsity = float(sparsity)
        self.momentum = float(momentum)
        self.rampup_begin_step = int(rampup_begin_step)
        self._step_count = 0
        super().__init__(model, loss_fn, optimizer, capture=capture)
        # DGC's residuals, per rank and parameter (the reference's
        # sharded [dp, ...] state)
        self._uv = [[(torch.zeros_like(p, dtype=torch.float32),
                      torch.zeros_like(p, dtype=torch.float32))
                     for p in self._opt_params] for _ in range(self.dp)] \
            if compression == "dgc" else []

    def _watched(self):
        return super()._watched() + [t for rank in self._uv
                                     for pair in rank for t in pair]

    def __call__(self, *batch):
        for b in batch:
            if getattr(b, "ndim", 0) == 0 or b.shape[0] % self.dp:
                raise InvalidArgumentError(
                    "CompressedAllReduceStep: every batch input's dim 0 "
                    "must divide by dp=%d" % self.dp)
        self._step_count += 1
        return super().__call__(*batch,
                                self._step_count > self.rampup_begin_step)

    def wire_bytes_per_step(self) -> dict:
        """Per-device gradient bytes a step puts on the wire, this
        compression's and the dense float32 all-reduce's."""
        n = sum(p.numel() for p in self._opt_params)
        return {"compressed": sum(
                    wire_bytes(p.numel(), self.dp, self.compression,
                               self.sparsity) for p in self._opt_params),
                "dense_fp32": wire_bytes(n, self.dp, "none")}

    def _one_step(self, batch, lr):
        *batch, compress_now = batch
        n = self.dp
        params = self._opt_params
        buffers = [b for b in self._model.buffers() if b.is_floating_point()]
        start = [b.clone() for b in buffers]
        ended = [[] for _ in buffers]
        losses, grads = [], []
        for r in range(n):
            shard = [b[r * (b.shape[0] // n):(r + 1) * (b.shape[0] // n)]
                     if torch.is_tensor(b) else b for b in batch]
            with torch.no_grad():  # each rank advances from the same start
                for b, s in zip(buffers, start):
                    b.copy_(s)
            loss = self._loss_fn(self._model, *shard)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            grads.append([torch.zeros_like(p) if x is None else x
                          for p, x in zip(params, g)])
            losses.append(loss.detach().float())
            for acc, b in zip(ended, buffers):
                acc.append(b.detach().clone())
        with torch.no_grad():
            for b, ends in zip(buffers, ended):
                b.copy_((rank_sum([e.float() for e in ends]) / n).to(b.dtype))
        synced = [self._sync([grads[r][j] for r in range(n)], j,
                             compress_now) for j in range(len(params))]
        self._optimizer._functional_step(params, synced, lr)
        return rank_sum(losses) / n

    def _sync(self, per_rank, j, compress_now):
        """The ranks' gradients of parameter ``j`` -> the mean every rank
        applies."""
        n = self.dp
        gf = [g.float() for g in per_rank]
        dtype = per_rank[0].dtype
        if self.compression == "fp16":
            # the wire carries fp16: the sum as fp16 holds it
            total = rank_sum([g.half() for g in per_rank])
            return (total.float() / n).to(dtype)
        if not compress_now:
            return (rank_sum(gf) / n).to(dtype)
        idx, vals = [], []
        for r in range(n):
            u, v = self._uv[r][j]
            i, x, nu, nv = dgc_compress(gf[r], u, v, self.momentum,
                                        self.sparsity)
            with torch.no_grad():
                u.copy_(nu)
                v.copy_(nv)
            idx.append(i)
            vals.append(x)
        # the wire: every rank all-gathers the k (index, value) pairs
        g_idx = all_gather(torch.stack(idx), group=self.group)
        g_val = all_gather(torch.stack(vals), group=self.group)
        flat = torch.zeros(gf[0].numel(), dtype=torch.float32,
                           device=gf[0].device)
        for r in range(n):  # scatter-add in rank order
            flat = flat.index_put((g_idx[r],), g_val[r], accumulate=True)
        return (flat / n).reshape(per_rank[0].shape).to(dtype)

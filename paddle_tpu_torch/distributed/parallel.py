"""Data parallelism and the parallel environment (counterpart of the
reference's ``distributed/parallel.py``).

The reference's ``DataParallel`` does not hook gradients: under one
controller the step is one program over the GLOBAL batch, sharded on the
``dp`` axis, and the gradient all-reduce is part of that program (the
loss's mean over the global batch already scales by ``1/nranks``).  The
port's ranks share one device, so the global-view program is the whole
of it: ``DataParallel`` checks that the batch divides over the dp ranks
and runs the wrapped layer on it, and the gradient is the global batch's.
A step whose gradient communication differs from the dense sum (fp16 on
the wire, DGC's top-k) runs each rank's backward apart:
``distributed.CompressedAllReduceStep``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from ..core.errors import InvalidArgumentError
from ..nn.layer.layers import Layer
from .collective import (Group, _get_default_group, get_rank,
                         get_world_size, init_parallel_env)

__all__ = ["ParallelEnv", "DataParallel", "get_rank", "get_world_size",
           "shard_batch", "scale_loss"]


class ParallelEnv:
    """The process's view of the cluster: its rank and the number of
    processes (a launched world's, from ``torch.distributed``; else rank
    0 of 1), its card ``device_id`` and the launcher's endpoints."""

    def __init__(self):
        import torch.distributed as dist

        launched = dist.is_available() and dist.is_initialized()
        self._rank = dist.get_rank() if launched else 0
        self._world_size = dist.get_world_size() if launched else 1
        self._device_id = torch.cuda.current_device() \
            if launched and dist.get_backend() == "nccl" else 0
        self._trainer_endpoints = os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def rank(self) -> int:
        return self._rank

    local_rank = rank

    @property
    def world_size(self) -> int:
        return self._world_size

    nranks = world_size

    @property
    def device_id(self) -> int:
        return self._device_id

    dev_id = device_id

    @property
    def current_endpoint(self) -> str:
        eps = self._trainer_endpoints
        return eps[self._rank] if self._rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints


def shard_batch(x, group: Optional[Group] = None):
    """A global batch on the group's device, its dim 0 checked to divide
    over the group's ranks (rank i's shard is rows ``i*B/n`` to
    ``(i+1)*B/n``)."""
    group = group or _get_default_group()
    t = x if torch.is_tensor(x) else torch.as_tensor(x)
    if t.shape[0] % group.nranks != 0:
        raise InvalidArgumentError(
            "batch dim %d not divisible by dp degree %d"
            % (t.shape[0], group.nranks))
    return t.to(group.device)


def scale_loss(loss, group: Optional[Group] = None):
    """The reference's ``scale_loss``: the global batch's mean already
    scales, so this is the identity."""
    return loss


class DataParallel(Layer):
    """``paddle.DataParallel``: the wrapped layer over the global batch,
    whose dim 0 must divide over the dp ranks (raised loudly, as the
    reference's reducer does).  ``comm_buffer_size`` and its kin are
    accepted and have no effect."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group: Optional[Group] = None):
        super().__init__()
        if not isinstance(layers, torch.nn.Module):
            raise InvalidArgumentError(
                "DataParallel expects a Layer, got %r" % type(layers))
        self._layers = layers
        self.group = group or init_parallel_env()
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        placed = []
        for x in inputs:
            if torch.is_tensor(x) and x.ndim >= 1:
                if x.shape[0] % self.group.nranks != 0:
                    raise InvalidArgumentError(
                        "DataParallel: batch dim %d is not divisible by the "
                        "data-parallel degree %d; pad the batch or use "
                        "DistributedBatchSampler(drop_last=True)"
                        % (x.shape[0], self.group.nranks))
                x = shard_batch(x, self.group)
            placed.append(x)
        return self._layers(*placed, **kwargs)

    def parameters(self, include_sublayers: bool = True, recurse=None):
        return list(self._layers.parameters(include_sublayers))

    def named_parameters(self, prefix: str = "", include_sublayers=True,
                         remove_duplicate: bool = True, recurse=None):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return scale_loss(loss, self.group)

    def no_sync(self):
        """The reference's ``no_sync``: a no-op context (accumulate with
        ``fleet.meta_optimizers.GradientMergeOptimizer`` instead)."""
        return contextlib.nullcontext()

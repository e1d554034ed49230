"""The pipeline's train step (counterpart of the reference's
``meta_parallel/spmd_pipeline.py``): ``partition_pipeline``,
``megatron_param_spec`` and ``PipelineTrainStep``.

The reference compiles the pipeline as one SPMD program: the core
stages' parameters stacked on a ``pp`` axis, a scan of ``M + pp - 1``
ticks handing each microbatch's activation to the next stage, and
autodiff of the scan giving the backward.  Its arithmetic is the
microbatch loop's: the mean of the microbatches' losses, their gradients
summed.  The port's stages share one device, so the schedule is a static
loop on it -- for each microbatch, the prefix (embeddings), every
stage's blocks in stage order, the suffix (head) and loss, then that
microbatch's backward -- and one optimizer update.  With ``recompute``
each core block is checkpointed, so the activations alive are one
microbatch's, one block at a time (the reference checkpoints each
stage's tick).  The stages keep their own parameters (no stacking:
``state_dict`` and checkpoints see them as they are).

``mp_param_spec`` (``megatron_param_spec``) splits the core blocks'
Linears over an ``mp`` axis of the mesh (``mp_layers.shard_linear``):
each mp rank's heads attend apart (K3 at ``H/mp`` heads) and the
row-parallel products sum in rank order.  The step is a
``jit.TrainStep``: on the card one CUDA graph per batch shape.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ...core.errors import InvalidArgumentError
from ...jit.train_step import TrainStep
from ...nn.layer.common import Linear
from ...nn.layer.layers import Layer
from ...optimizer import param_name
from .mp_layers import shard_linear

__all__ = ["partition_pipeline", "megatron_param_spec", "PipelineTrainStep"]


def _layer_sig(obj, ffunc=None):
    """Structural signature of an entry: its class and parameter shapes
    and dtypes; an entry with a ``forward_func`` (a shared layer) is
    unique, so it lands in the prefix or suffix."""
    if ffunc is not None:
        return ("sharedfn:%d" % id(ffunc), ())
    if isinstance(obj, Layer):
        return (type(obj).__name__,
                tuple((n, tuple(p.shape), str(p.dtype))
                      for n, p in obj.named_parameters()))
    return ("callable:%s" % getattr(obj, "__name__", repr(obj)), ())


def _walk_params(entries) -> list:
    out, seen = [], set()
    for e in entries:
        obj = e[0] if isinstance(e, tuple) else e
        if isinstance(obj, Layer):
            for p in obj.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    out.append(p)
    return out


def _partition_by_bounds(pipeline_layer):
    """Partition along the layer's own stage bounds when the stages are
    homogeneous after trimming stage 0's leading and the last stage's
    trailing odd entries."""
    pp = pipeline_layer.get_num_stages()
    pairs = list(pipeline_layer._funcs)
    b = pipeline_layer._stage_bounds
    stages = [pairs[b[s]:b[s + 1]] for s in range(pp)]
    sigs = [[_layer_sig(o, f) for o, f in st] for st in stages]
    if pp >= 3:
        ref = sigs[1]
        if any(sigs[s] != ref for s in range(1, pp - 1)) or not ref:
            return None
        npre = len(sigs[0]) - len(ref)
        nsuf = len(sigs[-1]) - len(ref)
        if npre < 0 or nsuf < 0 or sigs[0][npre:] != ref \
                or sigs[-1][:len(ref)] != ref:
            return None
    else:
        best = 0
        for k in range(1, min(len(sigs[0]), len(sigs[1])) + 1):
            if sigs[0][-k:] == sigs[1][:k]:
                best = k
        if best == 0:
            return None
        npre = len(sigs[0]) - best
        nsuf = len(sigs[1]) - best
        ref = sigs[0][npre:]
    core = [stages[0][npre:]] + stages[1:-1] + \
        [stages[-1][:len(stages[-1]) - nsuf] if nsuf else stages[-1]]
    if not _walk_params(core[0]):
        return None  # a stateless core: nothing to place
    prefix = stages[0][:npre]
    suffix = stages[-1][len(stages[-1]) - nsuf:] if nsuf else []
    return prefix, core, suffix


def partition_pipeline(pipeline_layer):
    """``(prefix, core_stages, suffix)`` of a PipelineLayer, or None: its
    own stage bounds when homogeneous after end-trimming, else the longest
    run of structurally identical entries split into ``pp`` equal chunks
    (a remainder joins the prefix).  Each element is an ``(obj,
    forward_func)`` pair, application order kept.  None when no
    homogeneous core of at least ``pp`` entries exists."""
    pp = pipeline_layer.get_num_stages()
    if pp <= 1:
        return None
    by_bounds = _partition_by_bounds(pipeline_layer)
    if by_bounds is not None:
        return by_bounds
    pairs = list(pipeline_layer._funcs)
    sigs = [_layer_sig(obj, ffunc) for obj, ffunc in pairs]
    best_start, best_len, i = 0, 0, 0
    while i < len(sigs):
        j = i
        while j < len(sigs) and sigs[j] == sigs[i]:
            j += 1
        if _walk_params([pairs[i]]) and j - i > best_len:
            best_start, best_len = i, j - i
        i = j
    if best_len < pp:
        return None
    k = best_len // pp
    core_start = best_start + best_len - k * pp
    prefix = pairs[:core_start]
    core = [pairs[core_start + s * k: core_start + (s + 1) * k]
            for s in range(pp)]
    suffix = pairs[best_start + best_len:]
    return prefix, core, suffix


def megatron_param_spec(core_stage, mp_axis: str = "mp",
                        column=("q_proj.weight", "k_proj.weight",
                                "v_proj.weight", "linear1.weight"),
                        row=("out_proj.weight", "linear2.weight")):
    """An ``mp_param_spec`` for a partitioned core stage (one entry of
    ``partition_pipeline``'s core list): ``spec(param_name, ndim)`` gives
    ``(None, mp_axis)`` for the weights whose attribute path matches
    ``column``, ``(mp_axis, None)`` for ``row``, and all-None otherwise
    (the Megatron transformer placement).  None when nothing matches."""
    spec_map = {}
    for i, (obj, _f) in enumerate(core_stage):
        if not isinstance(obj, Layer):
            continue
        for attr, p in obj.named_parameters():
            if p.ndim != 2:
                continue
            if any(k in attr for k in column):
                spec_map[param_name(p)] = (None, mp_axis)
            elif any(k in attr for k in row):
                spec_map[param_name(p)] = (mp_axis, None)

    def spec(name, ndim):
        return spec_map.get(name, (None,) * ndim)

    return spec if spec_map else None


def _apply(entries, x):
    for obj, ffunc in entries:
        x = ffunc(obj, x) if ffunc else obj(x)
    return x


def _linears(entries) -> List[Linear]:
    return [m for obj, _ in entries if isinstance(obj, Layer)
            for m in obj.modules() if isinstance(m, Linear)]


class PipelineTrainStep(TrainStep):
    """One pipelined training step over a mesh with a ``pp`` axis
    (``fleet``'s ``hcg.mesh``, or anything with ``.shape`` by axis name):
    ``step(x, y) -> loss``, the mean of the ``microbatches`` losses.
    ``mp_param_spec`` splits the core stages' Linears over the axis it
    names; ``amp_configs`` (``amp.auto_cast``'s keywords) runs each
    microbatch's forward under autocast.  A ``jit.TrainStep``: captured
    on the card unless ``capture=False``."""

    def __init__(self, pipeline_layer, optimizer, mesh, microbatches: int,
                 dp_axis: str = "dp", pp_axis: str = "pp",
                 recompute: bool = True, mp_param_spec=None,
                 amp_configs: Optional[dict] = None, capture: bool = True):
        parts = partition_pipeline(pipeline_layer)
        if parts is None:
            raise InvalidArgumentError(
                "PipelineTrainStep: stages are not homogeneous after "
                "prefix/suffix trimming; use the gradient-accumulation "
                "fallback")
        self._prefix, self._core, self._suffix = parts
        if pipeline_layer._loss_fn is None:
            raise InvalidArgumentError("PipelineLayer needs loss_fn=")
        self.mesh = getattr(mesh, "mesh", mesh)
        shape = self.mesh.shape
        if pp_axis not in shape:
            raise InvalidArgumentError(
                "mesh %r has no %r axis" % (tuple(shape), pp_axis))
        self.pp = shape[pp_axis]
        self.dp = shape.get(dp_axis, 1)
        if self.pp != pipeline_layer.get_num_stages():
            raise InvalidArgumentError(
                "mesh pp=%d != PipelineLayer stages=%d"
                % (self.pp, pipeline_layer.get_num_stages()))
        self.microbatches = int(microbatches)
        self.recompute = recompute
        self.optimizer = optimizer
        self._amp = amp_configs
        template = _walk_params(self._core[0])
        for s, st in enumerate(self._core):
            if [tuple(p.shape) for p in _walk_params(st)] != \
                    [tuple(p.shape) for p in template]:
                raise InvalidArgumentError(
                    "stage %d parameter structure mismatch" % s)
        self.mp = 1
        if mp_param_spec is not None:
            self._place_mp(mp_param_spec, shape)
        super().__init__(pipeline_layer, None, optimizer, capture=capture)

    def _place_mp(self, spec, shape) -> None:
        """Mark each core stage's Linears by the spec of the template
        stage's Linear at the same place."""
        template = _linears(self._core[0])
        for st in self._core:
            lins = _linears(st)
            for t, lin in zip(template, lins):
                dims = tuple(spec(param_name(t.weight), 2))
                if len(dims) != 2:
                    raise InvalidArgumentError(
                        "mp_param_spec(%r, 2) returned %d dims"
                        % (param_name(t.weight), len(dims)))
                if dims == (None, None):
                    continue
                kind = "column" if dims[0] is None else "row"
                axis = dims[1] if kind == "column" else dims[0]
                self.mp = shape[axis]
                shard_linear(lin, kind, shape[axis])

    def stage_devices(self, s: int):
        """The devices holding stage ``s``'s parameters: the mesh's one."""
        if not 0 <= s < self.pp:
            raise InvalidArgumentError("stage %d out of range" % s)
        return {self.mesh.device}

    def _microbatch_loss(self, x, y):
        from ..fleet.utils import recompute

        h = _apply(self._prefix, x)
        for stage in self._core:
            for obj, ffunc in stage:
                def fn(v, o=obj, f=ffunc):
                    return f(o, v) if f else o(v)
                h = recompute(fn, h) if self.recompute else fn(h)
        return self._model._loss_fn(_apply(self._suffix, h), y)

    def forward_backward(self, x, y):
        """The step without its update: the mean of the microbatches'
        losses, every parameter's gradient accumulated into ``.grad``."""
        import contextlib

        from ... import amp

        m = self.microbatches
        if x.shape[0] % m:
            raise InvalidArgumentError(
                "batch %d not divisible by accumulate_steps %d"
                % (x.shape[0], m))
        mb = x.shape[0] // m
        if mb % self.dp:
            raise InvalidArgumentError(
                "microbatch %d not divisible by dp degree %d"
                % (mb, self.dp))
        total = None
        for i in range(m):
            rows = slice(i * mb, (i + 1) * mb)
            ctx = amp.auto_cast(**self._amp) if self._amp \
                else contextlib.nullcontext()
            with ctx:
                loss = self._microbatch_loss(x[rows], y[rows])
            (loss / m).backward()
            loss = loss.detach().float()
            total = loss if total is None else total + loss
        return total / m

    def _one_step(self, batch, lr):
        for p in self._opt_params:
            p.grad = None
        loss = self.forward_backward(*batch)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._opt_params]
        for p in self._opt_params:
            p.grad = None
        self._optimizer._functional_step(self._opt_params, grads, lr)
        return loss

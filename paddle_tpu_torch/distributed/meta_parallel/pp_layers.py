"""Pipeline layer description and container (counterpart of the
reference's ``meta_parallel/pp_layers.py``): ``LayerDesc`` (build later),
``SharedLayerDesc`` (one layer at several positions, e.g. a tied
embedding) and ``PipelineLayer`` with the reference's stage
segmentation, kept identical (``uniform``, or ``layer:<regex>`` over the
entries' class names).  The schedule is ``spmd_pipeline``'s.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

from ...core.errors import InvalidArgumentError
from ...nn.layer.layers import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    """A build-later record of ``(layer class or callable, args)``."""

    def __init__(self, layer_func, *inputs, **kwargs):
        if not callable(layer_func):
            raise InvalidArgumentError(
                "LayerDesc expects a Layer subclass or callable, got %r"
                % (layer_func,))
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return "LayerDesc(%s)" % getattr(self.layer_func, "__name__",
                                         self.layer_func)


class SharedLayerDesc(LayerDesc):
    """One layer built once and shared by every position naming ``key``;
    ``forward_func(layer, x)`` (when given) is how a position applies
    it."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """The pipeline's entries in execution order (layers, descriptions or
    callables), segmented into ``num_stages`` stages (the fleet's pp
    degree when None).  ``forward`` runs them all in order, with every
    ``recompute_interval``-th entry checkpointed."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0, **kwargs):
        super().__init__()
        self._descs = list(layers)
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        if num_stages is None:
            from ..fleet import fleet

            num_stages = (fleet.get_hybrid_communicate_group()
                          .get_pipe_parallel_world_size()
                          if fleet.is_initialized else 1)
        self._num_stages = int(num_stages)
        self._shared: Dict[str, Any] = {}
        built: List[Any] = []
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    self._shared[d.layer_name] = d.build_layer()
                built.append((self._shared[d.layer_name], d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), None))
            elif callable(d):
                built.append((d, None))
            else:
                raise InvalidArgumentError(
                    "PipelineLayer entries must be Layer/LayerDesc/callable, "
                    "got %r" % (d,))
        self._funcs: List = []
        for i, (obj, ffunc) in enumerate(built):
            if isinstance(obj, Layer):
                self.add_sublayer(str(i), obj)
            self._funcs.append((obj, ffunc))
        self._stage_bounds = self._segment(seg_method)

    def _segment(self, seg_method: str) -> List[int]:
        n, stages = len(self._funcs), self._num_stages
        if stages <= 1:
            return [0, n]
        if seg_method.startswith("layer:"):
            pat = seg_method.split(":", 1)[1]
            marks = [i for i, (obj, _) in enumerate(self._funcs)
                     if re.search(pat, type(obj).__name__)]
            if len(marks) < stages:
                raise InvalidArgumentError(
                    "seg_method %r marks %d boundaries < %d stages"
                    % (seg_method, len(marks), stages))
            # marked layers spread evenly; the unmarked prefix and suffix
            # join the first and last stage
            per, extra = divmod(len(marks), stages)
            bounds, idx = [0], 0
            for s in range(stages - 1):
                idx += per + (1 if s < extra else 0)
                bounds.append(marks[idx] if idx < len(marks) else n)
            bounds.append(n)
            return bounds
        per, extra = divmod(n, stages)
        bounds = [0]
        for s in range(stages):
            bounds.append(bounds[-1] + per + (1 if s < extra else 0))
        return bounds

    def get_num_stages(self) -> int:
        return self._num_stages

    def stage_of(self, layer_index: int) -> int:
        for s in range(self._num_stages):
            if self._stage_bounds[s] <= layer_index \
                    < self._stage_bounds[s + 1]:
                return s
        raise InvalidArgumentError("layer index %d out of range"
                                   % layer_index)

    def stage_layers(self, stage: int) -> List:
        lo, hi = self._stage_bounds[stage], self._stage_bounds[stage + 1]
        return [obj for obj, _ in self._funcs[lo:hi]]

    def forward(self, x):
        from ..fleet.utils import recompute

        for i, (obj, ffunc) in enumerate(self._funcs):
            def fn(v, o=obj, f=ffunc):
                return f(o, v) if f else o(v)
            if self._recompute_interval and \
                    i % self._recompute_interval == 0 and \
                    not isinstance(x, (tuple, list)):
                x = recompute(fn, x)
            else:
                x = fn(x)
        return x

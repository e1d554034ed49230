"""The pipeline-parallel engine (counterpart of the reference's
``meta_parallel/pipeline_parallel.py``): ``PipelineParallel.train_batch``
runs a ``PipelineLayer`` through ``spmd_pipeline.PipelineTrainStep``
(microbatched, one update), or, when its stages do not partition
homogeneously or a loss scaler is given, through plain microbatch
gradient accumulation -- the same arithmetic.
"""
from __future__ import annotations

import torch

from ...core.errors import InvalidArgumentError
from ...nn.layer.layers import Layer
from .pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]


class PipelineParallel(Layer):
    """``strategy.pipeline_configs``: ``accumulate_steps`` (the
    microbatches) and an optional ``mp_param_spec``; ``strategy.amp``'s
    ``amp_configs`` run the microbatches under autocast."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise InvalidArgumentError(
                "PipelineParallel expects a PipelineLayer, got %r"
                % type(layers))
        self._layers = layers
        self._hcg = hcg
        cfg = getattr(strategy, "pipeline_configs", None) or {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self._mp_param_spec = cfg.get("mp_param_spec")
        self._amp = None
        if getattr(strategy, "amp", False):
            amp_cfg = getattr(strategy, "amp_configs", None) or {}
            self._amp = {"level": "O1",
                         "dtype": amp_cfg.get("dtype", "bfloat16")}
        self._step = None
        self._unavailable = False

    def forward(self, x):
        return self._layers(x)

    def _engine(self, optimizer):
        from .spmd_pipeline import PipelineTrainStep, partition_pipeline

        if self._unavailable:
            return None
        if self._step is not None and self._step.optimizer is optimizer:
            return self._step
        pp = self._layers.get_num_stages()
        if pp <= 1 or self._hcg is None \
                or self._hcg.mesh.shape.get("pp", 1) != pp \
                or partition_pipeline(self._layers) is None:
            self._unavailable = True
            return None
        self._step = PipelineTrainStep(
            self._layers, optimizer, self._hcg.mesh,
            microbatches=self.accumulate_steps,
            mp_param_spec=self._mp_param_spec, amp_configs=self._amp)
        return self._step

    def stage_devices(self, s: int):
        if self._step is None:
            raise InvalidArgumentError(
                "stage_devices is available after the first train_batch "
                "on the pipeline engine")
        return self._step.stage_devices(s)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One step over ``data = (inputs, labels)`` (batch divisible by
        ``accumulate_steps``); returns the mean microbatch loss."""
        x, y = data
        loss_fn = self._layers._loss_fn
        if loss_fn is None:
            raise InvalidArgumentError(
                "PipelineLayer needs loss_fn= for train_batch")
        engine = self._engine(optimizer) if scaler is None else None
        if engine is not None:
            loss = engine(x, y)
        else:
            loss = self._accumulate(x, y, loss_fn, optimizer, scaler)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def _accumulate(self, x, y, loss_fn, optimizer, scaler):
        k = self.accumulate_steps
        dev = next(iter(self._layers.parameters())).device
        x = torch.as_tensor(x).to(dev)
        y = torch.as_tensor(y).to(dev)
        if x.shape[0] % k:
            raise InvalidArgumentError(
                "batch %d not divisible by accumulate_steps %d"
                % (x.shape[0], k))
        mb = x.shape[0] // k
        total = None
        for i in range(k):
            rows = slice(i * mb, (i + 1) * mb)
            loss = loss_fn(self._layers(x[rows]), y[rows])
            scaled = loss * (1.0 / k)
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            loss = loss.detach().float()
            total = loss if total is None else total + loss
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        return total / k

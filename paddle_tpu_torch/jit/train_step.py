"""Training steps (counterpart of the reference's ``jit.TrainStep`` and
``jit.MultiStepTrainStep``).

One step is: clear the gradients, ``loss_fn(model, *batch)``, backward,
clip, and the optimizer's update of every parameter in place.  It returns
the loss detached, on the device, with no host sync, so a caller can queue
steps back to back.

The reference compiles the step with ``jax.jit`` and donates the
parameter and state buffers so XLA updates them in place; torch runs
eagerly and updates in place already, so there is nothing to compile and
``donate=`` is accepted and has no effect.  Pinned-host (offloaded)
optimizer states have no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..core.errors import InvalidArgumentError

__all__ = ["TrainStep", "MultiStepTrainStep"]


class TrainStep:
    """Forward + backward + optimizer update of ``model``.

    ``loss_fn(model, *batch) -> scalar tensor``.  Batch inputs that are
    numpy arrays are moved to the model's device.  Every trainable
    parameter the optimizer tracks gets a dense gradient (zeros where the
    loss does not reach it), as in the reference's compiled step."""

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 donate: Optional[bool] = None):
        self._model = model
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self.donate = donate  # no effect: torch updates in place
        params = list(model.parameters())
        if optimizer._parameter_list is None:
            optimizer._parameter_list = params
        opt_ids = {id(p) for p in optimizer._parameter_list
                   if p.requires_grad}
        # the model's parameter order, whatever order the optimizer got
        self._opt_params = [p for p in params if id(p) in opt_ids]
        if len(self._opt_params) != len(opt_ids):
            raise InvalidArgumentError(
                "TrainStep: optimizer tracks %d trainable parameters that "
                "are not parameters of the model"
                % (len(opt_ids) - len(self._opt_params)))
        for p in self._opt_params:
            optimizer._state_for(p)
        self._device = params[0].device if params else torch.device("cpu")

    def _batch(self, batch):
        return [torch.from_numpy(b).to(self._device)
                if isinstance(b, np.ndarray) else b for b in batch]

    def __call__(self, *batch):
        opt = self._optimizer
        for p in self._opt_params:
            p.grad = None
        loss = self._loss_fn(self._model, *self._batch(batch))
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._opt_params]
        opt._functional_step(self._opt_params, grads, opt.get_lr())
        for p in self._opt_params:
            p.grad = None  # the gradients' memory is free between steps
        return loss.detach()


class MultiStepTrainStep(TrainStep):
    """K optimizer steps per call: every batch input is K per-step batches
    stacked on a new leading axis ``[K, ...]``; the steps run in order and
    the ``[K]`` per-step losses are returned.  The learning rate is read
    once per step, as the reference reads it once per call (a scheduler
    that is not stepped in between gives the same value)."""

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 steps_per_call: int, donate: Optional[bool] = None):
        if steps_per_call < 1:
            raise InvalidArgumentError(
                "MultiStepTrainStep: steps_per_call must be >= 1, got %r"
                % (steps_per_call,))
        super().__init__(model, loss_fn, optimizer, donate=donate)
        self.steps_per_call = steps_per_call

    # the K-stacking contract, spelled out in every shape error so the
    # batch==K aliasing case is diagnosable from the message alone
    _STACK_CONTRACT = (
        "each batch input must be K per-STEP batches stacked along a NEW "
        "leading axis (np.stack -> [K, batch, ...]); a plain [batch, ...] "
        "input is never valid here — if your per-step batch size equals "
        "K, the leading dim would alias the batch axis and the scan "
        "would train on single examples")

    def __call__(self, *batch):
        k = self.steps_per_call
        for i, b in enumerate(batch):
            shape = getattr(b, "shape", None)
            if shape is None or len(shape) == 0:
                raise InvalidArgumentError(
                    "MultiStepTrainStep: batch input %d is a scalar; "
                    "scan needs a [%d, ...] leading step axis — %s "
                    "(or close over constants in loss_fn)"
                    % (i, k, self._STACK_CONTRACT))
            if shape[0] != k:
                raise InvalidArgumentError(
                    "MultiStepTrainStep(steps_per_call=%d): batch input "
                    "%d has shape %s, leading dim %s != K=%d; %s"
                    % (k, i, tuple(shape), shape[0], k,
                       self._STACK_CONTRACT))
        batch = self._batch(batch)
        losses = [super(MultiStepTrainStep, self).__call__(
            *[b[s] for b in batch]) for s in range(k)]
        return torch.stack(losses)

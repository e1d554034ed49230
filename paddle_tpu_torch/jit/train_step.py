"""Training steps (counterpart of the reference's ``jit.TrainStep`` and
``jit.MultiStepTrainStep``).

One step is: clear the gradients, ``loss_fn(model, *batch)``, backward,
clip, and the optimizer's grouped update of every parameter in place.
The reference compiles it into one XLA program; here it is one
:class:`~.aot.AotFunction` keyed by the batch's shapes and dtypes, which on
the card holds one CUDA graph per key:

- a key's first call is its warm-up and the real step, run eagerly on a
  side stream (whole-network capture needs autograd warmed up off the
  capturing stream);
- its second call frees the cached blocks the warm-up left
  (``torch.cuda.empty_cache()``: the graph's private pool would otherwise
  sit beside them), captures the step and replays it once;
- every later call copies the batch into the key's held inputs and writes
  the learning rate into a device scalar, then replays.  Before each call
  the parameters, buffers and optimizer state are checked against the
  addresses the graph recorded: a tensor that moved (``amp.decorate``
  after construction, ``load_state_dict(..., assign=True)``) drops the
  graph, and the key warms up and captures again.

Dropout draws from the default CUDA generator, which the capture
registers, so every replay draws a fresh mask, as the reference draws a
new key each call.  The loss is returned detached, as a fresh tensor each
call (never the graph's static output), with no host sync.  A step that
cannot be captured (a host op in the loss, a host read) raises
:class:`~.aot.CaptureError`; ``capture=False`` runs every step eagerly,
and nothing falls back to it silently.  On the CPU every step runs
eagerly and the keys are still counted.

``donate=`` is accepted and has no effect: torch updates in place.
Pinned-host (offloaded) optimizer states have no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..core.errors import InvalidArgumentError
from .aot import AotFunction, CaptureError, _on_cuda, module_tensors, \
    shape_key

__all__ = ["TrainStep", "MultiStepTrainStep"]


class _StepGraphs(AotFunction):
    """:class:`AotFunction` with the whole-network capture's warm-up on a
    side stream."""

    def _warm_up(self, args):
        if not (self._capture and _on_cuda(args)):
            return self._fn(*args)
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._fn(*args)
        main.wait_stream(side)
        return out


def _batch_key(batch) -> str:
    return "|".join(shape_key(b) if hasattr(b, "shape") else repr(b)
                    for b in batch)


class TrainStep:
    """Forward + backward + optimizer update of ``model``.

    ``loss_fn(model, *batch) -> scalar tensor``.  Batch inputs that are
    numpy arrays are moved to the model's device.  Every trainable
    parameter the optimizer tracks gets a dense gradient (zeros where the
    loss does not reach it), as in the reference's compiled step.  With
    ``capture`` (the default) a step on the card is a CUDA graph replay;
    ``capture=False`` runs it eagerly."""

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 donate: Optional[bool] = None, capture: bool = True):
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
        # the learning rate the step reads, rewritten before each call
        self._lr = torch.zeros((), dtype=torch.float32, device=self._device)
        # key -> the batch tensors a captured step reads by address
        self._held = {}
        self._fn = _StepGraphs(self._run, key_fn=self._key,
                               name=type(self).__name__, capture=capture,
                               watch=self._watched)

    def _watched(self):
        states = self._optimizer._states
        return module_tensors(self._model) + [
            t for st in states.values() for t in st.values()
            if torch.is_tensor(t)]

    @staticmethod
    def _key(lr, *batch):
        return _batch_key(batch)

    def _one_step(self, batch, lr):
        opt = self._optimizer
        for p in self._opt_params:
            p.grad = None
        loss = self._loss_fn(self._model, *batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._opt_params]
        for p in self._opt_params:
            p.grad = None  # the gradients' memory is free between steps
        opt._functional_step(self._opt_params, grads, lr)
        return loss.detach()

    def _run(self, lr, *batch):
        return self._one_step(batch, lr)

    def _inputs(self, batch):
        """The batch on the model's device; when steps are captured, copied
        into the key's held tensors (made at the key's first call), which
        the graph reads by address."""
        batch = [torch.from_numpy(b) if isinstance(b, np.ndarray) else b
                 for b in batch]
        if not (self._fn._capture and self._device.type == "cuda"):
            return [b.to(self._device) if torch.is_tensor(b) else b
                    for b in batch]
        key = _batch_key(batch)
        held = self._held.get(key)
        if held is None:
            held = self._held[key] = [
                torch.empty_like(b, device=self._device)
                if torch.is_tensor(b) else b for b in batch]
        for h, b in zip(held, batch):
            if torch.is_tensor(h):
                h.copy_(b)
        return held

    def __call__(self, *batch):
        batch = self._inputs(batch)
        self._lr.fill_(self._optimizer.get_lr())
        self._fn.drop_moved(allow_retype=True)
        try:
            loss = self._fn(self._lr, *batch)
        except CaptureError as e:
            raise CaptureError(
                "%s; build the step with capture=False to run it eagerly"
                % e) from e
        return loss.clone()

    def compile_counts(self) -> dict:
        """``{"train_step": n}``: the batch shape keys met (one captured
        graph each on the card)."""
        return {"train_step": self._fn._cache_size()}


class MultiStepTrainStep(TrainStep):
    """K optimizer steps per call: every batch input is K per-step batches
    stacked on a new leading axis ``[K, ...]``; the steps run in order and
    the ``[K]`` per-step losses are returned.  On the card the K steps are
    one captured graph, one replay a call.  The learning rate is read once
    per call, as the reference reads it once per dispatch (a scheduler
    advances per K steps)."""

    def __init__(self, model: nn.Module, loss_fn: Callable, optimizer,
                 steps_per_call: int, donate: Optional[bool] = None,
                 capture: bool = True):
        if steps_per_call < 1:
            raise InvalidArgumentError(
                "MultiStepTrainStep: steps_per_call must be >= 1, got %r"
                % (steps_per_call,))
        super().__init__(model, loss_fn, optimizer, donate=donate,
                         capture=capture)
        self.steps_per_call = steps_per_call

    # the K-stacking contract, spelled out in every shape error so the
    # batch==K aliasing case is diagnosable from the message alone
    _STACK_CONTRACT = (
        "each batch input must be K per-STEP batches stacked along a NEW "
        "leading axis (np.stack -> [K, batch, ...]); a plain [batch, ...] "
        "input is never valid here — if your per-step batch size equals "
        "K, the leading dim would alias the batch axis and the scan "
        "would train on single examples")

    def _run(self, lr, *batch):
        return torch.stack([self._one_step([b[s] for b in batch], lr)
                            for s in range(self.steps_per_call)])

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
        return super().__call__(*batch)

"""``Model``: prepare, fit, evaluate, predict, save and load around a
network (counterpart of the reference's ``hapi/model.py``).

``Model(network, inputs=None, labels=None, device=None)`` puts the
network on ``device`` (None: the card, which raises without one; the
tests pass ``"cpu"``).  Data comes as a ``DataLoader``, a ``Dataset`` or
a tuple of arrays; a loader is built on the model's device.

``train_batch`` runs the port's ``TrainStep`` over the network and the
loss (captured into a CUDA graph on the card) and returns
``[float(loss)]``: one read-back a step, as the reference.  Gradient
accumulation (``update=False``, ``fit(accumulate_grad_batches=)``) runs
eagerly: backward on each batch, the optimizer's ``step()`` on the one
that closes the cycle.  ``eval_batch``/``predict_batch`` run the network
in eval mode under ``no_grad`` and restore each sublayer's mode after.

``save(path)`` writes ``path.pdparams`` (the network's ``state_dict``)
and ``path.pdopt`` (the optimizer's) in ``paddle.save``'s format, which
the reference's ``load`` reads and whose files the port's ``load``
reads.  ``save(training=False)`` writes the network by ``jit.save`` over
``Model(inputs=)``'s ``InputSpec``s.  ``prepare(amp_configs=)`` is kept
and unused,
as in the reference.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader, Dataset, TensorDataset
from ..io.dataloader import _resolve_place
from ..jit import InputSpec
from ..metric import Metric
from ..nn.layer.layers import Layer
from .callbacks import Callback, CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["Model", "InputSpec"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    """The reference's ``Model`` over a port ``Layer``."""

    def __init__(self, network: Layer, inputs=None, labels=None,
                 device=None):
        if not isinstance(network, Layer):
            raise InvalidArgumentError(
                "Model wraps a paddle_tpu_torch.nn.Layer, got %r"
                % type(network))
        self.device = _resolve_place(None, device)
        self.network = network.to(self.device)
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self._accum_pending = False
        self.stop_training = False

    # -- setup ------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise InvalidArgumentError("loss must be a Layer or callable")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise InvalidArgumentError(
                    "metrics must be paddle_tpu_torch.metric.Metric, got %r"
                    % type(m))
        self._amp_configs = amp_configs  # kept, unused (as the reference)
        self._train_step = None  # rebuilt against this optimizer

    def _to_batches(self, data, batch_size: int, shuffle: bool,
                    drop_last: bool = False, num_workers: int = 0):
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, (tuple, list)):
            data = TensorDataset(list(data))
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers,
                              device=self.device)
        raise InvalidArgumentError(
            "unsupported data of type %r; pass a DataLoader, Dataset or "
            "tuple of arrays" % type(data))

    def _tensor(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device) if torch.is_tensor(x) else x

    # -- one batch ----------------------------------------------------------
    def _ensure_train_step(self):
        if self._train_step is None:
            self._check_prepared()
            from ..jit.train_step import TrainStep

            loss_fn = self._loss

            def wrapped_loss(net, *batch):
                *xs, y = batch
                return loss_fn(net(*xs), y)

            self._train_step = TrainStep(self.network, wrapped_loss,
                                         self._optimizer)
        return self._train_step

    def _check_prepared(self):
        if self._optimizer is None or self._loss is None:
            raise InvalidArgumentError(
                "call prepare(optimizer=..., loss=...) before training")

    def train_batch(self, inputs, labels=None, update: bool = True):
        """One training step on a batch; returns ``[loss]``."""
        inputs = _to_list(inputs)
        labels = _to_list(labels)
        if not labels:
            *inputs, last = inputs
            labels = [last]
        if not update or self._accum_pending:
            self._check_prepared()
            out = self.network(*[self._tensor(x) for x in inputs])
            loss = self._loss(out, self._tensor(labels[0]))
            loss.backward()
            if update:
                self._optimizer.step()
                self._optimizer.clear_grad()
            self._accum_pending = not update
            return [float(loss.detach())]
        loss = self._ensure_train_step()(*inputs, *labels)
        return [float(loss)]

    @contextlib.contextmanager
    def _mode_guard(self):
        """Eval mode and no gradient; every sublayer's mode restored."""
        layers = list(self.network.modules())
        was = [m.training for m in layers]
        self.network.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            for m, t in zip(layers, was):
                m.training = t

    def eval_batch(self, inputs, labels=None):
        """The batch's loss (a list, empty without a loss or labels) and
        the metrics updated; returns ``(loss, [])``."""
        inputs = [self._tensor(x) for x in _to_list(inputs)]
        labels = [self._tensor(y) for y in _to_list(labels)]
        with self._mode_guard():
            out = self.network(*inputs)
            loss_val = None
            if self._loss is not None and labels:
                loss_val = float(self._loss(out, labels[0]))
            for m in self._metrics:
                r = m.compute(out, labels[0] if labels else None)
                if isinstance(r, tuple):
                    m.update(*r)
                else:
                    m.update(r)
        return ([loss_val] if loss_val is not None else []), []

    def predict_batch(self, inputs):
        inputs = [self._tensor(x) for x in _to_list(inputs)]
        with self._mode_guard():
            return self.network(*inputs)

    # -- loops --------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 2, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0,
            callbacks: Optional[List[Callback]] = None,
            accumulate_grad_batches: int = 1,
            num_iters: Optional[int] = None):
        loader = self._to_batches(train_data, batch_size, shuffle,
                                  drop_last=drop_last,
                                  num_workers=num_workers)
        cbs = CallbackList(callbacks)
        if not any(isinstance(c, ProgBarLogger) for c in cbs.callbacks):
            cbs.append(ProgBarLogger(log_freq, verbose))
        if save_dir and not any(isinstance(c, ModelCheckpoint)
                                for c in cbs.callbacks):
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        try:
            steps = len(loader)
        except Exception:
            steps = None
        cbs.set_model(self)
        cbs.set_params({
            "epochs": epochs, "steps": steps, "verbose": verbose,
            "metrics": self._metric_names() + ["loss"],
            "save_dir": save_dir,
        })
        self.stop_training = False
        cbs.on_train_begin()
        it = 0
        logs = {}
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cbs.on_train_batch_begin(step)
                batch = _to_list(batch)
                update = (step + 1) % accumulate_grad_batches == 0
                loss = self.train_batch(batch[:-1], batch[-1], update=update)
                logs = {"loss": loss}
                cbs.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
            cbs.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                logs.update(self.evaluate(
                    eval_data, batch_size=batch_size, verbose=0,
                    num_workers=num_workers, _callbacks=cbs))
            if self.stop_training:
                break
        cbs.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 2, num_workers: int = 0, callbacks=None,
                 num_samples: Optional[int] = None, _callbacks=None):
        """``{"eval_loss": [mean], "eval_<metric>": value, ...}``."""
        loader = self._to_batches(eval_data, batch_size, shuffle=False,
                                  num_workers=num_workers)
        cbs = _callbacks or CallbackList(callbacks)
        if _callbacks is None:
            cbs.set_model(self)
            cbs.set_params({"verbose": verbose})
        for m in self._metrics:
            m.reset()
        cbs.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbs.on_eval_batch_begin(step)
            batch = _to_list(batch)
            loss, _ = self.eval_batch(batch[:-1], batch[-1])
            if loss:
                losses.append(loss[0])
            cbs.on_eval_batch_end(step)
        logs = {}
        if losses:
            logs["eval_loss"] = [float(np.mean(losses))]
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            for n, v in zip(names, vals):
                logs["eval_" + n] = v
        cbs.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0,
                stack_outputs: bool = False, verbose: int = 1,
                callbacks=None):
        """The network's outputs as numpy arrays: ``[[batch outputs]]``,
        or ``[stacked]``."""
        loader = self._to_batches(test_data, batch_size, shuffle=False,
                                  num_workers=num_workers)
        outputs = []
        for batch in loader:
            out = self.predict_batch(_to_list(batch))
            outputs.append(out.detach().cpu().numpy()
                           if torch.is_tensor(out) else np.asarray(out))
        if stack_outputs:
            return [np.concatenate(outputs, axis=0)]
        return [outputs]

    def _metric_names(self) -> List[str]:
        names: List[str] = []
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    # -- persistence --------------------------------------------------------
    def save(self, path: str, training: bool = True) -> None:
        """``training``: ``path.pdparams`` and ``path.pdopt``; otherwise
        the inference artifact by ``jit.save`` over ``Model(inputs=)``'s
        ``InputSpec``s."""
        if not training:
            from .. import jit

            if not self._inputs:
                raise InvalidArgumentError(
                    "save(training=False) needs Model(inputs=[InputSpec...])")
            jit.save(self.network, path, input_spec=self._inputs)
            return
        _save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        state = _load(path + ".pdparams")
        missing, unexpected = self.network.set_state_dict(state)
        if (missing or unexpected) and not skip_mismatch:
            raise InvalidArgumentError(
                "load mismatch: missing=%s unexpected=%s (skip_mismatch=True "
                "to ignore)" % (missing, unexpected))
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))
        return self

    def parameters(self, *a, **k):
        return self.network.parameters(*a, **k)

    def summary(self, input_size=None, dtype=None):
        if input_size is not None:
            from .summary import summary as _summary

            return _summary(self.network, input_size,
                            dtypes=[dtype] if dtype else None)
        params = self.network.parameters()
        total = sum(int(np.prod(p.shape)) for p in params)
        trainable = sum(int(np.prod(p.shape)) for p in params
                        if p.requires_grad)
        lines = ["-" * 60]
        for name, p in self.network.named_parameters():
            lines.append("%-40s %-15s" % (name, tuple(p.shape)))
        lines += ["-" * 60, "Total params: {:,}".format(total),
                  "Trainable params: {:,}".format(trainable)]
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}

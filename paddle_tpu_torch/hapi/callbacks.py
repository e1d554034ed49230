"""Callbacks of ``Model.fit``/``evaluate`` (counterpart of the
reference's ``hapi/callbacks.py``): ``Callback``, ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping``, ``ReduceLROnPlateau`` and ``VisualDL`` (scalars
through ``profiler.LogWriter``).  The decisions are the reference's: the
same monitored sequence stops, saves and cuts the learning rate at the
same points."""
from __future__ import annotations

import os
import time
import warnings
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau", "VisualDL", "CallbackList"]


class Callback:
    """The hooks the trainer fires; each does nothing by default."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb: Callback):
        self.callbacks.append(cb)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def fire(*args, **kwargs):
            for cb in self.callbacks:
                getattr(cb, name)(*args, **kwargs)

        return fire


def _resolve_mode(monitor: str, mode: str, warn_unknown: bool = False) -> str:
    """'auto' is 'max' for an accuracy-like monitor, else 'min'."""
    if mode not in ("auto", "min", "max"):
        if warn_unknown:
            warnings.warn("Learning rate reduction mode %s is unknown, "
                          "fallback to auto mode." % mode)
        mode = "auto"
    if mode == "auto":
        mode = "max" if "acc" in monitor else "min"
    return mode


def _is_better(cur: float, best: float, mode: str, min_delta: float) -> bool:
    if mode == "min":
        return cur < best - min_delta
    return cur > best + min_delta


class ProgBarLogger(Callback):
    """Logs to stdout: each epoch (``verbose`` 1) and every ``log_freq``
    steps (``verbose`` 2)."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()
        if self.verbose and self.params.get("epochs"):
            print("Epoch %d/%d" % (epoch + 1, self.params["epochs"]))

    def _fmt(self, logs):
        out = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                v = v[0] if len(v) == 1 else list(np.round(v, 4))
            if isinstance(v, float):
                out.append("%s: %.4f" % (k, v))
            else:
                out.append("%s: %s" % (k, v))
        return " - ".join(out)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and self.log_freq \
                and (step + 1) % self.log_freq == 0:
            total = "/%s" % self.steps if self.steps else ""
            print("step %d%s - %s" % (step + 1, total, self._fmt(logs)))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            print("epoch %d done (%.1fs) - %s"
                  % (epoch + 1, dt, self._fmt(logs)))

    def on_eval_end(self, logs=None):
        if self.verbose:
            print("eval - %s" % self._fmt(logs))


class ModelCheckpoint(Callback):
    """``model.save(<save_dir>/<epoch>)`` every ``save_freq`` epochs and
    ``<save_dir>/final`` at the end."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None \
                and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's ``LRScheduler`` each batch (``by_step``)
    and/or each epoch (``by_epoch``)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stops training when ``monitor`` (an eval log) has not improved by
    ``min_delta`` for more than ``patience`` evaluations; saves
    ``best_model`` under ``save_dir`` at each improvement."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1, min_delta: float = 0.0,
                 baseline: Optional[float] = None,
                 save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.mode = _resolve_mode(monitor, mode)
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = (self.baseline if self.baseline is not None
                     else (np.inf if self.mode == "min" else -np.inf))
        self.model.stop_training = False

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(cur)
        if _is_better(cur, self.best, self.mode, self.min_delta):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(os.path.join(self.params["save_dir"],
                                             "best_model"))
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print("Early stopping: %s did not improve beyond %.5f"
                          % (self.monitor, self.best))


class ReduceLROnPlateau(Callback):
    """Multiplies a float learning rate by ``factor`` after ``patience``
    evaluations without ``min_delta`` improvement on ``monitor``, then
    waits ``cooldown`` evaluations; never below ``min_lr``.  An
    optimizer driven by an ``LRScheduler`` is left alone, with a
    warning (use ``optimizer.lr.ReduceOnPlateau``)."""

    def __init__(self, monitor: str = "loss", factor: float = 0.1,
                 patience: int = 10, verbose: int = 1, mode: str = "auto",
                 min_delta: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0):
        super().__init__()
        if factor >= 1.0:
            raise ValueError(
                "ReduceLROnPlateau does not support a factor >= 1.0.")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = _resolve_mode(monitor, mode, warn_unknown=True)
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._reset()

    def _reset(self):
        self.best = np.inf if self.mode == "min" else -np.inf
        self.wait = 0
        self.cooldown_counter = 0
        self.epoch = 0

    def on_train_begin(self, logs=None):
        self._reset()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            warnings.warn(
                "Monitor of ReduceLROnPlateau should be loss or metric "
                "name.")
            return
        opt = getattr(self.model, "_optimizer", None)
        if opt is None:
            return
        from ..optimizer.lr import LRScheduler as Sched

        if isinstance(getattr(opt, "_learning_rate", None), Sched):
            warnings.warn("ReduceLROnPlateau expects a float learning "
                          "rate; the optimizer uses an LRScheduler — use "
                          "optimizer.lr.ReduceOnPlateau instead.")
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        cur = float(cur)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if _is_better(cur, self.best, self.mode, self.min_delta):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                old_lr = opt.get_lr()
                if old_lr > self.min_lr:
                    new_lr = max(old_lr * self.factor, self.min_lr)
                    opt.set_lr(new_lr)
                    if self.verbose:
                        print("Epoch %d: ReduceLROnPlateau reducing "
                              "learning rate to %s." % (self.epoch, new_lr))
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Train and eval logs as scalars in ``log_dir`` (``LogWriter``'s
    JSONL; ``LogWriter.read`` reads them back)."""

    def __init__(self, log_dir: str):
        super().__init__()
        self.log_dir = log_dir
        self._writer = None
        self._step = 0

    def _w(self):
        if self._writer is None:
            from ..profiler import LogWriter

            self._writer = LogWriter(self.log_dir)
        return self._writer

    def _emit(self, prefix, logs):
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):  # hapi's loss is a list
                v = v[0] if len(v) == 1 else None
            try:
                self._w().add_scalar("%s/%s" % (prefix, k), float(v),
                                     self._step)
            except (TypeError, ValueError):
                continue  # not a scalar

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._emit("train", logs)

    def on_epoch_end(self, epoch, logs=None):
        self._emit("train_epoch", logs)

    def on_eval_end(self, logs=None):
        self._emit("eval", logs)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()

"""``paddle_tpu_torch.amp``: automatic mixed precision (counterpart of the
reference's ``amp/__init__.py``).

- ``auto_cast`` (``amp_guard``) turns on the autocast shim of
  ``framework.dispatch`` for a region: the ops installed under a name in
  the white list run in the amp dtype, those in the black list in
  float32.  The lists are the reference's, name for name.
- ``decorate(level="O2")`` casts every floating parameter and buffer of
  a model to the amp dtype in place, except in normalization layers
  (class names containing ``"Norm"``), which stay float32; the optimizers
  then keep float32 master weights (``multi_precision``).
- ``GradScaler`` (``AmpScaler``) is dynamic loss scaling for float16; a
  bf16 run needs none.

The port has no Tensor facade: Python operators on ``torch.Tensor``
(``a * b``) are torch's and are not cast, also under O2, where the
reference casts ``add``/``subtract``/``multiply``/``divide`` of its
Tensors.  Only the installed ops are cast.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional, Sequence

import torch

from ..core import amp_state
from ..core import flags as _flags
from ..core.dtype import convert_dtype
from ..core.errors import InvalidArgumentError

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "WHITE_LIST", "BLACK_LIST"]

# ops that run in the amp dtype (the reference's names)
WHITE_LIST = frozenset({
    "matmul", "bmm", "mm", "mv", "addmm", "linear", "einsum",
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "s2d_stem",
})

# numerically sensitive ops, forced to float32 (the reference's names)
BLACK_LIST = frozenset({
    "exp", "square", "log", "log2", "log10", "log1p", "logsumexp",
    "mean", "sum", "prod", "cumsum", "softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "sigmoid_cross_entropy_with_logits", "mse_loss", "l1_loss",
    "smooth_l1_loss", "kl_div", "cosine_similarity", "pow", "rsqrt",
    "norm", "p_norm", "var", "std",
})


def _default_dtype() -> str:
    return _flags.get_flags(["FLAGS_amp_dtype"])["FLAGS_amp_dtype"]


@contextlib.contextmanager
def auto_cast(enable: bool = True,
              custom_white_list: Optional[Sequence[str]] = None,
              custom_black_list: Optional[Sequence[str]] = None,
              level: str = "O1", dtype: Optional[str] = None):
    """paddle.amp.auto_cast: autocast the installed ops inside the region.
    ``dtype`` defaults to ``FLAGS_amp_dtype``; O0 disables; O2 adds the
    elementwise ``add``/``subtract``/``multiply``/``divide`` to the white
    set.  A custom black entry wins over a white one, and a custom white
    entry takes an op off the black list."""
    if level not in ("O0", "O1", "O2"):
        raise InvalidArgumentError(
            "auto_cast level must be O0/O1/O2, got %r" % level)
    if dtype is None:
        dtype = _default_dtype()
    if dtype not in ("bfloat16", "float16"):
        raise InvalidArgumentError(
            "auto_cast dtype must be bfloat16/float16, got %r" % dtype)
    white = set(WHITE_LIST) | set(custom_white_list or ())
    if level == "O2":
        white |= {"add", "subtract", "multiply", "divide"}
    black = (set(BLACK_LIST) | set(custom_black_list or ())) - set(
        custom_white_list or ())
    white -= set(custom_black_list or ())
    prev = amp_state.push(amp_state.AmpAttrs(
        enabled=enable and level != "O0", dtype=dtype, white=white,
        black=black, level=level))
    try:
        yield
    finally:
        amp_state.pop(prev)


amp_guard = auto_cast


def _cast_model_keep_norms(model: torch.nn.Module, dtype: torch.dtype):
    """O2's cast: every floating parameter and buffer of every module
    whose class name lacks ``"Norm"``, in place.  A parameter keeps its
    identity (``p.data`` is replaced), so an optimizer's list, its state
    names and a later ``TrainStep`` stay valid."""
    for layer in model.modules():
        if "Norm" in type(layer).__name__:
            continue
        for p in layer._parameters.values():
            if p is not None and p.is_floating_point():
                p.data = p.data.to(dtype)
        for name, b in layer._buffers.items():
            if b is not None and b.is_floating_point():
                layer._buffers[name] = b.to(dtype)


def _install_save_dtype(model: torch.nn.Module, save_dtype) -> None:
    """decorate(save_dtype=...): the instance's ``state_dict`` is shadowed
    by a copy that casts floating entries to ``save_dtype``; loading
    copies into the live parameters, whose dtype stays."""
    sd_dtype = convert_dtype(save_dtype)
    orig = model.state_dict

    def casted_state_dict(*args, **kwargs):
        d = orig(*args, **kwargs)
        out = collections.OrderedDict(
            (k, v.to(sd_dtype) if v.is_floating_point()
             and v.dtype != sd_dtype else v) for k, v in d.items())
        if hasattr(d, "_metadata"):
            out._metadata = d._metadata
        return out

    model.state_dict = casted_state_dict


def decorate(models, optimizers=None, level: str = "O2",
             dtype: Optional[str] = None,
             master_weight: Optional[bool] = None,
             save_dtype: Optional[str] = None):
    """paddle.amp.decorate.  O2 casts the models' parameters to ``dtype``
    (``FLAGS_amp_dtype`` by default) keeping normalization layers float32,
    and sets the optimizers' ``_multi_precision`` (float32 master weights)
    unless ``master_weight=False``; O1 returns its inputs unchanged.
    Returns ``models``, or ``(models, optimizers)`` when optimizers are
    given."""
    if dtype is None:
        dtype = _default_dtype()
    if level == "O1":
        return (models, optimizers) if optimizers is not None else models
    if level != "O2":
        raise InvalidArgumentError(
            "decorate level must be O1/O2, got %r" % level)
    tdt = convert_dtype(dtype)
    for m in models if isinstance(models, (list, tuple)) else [models]:
        _cast_model_keep_norms(m, tdt)
        if save_dtype is not None:
            _install_save_dtype(m, save_dtype)
    if optimizers is None:
        return models
    for o in (optimizers if isinstance(optimizers, (list, tuple))
              else [optimizers]):
        if master_weight is not False:
            o._multi_precision = True
    return models, optimizers


class GradScaler:
    """paddle.amp.GradScaler: dynamic loss scaling.

    ``scale(loss)`` multiplies the loss by the live scale; after its
    backward, ``step(opt)`` unscales every gradient of the optimizer's
    parameters (``unscale_``, one host readback for all of them) and skips
    the update when any is inf or NaN; ``update()`` halves the scale after
    ``decr_every_n_nan_or_inf`` bad steps and doubles it after
    ``incr_every_n_steps`` good ones (by ``decr_ratio``/``incr_ratio``)."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 1,
                 use_dynamic_loss_scaling: bool = True):
        if incr_ratio <= 1.0:
            raise InvalidArgumentError("incr_ratio must be > 1")
        if not 0.0 < decr_ratio < 1.0:
            raise InvalidArgumentError("decr_ratio must be in (0, 1)")
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_count = 0
        self._decr_count = 0
        self._found_inf = False
        self._unscaled = False
        self._stepped = False

    def is_enable(self) -> bool:
        return self._enable

    is_enabled = is_enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v: float) -> None:
        self._scale = float(v)

    def scale(self, var):
        """The loss times the live scale (recorded, so backward scales)."""
        if not self._enable:
            return var
        return var * self._scale

    @staticmethod
    def _grads(optimizer):
        return [p.grad for p in optimizer._parameter_list or []
                if p.requires_grad and p.grad is not None]

    def unscale_(self, optimizer) -> None:
        """Divide every gradient by the scale in place and note whether
        any is non-finite; the per-gradient checks stay on the device and
        combine before one readback."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        flags = []
        for g in self._grads(optimizer):
            g.mul_(inv)
            flags.append(torch.isfinite(g).all())
        self._found_inf = bool(flags) and not bool(torch.stack(flags).all())
        self._unscaled = True

    def step(self, optimizer) -> None:
        """Unscale, then update unless a gradient was inf or NaN.  A
        second ``step`` before ``update`` raises."""
        if not self._enable:
            optimizer.step()
            return
        if self._stepped:
            raise RuntimeError(
                "GradScaler.step() has already been called since the last "
                "update(); call scaler.update() after each step")
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._stepped = True

    def update(self) -> None:
        """The dynamic scale's adjustment after a step."""
        self._stepped = False
        if not (self._enable and self._use_dynamic):
            self._unscaled = False
            return
        if self._found_inf:
            self._decr_count += 1
            self._incr_count = 0
            if self._decr_count >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._decr_count = 0
        else:
            self._incr_count += 1
            self._decr_count = 0
            if self._incr_count >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._incr_count = 0
        self._found_inf = False
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss) -> None:
        """AmpScaler.minimize: the caller has run backward on the scaled
        loss; unscale, step unless non-finite, update."""
        self.step(optimizer)
        self.update()

    def state_dict(self) -> dict:
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": self._incr_count,
            "decr_count": self._decr_count,
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    def load_state_dict(self, sd: dict) -> None:
        self._scale = float(sd.get("scale", self._scale))
        self._incr_ratio = float(sd.get("incr_ratio", self._incr_ratio))
        self._decr_ratio = float(sd.get("decr_ratio", self._decr_ratio))
        self._incr_every_n_steps = int(sd.get(
            "incr_every_n_steps", self._incr_every_n_steps))
        self._decr_every_n_nan_or_inf = int(sd.get(
            "decr_every_n_nan_or_inf", self._decr_every_n_nan_or_inf))
        self._incr_count = int(sd.get("incr_count", 0))
        self._decr_count = int(sd.get("decr_count", 0))
        self._use_dynamic = bool(sd.get(
            "use_dynamic_loss_scaling", self._use_dynamic))


AmpScaler = GradScaler

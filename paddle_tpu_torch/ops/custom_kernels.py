"""K4, the custom-op door's user kernel: ``scale_mul`` (``out = x * y * 2``),
its plain twin and its launch counter.

Counterpart of the Pallas kernel ``_pallas_scale_mul`` that the
reference's tests register through ``incubate.register_custom_op``.  The
kernel is hand-written CUDA for Hopper (``csrc/scale_mul.cu``), built by
``ops/_build.py`` at first launch and bound through a plain C interface.
Like the reference's, it has no backward kernel: a caller registers it
with a backward written in torch ops (``2 * cot * y, 2 * cot * x``).

Dispatch is by the device of the tensors alone, as in ``decode_kernels``:
a CUDA tensor launches the kernel, or raises when the kernel cannot take
the inputs -- there is no fallback; a CPU tensor runs the plain twin.
``scale_mul.launches`` counts the launches on the card and nothing else.
"""
from __future__ import annotations

import torch

from ..core.errors import ExternalError, InvalidArgumentError
from . import kernel_cost

__all__ = ["scale_mul", "scale_mul_plain", "reset_launch_counts",
           "launch_counts"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def scale_mul_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of K4: ``(x * y) * 2`` in fp32, rounded once to
    x's dtype (the kernel's arithmetic)."""
    return ((x.float() * y.float()) * 2.0).to(x.dtype)


def scale_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K4: ``out = x * y * 2`` elementwise; the output has x's shape and
    dtype (f32, bf16 or f16).  x and y must agree in shape, dtype and
    device.  CPU tensors run :func:`scale_mul_plain`."""
    if not (torch.is_tensor(x) and torch.is_tensor(y)):
        raise InvalidArgumentError(
            "scale_mul takes two tensors, got %s and %s"
            % (type(x).__name__, type(y).__name__))
    if x.shape != y.shape or x.dtype != y.dtype or x.device != y.device:
        raise InvalidArgumentError(
            "scale_mul needs x and y of one shape, dtype and device, got "
            "%s %s on %s and %s %s on %s"
            % (tuple(x.shape), x.dtype, x.device, tuple(y.shape), y.dtype,
               y.device))
    if x.device.type == "cpu":
        return scale_mul_plain(x, y)
    if x.device.type != "cuda":
        raise InvalidArgumentError(
            "scale_mul runs on cuda (or its plain twin on cpu), got %s"
            % (x.device,))
    if x.dtype not in _DTYPE_CODES:
        raise InvalidArgumentError(
            "scale_mul kernel takes float32, bfloat16 or float16, got %s"
            % (x.dtype,))
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    from ._build import load

    rc = load("scale_mul").ptt_scale_mul(
        _DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), out.data_ptr(),
        out.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise ExternalError("scale_mul launch failed: cudaError_t %d" % rc)
    scale_mul.launches += 1
    kernel_cost.report(2.0 * out.numel(), kernel_cost.nbytes(x, y, out))
    return out


scale_mul.launches = 0


def reset_launch_counts() -> None:
    """Set the kernel's launch count to 0."""
    scale_mul.launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches since the last reset}."""
    return {"scale_mul": scale_mul.launches}

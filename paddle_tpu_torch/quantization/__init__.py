"""Quantization (counterpart of the reference's ``quantization``):
quantization-aware training (fake quantization with a straight-through
gradient) and post-training quantization to int8 layers.

- ``fake_quant_dequant_abs_max(x, bits)``: ``x`` rounded to ``bits``
  levels of its own abs-max; ``fake_quant_dequant_moving_scale(x, scale,
  bits)``: the same at a given scale, clipped.  Each is a
  ``torch.autograd.Function`` whose backward passes the gradient where
  ``|x| <= scale`` and zero elsewhere (the reference's clipped
  straight-through estimator; no gradient to the scale).
- ``ImperativeQuantAware.quantize(model)`` swaps every ``Linear`` and
  ``Conv2D`` for ``QuantedLinear``/``QuantedConv2D``: weights
  fake-quantized by their abs-max each call, inputs at a moving abs-max
  held in the ``_act_scale`` buffer (-1 until the first batch, moving
  rate 0.9), updated in place in training mode, so a captured
  ``TrainStep`` advances it on every replay as it does BatchNorm's
  statistics.
- ``ImperativePTQ``: ``quantize(model)`` arms forward pre-hooks that
  track each ``Linear``'s input abs-max (one read-back a call: it is a
  calibration pass); ``convert(model)`` swaps each for an
  ``Int8Linear``.
- ``Int8Linear``: int8 weights and inputs, an int8 x int8 -> int32
  product, one rescale.  On the card the product is ``torch._int_mm``
  where its shapes allow (more than 16 rows, K and N multiples of 8);
  any other shape, and the CPU, take the exact route: K in chunks of at
  most 1024, each an fp32 product (an int8 product is at most 2^14, so
  a chunk's sum is an integer below 2^24, exact in fp32, and in TF32
  too, whose 10-bit mantissa holds every int8), summed in int32.
  ``Int8Linear.routes`` counts which route ran.

The swap walks ``_modules``, where the reference walks ``_sub_layers``.
``save_quantized_model`` writes the model by ``jit.save``; on the card an
``Int8Linear``'s product stays ``torch._int_mm`` in the program whatever
the batch (where the traced rows are not known above 16 from the
program's shapes, the product pads 16 zero rows).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import InvalidArgumentError
from ..nn import functional as F
from ..nn.layer.common import Linear
from ..nn.layer.conv import Conv2D
from ..nn.layer.layers import Layer

__all__ = [
    "fake_quant_dequant_abs_max", "fake_quant_dequant_moving_scale",
    "quant_abs_max", "dequant", "QuantedLinear", "QuantedConv2D",
    "ImperativeQuantAware", "ImperativePTQ", "Int8Linear",
]

_CHUNK_K = 1024  # an fp32 sum of 1024 int8 products stays exact


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


class _FakeQDQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        qm = _qmax(bits)
        scale = x.detach().abs().max().clamp_min(1e-8)
        ctx.save_for_backward(x, scale)
        return torch.round(x / scale * qm) / qm * scale

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return torch.where(x.abs() <= scale, g, torch.zeros_like(g)), None


class _FakeQDQScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bits):
        qm = _qmax(bits)
        s = scale.clamp_min(1e-8)
        ctx.save_for_backward(x, scale)
        return torch.clamp(torch.round(x / s * qm), -qm, qm) / qm * s

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return (torch.where(x.abs() <= scale, g, torch.zeros_like(g)),
                torch.zeros_like(scale), None)


def fake_quant_dequant_abs_max(x, bits: int = 8):
    return _FakeQDQ.apply(x, bits)


def fake_quant_dequant_moving_scale(x, scale, bits: int = 8):
    return _FakeQDQScaled.apply(x, scale, bits)


def quant_abs_max(x, bits: int = 8, scale: Optional[float] = None):
    """``x`` as (int8 values, scale): per-tensor abs-max, symmetric."""
    x = torch.as_tensor(x).detach()
    qm = _qmax(bits)
    s = float(x.abs().max().clamp_min(1e-8)) if scale is None else scale
    q = torch.clamp(torch.round(x / s * qm), -qm - 1, qm).to(torch.int8)
    return q, s


def dequant(q, scale: float, bits: int = 8, dtype=torch.float32):
    return torch.as_tensor(q).to(dtype) * (scale / _qmax(bits))


class _MovingAbsMax:
    """An activation range (moving abs-max, rate 0.9) read on the host."""

    def __init__(self, rate: float = 0.9):
        self.rate = rate
        self.value: Optional[float] = None

    def update(self, x) -> float:
        cur = float(x.detach().abs().max())
        self.value = cur if self.value is None else \
            self.rate * self.value + (1 - self.rate) * cur
        return self.value


class _QuantedBase(Layer):
    """The wrapped layer with fake-quantized weights and inputs; the
    input scale is the ``_act_scale`` buffer (see the module's text)."""

    def __init__(self, inner, weight_bits: int = 8,
                 activation_bits: int = 8, moving_rate: float = 0.9):
        super().__init__()
        self.inner = inner
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.register_buffer("_act_scale", torch.full(
            (), -1.0, dtype=torch.float32, device=inner.weight.device))

    @property
    def weight(self):
        return self.inner.weight

    @property
    def bias(self):
        return getattr(self.inner, "bias", None)

    def _quant_input(self, x):
        cur = x.detach().abs().max().to(torch.float32)
        old = self._act_scale.detach()
        r = self.moving_rate
        if self.training:
            scale = torch.where(old > 0, r * old + (1 - r) * cur, cur)
            with torch.no_grad():
                self._act_scale.copy_(scale)
        else:
            scale = torch.where(old > 0, old, cur)
        return fake_quant_dequant_moving_scale(
            x, scale.detach().to(x.dtype), self.activation_bits)


class QuantedLinear(_QuantedBase):
    def forward(self, x):
        xq = self._quant_input(x)
        wq = fake_quant_dequant_abs_max(self.inner.weight, self.weight_bits)
        out = torch.matmul(xq, wq)
        if self.inner.bias is not None:
            out = out + self.inner.bias
        return out


class QuantedConv2D(_QuantedBase):
    def forward(self, x):
        inner = self.inner
        xq = self._quant_input(x)
        wq = fake_quant_dequant_abs_max(inner.weight, self.weight_bits)
        return F.conv2d(xq, wq, bias=inner.bias, stride=inner._stride,
                        padding=inner._padding, dilation=inner._dilation,
                        groups=inner._groups, data_format=inner._data_format)


_QUANT_MAP = {Linear: QuantedLinear, Conv2D: QuantedConv2D}


def _swap_sublayers(model, build):
    for name, sub in list(model._modules.items()):
        if sub is None:
            continue
        repl = build(sub)
        if repl is not None:
            model._modules[name] = repl
        else:
            _swap_sublayers(sub, build)


class ImperativeQuantAware:
    """Swaps the quantizable layers of a model in place (``quantize``)."""

    def __init__(self, quantizable_layer_type=("Linear", "Conv2D"),
                 weight_bits: int = 8, activation_bits: int = 8,
                 weight_quantize_type: str = "abs_max",
                 activation_quantize_type: str = "moving_average_abs_max"):
        if weight_quantize_type != "abs_max":
            raise InvalidArgumentError(
                "weight_quantize_type %r unsupported (abs_max only)"
                % weight_quantize_type)
        self.types = set(quantizable_layer_type)
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    def quantize(self, model):
        def build(sub):
            for cls, qcls in _QUANT_MAP.items():
                if isinstance(sub, cls) and cls.__name__ in self.types:
                    return qcls(sub, self.weight_bits, self.activation_bits)
            return None

        _swap_sublayers(model, build)
        return model

    def save_quantized_model(self, model, path: str, input_spec=None):
        """The quantized model as a ``jit.save`` artifact."""
        from ..jit import save as jit_save

        jit_save(model, path, input_spec=input_spec)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``a`` [M, K] int8 @ ``b`` [K, N] int8 -> (int32 [M, N], route)."""
    m, k = a.shape
    n = b.shape[1]
    # M is tested only as far as it is known without a guard: in a traced
    # program M holds the open batch, and a guard on it would pin the
    # batch's range.  A program whose M is known above 16 from its shape
    # (ERNIE's batch x 384) runs the product as it is.
    if a.is_cuda and k % 8 == 0 and n % 8 == 0:
        # imported here: its module pulls in sympy, a second of every
        # process's import of the package
        from torch.fx.experimental.symbolic_shapes import \
            statically_known_true

        if statically_known_true(m > 16):
            return torch._int_mm(a, b), "int_mm"
        if torch.compiler.is_compiling():
            # some batch the program serves may give 16 rows or fewer: 16
            # zero rows keep M above _int_mm's 16 whatever the batch
            return torch._int_mm(torch.cat([a, a.new_zeros(16, k)]),
                                 b)[:m], "int_mm"
    out = torch.zeros(m, n, dtype=torch.int32, device=a.device)
    for k0 in range(0, k, _CHUNK_K):
        part = torch.matmul(a[:, k0:k0 + _CHUNK_K].to(torch.float32),
                            b[k0:k0 + _CHUNK_K].to(torch.float32))
        out += part.to(torch.int32)
    return out, "chunked"


class Int8Linear(Layer):
    """A converted Linear: int8 weights [in, out] (a buffer), inputs
    quantized at ``act_scale``, the integer product, one rescale."""

    routes = {"int_mm": 0, "chunked": 0}

    def __init__(self, w_int8, w_scale: float, bias, act_scale: float,
                 bits: int = 8):
        super().__init__()
        self.register_buffer("w_int8", torch.as_tensor(w_int8).to(
            torch.int8))
        self.w_scale = float(w_scale)
        self.act_scale = float(act_scale)
        self.bits = bits
        self.bias = bias

    def forward(self, x):
        qm = _qmax(self.bits)
        xq = torch.clamp(torch.round(x / self.act_scale * qm),
                         -qm - 1, qm).to(torch.int8)
        lead = xq.shape[:-1]
        acc, route = _int8_matmul(xq.reshape(-1, xq.shape[-1]), self.w_int8)
        Int8Linear.routes[route] += 1
        out = acc.reshape(*lead, -1).to(torch.float32) * (
            (self.act_scale / qm) * (self.w_scale / qm))
        if self.bias is not None:
            out = out + self.bias
        return out


class ImperativePTQ:
    """Calibrate each ``Linear``'s input range with forward pre-hooks
    (``quantize``), run calibration batches, then ``convert`` each
    calibrated layer into an :class:`Int8Linear`."""

    def __init__(self, activation_bits: int = 8, weight_bits: int = 8):
        self.activation_bits = activation_bits
        self.weight_bits = weight_bits
        self._ranges: dict = {}
        self._hooks: list = []

    def quantize(self, model):
        for _, sub in model.named_modules():
            if sub is not model and isinstance(sub, Linear):
                tracker = _MovingAbsMax()
                self._ranges[id(sub)] = tracker

                def hook(layer, inputs, _tracker=tracker):
                    x = inputs[0] if isinstance(inputs, tuple) else inputs
                    _tracker.update(x)

                self._hooks.append(sub.register_forward_pre_hook(hook))
        return model

    def convert(self, model):
        for h in self._hooks:
            h.remove()
        self._hooks = []

        def build(sub):
            tracker = self._ranges.get(id(sub))
            if tracker is None or tracker.value is None:
                return None
            q, s = quant_abs_max(sub.weight, self.weight_bits)
            return Int8Linear(q, s, sub.bias, tracker.value,
                              self.weight_bits)

        _swap_sublayers(model, build)
        return model

    save_quantized_model = ImperativeQuantAware.save_quantized_model

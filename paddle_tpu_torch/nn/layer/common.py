"""Common layers (counterpart of the reference's ``nn/layer/common.py``).

Parameter names and shapes are the reference's -- ``Linear.weight`` is
[in_features, out_features], Paddle's layout, not torch's [out, in] -- so
carrying weights across is a copy (``convert.load_reference_params``).
``weight_attr``/``bias_attr`` are the reference's (``layers.ParamAttr``,
an initializer, a name, or ``False`` for none); the default draws come
from ``generator`` on ``device``.  A Linear with an attached LoRA bank
(``nn.lora.attach_lora``) adds the per-row adapter delta while adapter
ids are ambient (``nn.lora``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from .. import lora as _lora
from ...tensor import flatten as _flatten
from ...tensor import norm as _norm
from .layers import Layer, create_parameter


class Linear(Layer):
    """paddle.nn.Linear: weight [in_features, out_features] (XavierNormal),
    bias zeros.  Marked tensor-parallel
    (``distributed.meta_parallel.shard_linear``) it runs each rank's
    columns or rows on views of its weight."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter([in_features, out_features],
                                       weight_attr,
                                       default_initializer=I.XavierNormal(),
                                       **kw)
        self.bias = create_parameter([out_features], bias_attr,
                                     is_bias=True, **kw)

    def forward(self, x):
        tp = self.__dict__.get("_tp")
        if tp is not None:  # distributed.meta_parallel.shard_linear
            from ...distributed.meta_parallel import mp_layers
            if tp[0] == "column":
                return mp_layers.column_linear(x, self.weight, self.bias,
                                               tp[1])
            return mp_layers.row_linear(x, self.weight, self.bias, tp[1])
        out = F.linear(x, self.weight, self.bias)
        lora_a = self._parameters.get("lora_a")
        if lora_a is not None:
            ids = _lora.current_adapter_ids()
            if ids is not None:
                out = _lora.apply_delta(out, x, lora_a, self.lora_b, ids)
        return out

    def extra_repr(self):
        return "in_features=%d, out_features=%d" % (self.in_features,
                                                    self.out_features)


class Embedding(Layer):
    """paddle.nn.Embedding: weight [num_embeddings, embedding_dim].

    ``padding_idx``: the output is zeros at that id whatever its row
    holds, and the row gets no gradient.  ``sparse``: the weight's
    gradient is row-sparse (``framework.sparse``), which the optimizers
    update row by row where they can; the forward is the same.  A
    regularizer given in ``weight_attr`` makes that update dense, as in
    the reference."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = bool(sparse)
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=I.XavierNormal(), device=device,
            generator=generator)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return "%d, %d" % (self._num_embeddings, self._embedding_dim)


class Dropout(Layer):
    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return "p=%s" % self.p


class Dropout2D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCHW",
                 name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCDHW",
                 name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p: float = 0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return _flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class _PadNd(Layer):
    _format = "NCHW"

    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format=None, name=None):
        super().__init__()
        self._padding = padding
        self._mode = mode
        self._value = value
        self._fmt = data_format or self._format

    def forward(self, x):
        return F.pad(x, self._padding, self._mode, self._value, self._fmt)


class Pad1D(_PadNd):
    _format = "NCL"


class Pad2D(_PadNd):
    _format = "NCHW"


class Pad3D(_PadNd):
    _format = "NCDHW"


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False, align_mode: int = 0,
                 data_format: str = "NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None,
                 data_format: str = "NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None,
                 data_format: str = "NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False,
                         data_format=data_format)


class Bilinear(Layer):
    """weight [out, in1, in2] (XavierNormal), bias [out] zeros."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, weight_attr=None, bias_attr=None,
                 name=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.weight = create_parameter(
            [out_features, in1_features, in2_features], weight_attr,
            default_initializer=I.XavierNormal(), **kw)
        self.bias = create_parameter([out_features], bias_attr,
                                     is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor: int, data_format: str = "NCHW",
                 name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """The ``p``-norm of ``x - y + epsilon`` along the last axis."""

    def __init__(self, p: float = 2.0, epsilon: float = 1e-6,
                 keepdim: bool = False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return _norm(x - y + self.epsilon, p=self.p, axis=-1,
                     keepdim=self.keepdim)

    def extra_repr(self):
        return "p=%s" % self.p


class Unfold(Layer):
    """im2col over ``F.unfold``."""

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)

    def extra_repr(self):
        return "kernel_sizes=%s, strides=%s" % (self.kernel_sizes,
                                                self.strides)

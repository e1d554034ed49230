"""Common functionals (counterpart of the reference's
``nn/functional/common.py``): the Paddle-layout linear, embedding (with
``padding_idx`` and row-sparse gradients), the dropouts (``dropout``
with ``axis``/``mode``, ``dropout2d``/``dropout3d``, ``alpha_dropout``),
``scaled_dot_product_attention`` with its routing between the flash
kernel K3 and the matmul-softmax-matmul composition, the sequence
functions (``one_hot``, ``label_smooth``, ``sequence_mask``,
``gather_tree``) and the vision functions: ``pad``, ``unfold``,
``interpolate``/``upsample`` in the six modes, ``pixel_shuffle``,
``bilinear``, ``temporal_shift`` and ``diag_embed``.

Resampling keeps the reference's rules, which are not torch's:

- ``scale_factor`` becomes a size first (``int(in * f)``), and every
  mode then samples at ``in / out``;
- nearest: ``floor(dst * in / out)``, or ``round(dst * (in - 1) /
  (out - 1))`` (half to even) with ``align_corners``;
- linear: half-pixel centres, ``dst * in / out`` with ``align_mode=1``,
  ``dst * (in - 1) / (out - 1)`` with ``align_corners``; one axis at a
  time;
- bicubic: ``jax.image.resize``'s ``"cubic"``, the Keys kernel with a =
  -0.5 at half-pixel centres that widens by ``in / out`` when it shrinks
  (antialiasing), each output's weights renormalized to sum 1 -- a
  weight matrix an axis, contracted on the device;
- area: the adaptive average pool.

No library attention is called here: the kernel route goes to the port's
own K3 (``ops.flash_attention``), the other route is the composition, op
for op the reference's fallback.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def linear(x, weight, bias=None):
    """Paddle weight layout [in_features, out_features]."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight, padding_idx: Optional[int] = None,
              sparse: bool = False):
    """Rows of ``weight`` at the ids ``x``; zeros where an id equals
    ``padding_idx`` (whatever that row holds), whose row then gets no
    gradient.  With ``sparse`` the weight's gradient is a sparse COO
    tensor of the rows met (``framework.sparse``), except inside
    ``framework.sparse.dense_gradients()`` (a train step), where it is
    dense.  The forward is the same gather either way."""
    from ...framework.sparse import sparse_gradients_enabled

    ids = x.long()
    if sparse and sparse_gradients_enabled():
        # torch reads a negative padding_idx from the end; the reference
        # compares the ids with it as given, which no id equals
        pad = padding_idx if padding_idx is not None and padding_idx >= 0 \
            else None
        out = torch.nn.functional.embedding(ids, weight, padding_idx=pad,
                                            sparse=True)
    else:
        out = weight[ids]
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train"):
    """Dropout: ``upscale_in_train`` (kept values divided by ``1 - p``)
    or ``downscale_in_infer`` (kept values as they are in training, all
    values times ``1 - p`` in inference).  ``axis`` draws one mask entry
    per index of those axes, broadcast over the others."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    if axis is None and mode == "upscale_in_train":
        return torch.nn.functional.dropout(x, p, training=True)
    if axis is None:
        shape = x.shape
    else:
        axes = {a % x.ndim for a in ((axis,) if isinstance(axis, int)
                                     else axis)}
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    keep = torch.empty(shape, device=x.device).bernoulli_(1.0 - p)
    if mode == "upscale_in_train":
        keep = keep / (1.0 - p)
    return (x * keep).to(x.dtype)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW"):
    """Whole channels dropped: one draw per (sample, channel)."""
    return dropout(x, p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW"):
    return dropout(x, p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def alpha_dropout(x, p: float = 0.5, training: bool = True):
    """SELU-preserving dropout: dropped values set to ``-alpha * scale``,
    then an affine map that keeps a unit normal's mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - p) > 0
    a = (1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2))) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Batched [B, H, L, D] attention.

    4-D attention without dropout and without a boolean mask goes to
    ``ops.flash_attention.flash_attention``, which alone decides between
    the flash kernel K3 and the composition by the kernel's limits.  On the
    way a materialized 2-D additive causal mask becomes ``causal=True`` and
    a [B, 1, 1, Lk] additive padding mask becomes ``key_padding_mask``, so
    the kernel never reads an [L, L] bias.  Dropout and boolean masks keep
    the composition here (scores / sqrt(D), masks, softmax, dropout, value
    product)."""
    from ...ops.flash_attention import (detect_causal_additive_mask,
                                        detect_padding_additive_mask,
                                        flash_attention)

    d = query.shape[-1]
    drop_p = dropout_p if training else 0.0
    if drop_p == 0.0 and query.ndim == 4 \
            and (attn_mask is None or attn_mask.dtype != torch.bool):
        mask = attn_mask
        causal = is_causal
        if not causal and detect_causal_additive_mask(mask, query.shape[-2]):
            causal, mask = True, None
        key_mask = None
        if mask is not None:
            pad_valid = detect_padding_additive_mask(mask)
            if pad_valid is not None \
                    and pad_valid.shape[-1] == key.shape[-2]:
                key_mask, mask = pad_valid, None
        return flash_attention(query, key, value, bias=mask, causal=causal,
                               key_padding_mask=key_mask)
    scores = torch.matmul(query, key.transpose(-1, -2)) / math.sqrt(d)
    if is_causal:
        q_len, k_len = scores.shape[-2], scores.shape[-1]
        allow = torch.ones(q_len, k_len, dtype=torch.bool,
                           device=scores.device).tril()
        scores = torch.where(allow, scores, torch.finfo(scores.dtype).min)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores,
                                 torch.finfo(scores.dtype).min)
        else:
            scores = scores + attn_mask
    weights = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and training:
        weights = dropout(weights, dropout_p, training=training)
    return torch.matmul(weights, value)


def one_hot(x, num_classes: int):
    """float32 one-hot rows of the ids ``x`` over ``num_classes``; an id
    outside [0, num_classes) gives a row of zeros, as the reference's."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon: float = 0.1):
    """``(1 - epsilon) label + epsilon prior`` over the last axis; the
    prior is uniform (``1 / n``) when ``prior_dist`` is None."""
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


def sequence_mask(lengths, maxlen: Optional[int] = None, dtype="int64"):
    """``tensor.segment.sequence_mask`` with this API's int64 default."""
    from ...tensor.segment import sequence_mask as _impl

    return _impl(lengths, maxlen=maxlen, dtype=dtype)


def gather_tree(ids, parents):
    """Back-trace beam-search parent pointers: ``ids``/``parents``
    [T, B, K] -> the [T, B, K] sequences that end in each final beam.  One
    reverse loop of T gathers on the device, no host read."""
    t_len, b, k = ids.shape
    ptr = torch.arange(k, device=ids.device).expand(b, k)
    parents = parents.long()
    out = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        out[t] = ids[t].gather(1, ptr)
        ptr = parents[t].gather(1, ptr)
    return torch.stack(out) if out else ids.clone()


# -- vision functions ---------------------------------------------------------

def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    """The source index of each of ``lo + n + hi`` padded positions along
    an axis of length ``n``: numpy's ``reflect`` (mirror without the
    edge), ``edge`` and ``wrap``, repeated as far as the pad reaches."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode: str = "constant", value: float = 0.0,
        data_format: str = "NCHW"):
    """paddle.nn.functional.pad.  ``pad`` of ``2 * x.ndim`` entries is
    ``(before, after)`` per axis from the *first* axis; a shorter list
    pads the spatial axes innermost (W) first, as torch orders it.
    ``mode``: ``constant`` (``value``), ``reflect``, ``replicate`` (the
    edge) or ``circular`` (wrap)."""
    if mode not in ("constant", "reflect", "replicate", "circular"):
        from ...core.errors import InvalidArgumentError

        raise InvalidArgumentError(
            "pad mode must be constant/reflect/replicate/circular, got %r"
            % (mode,))
    pad = [int(v) for v in pad]
    nd = x.ndim
    cfg = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_spatial = len(pad) // 2
        channel_last = data_format.endswith("C") and nd > 2
        spatial = (list(range(1, 1 + n_spatial)) if channel_last
                   else list(range(2, 2 + n_spatial)))
        for i, ax in enumerate(reversed(spatial)):
            cfg[ax] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [v for lo, hi in reversed(cfg) for v in (lo, hi)]
        return torch.nn.functional.pad(x, flat, value=value)
    for ax, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of an NCHW ``x``: [N, C * kh * kw, oh * ow], rows ordered
    (channel, kernel row, kernel column).  ``paddings``: one int, (h, w),
    or (top, left, bottom, right)."""
    from .conv import _normalize_tuple

    k = _normalize_tuple(kernel_sizes, 2, "kernel_sizes")
    s = _normalize_tuple(strides, 2, "strides")
    d = _normalize_tuple(dilations, 2, "dilations")
    if isinstance(paddings, int):
        p = [(paddings, paddings)] * 2
    elif len(paddings) == 2:
        p = [(paddings[0], paddings[0]), (paddings[1], paddings[1])]
    else:
        p = [(paddings[0], paddings[2]), (paddings[1], paddings[3])]
    n, c = x.shape[:2]
    xp = torch.nn.functional.pad(x, [p[1][0], p[1][1], p[0][0], p[0][1]])
    oh = (xp.shape[2] - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (xp.shape[3] - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    patches = [xp[:, :, i * d[0]:i * d[0] + oh * s[0]:s[0],
                  j * d[1]:j * d[1] + ow * s[1]:s[1]]
               for i in range(k[0]) for j in range(k[1])]
    return torch.stack(patches, dim=2).reshape(n, c * k[0] * k[1], oh * ow)


def _resize_nearest(x, axis, out_len, align_corners):
    in_len = x.shape[axis]
    pos = torch.arange(out_len, dtype=torch.float32, device=x.device)
    if align_corners and out_len > 1:
        idx = torch.round(pos * ((in_len - 1) / (out_len - 1)))
    else:
        idx = torch.floor(pos * (in_len / out_len))
    return x.index_select(axis, idx.long().clamp(0, in_len - 1))


def _resize_linear(x, axis, out_len, align_corners, align_mode):
    in_len = x.shape[axis]
    pos = torch.arange(out_len, dtype=torch.float32, device=x.device)
    if align_corners:
        src = pos * ((in_len - 1) / (out_len - 1) if out_len > 1 else 0.0)
    elif align_mode == 1:
        src = pos * (in_len / out_len)
    else:
        src = (pos + 0.5) * (in_len / out_len) - 0.5
    i0 = torch.floor(src).long().clamp(0, in_len - 1)
    i1 = (i0 + 1).clamp(0, in_len - 1)
    w = (src - i0).clamp(0.0, 1.0).to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = out_len
    w = w.reshape(shape)
    return x.index_select(axis, i0) * (1 - w) + x.index_select(axis, i1) * w


def _keys_cubic(t):
    """The Keys cubic kernel at a = -0.5 (``jax.image``'s)."""
    t = t.abs()
    near = ((1.5 * t - 2.5) * t) * t + 1.0
    far = ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0
    out = torch.where(t >= 1.0, far, near)
    return torch.where(t >= 2.0, torch.zeros_like(t), out)


def _cubic_weights(in_len: int, out_len: int, device):
    """[in, out] weights of ``jax.image.scale_and_translate``'s cubic
    resize at scale ``out / in``: the kernel widened by ``in / out`` when
    shrinking, each column renormalized, columns sampled outside the input
    zeroed."""
    inv = 1.0 / (out_len / in_len)
    kscale = max(inv, 1.0)
    sample = (torch.arange(out_len, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(in_len, dtype=torch.float32, device=device)
    w = _keys_cubic((sample[None, :] - src[:, None]).abs() / kscale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_cubic(x, axis, out_len):
    w = _cubic_weights(x.shape[axis], out_len, x.device).to(x.dtype)
    out = torch.tensordot(x.movedim(axis, -1), w, dims=1)
    return out.movedim(-1, axis)


_MODES = ("nearest", "linear", "bilinear", "trilinear", "area", "bicubic")


def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, align_mode: int = 0,
                data_format: str = "NCHW"):
    """Resize the spatial axes of ``x`` to ``size`` (or ``int(in *
    scale_factor)``) by ``mode``, by the reference's rules (module
    docstring)."""
    from ...core.errors import InvalidArgumentError

    if mode not in _MODES:
        raise InvalidArgumentError(
            "interpolate mode must be one of nearest/linear/bilinear/"
            "trilinear/bicubic/area, got %r" % (mode,))
    channel_last = data_format.endswith("C") and x.ndim > 2
    n_spatial = x.ndim - 2
    axes = (tuple(range(1, 1 + n_spatial)) if channel_last
            else tuple(range(2, 2 + n_spatial)))
    if size is None:
        if scale_factor is None:
            raise InvalidArgumentError("one of size/scale_factor is required")
        factors = ((scale_factor,) * n_spatial
                   if isinstance(scale_factor, (int, float))
                   else tuple(scale_factor))
        size = tuple(int(x.shape[a] * f) for a, f in zip(axes, factors))
    else:
        size = ((size,) * n_spatial if isinstance(size, int)
                else tuple(int(v) for v in size))
    if mode == "area":
        from . import pooling as _pooling

        pool = {1: _pooling.adaptive_avg_pool1d,
                2: _pooling.adaptive_avg_pool2d,
                3: _pooling.adaptive_avg_pool3d}[n_spatial]
        fmt = ({1: "NLC", 2: "NHWC", 3: "NDHWC"} if channel_last
               else {1: "NCL", 2: "NCHW", 3: "NCDHW"})[n_spatial]
        return pool(x, list(size), data_format=fmt)
    if mode == "bicubic" and not x.is_floating_point():
        x = x.float()
    for ax, out_len in zip(axes, size):
        if mode == "nearest":
            x = _resize_nearest(x, ax, out_len, align_corners)
        elif mode == "bicubic":
            if x.shape[ax] != out_len:
                x = _resize_cubic(x, ax, out_len)
        else:
            x = _resize_linear(x, ax, out_len, align_corners, align_mode)
    return x


def upsample(x, size=None, scale_factor=None, mode: str = "nearest",
             align_corners: bool = False, data_format: str = "NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       data_format=data_format)


def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW"):
    """[N, C * r * r, H, W] -> [N, C, H * r, W * r] (or the NHWC
    counterpart)."""
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def bilinear(x1, x2, weight, bias=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias[o])``; ``weight``
    is [out, in1, in2]."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW"):
    """TSM's shift over [N * T, C, H, W]: the first ``C * shift_ratio``
    channels come from the next frame, the next as many from the previous
    one (zeros past the ends), the rest stay."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    zero = torch.zeros_like(x[:, :1, :fold])
    back = torch.cat([x[:, 1:, :fold], zero], dim=1)
    fwd = torch.cat([torch.zeros_like(x[:, :1, fold:2 * fold]),
                     x[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([back, fwd, x[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)


def diag_embed(input, offset: int = 0, dim1: int = -2, dim2: int = -1):
    """The last axis of ``input`` as the ``offset`` diagonal of new
    matrices spanning ``dim1``/``dim2``."""
    n = input.shape[-1]
    size = n + abs(offset)
    rows = torch.arange(n, device=input.device) + max(-offset, 0)
    cols = torch.arange(n, device=input.device) + max(offset, 0)
    out = input.new_zeros(input.shape[:-1] + (size, size))
    out[..., rows, cols] = input
    nd = out.ndim
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        out = out.movedim((nd - 2, nd - 1), (d1, d2))
    return out

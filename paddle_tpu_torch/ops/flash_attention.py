"""Decode-time attention and int8 KV quantization, with the routing seam
between the composition and the hand-written kernels.

Counterpart of the reference's ``ops/flash_attention.py`` (the decode
half: ``quantize_kv``/``dequantize_kv``, ``decode_attention``,
``paged_decode_attention``, ``_effective_qpos``, ``_qpos_bias`` and the
route knob).  The uncached ``flash_attention`` (kernel K3 of the
reference, the training path) is not ported yet.

Routes, per call or ambient through :func:`decode_route`:

- ``"auto"``: the kernels' structural limits decide, not a measured
  crossover (none has been measured on the card yet).  A query chunk of at
  most 8 positions with supported dtypes, a head_dim the kernels take and
  a streamable bias goes to the kernel wrapper -- which launches K1/K2 on a
  CUDA tensor and runs the plain twin on a CPU tensor.  Longer chunks (the
  bucketed prefill) take the composition, as in the reference, where
  prefill is no kernel either.
- ``"composition"``: always the gather + dequantize + matmul-softmax-matmul
  composition, op for op the reference's.
- ``"kernel"``: the kernel wherever it structurally applies; other shapes
  keep the composition, so a forced session still prefills.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from ..core.errors import InvalidArgumentError
from . import decode_kernels as _dk

__all__ = ["decode_attention", "paged_decode_attention", "quantize_kv",
           "dequantize_kv", "decode_route", "normalize_decode_route",
           "DECODE_ROUTES", "KV_QUANT_EPS"]

# Floor for the absmax scale: an all-zero head row quantizes to zeros with
# a tiny scale instead of dividing by zero.
KV_QUANT_EPS = 1e-8


def quantize_kv(x):
    """``[..., D]`` float K/V -> ``(int8 values [..., D], fp32 scales
    [...])``: symmetric per-head absmax quantization (one scale per head
    per position), rounding half to even as the reference does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=KV_QUANT_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: int8 values times their scales."""
    return q.to(dtype) * scale[..., None].to(dtype)


DECODE_ROUTES = ("auto", "composition", "kernel")

# The ambient route is thread-local, as in the reference: a serving loop
# thread may decode under one route while another thread uses another.
_route_state = threading.local()


def _route_stack() -> list:
    stack = getattr(_route_state, "stack", None)
    if stack is None:
        stack = _route_state.stack = ["auto"]
    return stack


def normalize_decode_route(route) -> str:
    """Validated route name, or a typed error naming the choices."""
    if route not in DECODE_ROUTES:
        raise InvalidArgumentError(
            "decode route must be one of %s, got %r"
            % (list(DECODE_ROUTES), route))
    return route


@contextlib.contextmanager
def decode_route(route):
    """Ambient decode-attention routing for a region: sessions wrap their
    model forwards in this so the route reaches the attention calls under
    the layer stack without a kwarg through every ``forward``."""
    stack = _route_stack()
    stack.append(normalize_decode_route(route))
    try:
        yield
    finally:
        stack.pop()


def _kernel_feasible(q, kv_dtype, bias, s: int) -> bool:
    """The kernels' structural limits: 4-D queries, a chunk of at most 8,
    supported dtypes, a head_dim they take, a streamable bias."""
    if q.ndim != 4 or q.shape[2] > _dk.MAX_KERNEL_QUERY_CHUNK:
        return False
    d = q.shape[3]
    if d % 8 != 0 or d > _dk.MAX_KERNEL_HEAD_DIM:
        return False
    if not _dk.kernel_dtypes_supported(q.dtype, kv_dtype):
        return False
    return bias is None or _dk.bias_streamable(
        tuple(bias.shape), q.shape[0], q.shape[1], q.shape[2], s)


def _use_kernel(route, feasible: bool) -> bool:
    r = _route_stack()[-1] if route is None else normalize_decode_route(route)
    if r == "composition":
        return False
    return feasible  # "auto" and "kernel" share the structural gate


def _qpos_bias(q_pos, s_len: int, dtype, device):
    """The composition's additive mask from last-visible-key positions:
    [L] q_pos -> [1, 1, L, S], [B, L] -> [B, 1, L, S]."""
    qp = q_pos.to(device=device, dtype=torch.int64)
    neg = torch.finfo(torch.float32).min
    pos = torch.arange(s_len, device=device)
    if qp.ndim == 1:
        allow = pos[None, :] <= qp[:, None]
        return torch.where(allow, 0.0, neg).to(dtype)[None, None]
    allow = pos[None, None, :] <= qp[:, :, None]
    return torch.where(allow, 0.0, neg).to(dtype)[:, None]


def _effective_qpos(q_pos, lengths, b: int, lq: int, s: int, device):
    """The kernels' [B, Lq] int32 mask-index form of ``q_pos`` (the last
    visible key per query) and/or ``lengths`` (key s visible iff s <
    lengths), combined by min; with neither every key is visible."""
    qp = None
    if q_pos is not None:
        qp = torch.as_tensor(q_pos, device=device).to(torch.int32)
        qp = qp[None, :].expand(b, lq) if qp.ndim == 1 else qp.expand(b, lq)
    if lengths is not None:
        ln = torch.as_tensor(lengths, device=device).to(torch.int32)
        if ln.ndim == 0:
            ln = ln[None].expand(b)
        lim = (ln - 1)[:, None].expand(b, lq)
        qp = lim if qp is None else torch.minimum(qp, lim)
    if qp is None:
        qp = torch.full((b, lq), s - 1, dtype=torch.int32, device=device)
    return qp.contiguous()


def decode_attention(q, k, v, bias=None, sm_scale: Optional[float] = None,
                     k_scale=None, v_scale=None, q_pos=None, route=None):
    """Decode-step attention: [B, H, Lq, D] queries against a full
    preallocated cache [B, H, S, D].

    ``q_pos`` ([Lq] or [B, Lq]) names the last key each query may attend;
    ``k_scale``/``v_scale`` ([B, H, S] fp32) mark an int8 cache; ``bias``
    is an extra additive mask broadcastable to [B, H, Lq, S]; ``route``
    overrides the ambient :func:`decode_route`."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = k.shape[2]
    if _use_kernel(route, _kernel_feasible(q, k.dtype, bias, s)):
        qp = _effective_qpos(q_pos, None, q.shape[0], q.shape[2], s,
                             q.device)
        return _dk.decode_attention_kernel(q, k, v, qp, float(sm_scale),
                                           k_scale=k_scale, v_scale=v_scale,
                                           bias=bias)
    if k_scale is not None:
        k = dequantize_kv(k, k_scale, q.dtype)
    if v_scale is not None:
        v = dequantize_kv(v, v_scale, q.dtype)
    k, v = k.to(q.dtype), v.to(q.dtype)
    if q_pos is not None:
        pos_bias = _qpos_bias(torch.as_tensor(q_pos), s, q.dtype, q.device)
        bias = pos_bias if bias is None else bias + pos_bias
    scores = torch.matmul(q, k.transpose(-1, -2)) * sm_scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v)


def paged_decode_attention(q, k_pool, v_pool, table, lengths=None, bias=None,
                           sm_scale: Optional[float] = None, k_scale=None,
                           v_scale=None, q_pos=None, route=None):
    """Decode-step attention against a block-table KV cache.

    ``k_pool``/``v_pool`` [num_blocks, H, bs, D] are shared by every row;
    row b's logical block j lives in pool row ``table[b, j]`` (block 0 is
    the scratch block unmapped entries point at).  ``lengths`` (scalar or
    [B]) counts each row's valid tokens; ``k_scale``/``v_scale``
    [num_blocks, H, bs] mark an int8 pool; ``q_pos``/``bias``/``route`` as
    in :func:`decode_attention`.  On the kernel route the gather below
    never happens: K1 walks the table itself."""
    b, mb = table.shape
    nb, h, bs, d = k_pool.shape
    s = mb * bs
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _use_kernel(route, _kernel_feasible(q, k_pool.dtype, bias, s)):
        qp = _effective_qpos(q_pos, lengths, b, q.shape[2], s, q.device)
        return _dk.paged_decode_attention_kernel(
            q, k_pool, v_pool, table.to(torch.int32).contiguous(), qp,
            float(sm_scale), k_scale=k_scale, v_scale=v_scale, bias=bias)
    tbl = table.long()
    k = k_pool[tbl].permute(0, 2, 1, 3, 4).reshape(b, h, s, d)
    v = v_pool[tbl].permute(0, 2, 1, 3, 4).reshape(b, h, s, d)
    ks = vs = None
    if k_scale is not None:
        ks = k_scale[tbl].permute(0, 2, 1, 3).reshape(b, h, s)
    if v_scale is not None:
        vs = v_scale[tbl].permute(0, 2, 1, 3).reshape(b, h, s)
    if lengths is not None:
        ln = torch.as_tensor(lengths, device=q.device).long()
        pos = torch.arange(s, device=q.device)
        if ln.ndim == 0:
            allow = (pos < ln)[None, None, None, :]
        else:
            allow = (pos[None, :] < ln[:, None])[:, None, None, :]
        neg = torch.finfo(torch.float32).min
        len_bias = torch.where(allow, 0.0, neg).to(q.dtype)
        bias = len_bias if bias is None else bias + len_bias
    if q_pos is not None:
        pos_bias = _qpos_bias(torch.as_tensor(q_pos), s, q.dtype, q.device)
        bias = pos_bias if bias is None else bias + pos_bias
    # the kernel decision was made on the paged shapes: the gathered dense
    # arrays stay on the composition
    return decode_attention(q, k, v, bias=bias, sm_scale=sm_scale,
                            k_scale=ks, v_scale=vs, route="composition")

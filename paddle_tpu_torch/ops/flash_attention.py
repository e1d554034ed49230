"""Attention ops with the routing seam between the composition and the
hand-written kernels, and int8 KV quantization.

Counterpart of the reference's ``ops/flash_attention.py``:

- the uncached half: ``flash_attention`` (kernel K3, the training path),
  its gate ``flash_attention_supported``, the composition
  ``_reference_attention`` it falls back to on shapes the kernel does not
  take, and the mask detections ``detect_causal_additive_mask`` /
  ``detect_padding_additive_mask`` with their per-version caches;
- the decode half: ``quantize_kv``/``dequantize_kv``, ``decode_attention``,
  ``paged_decode_attention``, ``_effective_qpos``, ``_qpos_bias`` and the
  route knob.

The flash gate is the kernel's structural limits (4-D, no dropout, f32 or
bf16, head_dim a multiple of 8 up to 256), not the reference's TPU
choices (backend, minimum sequence, L % 128, d in {64, 128, 256}): on a
CUDA tensor the call launches K3, on a CPU tensor it runs K3's plain twin.

``FLAGS_seq_block_size`` bounds the reference's Pallas sequence tiles (a
VMEM budget; it changes no value).  K3's tiles are compiled per head_dim
(at most 128 rows a CTA, ``csrc/flash_attention.cu``), within the flag's
default of 512; a smaller flag leaves them as compiled, and no value
changes either way.

Decode routes, per call or ambient through :func:`decode_route`:

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
import weakref
from typing import Optional

import torch

from ..core.errors import InvalidArgumentError
from . import decode_kernels as _dk
from . import flash_kernels as _fk

__all__ = ["flash_attention", "flash_attention_supported",
           "detect_causal_additive_mask", "detect_padding_additive_mask",
           "decode_attention", "paged_decode_attention", "quantize_kv",
           "dequantize_kv", "decode_route", "normalize_decode_route",
           "DECODE_ROUTES", "KV_QUANT_EPS"]


def flash_attention_supported(q_shape, dtype, dropout_p: float = 0.0) -> bool:
    """Gate: K3 takes 4-D [B, H, L, D] in f32 or bf16, head_dim a multiple
    of 8 up to 256, and no attention-weight dropout (the kernel never
    materializes the weights)."""
    if dropout_p > 0.0 or len(q_shape) != 4:
        return False
    return _fk.head_dim_and_dtype_supported(q_shape[-1], dtype)


def _reference_attention(q, k, v, bias, causal, sm_scale, segment_ids=None):
    """The composition, op for op the reference's: masked scores replaced
    by finfo.min, then the bias added, softmax, value product."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * torch.tensor(
        sm_scale, dtype=q.dtype)
    neg = torch.finfo(scores.dtype).min
    if causal:
        ql, kl = scores.shape[-2], scores.shape[-1]
        allow = torch.ones(ql, kl, dtype=torch.bool,
                           device=scores.device).tril()
        scores = torch.where(allow, scores, neg)
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        same = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
        scores = torch.where(same, scores, neg)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v)


def flash_attention(q, k, v, bias=None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    key_padding_mask=None, segment_ids=None):
    """[B, H, L, D] attention through K3 (its twin on the CPU), with the
    composition for shapes the kernel does not take.

    ``bias``: additive attention bias broadcastable to [B, H, Lq, Lk].
    ``key_padding_mask``: [B, Lk] bool, True = real token; padded keys are
    excluded from every softmax.  ``segment_ids``: ([B, Lq], [B, Lk]) ints;
    attention is confined to equal ids.  Both are O(L) lanes: no [L, L]
    mask is built.  Differentiable in q, k, v and bias."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if key_padding_mask is not None:
        if segment_ids is not None:
            raise ValueError(
                "pass either key_padding_mask or segment_ids, not both")
        # valid keys -> segment 0, pads -> 1; queries are all segment 0
        # (their pad rows are ignored downstream)
        valid = torch.as_tensor(key_padding_mask, device=q.device).bool()
        kv_seg = torch.where(valid, 0, 1).to(torch.int32)
        q_seg = torch.zeros(q.shape[0], q.shape[2], dtype=torch.int32,
                            device=q.device)
        segment_ids = (q_seg, kv_seg)
    elif segment_ids is not None:
        segment_ids = tuple(torch.as_tensor(s, device=q.device)
                            .to(torch.int32) for s in segment_ids)
    if not _fk.kernel_takes(q, k, v, bias):
        return _reference_attention(q, k, v, bias, causal, sm_scale,
                                    segment_ids)
    q_seg, kv_seg = segment_ids if segment_ids is not None else (None, None)
    return _fk.FlashAttentionFunction.apply(q, k, v, bias, q_seg, kv_seg,
                                            bool(causal), float(sm_scale))


# Mask detections run once per mask version: the cache keys on the mask's
# identity and checks its ``_version`` (torch bumps it on every in-place
# write: ``copy_``, ``zero_``, slice assignment), so a mask rewritten in
# place is read back again, while an unchanged mask costs no
# device-to-host readback.  Weakrefs keep the cache from pinning [L, L]
# masks after their models are freed, and a dead ref also invalidates an
# entry whose id a new allocation recycled.
_detect_cache: dict = {}
_pad_detect_cache: dict = {}
_DETECT_CACHE_MAX = 64

# While a step is captured as a CUDA graph nothing is read back, and what
# a detection returns is baked into the graph: a verdict (or, for padding,
# the ``valid`` lanes) cached for a graph input would be replayed against
# whatever a later call copies into that input.  So while the current
# stream captures, a mask sharing storage with an input of the captured
# call is never claimed (it reaches K3 as a broadcast bias, as the
# reference's traced masks take the general bias path), any other mask is
# claimed only from its cached verdict (the model's own causal mask, cached
# by the warm-up), and nothing new is cached.
_capture = threading.local()


@contextlib.contextmanager
def capturing_inputs(args):
    """Name the tensors of ``args`` as the inputs of the call being
    captured on this thread (``jit.aot`` wraps each capture in it)."""
    prev = getattr(_capture, "storages", None)
    _capture.storages = {a.untyped_storage().data_ptr() for a in args
                         if torch.is_tensor(a) and a.is_cuda}
    try:
        yield
    finally:
        _capture.storages = prev


def _capturing(mask) -> bool:
    return mask.is_cuda and torch.cuda.is_current_stream_capturing()


def _graph_input(mask) -> bool:
    return _capturing(mask) and mask.untyped_storage().data_ptr() in (
        getattr(_capture, "storages", None) or ())


def _cache_get(cache, mask):
    if _graph_input(mask):
        return False, None
    hit = cache.get(id(mask))
    if hit is not None and hit[0]() is mask and hit[1] == mask._version:
        return True, hit[2]
    return False, None


def _cache_put(cache, mask, verdict):
    if _capturing(mask):
        return verdict
    if len(cache) >= _DETECT_CACHE_MAX:
        for key in [k for k, v in cache.items() if v[0]() is None]:
            del cache[key]
        if len(cache) >= _DETECT_CACHE_MAX:
            cache.clear()
    cache[id(mask)] = (weakref.ref(mask), mask._version, verdict)
    return verdict


def detect_padding_additive_mask(mask):
    """[B, 1, 1, Lk] additive padding mask -> [B, Lk] bool validity on the
    mask's device, else None.  Catches the convention 0 = keep,
    big-negative (<= finfo.min / 2) = pad, so the kernel takes O(L) segment
    lanes instead of an [B, H, Lq, Lk] bias.  A 2-D mask means [Lq, Lk]
    and is not claimed; a mask that requires grad is a learned bias and is
    not claimed either.  Verdicts are cached per mask version; while a
    CUDA graph is captured, only a cached verdict for a mask that is not
    an input of the captured call is claimed."""
    if mask is None or not isinstance(mask, torch.Tensor) \
            or mask.requires_grad:
        return None
    if mask.ndim != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
        return None
    found, valid = _cache_get(_pad_detect_cache, mask)
    if found or _capturing(mask):
        return valid
    m = mask[:, 0, 0, :]
    if m.dtype == torch.bool:
        valid = m
    else:
        m = m.float()
        ok = m == 0
        pad = m <= torch.finfo(torch.float32).min / 2
        valid = ok if bool((ok | pad).all()) else None  # else: general bias
    return _cache_put(_pad_detect_cache, mask, valid)


def detect_causal_additive_mask(mask, seq_len: Optional[int] = None) -> bool:
    """True when ``mask`` is a 2-D additive causal mask (0 on and below the
    diagonal, at most finfo.min / 2 above) of side ``seq_len``, so K3's
    causal path can replace the materialized mask.  A mask that requires
    grad is a learned bias and is never claimed.  Verdicts are cached per
    mask version: the check reads an unchanged mask back to the host
    once.  While a CUDA graph is captured, only a cached verdict for a mask
    that is not an input of the captured call is claimed."""
    if mask is None or not isinstance(mask, torch.Tensor) \
            or mask.requires_grad:
        return False
    if mask.ndim != 2 or mask.shape[-1] != mask.shape[-2]:
        return False
    l = mask.shape[0]
    if l < 2:  # 1x1 has an empty upper triangle: vacuously "causal"
        return False
    if seq_len is not None and l != seq_len:
        return False
    found, verdict = _cache_get(_detect_cache, mask)
    if found or _capturing(mask):
        return bool(verdict)
    m = mask.float()
    allow = torch.ones(l, l, dtype=torch.bool, device=m.device).tril()
    neg = torch.finfo(torch.float32).min
    lower_ok = (torch.where(allow, m, 0.0) == 0).all()
    upper_ok = (torch.where(allow, neg, m) <= neg / 2).all()
    return _cache_put(_detect_cache, mask, bool(lower_ok & upper_ok))

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
        # a chunk's heads split off a [B, L, H*D] projection are strided
        # once L > 1 (a verify chunk, a short prompt chunk)
        return _dk.decode_attention_kernel(q.contiguous(), k, v, qp,
                                           float(sm_scale),
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
            q.contiguous(), k_pool, v_pool,
            table.to(torch.int32).contiguous(), qp,
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

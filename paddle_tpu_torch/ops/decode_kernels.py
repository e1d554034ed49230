"""Decode-attention kernels: K1 (paged) and K2 (dense), their plain twins
and their launch counters.

Counterpart of the reference's ``ops/pallas_decode.py``.  The kernels are
hand-written CUDA for Hopper (``csrc/decode_attention.cu``), built by
``ops/_build.py`` at first launch and bound through a plain C interface.

Dispatch is by the device of the tensors alone:

- a CUDA tensor launches the kernel, or raises when the kernel cannot take
  the inputs -- there is no fallback;
- a CPU tensor runs the plain twin, a straightforward torch version of the
  kernel's semantics (including the 0 a row with no visible key emits).

Each wrapper counts its own launches in a plain integer attribute
(``paged_decode_attention_kernel.launches``), incremented only where the
kernel is launched, so a run can show which path it went through.  One
wrapper call is one launch, though on the card it may run two kernels:
the split kernel and the combine of its partials (:func:`num_splits`).
"""
from __future__ import annotations

import functools

import torch

from ..core.errors import ExternalError, InvalidArgumentError
from . import kernel_cost

__all__ = ["paged_decode_attention_kernel", "decode_attention_kernel",
           "paged_decode_attention_plain", "decode_attention_plain",
           "decode_combine_plain", "num_splits", "MAX_KERNEL_QUERY_CHUNK",
           "MAX_KERNEL_HEAD_DIM", "bias_streamable", "kernel_dtypes_supported",
           "reset_launch_counts", "launch_counts"]

# The longest query chunk the kernels take: 1 for autoregressive decode,
# spec_k+1 for a speculative verify chunk.  Longer chunks are prefill work.
MAX_KERNEL_QUERY_CHUNK = 8
# head_dim must be a multiple of 8 (8-element vector loads) and at most this
MAX_KERNEL_HEAD_DIM = 256

# Floor of the running max, as in the reference kernel: a fully masked
# prefix leaves the max here, and exp(-inf - floor) == 0 keeps it out.
_M_FLOOR = -1e30

# Key splitting (flash-decoding), mirrored from csrc/decode_attention.cu:
# spans are multiples of 32 keys, and a CTA's block-table entries must fit
# its 2048-entry shared-memory slice.  About one wave of resident CTAs on
# an H100 (132 SMs, 3 CTAs each by shared memory) is the target; a split
# covers at least 64 cache positions.
_WAVE_CTAS = 3 * 132
_MIN_SPLIT_KEYS = 64
_SPAN_KEYS = 32
_MAX_TABLE_SLOTS = 2048

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int8: 3}


def bias_streamable(bias_shape, b: int, h: int, lq: int, s: int) -> bool:
    """Whether an additive bias can stream through the kernel: 4-D
    [B|1, H|1, Lq, S].  The routing layer and the kernels' own validation
    both read this rule."""
    return (len(bias_shape) == 4 and bias_shape[0] in (1, b)
            and bias_shape[1] in (1, h) and bias_shape[2] == lq
            and bias_shape[3] == s)


def kernel_dtypes_supported(q_dtype, kv_dtype) -> bool:
    """Query dtypes f32/bf16; cache dtypes f32/bf16/f16/int8."""
    return q_dtype in _Q_CODES and kv_dtype in _KV_CODES


def _check_common(q, q_pos, bias, s: int):
    if q.ndim != 4:
        raise InvalidArgumentError(
            "decode kernel needs 4-D [B, H, Lq, D] queries, got shape %r"
            % (tuple(q.shape),))
    b, h, lq, _ = q.shape
    if lq > MAX_KERNEL_QUERY_CHUNK:
        raise InvalidArgumentError(
            "decode kernel takes query chunks of at most %d positions "
            "(decode steps and speculative verify chunks), got Lq=%d — "
            "long chunks are prefill work" % (MAX_KERNEL_QUERY_CHUNK, lq))
    if q_pos.ndim != 2 or tuple(q_pos.shape) != (b, lq):
        raise InvalidArgumentError(
            "q_pos must be [B, Lq] int32 last-visible-key positions "
            "(got %r for q %r)" % (tuple(q_pos.shape), tuple(q.shape)))
    if bias is not None and not bias_streamable(tuple(bias.shape), b, h,
                                                lq, s):
        raise InvalidArgumentError(
            "kernel bias must be 4-D broadcastable to [B, H, Lq, S] = %r "
            "(got %r); other shapes take the composition path"
            % ((b, h, lq, s), tuple(bias.shape)))


def _check_scales(k_scale, v_scale, kv_dtype, what: str):
    if (k_scale is None) != (v_scale is None):
        raise InvalidArgumentError(
            "int8 %s carry BOTH k_scale and v_scale (got one)" % what)
    if (kv_dtype == torch.int8) != (k_scale is not None):
        raise InvalidArgumentError(
            "k_scale/v_scale mark an int8 %s: got cache dtype %s with%s "
            "scales" % (what, kv_dtype,
                        "" if k_scale is not None else "out"))


# -- plain twins ---------------------------------------------------------


def _attend_plain(q, k, v, q_pos, sm_scale, bias):
    """The kernels' arithmetic on gathered fp32 K/V [B, H, S, D]: scores
    q.k * sm_scale + bias, keys past ``q_pos`` masked, softmax with the
    running max floored at -1e30 and a zero normalizer mapped to 1 (so a
    row that sees no key emits 0), output in q's dtype."""
    s_len = k.shape[2]
    s = torch.matmul(q.float(), k.transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    pos = torch.arange(s_len, device=q.device)
    allow = pos[None, None, :] <= q_pos.long()[:, :, None]      # [B, Lq, S]
    s = s.masked_fill(~allow[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp(min=_M_FLOOR)
    p = torch.exp(s - m)
    norm = p.sum(dim=-1, keepdim=True)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    return (torch.matmul(p, v) / norm).to(q.dtype)


def _dequant(x, scale):
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def paged_decode_attention_plain(q, k_pool, v_pool, table, q_pos,
                                 sm_scale: float, k_scale=None, v_scale=None,
                                 bias=None):
    """Plain torch twin of K1: gathers the row's blocks through ``table``
    ([B, MB] -> [B, H, MB*bs, D]) and runs the kernel's arithmetic."""
    b, mb = table.shape
    _, h, bs, d = k_pool.shape
    tbl = table.long()

    def gather(pool):
        return pool[tbl].permute(0, 2, 1, 3, 4).reshape(b, h, mb * bs, d)

    def gather_scale(scale):
        if scale is None:
            return None
        return scale[tbl].permute(0, 2, 1, 3).reshape(b, h, mb * bs)

    k = _dequant(gather(k_pool), gather_scale(k_scale))
    v = _dequant(gather(v_pool), gather_scale(v_scale))
    return _attend_plain(q, k, v, q_pos, sm_scale, bias)


def decode_attention_plain(q, k, v, q_pos, sm_scale: float, k_scale=None,
                           v_scale=None, bias=None):
    """Plain torch twin of K2 over a dense [B, H, S, D] cache."""
    return _attend_plain(q, _dequant(k, k_scale), _dequant(v, v_scale),
                         q_pos, sm_scale, bias)


def decode_combine_plain(m, l, acc):
    """Plain combine of split partials, as the kernel's second pass does:
    ``m``/``l`` [B, H, splits, Lq] are each split's floored running max
    and normalizer, ``acc`` [B, H, splits, Lq, D] its unnormalized P.V.
    Returns the fp32 output [B, H, Lq, D]; a row whose normalizer sums to
    0 emits 0."""
    w = torch.exp(m - m.amax(dim=2, keepdim=True))
    norm = (w * l).sum(dim=2)
    norm = torch.where(norm == 0, torch.ones_like(norm), norm)
    return (w[..., None] * acc).sum(dim=2) / norm[..., None]


# -- kernel wrappers -------------------------------------------------------


def _table_slots(s: int, splits: int, block_size: int) -> int:
    per = -(-s // splits)
    span = -(-per // _SPAN_KEYS) * _SPAN_KEYS
    return min(s // block_size, (span - 1) // block_size + 2)


@functools.lru_cache(maxsize=None)
def num_splits(b: int, h: int, s: int, block_size=None) -> int:
    """How many CTAs share one (row, head) of a decode launch: about one
    wave of resident CTAs over the ``b * h`` pairs, at most one per 64
    positions of the capacity ``s``; paged (``block_size`` given), enough
    that a span's table entries fit the kernel's shared slice.  Static
    shapes only, so a request's result never depends on which other slots
    are live."""
    splits = max(1, min(int(_WAVE_CTAS / (b * h) + 0.5),
                        s // _MIN_SPLIT_KEYS))
    if block_size is not None:
        while _table_slots(s, splits, block_size) > _MAX_TABLE_SLOTS:
            splits += 1
    return splits


def _workspace(q, splits: int):
    """fp32 scratch for the split partials (m, l, acc), or None."""
    if splits == 1:
        return None
    b, h, lq, d = q.shape
    return torch.empty(b * h * splits * lq * (d + 2), dtype=torch.float32,
                       device=q.device)


def _check_cuda(named, device):
    for name, t in named:
        if t is None:
            continue
        if t.device != device:
            raise InvalidArgumentError(
                "decode kernel: %s is on %s, q on %s" % (name, t.device,
                                                        device))
        if not t.is_contiguous():
            raise InvalidArgumentError(
                "decode kernel: %s must be contiguous" % name)


def _bias_args(bias, device):
    """fp32 bias with unit key stride, and its (batch, head, query)
    element strides; broadcast axes get stride 0."""
    if bias is None:
        return None, 0, 0, 0
    bias = bias.to(device=device, dtype=torch.float32).contiguous()
    sb = 0 if bias.shape[0] == 1 else bias.stride(0)
    sh = 0 if bias.shape[1] == 1 else bias.stride(1)
    return bias, sb, sh, bias.stride(2)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_kernel_inputs(q, k, q_pos, k_scale, d):
    if not kernel_dtypes_supported(q.dtype, k.dtype):
        raise InvalidArgumentError(
            "decode kernel takes f32/bf16 queries and f32/bf16/f16/int8 "
            "caches, got q %s and cache %s" % (q.dtype, k.dtype))
    if d % 8 != 0 or d > MAX_KERNEL_HEAD_DIM:
        raise InvalidArgumentError(
            "decode kernel needs head_dim a multiple of 8 up to %d, got %d"
            % (MAX_KERNEL_HEAD_DIM, d))
    if q_pos.dtype != torch.int32:
        raise InvalidArgumentError(
            "q_pos must be int32 at the kernel boundary, got %s"
            % (q_pos.dtype,))
    if k_scale is not None and k_scale.dtype != torch.float32:
        raise InvalidArgumentError(
            "int8 cache scales must be float32, got %s" % (k_scale.dtype,))


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise ExternalError("%s launch failed: cudaError_t %d" % (what, rc))


def paged_decode_attention_kernel(q, k_pool, v_pool, table, q_pos,
                                  sm_scale: float, k_scale=None,
                                  v_scale=None, bias=None):
    """K1: fused paged decode attention, ``q`` [B, H, Lq<=8, D] against a
    block pool [num_blocks, H, bs, D] walked through ``table`` [B, MB]
    int32, never materializing the gathered K/V.

    ``q_pos`` [B, Lq] int32 names the last key position each query sees;
    ``k_scale``/``v_scale`` [num_blocks, H, bs] fp32 mark an int8 pool;
    ``bias`` is an optional additive [B|1, H|1, Lq, MB*bs].  CPU tensors
    run :func:`paged_decode_attention_plain`."""
    nb, h, bs, d = k_pool.shape
    if table.ndim != 2 or table.shape[0] != q.shape[0]:
        raise InvalidArgumentError(
            "table must be [B, max_blocks] int32 (got %r for q %r)"
            % (tuple(table.shape), tuple(q.shape)))
    mb = table.shape[1]
    _check_common(q, q_pos, bias, mb * bs)
    _check_scales(k_scale, v_scale, k_pool.dtype, "pools")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, table, q_pos,
                                            sm_scale, k_scale, v_scale, bias)
    if q.device.type != "cuda":
        raise InvalidArgumentError(
            "decode kernel runs on cuda (or its plain twin on cpu), got %s"
            % (q.device,))
    _check_kernel_inputs(q, k_pool, q_pos, k_scale, d)
    if table.dtype != torch.int32:
        raise InvalidArgumentError(
            "table must be int32 at the kernel boundary, got %s"
            % (table.dtype,))
    if tuple(v_pool.shape) != tuple(k_pool.shape) \
            or v_pool.dtype != k_pool.dtype or q.shape[1] != h \
            or q.shape[3] != d:
        raise InvalidArgumentError(
            "k/v pools must both be [num_blocks, H, bs, D] = %r matching q "
            "%r" % (tuple(k_pool.shape), tuple(q.shape)))
    bias, sb, sh, sl = _bias_args(bias, q.device)
    _check_cuda((("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                 ("table", table), ("q_pos", q_pos), ("k_scale", k_scale),
                 ("v_scale", v_scale)), q.device)
    from ._build import load

    lib = load("decode_attention")
    out = torch.empty_like(q)
    b, _, lq, _ = q.shape
    splits = num_splits(b, h, mb * bs, bs)
    work = _workspace(q, splits)
    rc = lib.ptt_paged_decode_attention(
        _Q_CODES[q.dtype], _KV_CODES[k_pool.dtype], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        table.data_ptr(), q_pos.data_ptr(), _ptr(bias), sb, sh, sl,
        out.data_ptr(), _ptr(work), b, h, lq, d, mb, bs, splits,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "paged_decode_attention_kernel")
    paged_decode_attention_kernel.launches += 1
    _report_cost(q, k_pool, k_scale, mb * bs, table, q_pos, bias, out)
    return out


def decode_attention_kernel(q, k, v, q_pos, sm_scale: float, k_scale=None,
                            v_scale=None, bias=None):
    """K2: the same fused decode attention over a dense [B, H, S, D] cache
    (``k_scale``/``v_scale`` [B, H, S] mark the int8 cache).  CPU tensors
    run :func:`decode_attention_plain`."""
    if k.ndim != 4:
        raise InvalidArgumentError(
            "dense kernel cache must be [B, H, S, D], got %r"
            % (tuple(k.shape),))
    _check_common(q, q_pos, bias, k.shape[2])
    _check_scales(k_scale, v_scale, k.dtype, "caches")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, q_pos, sm_scale, k_scale,
                                      v_scale, bias)
    if q.device.type != "cuda":
        raise InvalidArgumentError(
            "decode kernel runs on cuda (or its plain twin on cpu), got %s"
            % (q.device,))
    b, h, lq, d = q.shape
    _check_kernel_inputs(q, k, q_pos, k_scale, d)
    if tuple(k.shape[:2]) != (b, h) or k.shape[3] != d \
            or tuple(v.shape) != tuple(k.shape) or v.dtype != k.dtype:
        raise InvalidArgumentError(
            "k/v caches must both be [B, H, S, D] matching q %r, got %r / %r"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    bias, sb, sh, sl = _bias_args(bias, q.device)
    _check_cuda((("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                 ("k_scale", k_scale), ("v_scale", v_scale)), q.device)
    from ._build import load

    lib = load("decode_attention")
    out = torch.empty_like(q)
    splits = num_splits(b, h, k.shape[2])
    work = _workspace(q, splits)
    rc = lib.ptt_dense_decode_attention(
        _Q_CODES[q.dtype], _KV_CODES[k.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), _ptr(k_scale), _ptr(v_scale), q_pos.data_ptr(),
        _ptr(bias), sb, sh, sl, out.data_ptr(), _ptr(work), b, h, lq, d,
        k.shape[2], splits, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "decode_attention_kernel")
    decode_attention_kernel.launches += 1
    _report_cost(q, k, k_scale, k.shape[2], None, q_pos, bias, out)
    return out


def _report_cost(q, k, k_scale, s, table, q_pos, bias, out) -> None:
    """K1/K2's count for a step's cost report: ``4 B H Lq S D`` FLOPs (the
    two products over the ``S`` keys each row reaches), and the bytes of q,
    every row's K and V (with their scales), the table, the positions, the
    bias and the output."""
    b, h, lq, d = q.shape
    kv = 2 * b * h * s * (d * k.element_size()
                          + (4 if k_scale is not None else 0))
    kernel_cost.report(4.0 * b * h * lq * s * d,
                       kv + kernel_cost.nbytes(q, table, q_pos, bias, out))


paged_decode_attention_kernel.launches = 0
decode_attention_kernel.launches = 0

_WRAPPERS = {"paged_decode_attention_kernel": paged_decode_attention_kernel,
             "decode_attention_kernel": decode_attention_kernel}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches since the last reset}."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}

"""Transformer layers (counterpart of the reference's
``nn/layer/transformer.py``): ``MultiHeadAttention`` with its uncached
forward and its dense and paged decode-cache forwards,
``TransformerEncoderLayer`` (pre- and post-norm) and
``TransformerEncoder``.

Decode caches are named tuples as in the reference.  Unlike JAX arrays,
torch tensors are written in place: a decode forward scatters the new K/V
into the cache's own buffers (no copy of a [B, H, max_len, D] buffer per
step) and returns the tuple with the advanced index; the caller's old tuple
shares those buffers.

Not ported yet: the sequence-parallel attention, the quantized
row-parallel collective seam and the LoRA hooks of the reference's
``forward``s.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
from torch import nn

from ...core.dtype import convert_dtype, dtype_name
from ...core.errors import InvalidArgumentError
from ...ops.flash_attention import (_cache_get, _cache_put, decode_attention,
                                    paged_decode_attention, quantize_kv)
from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm

# Decode-cache storage dtypes: the float dtypes store K/V verbatim; "int8"
# stores K/V quantized with per-head fp32 absmax scales riding alongside.
SUPPORTED_CACHE_DTYPES = ("float32", "bfloat16", "float16", "int8")

DecodeCache = collections.namedtuple(
    "DecodeCache", ["k", "v", "index", "k_scale", "v_scale"],
    defaults=(None, None))
PagedDecodeCache = collections.namedtuple(
    "PagedDecodeCache", ["k", "v", "table", "index", "k_scale", "v_scale"],
    defaults=(None, None))


def normalize_cache_dtype(dtype) -> str:
    """Canonical dtype name for a decode cache, or a typed error naming
    the supported set."""
    try:
        name = dtype_name(dtype)
    except (InvalidArgumentError, KeyError):
        name = str(dtype)
    if name not in SUPPORTED_CACHE_DTYPES:
        raise InvalidArgumentError(
            "unsupported KV cache dtype %r; supported cache dtypes: %s "
            "('int8' stores quantized K/V with per-head fp32 scales)"
            % (dtype, list(SUPPORTED_CACHE_DTYPES)))
    return name


# One converted copy per (mask version, dtype): every layer of a model
# converts the mask it was passed, and the attention's mask detections key
# on the converted tensor's identity, so a fresh copy in each layer (an O2
# bf16 model given a float32 padding mask) would read the mask back to the
# host once a layer instead of once.
_converted_masks: dict = {}


def _convert_attn_mask(mask, dtype):
    """bool mask (True = keep) -> additive; numeric passes through, cast to
    ``dtype`` (a mask that requires grad is cast afresh each call)."""
    if mask is None:
        return None
    if mask.dtype == dtype:
        return mask
    if mask.requires_grad:
        return mask.to(dtype)
    cache = _converted_masks.setdefault(dtype, {})
    found, out = _cache_get(cache, mask)
    if not found:
        out = _cache_put(cache, mask, (~mask).to(dtype) * -1e9
                         if mask.dtype == torch.bool else mask.to(dtype))
    return out


def _chunk_positions(index, b: int, length: int):
    """[B, L] absolute write positions of an L-token chunk: a scalar index
    (an aligned batch) broadcasts over rows, a [B] index is per row."""
    idx = index.to(torch.int64)
    step = torch.arange(length, device=idx.device)
    if idx.ndim == 0:
        return (idx + step)[None, :].expand(b, length)
    return idx[:, None] + step[None, :]


def _dense_write(buf, new, pos):
    """Write ``new`` [B, H, L, ...] into ``buf`` [B, H, S, ...] at
    positions ``pos`` [B, L], dropping positions at or past S (the
    reference's scatter ``mode="drop"``).

    torch has no drop mode, so every dropped position of a row is
    redirected to the position just before the row's chunk (clamped into
    the buffer; a row whose whole chunk lies past S has no valid target
    to meet) and rewrites the value already there: no valid write is
    clobbered, and no index leaves the buffer however far past S the
    chunk runs (a speculative verify, or a finished row's frozen index,
    can run ``spec_k`` positions past it)."""
    b, length = pos.shape
    s = buf.shape[2]
    valid = pos < s
    before = (pos[:, :1] - 1).clamp(0, s - 1)
    tgt = torch.where(valid, pos, before.expand(b, length))
    rows = torch.arange(b, device=buf.device)[:, None]
    vals = new.transpose(1, 2).to(buf.dtype)           # [B, L, H, ...]
    # unconditional (no host read of ``valid``): a device sync per write
    # would stall the decode step's launch queue
    keep = valid.view(b, length, *([1] * (vals.ndim - 2)))
    buf[rows, :, tgt] = torch.where(keep, vals, buf[rows, :, tgt])


def _paged_write(pool, new, phys, off):
    """Scatter ``new`` [B, H, L, ...] into ``pool`` [NB, H, bs, ...] at
    (``phys``, ``off``) [B, L].  Positions routed to the scratch block may
    repeat; they land there in any order, which is harmless because the
    scratch block is never read unmasked."""
    pool[phys, :, off] = new.transpose(1, 2).to(pool.dtype)


class MultiHeadAttention(nn.Module):
    """paddle.nn.MultiHeadAttention counterpart (self-attention with
    optional key/value inputs)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise InvalidArgumentError(
                "embed_dim %d not divisible by num_heads %d"
                % (embed_dim, num_heads))
        kw = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def gen_decode_cache(self, batch_size: int, max_length: int,
                         dtype="float32", per_slot: bool = False,
                         layout: str = "dense", block_size: int = 32,
                         num_blocks: Optional[int] = None):
        """A preallocated decode cache on this layer's device.  The index
        is 0 (a scalar, or [B] when ``per_slot``: the pool's slot-batched
        layout where every row decodes at its own position).

        ``layout="dense"``: zeroed [B, H, max_len, D] K/V.  ``"paged"``: a
        block pool [num_blocks, H, block_size, D] and a [B, max_blocks]
        int32 table; block 0 is the scratch block.  ``num_blocks=None``
        sizes the pool to full capacity with an identity table (no
        allocator needed); an explicit ``num_blocks`` leaves the table all
        zeros for an external allocator to map.  ``dtype="int8"`` adds fp32
        scales (dense [B, H, max_len], paged [num_blocks, H, block_size])."""
        if layout not in ("dense", "paged"):
            raise InvalidArgumentError(
                "cache layout must be 'dense' or 'paged', got %r" % (layout,))
        name = normalize_cache_dtype(dtype)
        dt = convert_dtype(name)
        quant = name == "int8"
        dev = self.q_proj.weight.device
        index = torch.zeros((batch_size,) if per_slot else (),
                            dtype=torch.int32, device=dev)
        if layout == "dense":
            shape = (batch_size, self.num_heads, max_length, self.head_dim)
            scales = ((torch.zeros(shape[:-1], device=dev),
                       torch.zeros(shape[:-1], device=dev)) if quant
                      else (None, None))
            return DecodeCache(torch.zeros(shape, dtype=dt, device=dev),
                               torch.zeros(shape, dtype=dt, device=dev),
                               index, *scales)
        block_size = int(block_size)
        if block_size < 1:
            raise InvalidArgumentError(
                "paged cache needs block_size >= 1, got %d" % block_size)
        max_blocks = -(-int(max_length) // block_size)
        if num_blocks is None:
            num_blocks = 1 + batch_size * max_blocks
            table = 1 + torch.arange(batch_size * max_blocks,
                                     dtype=torch.int32, device=dev) \
                .reshape(batch_size, max_blocks)
        else:
            num_blocks = int(num_blocks)
            if num_blocks < 2:
                raise InvalidArgumentError(
                    "paged cache needs num_blocks >= 2 (block 0 is the "
                    "reserved scratch block), got %d" % num_blocks)
            table = torch.zeros((batch_size, max_blocks), dtype=torch.int32,
                                device=dev)
        shape = (num_blocks, self.num_heads, block_size, self.head_dim)
        scales = ((torch.zeros(shape[:-1], device=dev),
                   torch.zeros(shape[:-1], device=dev)) if quant
                  else (None, None))
        return PagedDecodeCache(torch.zeros(shape, dtype=dt, device=dev),
                                torch.zeros(shape, dtype=dt, device=dev),
                                table, index, *scales)

    @staticmethod
    def _check_no_mask(attn_mask):
        if attn_mask is not None:
            raise InvalidArgumentError(
                "decode-cache attention derives its mask from the cache "
                "index (causal over the valid prefix); additive attn_mask "
                "is not supported with a DecodeCache — pass "
                "attn_mask=None, or use the uncached forward")

    def _decode_forward(self, q, k_new, v_new, attn_mask, cache):
        """Dense cached attention: write the chunk's K/V at ``cache.index``
        (per row when the index is [B]; positions past max_len dropped),
        attend causally over the valid prefix, advance the index."""
        self._check_no_mask(attn_mask)
        quant = cache.k_scale is not None
        k_s = v_s = None
        if quant:
            k_new, k_s = quantize_kv(k_new)
            v_new, v_s = quantize_kv(v_new)
        b, _, length, _ = q.shape
        pos = _chunk_positions(cache.index, b, length)
        _dense_write(cache.k, k_new, pos)
        _dense_write(cache.v, v_new, pos)
        if quant:
            _dense_write(cache.k_scale, k_s, pos)
            _dense_write(cache.v_scale, v_s, pos)
        out = decode_attention(q, cache.k, cache.v, q_pos=pos.to(torch.int32),
                               k_scale=cache.k_scale, v_scale=cache.v_scale)
        return out, cache._replace(index=cache.index + length)

    def _paged_decode_forward(self, q, k_new, v_new, attn_mask, cache):
        """Block-table cached attention: the chunk's K/V scatter into the
        pool through the row's table (positions past the table's span go
        to the scratch block), queries attend over the valid prefix, the
        index advances."""
        self._check_no_mask(attn_mask)
        quant = cache.k_scale is not None
        k_s = v_s = None
        if quant:
            k_new, k_s = quantize_kv(k_new)
            v_new, v_s = quantize_kv(v_new)
        table = cache.table
        b, _, length, _ = q.shape
        bs = cache.k.shape[2]
        mb = table.shape[1]
        pos = _chunk_positions(cache.index, b, length)
        logical = torch.clamp(pos // bs, max=mb - 1)
        phys = torch.where(pos < mb * bs,
                           torch.gather(table.long(), 1, logical),
                           torch.zeros_like(logical))
        off = pos % bs
        _paged_write(cache.k, k_new, phys, off)
        _paged_write(cache.v, v_new, phys, off)
        if quant:
            _paged_write(cache.k_scale, k_s, phys, off)
            _paged_write(cache.v_scale, v_s, phys, off)
        out = paged_decode_attention(q, cache.k, cache.v, table,
                                     q_pos=pos.to(torch.int32),
                                     k_scale=cache.k_scale,
                                     v_scale=cache.v_scale)
        return out, cache._replace(index=cache.index + length)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        if isinstance(cache, (DecodeCache, PagedDecodeCache)):
            fwd = (self._decode_forward if isinstance(cache, DecodeCache)
                   else self._paged_decode_forward)
            out, cache = fwd(q, k, v, attn_mask, cache)
            return self.out_proj(self._merge_heads(out)), cache
        mask = _convert_attn_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             dropout_p=self.dropout,
                                             training=self.training)
        return self.out_proj(self._merge_heads(out))


class TransformerEncoderLayer(nn.Module):
    """Encoder block; post-norm by default (``normalize_before=False``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 normalize_before: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # constructor arguments, so TransformerEncoder can build siblings
        self._config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation,
            normalize_before=normalize_before, device=device,
            generator=generator)
        self.normalize_before = normalize_before
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        hidden = self.dropout(getattr(F, self.activation)(self.linear1(src)))
        src = residual + self.dropout2(self.linear2(hidden))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_decode_cache(self, *args, **kwargs):
        return self.self_attn.gen_decode_cache(*args, **kwargs)


class TransformerEncoder(nn.Module):
    """A stack of ``num_layers`` encoder layers: ``encoder_layer`` first,
    then fresh siblings built from its constructor arguments."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [TransformerEncoderLayer(**encoder_layer._config)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        return output if cache is None else (output, new_caches)

    def gen_decode_cache(self, *args, **kwargs):
        return [layer.gen_decode_cache(*args, **kwargs)
                for layer in self.layers]

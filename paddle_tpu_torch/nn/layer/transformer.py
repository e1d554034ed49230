"""Transformer layers (counterpart of the reference's
``nn/layer/transformer.py``): ``MultiHeadAttention`` with its uncached
forward, the reference's incremental and static attention caches
(``Cache``, which grows by concatenation, and ``StaticCache``, the
memory's projection made once) and its dense and paged decode-cache
forwards; ``TransformerEncoderLayer``/``TransformerEncoder`` and
``TransformerDecoderLayer``/``TransformerDecoder`` (pre- and post-norm),
and the encoder-decoder ``Transformer``.  Every uncached attention goes
through ``F.scaled_dot_product_attention`` and so, without dropout, to
the flash kernel K3.

Decode caches are named tuples as in the reference.  Unlike JAX arrays,
torch tensors are written in place: a decode forward scatters the new K/V
into the cache's own buffers (no copy of a [B, H, max_len, D] buffer per
step) and returns the tuple with the advanced index; the caller's old tuple
shares those buffers.

Under a decode mesh (``jit/mesh.py``) a layer's cache is a
``ShardedCache``: the attention then runs each dp shard's rows and, within
it, each mp shard's heads -- the shard's q/k/v columns, the decode kernel
on the shard's own cache tensors at H/mp heads, and its ``out_proj`` rows
-- and the MLP each shard's ``linear1`` columns and ``linear2`` rows.  Each
row-parallel projection ends at :func:`_row_parallel_seam`, which reduces
the shards' partial products (``distributed.qcollectives``), adds the bias
once and re-applies a LoRA bank's delta on the reduced output from the
global input; a column-parallel projection's delta uses the shard's
columns of ``lora_b`` (``lora_a`` whole).

Not ported yet: the sequence-parallel attention.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
from torch import nn

from ...core.dtype import convert_dtype, dtype_name
from ...core.errors import InvalidArgumentError
from ...distributed import qcollectives as _qc
from ...distributed.sharded import is_sharded, mesh_parts
from ...ops.flash_attention import (_cache_get, _cache_put, decode_attention,
                                    paged_decode_attention, quantize_kv)
from .. import functional as F
from .. import lora as _lora
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
    """paddle.nn.MultiHeadAttention counterpart: self-attention, or
    attention over ``key``/``value`` inputs of widths ``kdim``/``vdim``.
    With ``need_weights`` the forward also returns the attention weights,
    which are None here, as in the reference (the kernel never makes
    them)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise InvalidArgumentError(
                "embed_dim %d not divisible by num_heads %d"
                % (embed_dim, num_heads))
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x):
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2)

    def _merge_heads(self, x):
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def gen_cache(self, key, value=None, type=None):
        """The reference's attention caches.  ``type=StaticCache``: the
        projections of ``key`` and ``value`` (``key`` when None), made once
        for every later step (a decoder's memory).  Otherwise a ``Cache``:
        empty ([B, H, 0, D] on this layer's device and dtype) when
        ``value`` is None, else ``Cache(key, value)`` as given."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                key if value is None else value))
            return self.StaticCache(k, v)
        if value is None:
            w = self.q_proj.weight
            empty = torch.zeros(key.shape[0], self.num_heads, 0,
                                self.head_dim, dtype=w.dtype, device=w.device)
            return self.Cache(empty, empty.clone())
        return self.Cache(key, value)

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
        out = self._dense_attend(q, k_new, v_new, cache)
        return out, cache._replace(index=cache.index + q.shape[2])

    @staticmethod
    def _dense_attend(q, k_new, v_new, cache):
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
        return decode_attention(q, cache.k, cache.v, q_pos=pos.to(torch.int32),
                                k_scale=cache.k_scale, v_scale=cache.v_scale)

    def _paged_decode_forward(self, q, k_new, v_new, attn_mask, cache):
        """Block-table cached attention: the chunk's K/V scatter into the
        pool through the row's table (positions past the table's span go
        to the scratch block), queries attend over the valid prefix, the
        index advances."""
        self._check_no_mask(attn_mask)
        out = self._paged_attend(q, k_new, v_new, cache)
        return out, cache._replace(index=cache.index + q.shape[2])

    @staticmethod
    def _paged_attend(q, k_new, v_new, cache):
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
        return paged_decode_attention(q, cache.k, cache.v, table,
                                      q_pos=pos.to(torch.int32),
                                      k_scale=cache.k_scale,
                                      v_scale=cache.v_scale)

    def _sharded_forward(self, query, attn_mask, cache):
        """Self-attention over a ``ShardedCache``: for each dp shard's rows
        and each mp shard, the shard's q/k/v columns (H/mp heads), the
        decode kernel on the shard's cache and its ``out_proj`` rows; the
        seam reduces over mp and the index advances on the whole batch."""
        self._check_no_mask(attn_mask)
        mp = cache.mp
        heads = self.num_heads // mp
        attend = (self._paged_attend if cache.table is not None
                  else self._dense_attend)
        projs = [mesh_parts(p, mp) for p in (self.q_proj, self.k_proj,
                                              self.v_proj)]
        width = heads * self.head_dim
        outs = []
        for d, (x, ids) in enumerate(_dp_rows(query, cache)):
            row = []
            for m in range(mp):
                cols = slice(m * width, (m + 1) * width)
                q, k, v = (self._heads(_column_linear(lin, x, *part[m], ids,
                                                      cols), heads)
                           for lin, part in zip((self.q_proj, self.k_proj,
                                                 self.v_proj), projs))
                row.append(self._merge_heads(
                    attend(q, k, v, cache.shards[d][m])))
            outs.append(row)
        out = _row_parallel_seam(self.out_proj, outs, mp)
        return out, cache._replace(index=cache.index + query.shape[1])

    def _heads(self, x, heads: int):
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, heads, self.head_dim).transpose(1, 2)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """Attention of ``query`` over ``key``/``value`` (``query`` when
        None).  A ``Cache`` gets this call's keys and values appended
        (axis 2) and is returned, a ``StaticCache`` is attended as it is,
        a decode cache is written in place and returned with its index
        advanced.  Returns ``out``, or ``(out, cache)`` for a ``Cache`` or
        a decode cache; with ``need_weights`` the weights (None) come
        after ``out``."""
        if is_sharded(cache):
            return self._sharded_forward(query, attn_mask, cache)
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, (DecodeCache, PagedDecodeCache)):
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            fwd = (self._decode_forward if isinstance(cache, DecodeCache)
                   else self._paged_decode_forward)
            out, cache = fwd(q, k, v, attn_mask, cache)
            out = self.out_proj(self._merge_heads(out))
            return (out, None, cache) if self.need_weights else (out, cache)
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = self.Cache(k, v)
        mask = _convert_attn_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             dropout_p=self.dropout,
                                             training=self.training)
        out = self.out_proj(self._merge_heads(out))
        if isinstance(cache, self.Cache):
            return (out, None, cache) if self.need_weights else (out, cache)
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(nn.Module):
    """Encoder block; post-norm by default (``normalize_before=False``).
    ``attn_dropout`` (on the attention weights) and ``act_dropout`` (after
    the activation) default to ``dropout``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        # where _clone_args' siblings draw their parameters
        self._factory = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
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
        if is_sharded(cache):
            out = self._sharded_mlp(src, cache)
        else:
            hidden = self.dropout(getattr(F, self.activation)(
                self.linear1(src)))
            out = self.linear2(hidden)
        src = residual + self.dropout2(out)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def _sharded_mlp(self, x, cache):
        """The MLP over a ``ShardedCache``'s grid: each dp shard's rows
        through each mp shard's ``linear1`` columns, then the ``linear2``
        seam."""
        mp = cache.mp
        w1 = mesh_parts(self.linear1, mp)
        width = self.linear1.weight.shape[1] // mp
        act = getattr(F, self.activation)
        hidden = [[self.dropout(act(_column_linear(
            self.linear1, xd, *w1[m], ids,
            slice(m * width, (m + 1) * width)))) for m in range(mp)]
            for xd, ids in _dp_rows(x, cache)]
        return _row_parallel_seam(self.linear2, hidden, mp)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)

    def gen_decode_cache(self, *args, **kwargs):
        return self.self_attn.gen_decode_cache(*args, **kwargs)


def _dp_rows(x, cache):
    """``[(rows of x, their adapter ids)]`` per dp shard of ``cache`` (the
    ambient LoRA ids sliced to the same rows, or None)."""
    ids = _lora.current_adapter_ids()
    n = x.shape[0] // cache.dp
    return [(x[d * n:(d + 1) * n],
             None if ids is None else ids[d * n:(d + 1) * n])
            for d in range(cache.dp)]


def _column_linear(lin, x, weight, bias, ids, cols):
    """One mp shard of a column-parallel Linear: ``x @ weight + bias``
    with the shard's columns, plus the LoRA delta of rows ``ids`` through
    the bank's columns ``cols`` of ``lora_b`` (a view: bank writes reach
    it in place)."""
    out = F.linear(x, weight, bias)
    lora_a = lin._parameters.get("lora_a")
    if lora_a is not None and ids is not None:
        out = _lora.apply_delta(out, x, lora_a, lin.lora_b[:, :, cols], ids)
    return out


def _row_parallel_seam(lin, xs, mp: int):
    """A row-parallel Linear (attention ``out_proj``, MLP ``linear2``) over
    a grid of shard inputs ``xs[d][m]``: the shards' partial products
    reduced through ``qcollectives.row_parallel_linear`` (fp32, or the
    int8 two-stage sum inside a quantized decode seam), the bias added
    once, then a bank-attached Linear's LoRA delta re-applied on the
    reduced output from the GLOBAL input (the delta contracts the whole
    input against the replicated bank, so it rides outside the mp
    reduction, unquantized)."""
    parts = mesh_parts(lin, mp)
    out = _qc.row_parallel_linear(xs, [w for w, _ in parts], lin.bias,
                                  _qc.active())
    lora_a = lin._parameters.get("lora_a")
    ids = _lora.current_adapter_ids()
    if lora_a is not None and ids is not None:
        x = torch.cat([torch.cat(row, dim=-1) for row in xs], dim=0)
        out = _lora.apply_delta(out, x, lora_a, lin.lora_b, ids)
    return out


class TransformerEncoder(nn.Module):
    """A stack of ``num_layers`` encoder layers: ``encoder_layer`` first,
    then fresh siblings built by :func:`_clone_args`; ``norm`` (a
    ``LayerNorm``, for pre-norm stacks) after the last."""

    def __init__(self, encoder_layer, num_layers: int, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [type(encoder_layer)(**_clone_args(
                encoder_layer)) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]

    def gen_decode_cache(self, *args, **kwargs):
        return [layer.gen_decode_cache(*args, **kwargs)
                for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Decoder block: masked self-attention, cross-attention over the
    encoder's ``memory``, the MLP; post-norm by default.  ``cache`` is the
    pair :meth:`gen_cache` makes: a ``Cache`` for the self-attention
    (returned grown) and a ``StaticCache`` of the memory."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self._factory = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=device, generator=generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incr_cache = None
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
        if isinstance(tgt, tuple):  # need_weights
            tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(getattr(F, self.activation)(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, cache[1]))

    def gen_cache(self, memory):
        """(an empty ``Cache`` for the self-attention, the memory's
        ``StaticCache`` for the cross-attention)."""
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(nn.Module):
    """A stack of ``num_layers`` decoder layers, built as
    :class:`TransformerEncoder` builds its stack; ``norm`` after the
    last."""

    def __init__(self, decoder_layer, num_layers: int, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [type(decoder_layer)(**_clone_args(
                decoder_layer)) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip: bool = False):
        """Each layer's (``Cache``, ``StaticCache``) pair; ``do_zip``
        regroups them as (all ``Cache``s, all ``StaticCache``s)."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


def _clone_args(layer) -> dict:
    """A sibling's constructor arguments, read off a prototype encoder or
    decoder layer as the reference reads them (its ``weight_attr`` and
    ``bias_attr`` are not carried over), with the prototype's device and
    generator."""
    return dict(
        d_model=layer.norm1._normalized_shape[0],
        nhead=layer.self_attn.num_heads,
        dim_feedforward=layer.linear1.out_features,
        dropout=layer.dropout1.p,
        activation=layer.activation,
        attn_dropout=layer.self_attn.dropout,
        act_dropout=layer.dropout.p,
        normalize_before=layer.normalize_before,
        **layer._factory)


class Transformer(nn.Module):
    """The encoder-decoder Transformer: a ``TransformerEncoder`` and a
    ``TransformerDecoder`` of the given sizes (each with a final
    ``LayerNorm`` when ``normalize_before``), or ``custom_encoder`` /
    ``custom_decoder`` in their place."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu", attn_dropout=None,
                 act_dropout=None, normalize_before: bool = False,
                 weight_attr=None, bias_attr=None, custom_encoder=None,
                 custom_decoder=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, device, generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args), num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args), num_decoder_layers, norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length: int):
        """[length, length] float32: 0 on and below the diagonal, -1e9
        above, on this model's device."""
        dev = next(self.parameters()).device
        return torch.full((length, length), -1e9, device=dev).triu(1)

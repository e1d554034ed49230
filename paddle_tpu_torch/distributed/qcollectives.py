"""Quantized model-parallel collectives for the decode step (counterpart of
the reference's ``distributed/qcollectives.py``).

The mp axis of a :class:`~paddle_tpu_torch.jit.mesh.DecodeMesh` pays for
its sharded matmuls with activation reductions: one after every
row-parallel projection (attention ``out_proj``, MLP ``linear2``).  At
decode batch sizes those are pure interconnect bandwidth, and a
block-quantized all-reduce (EQuARX, arXiv:2506.17615) recovers most of it
at a small accuracy cost.

The reference runs these as ``shard_map`` collectives over named mesh
axes.  The port is single-controller: one program holds every shard's
tensors and runs the shards in mesh order, so each primitive takes the
LIST of per-shard tensors in place of a bound axis, and an exchange is a
``.to(device)`` of exactly the bytes the wire would carry (the int8
payload and its fp32 scales):

- :func:`quantize_int8` / :func:`dequantize_int8`: int8 payload with fp32
  scales, per contiguous last-axis BLOCK (default) or per last-axis
  CHANNEL.  Bit for bit the reference's (``torch.round`` rounds half to
  even, as ``jnp.round`` does).
- :func:`qpsum`: the two-stage quantized sum.  Stage 1 quantizes each
  shard's ``n`` chunks, sends chunk ``c`` to shard ``c``, dequantizes and
  sums there in fp32 in shard order; stage 2 re-quantizes the reduced
  chunk once and gathers it to every shard.  Partial sums never
  accumulate in int8.
- :func:`qall_gather`: each shard's payload crosses as int8 + scales.
- :func:`row_parallel_linear`: the seam of one row-parallel projection
  over a dp x mp grid of shard inputs, the bias added once after the
  reduce.
- :func:`collective_quant`: the ambient seam (thread-local) the decode
  sessions install around their DECODE steps only.  Outside it (prefill,
  prompt chunks, the speculative verify) the seam reduces in fp32 and
  records nothing.

Byte accounting is computed from the shapes, never measured: every figure
is the per-device wire bytes of the ring algorithm for that collective
(an all-reduce moves ``2(n-1)/n`` of the payload per device; the
two-stage quantized form moves ``2(n-1)`` chunk payloads), recorded into
the installing session's sink and surfaced per token by the pool's cost
report and ``cache_stats``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional

import torch

from ..core.errors import InvalidArgumentError

__all__ = [
    "COLLECTIVE_QUANT_MODES", "COLLECTIVE_QUANT_SCALES", "QUANT_BLOCK",
    "normalize_collective_quant", "normalize_collective_scale",
    "quantize_int8", "dequantize_int8", "qpsum", "qall_gather",
    "qpsum_wire_bytes", "psum_wire_bytes",
    "collective_quant", "active", "row_parallel_linear",
]

# "none": the fp32 reduction of the partial products; under a mesh the
#   seam still RECORDS the dense ring bytes, so the comparison column
#   exists.
# "int8": the two-stage quantized reduction at the row-parallel seams of
#   the DECODE step (prefill stays dense: its cost is amortized over the
#   whole prompt, not paid per token).
COLLECTIVE_QUANT_MODES = ("none", "int8")

# Scale granularity: "block" gives each contiguous QUANT_BLOCK-element
# chunk of the last axis one fp32 scale; "channel" gives each last-axis
# channel one fp32 scale (amax over every leading axis).
COLLECTIVE_QUANT_SCALES = ("block", "channel")

# Elements per block scale: one fp32 per 32 int8 payload bytes (12.5%).
QUANT_BLOCK = 32


def normalize_collective_quant(mode) -> str:
    """Validated mode name, or a typed error naming the choices."""
    if mode not in COLLECTIVE_QUANT_MODES:
        raise InvalidArgumentError(
            "collective_quant must be one of %s, got %r"
            % (list(COLLECTIVE_QUANT_MODES), mode))
    return mode


def normalize_collective_scale(scale_mode) -> str:
    """Validated scale-granularity name ('block' or 'channel')."""
    if scale_mode not in COLLECTIVE_QUANT_SCALES:
        raise InvalidArgumentError(
            "collective_quant_scale must be one of %s, got %r"
            % (list(COLLECTIVE_QUANT_SCALES), scale_mode))
    return scale_mode


# -- quantize / dequantize ---------------------------------------------------

def quantize_int8(x, scale_mode: str = "block", block: int = QUANT_BLOCK):
    """One shard's activation as an int8 payload + fp32 scales.

    ``block``:   ``q`` of shape ``x.shape[:-1] + (nb, block)`` (the last
    block zero-padded) and ``scale`` of ``x.shape[:-1] + (nb,)``: a
    symmetric amax per contiguous last-axis chunk.
    ``channel``: ``q`` of ``x.shape`` and ``scale`` of ``(d,)``: an amax
    per last-axis channel over all leading axes.

    A zero amax maps to scale 1, so an all-zero block round-trips to
    zeros."""
    scale_mode = normalize_collective_scale(scale_mode)
    x = torch.as_tensor(x)
    if scale_mode == "channel":
        amax = x.abs().amax(dim=tuple(range(x.ndim - 1))) if x.ndim > 1 \
            else x.abs()
        scale = torch.where(amax > 0, amax / 127.0,
                            torch.ones_like(amax)).to(torch.float32)
        q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
        return q, scale
    d = x.shape[-1]
    nb = -(-d // block)
    pad = nb * block - d
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xb = x.reshape(tuple(x.shape[:-1]) + (nb, block))
    amax = xb.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.round(xb / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, d: int, scale_mode: str = "block"):
    """fp32 reconstruction of :func:`quantize_int8`'s payload (block
    padding stripped back to the original last-axis size ``d``)."""
    scale_mode = normalize_collective_scale(scale_mode)
    q, scale = torch.as_tensor(q), torch.as_tensor(scale)
    if scale_mode == "channel":
        return q.to(torch.float32) * scale
    x = q.to(torch.float32) * scale[..., None]
    x = x.reshape(tuple(x.shape[:-2]) + (x.shape[-2] * x.shape[-1],))
    return x[..., :d]


# -- the collectives over a list of shards ------------------------------------

def qpsum(parts: List[torch.Tensor], scale_mode: str = "block",
          block: int = QUANT_BLOCK, devices=None) -> List[torch.Tensor]:
    """Quantized sum of ``parts`` (one ``[..., d]`` partial per shard, in
    shard order), two-stage so partial sums never accumulate in int8:

    1. **reduce-scatter**: split the last axis into ``n`` chunks, one per
       shard; each shard quantizes its chunks and sends chunk ``c`` (int8
       + scales) to shard ``c``, which dequantizes every arrival and sums
       them IN FP32 in shard order;
    2. **all-gather**: each shard quantizes its reduced chunk once and
       sends it to every shard, which dequantizes and reassembles the full
       last axis.

    Returns one result per shard, on ``devices[j]`` (default: each part's
    own device); every shard holds the same values.  Needs the last axis
    divisible by ``n``; the identity when ``n == 1``."""
    n = len(parts)
    devs = [p.device for p in parts] if devices is None else \
        [torch.device(dv) for dv in devices]
    if n == 1:
        return [parts[0].to(devs[0])]
    d = int(parts[0].shape[-1])
    if d % n:
        raise InvalidArgumentError(
            "qpsum needs the last axis (%d) divisible by the number of "
            "shards (%d): the reduce-scatter stage assigns one equal "
            "chunk per shard" % (d, n))
    chunk = d // n
    dtype = parts[0].dtype
    # stage 1: shard j's chunk c crosses to shard c as int8 + scales
    sent = [[quantize_int8(p[..., c * chunk:(c + 1) * chunk], scale_mode,
                           block) for c in range(n)] for p in parts]
    reduced = []
    for c in range(n):
        acc = None
        for j in range(n):
            q, s = sent[j][c]
            deq = dequantize_int8(q.to(devs[c]), s.to(devs[c]), chunk,
                                  scale_mode)
            acc = deq if acc is None else acc + deq
        # stage 2: the reduced chunk, quantized exactly once
        reduced.append(quantize_int8(acc, scale_mode, block))
    out = []
    for j in range(n):
        chunks = [dequantize_int8(q.to(devs[j]), s.to(devs[j]), chunk,
                                  scale_mode) for q, s in reduced]
        out.append(torch.cat(chunks, dim=-1).to(dtype))
    return out


def qall_gather(parts: List[torch.Tensor], axis: int = 0,
                scale_mode: str = "block", block: int = QUANT_BLOCK,
                devices=None) -> List[torch.Tensor]:
    """Quantized all-gather: each shard's payload crosses as int8 + fp32
    scales and is dequantized on arrival; every shard stacks the payloads
    along a NEW axis at ``axis`` in shard order.  Returns one result per
    shard."""
    devs = [p.device for p in parts] if devices is None else \
        [torch.device(dv) for dv in devices]
    d = int(parts[0].shape[-1])
    sent = [quantize_int8(p, scale_mode, block) for p in parts]
    out = []
    for dev in devs:
        got = [dequantize_int8(q.to(dev), s.to(dev), d, scale_mode)
               for q, s in sent]
        out.append(torch.stack(got, dim=axis).to(parts[0].dtype))
    return out


# -- wire-byte accounting (python ints, from shapes) --------------------------

def _int8_payload(shape, scale_mode: str, block: int):
    """(int8_bytes, fp32_scale_bytes) of one quantized tensor."""
    d = int(shape[-1])
    lead = 1
    for s in shape[:-1]:
        lead *= int(s)
    if scale_mode == "channel":
        return lead * d, d * 4
    nb = -(-d // block)
    return lead * nb * block, lead * nb * 4


def psum_wire_bytes(shape, n: int, itemsize: int = 4) -> int:
    """Per-device wire bytes of the dense ring all-reduce of this payload:
    ``2(n-1)/n`` of the tensor crosses each device's links (the ring's
    reduce-scatter and all-gather phases).  0 when ``n <= 1``."""
    if n <= 1:
        return 0
    elems = 1
    for s in shape:
        elems *= int(s)
    return int(round(2 * (n - 1) / n * elems * itemsize))


def qpsum_wire_bytes(shape, n: int, scale_mode: str = "block",
                     block: int = QUANT_BLOCK) -> int:
    """Per-device wire bytes of :func:`qpsum` over ``n`` shards: stage 1
    sends ``n-1`` of this shard's ``n`` quantized chunks, stage 2 sends
    the reduced chunk to the ``n-1`` peers -- ``2(n-1)`` chunk payloads,
    each an int8 body plus its fp32 scales."""
    if n <= 1:
        return 0
    d = int(shape[-1])
    if d % n:
        raise InvalidArgumentError(
            "qpsum_wire_bytes: last axis %d not divisible by n=%d"
            % (d, n))
    cq, cs = _int8_payload(tuple(shape[:-1]) + (d // n,), scale_mode, block)
    return 2 * (n - 1) * (cq + cs)


# -- the ambient decode seam -------------------------------------------------

# Thread-local: the serving engine's loop thread decodes under its own
# seam while another thread may run another session's step.
_cq_state = threading.local()


class _SeamCtx:
    """One installed seam: the mode, the mesh, the scale granularity, the
    block size and the byte sink the installing session reads back."""

    __slots__ = ("mode", "mesh", "scale_mode", "block", "sink")

    def __init__(self, mode, mesh, scale_mode, block, sink):
        self.mode = mode
        self.mesh = mesh
        self.scale_mode = scale_mode
        self.block = block
        self.sink = sink


def _cq_stack() -> list:
    stack = getattr(_cq_state, "stack", None)
    if stack is None:
        stack = _cq_state.stack = []
    return stack


def active() -> Optional[_SeamCtx]:
    """The innermost installed seam, or None outside any decode step."""
    stack = _cq_stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def collective_quant(mode, mesh, scale_mode: str = "block",
                     block: Optional[int] = None,
                     sink: Optional[dict] = None):
    """Install the collective seam for one decode step.

    The decode sessions wrap their DECODE forwards in this, never the
    prefill.  ``mode="none"`` installs a RECORDING-only seam: the
    reduction is the fp32 one, and the dense wire bytes land in ``sink``
    so the comparison column exists."""
    mode = normalize_collective_quant(mode)
    scale_mode = normalize_collective_scale(scale_mode)
    if mesh is None:
        raise InvalidArgumentError(
            "collective_quant needs a DecodeMesh: the quantized "
            "collectives reduce over its mp shards")
    stack = _cq_stack()
    if block is None:
        # resolved at install time, so tests can vary the module default
        block = QUANT_BLOCK
    stack.append(_SeamCtx(mode, mesh, scale_mode, int(block), sink))
    try:
        yield
    finally:
        stack.pop()


def _record(ctx: _SeamCtx, wire: int, dense: int, tokens: int) -> None:
    """Bookkeeping into the installing session's sink: the wire bytes of
    the collective (mode-dependent), the dense ring equivalent, and the
    per-device tokens the step commits (max across seams: every seam of
    one step sees the same count)."""
    sink = ctx.sink
    if sink is None:
        return
    sink["calls"] = sink.get("calls", 0) + 1
    sink["wire_bytes"] = sink.get("wire_bytes", 0) + int(wire)
    sink["dense_bytes"] = sink.get("dense_bytes", 0) + int(dense)
    sink["tokens"] = max(sink.get("tokens", 0), int(tokens))


def row_parallel_linear(xs, ws, b=None, ctx: Optional[_SeamCtx] = None):
    """The seam of one row-parallel projection over the mesh's shards.

    ``xs[d][m]``: dp group ``d``'s rows of mp shard ``m``'s input
    ``[B/G, ..., K/mp]`` (the merged attention heads, or the MLP hidden,
    of that shard); ``ws[m]``: the weight's row slice ``[K/mp, N]``;
    ``b``: ``[N]`` or None, added once AFTER the reduce (added to every
    partial it would count ``mp`` times).

    Each group's partial products are reduced over ``m`` and the groups
    concatenated in slot order: the global ``[B, ..., N]``.  Without a
    seam (``ctx`` None: prefill, prompt chunks, the speculative verify)
    and under mode ``"none"`` the partials sum in fp32 in shard order;
    under ``"int8"`` through :func:`qpsum`.  Under a seam the decode
    batch must divide over dp and the contraction axis over mp, and the
    per-device bytes are recorded."""
    mp = len(ws)
    bsz = sum(int(row[0].shape[0]) for row in xs)
    x0 = xs[0][0]
    if ctx is not None:
        dp = ctx.mesh.dp
        k = sum(int(x.shape[-1]) for x in xs[0])
        if bsz % dp:
            raise InvalidArgumentError(
                "collective_quant=%r: decode batch %d must be divisible by "
                "dp=%d -- the seam shards the batch axis over dp (the pool "
                "guarantees slots %% dp == 0; a bare DecodeSession needs a "
                "batch the mesh divides)" % (ctx.mode, bsz, dp))
        if k % mp:
            raise InvalidArgumentError(
                "collective_quant=%r: contraction axis %d must be divisible "
                "by mp=%d (DecodeMesh.validate_model guarantees this for "
                "the transformer seams)" % (ctx.mode, k, mp))
        n_out = int(ws[0].shape[-1])
        part_shape = (bsz // dp,) + tuple(int(s) for s in x0.shape[1:-1]) \
            + (n_out,)
        tokens = (bsz // dp) * math.prod(int(s) for s in x0.shape[1:-1])
        dense = psum_wire_bytes(part_shape, mp)
        wire = dense if ctx.mode == "none" else qpsum_wire_bytes(
            part_shape, mp, ctx.scale_mode, ctx.block)
        _record(ctx, wire, dense, tokens)
    quant = ctx is not None and ctx.mode == "int8"
    outs = []
    for row in xs:
        partials = [torch.matmul(x, w) for x, w in zip(row, ws)]
        if mp == 1:
            outs.append(partials[0])
        elif quant:
            outs.append(qpsum(partials, ctx.scale_mode, ctx.block)[0])
        else:
            acc = partials[0].float()
            for p in partials[1:]:
                acc = acc + p.float()
            outs.append(acc.to(x0.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    if b is not None:
        out = out + b
    return out

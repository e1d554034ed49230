"""The decode mesh of sharded serving (counterpart of the reference's
``jit/mesh.py``).

The pool's batched decode step is row-independent (slot ``i``'s K/V,
position and token never read slot ``j``'s), so sharding the SLOT axis
over ``dp`` is placement alone: each dp shard runs its contiguous rows.
Sharding attention heads and the MLP hidden dimension over ``mp`` splits
the weights and the cache's head axis the way tensor-parallel layers
split training matmuls, and costs one reduction after each row-parallel
projection (``distributed.qcollectives.row_parallel_linear``).

The reference places arrays with ``NamedSharding`` rules and lets the
SPMD partitioner write one program per device.  The port is
single-controller, as the reference is: ONE pool, allocator and
scheduler, and ONE step function that runs the shards in mesh order --
each dp shard's rows, and within it each mp shard's heads with its own
weight slices and its own cache tensors -- and writes the mp reduction
out at the two row-parallel seams.  Every shard of a mesh sits on one
device (``devices=["cuda:0"] * 4``, or ``["cpu"] * 4`` in the tests), so
a decode step stays one CUDA graph per shape key and ``compile_counts()``
is the unsharded pool's.  A grid that spans several devices is refused
with ``UnimplementedError``: it needs a transport between cards (one
process and one captured graph per card) that is not ported.

Axis rules (the reference's):

==========================  =======================  ==================
array                        shape                    axes
==========================  =======================  ==================
dense cache k/v              [slots, H, max_len, D]   ('dp', 'mp')
dense cache scales           [slots, H, max_len]      ('dp', 'mp')
paged pool k/v               [blocks, H, bs, D]       ('dp', 'mp')
paged pool scales            [blocks, H, bs]          ('dp', 'mp')
block table                  [slots, max_blocks]      ('dp',)
cache index                  [slots]                  ('dp',)
recurrence carry             [slots, d_state]         ('dp', None)
recurrence window bound      []                       ()
q/k/v projection weight      [d_model, H*D]           (None, 'mp')
q/k/v projection bias        [H*D]                    ('mp',)
out projection weight        [H*D, d_model]           ('mp', None)
MLP linear1 weight / bias    [d_model, ffn] / [ffn]   (None,'mp')/('mp',)
MLP linear2 weight           [ffn, d_model]           ('mp', None)
everything else              (embeddings, norms, ...)  ()  (replicated)
==========================  =======================  ==================

The cache side is ``jit.cache.CacheLayout.shard_cache`` (from each
layout's ``field_axes``); the allocator side (per-dp-shard block
partition, per-shard scratch blocks, slot -> shard mapping) lives in
``inference.GenerationPool``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.errors import InvalidArgumentError, UnimplementedError
from ..distributed.qcollectives import (normalize_collective_quant,
                                        normalize_collective_scale)
from .cache import get_layout

__all__ = ["DecodeMesh", "refresh_placed"]


def _own(t, device):
    """A contiguous copy of ``t`` on ``device`` (None stays None)."""
    if t is None:
        return None
    with torch.no_grad():
        return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _slices(lin, mp: int) -> list:
    """``[(weight, bias)]`` views of ``lin``'s ``mp`` shards: columns
    with the bias, or rows with no bias (added once after the reduce)."""
    w, b = lin.weight, lin.bias
    column = lin.__dict__["_mesh_axis"] == "column"
    n = int(w.shape[1] if column else w.shape[0]) // mp
    out = []
    for m in range(mp):
        sl = slice(m * n, (m + 1) * n)
        out.append((w[:, sl], None if b is None else b[sl]) if column
                   else (w[sl], None))
    return out


def refresh_placed(model) -> None:
    """Copy the current parameters into every mp weight slice placed
    under ``model``, in place (so a captured step keeps reading them by
    address): after ``load_state_dict``, ``convert.load_reference_params``
    or any other write to the whole weights."""
    with torch.no_grad():
        for lin in model.modules():
            for mp, held in lin.__dict__.get("_mesh_parts", {}).items():
                for (hw, hb), (w, b) in zip(held, _slices(lin, mp)):
                    if tuple(hw.shape) != tuple(w.shape):
                        raise InvalidArgumentError(
                            "a sharded weight changed shape from %s to %s: "
                            "a mesh keeps the shapes it was placed with"
                            % (tuple(hw.shape), tuple(w.shape)))
                    hw.copy_(w)
                    if hb is not None:
                        hb.copy_(b)


class DecodeMesh:
    """A ``dp`` x ``mp`` grid of devices plus the decode-path placement
    rules: ``dp`` shards the pool's SLOT axis (and the paged block pool),
    ``mp`` shards attention heads and the MLP hidden dimension.

    ``devices=None`` takes the first ``dp * mp`` CUDA cards; a grid with
    every shard on one device is named explicitly, ``devices=["cuda:0"] *
    (dp * mp)`` (or ``["cpu"] * n`` in the tests).  ``collective_quant``
    ("none" or "int8") and ``collective_quant_scale`` ("block" or
    "channel") are the mp reductions' mode, a property of the interconnect
    the mesh spans: sessions and pools inherit it and may override it.

    ``DecodeMesh(1, 1)`` is a valid one-shard mesh; ``mesh=None`` on the
    session/pool side is the unsharded path."""

    def __init__(self, dp: int = 1, mp: int = 1, devices=None,
                 collective_quant: str = "none",
                 collective_quant_scale: str = "block"):
        self.collective_quant = normalize_collective_quant(collective_quant)
        self.collective_quant_scale = normalize_collective_scale(
            collective_quant_scale)
        dp, mp = int(dp), int(mp)
        if dp < 1 or mp < 1:
            raise InvalidArgumentError(
                "DecodeMesh needs dp >= 1 and mp >= 1, got dp=%r mp=%r"
                % (dp, mp))
        need = dp * mp
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = ["cuda:%d" % i for i in range(n)]
        if len(devices) < need:
            raise InvalidArgumentError(
                "DecodeMesh(dp=%d, mp=%d) needs %d devices, have %d (to put "
                "every shard on one card, name it explicitly: "
                "devices=[\"cuda:0\"] * %d)"
                % (dp, mp, need, len(devices), need))
        devs = [torch.device(d) for d in list(devices)[:need]]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
        if len(set(devs)) > 1:
            raise UnimplementedError(
                "DecodeMesh(dp=%d, mp=%d) over %s spans more than one "
                "device: the port runs a mesh as one program on one device "
                "(devices=[\"cuda:0\"] * %d); a grid across cards needs a "
                "transport between them (one process and one captured "
                "graph per card), which ROADMAP lists as not yet ported"
                % (dp, mp, sorted({str(d) for d in devs}), need))
        self.dp = dp
        self.mp = mp
        # row-major [dp][mp], the reference's Mesh reshape
        self.devices = [devs[d * mp:(d + 1) * mp] for d in range(dp)]

    @property
    def devices_n(self) -> int:
        """Shards the mesh spans (dp * mp)."""
        return self.dp * self.mp

    @property
    def device(self) -> torch.device:
        """The one device every shard sits on."""
        return self.devices[0][0]

    def check_device(self, device) -> None:
        """Refuse a session or pool on another device than the mesh's."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != self.device:
            raise InvalidArgumentError(
                "the mesh's shards sit on %s but the session runs on %s: "
                "build the mesh with devices=[%r] * %d"
                % (self.device, dev, str(dev), self.devices_n))

    # -- cache placement -------------------------------------------------
    def cache_field_axes(self, field: str):
        """The axes one decode-cache field is placed over: the leading
        axis (slots or blocks) is 'dp', the head axis 'mp'; the table and
        index carry only the slot axis; a recurrence carry shards slots
        over 'dp' with the state vector whole, and its scalar window bound
        replicates."""
        if field in ("k", "v", "k_scale", "v_scale"):
            return ("dp", "mp")
        if field in ("table", "index"):
            return ("dp",)
        if field == "state":
            return ("dp", None)
        if field == "limit":
            return ()
        raise InvalidArgumentError(
            "unknown decode-cache field %r" % (field,))

    def build_cache(self, model, batch: int, max_len: int, dtype="float32",
                    layout: str = "dense", per_slot: bool = False,
                    block_size: int = 32, num_blocks=None) -> list:
        """The model's per-layer decode cache for ``batch`` rows, split
        over the mesh (``jit.cache.ShardedCache`` per layer).  The rows
        shard over dp when ``batch`` divides (the pool's slots always do);
        otherwise (a batch-1 prefill) they form one group, every shard of
        it mp-sharded.  ``num_blocks`` (paged pools) divides over dp: each
        shard's partition has its own scratch block 0."""
        groups = self.dp if batch % self.dp == 0 else 1
        nb = None if num_blocks is None else int(num_blocks) // groups
        caches = [model.gen_decode_cache(
            batch // groups, max_len, dtype, per_slot=per_slot,
            layout=layout, block_size=block_size, num_blocks=nb)
            for _ in range(groups)]
        return get_layout(layout).shard_cache(caches, self.mp)

    # -- weight placement ------------------------------------------------
    def validate_model(self, model) -> None:
        """mp must divide the head count and the MLP hidden size: a head
        (or hidden column) straddling two shards would not align the
        cache's head axis with the projection's columns.  dp-side
        divisibility (slots, blocks) is the pool's to check."""
        heads = getattr(model, "num_heads", None)
        if heads is not None and heads % self.mp != 0:
            raise InvalidArgumentError(
                "mp=%d must divide num_heads=%d: attention sharding is "
                "head-granular (each mp shard owns whole heads so the "
                "cache's head axis aligns with the q/k/v projection "
                "sharding)" % (self.mp, heads))
        inter = getattr(model, "intermediate_size", None)
        if inter is not None and inter % self.mp != 0:
            raise InvalidArgumentError(
                "mp=%d must divide intermediate_size=%d: the MLP hidden "
                "axis is sharded column-wise over mp" % (self.mp, inter))

    def _weight_specs(self, model) -> Dict[int, tuple]:
        """id(param) -> axes, from the model's structure.

        Walks the TransformerLM shape (encoder.layers[i].self_attn /
        linear1 / linear2); anything unmatched replicates.  Structural,
        not name-matched: a model without that shape (an SSMLM), or
        ``mp == 1``, replicates everywhere."""
        specs: Dict[int, tuple] = {}
        if self.mp == 1:
            return specs
        layers = getattr(getattr(model, "encoder", None), "layers", None)
        if layers is None:
            return specs
        for lyr in layers:
            attn = getattr(lyr, "self_attn", None)
            if attn is not None:
                for prj in (attn.q_proj, attn.k_proj, attn.v_proj):
                    specs[id(prj.weight)] = (None, "mp")
                    if getattr(prj, "bias", None) is not None:
                        specs[id(prj.bias)] = ("mp",)
                specs[id(attn.out_proj.weight)] = ("mp", None)
            l1 = getattr(lyr, "linear1", None)
            if l1 is not None:
                specs[id(l1.weight)] = (None, "mp")
                if getattr(l1, "bias", None) is not None:
                    specs[id(l1.bias)] = ("mp",)
            l2 = getattr(lyr, "linear2", None)
            if l2 is not None:
                specs[id(l2.weight)] = ("mp", None)
        return specs

    def place_weights(self, model) -> int:
        """Build (or refresh, in place) each mp shard's slices of every
        weight the axis rules shard: q/k/v and ``linear1`` by columns with
        their bias, ``out_proj`` and ``linear2`` by rows with the bias
        kept whole (the seam adds it once, after the reduce).  Each slice
        is its own contiguous tensor on the mesh's device, kept on the
        Linear beside its parameters (which stay whole: a replicated
        tensor already on the shard's device is not copied, and the
        embeddings, norms and LoRA banks are read as they are).

        A second call copies the current parameters into the existing
        slices, so a captured step that reads them by address serves the
        new weights.  Returns the number of sharded parameters (0 when
        ``mp == 1``)."""
        self.validate_model(model)
        specs = self._weight_specs(model)
        for lin in model.modules():
            axes = specs.get(id(getattr(lin, "weight", None)))
            if axes is None:
                continue
            lin.__dict__["_mesh_axis"] = "column" if axes == (None, "mp") \
                else "row"
            store = lin.__dict__.setdefault("_mesh_parts", {})
            if self.mp not in store:
                store[self.mp] = [
                    (_own(w, self.device), _own(b, self.device))
                    for w, b in _slices(lin, self.mp)]
        refresh_placed(model)
        return len(specs)

    def describe(self) -> dict:
        """JSON-safe mesh description (cache_stats, cost reports)."""
        return {"dp": self.dp, "mp": self.mp, "devices": self.devices_n,
                "collective_quant": self.collective_quant,
                "collective_quant_scale": self.collective_quant_scale}

    def __repr__(self) -> str:
        return "DecodeMesh(dp=%d, mp=%d)" % (self.dp, self.mp)

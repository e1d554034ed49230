"""The cache-layout protocol (counterpart of the reference's
``jit/cache.py``): the operations the session and the pool perform on a
decode cache, one singleton per layout.

=================  ======================================================
operation           who calls it / what it decides
=================  ======================================================
``begin_prefill``   DecodeSession.prefill, before the forward: reset the
                    session's cache for a prompt from position 0 (the
                    recurrent layout also zeroes its carry and narrows
                    its update window to the true length, so padded
                    bucket positions are identity steps)
``finalize_prefill`` DecodeSession.prefill, after the forward: commit the
                    true prompt length as the index (pad K/V past it is
                    never attended); the recurrent layout also commits
                    the carry and re-opens its window to max_len
``commit_step``     DecodeSession's decode step: commit a step's index
                    (and carry) into the session's cache
``zero_cache``      GenerationPool.reset: zero the cache in place
``insert_row``      GenerationPool admission: splice a batch-1 prefilled
                    row cache into a pool slot
``freeze_step``     GenerationPool decode step: inactive slots keep their
                    pre-step index (and, recurrent, their carry: a
                    recurrence updates every row every step)
``field_axes``      the mesh's placement axes per cache field, which
                    ``shard_cache`` reads to split a cache over a
                    ``DecodeMesh`` (below)
``cache_dtype_str`` / ``state_bytes_per_slot``  cache_stats() accounting
``fingerprint_extra`` config_fingerprint(): the layout's geometry
                    (paged: block_size/num_blocks; recurrent: d_state),
                    part of the identity a journal or PTKV file is
                    checked against, so one model class never adopts
                    another's file
=================  ======================================================

Capabilities, which the pool's guards test instead of layout names:

- ``positional``: the cache addresses individual past positions (chunked
  prefill and prefix sharing are only meaningful here);
- ``paged``: the cache is a block pool behind a per-slot table;
- ``spillable``: preempt/resume can move a slot's state through the host
  spill tier.

Every operation writes the cache's own tensors in place and returns the
same layer caches: a captured CUDA graph reads the cache by address, so a
K/V buffer, a table, an index, a carry or a window bound is never replaced
by a new tensor.

Under a ``DecodeMesh`` (``jit/mesh.py``) a layer's cache is a
:class:`ShardedCache`: ``shards[d][m]`` is shard (d, m)'s cache, the
layout's own named tuple at its local shapes, built by
:meth:`CacheLayout.shard_cache` from ``field_axes``:

- a ``("dp", "mp")`` field (K/V and their int8 scales) is one contiguous
  tensor per shard, ``[rows/dp, H/mp, ...]`` (dense) or ``[blocks/dp,
  H/mp, bs, D]`` (paged), never a head-slice view of one pool: the decode
  kernels read contiguous K/V;
- a ``("dp", None)`` field (the recurrence carry) is one tensor per dp
  shard, the same tensor for every mp shard (replicated);
- a ``("dp",)`` field (the index, the table) is ONE tensor over every row,
  ``ShardedCache.index``/``.table``, whose dp shards are contiguous row
  views of it: the pool writes a slot's row and the steps commit the index
  on the whole vector, as unsharded.  A table holds each shard's LOCAL
  block ids (block 0 of every shard is its scratch block);
- a ``()`` field (the recurrence's window bound ``limit``) is one tensor
  every shard shares.

The operations below take either form: :func:`cache_parts` yields a
layer's per-shard caches (the cache itself when unsharded) with the rows
each covers.
"""
from __future__ import annotations

import torch

from ..core.dtype import dtype_name
from ..core.errors import InvalidArgumentError
from ..distributed.sharded import (ShardedCache, cache_parts,  # noqa: F401
                                   first_part, slot_parts)

__all__ = ["CacheLayout", "DenseLayout", "PagedLayout", "RecurrentLayout",
           "CACHE_LAYOUTS", "get_layout", "ShardedCache", "cache_parts",
           "slot_parts", "first_part"]

class CacheLayout:
    """One decode-cache layout's operations and capabilities."""

    #: registry key and the ``cache_layout=`` string users pass
    name: str = "?"
    #: cache addresses individual past positions
    positional: bool = True
    #: cache is a block pool behind a per-slot table
    paged: bool = False
    #: preempt/resume can move per-slot state through the host spill tier
    spillable: bool = False

    def begin_prefill(self, cache, true_len):
        """Reset the session's cache for a prompt from position 0 (stale
        K/V past the index are never attended)."""
        for c in cache:
            c.index.zero_()
        return cache

    def finalize_prefill(self, cache, true_len, max_len, new_cache=None):
        """Commit the true prompt length after the prefill forward
        (``new_cache`` is the forward's successor cache)."""
        for c in cache:
            c.index.fill_(int(true_len))
        return cache

    def zero_cache(self, cache, max_len: int):
        """Zero every tensor of ``cache`` in place (a pool reset)."""
        for c in cache:
            for t in c:
                if t is not None:
                    t.zero_()
        return cache

    def commit_step(self, cache, new_cache):
        """Commit a decode step's successor cache into ``cache`` in place
        (the positional layouts wrote K/V in place already: only the
        index moves)."""
        for c, n in zip(cache, new_cache):
            c.index.copy_(n.index)
        return cache

    def insert_row(self, pool_cache, row_cache, slot: int, length: int,
                   blocks=None):
        raise NotImplementedError

    def freeze_step(self, new_cache, prev_cache, active):
        """Commit a step's index into ``prev_cache`` (the pool's own) in
        place: active slots take the advanced index, inactive ones keep
        theirs (only the index moves per step on the positional
        layouts)."""
        for c, old in zip(new_cache, prev_cache):
            old.index.copy_(torch.where(active, c.index, old.index))
        return prev_cache

    def field_axes(self, field: str):
        """The mesh axes one cache field is placed over."""
        if field in ("k", "v", "k_scale", "v_scale"):
            return ("dp", "mp")
        if field in ("table", "index"):
            return ("dp",)
        raise InvalidArgumentError(
            "unknown decode-cache field %r for layout %r"
            % (field, self.name))

    def shard_cache(self, groups, mp: int) -> list:
        """Per-layer :class:`ShardedCache` from ``groups``: one unsharded
        per-layer cache per dp shard (each over that shard's rows, with
        its own block ids), split over ``mp`` by :meth:`field_axes`.  An
        mp-sharded field's shards are fresh contiguous tensors (the
        group's tensor itself when ``mp == 1``); the row fields are
        concatenated over the groups into one tensor."""
        out = []
        for layer in zip(*groups):
            fields = layer[0]._fields
            per = [[{} for _ in range(mp)] for _ in layer]
            glob = {}
            split = False
            for f in fields:
                vals = [getattr(c, f) for c in layer]
                if vals[0] is None:
                    for row in per:
                        for part in row:
                            part[f] = None
                    continue
                axes = self.field_axes(f)
                if axes == ("dp", "mp"):
                    split = split or mp > 1
                    h = int(vals[0].shape[1]) // mp
                    for d, v in enumerate(vals):
                        for m in range(mp):
                            per[d][m][f] = v[:, m * h:(m + 1) * h] \
                                .contiguous()
                elif axes == ("dp",):
                    g = vals[0] if vals[0].ndim == 0 else torch.cat(vals)
                    glob[f] = g
                    for d, row in enumerate(per):
                        view = g if g.ndim == 0 else \
                            g[d * vals[0].shape[0]:(d + 1) * vals[0].shape[0]]
                        for part in row:
                            part[f] = view
                elif axes == ("dp", None):
                    for d, row in enumerate(per):
                        for part in row:
                            part[f] = vals[d]
                else:  # (): replicated
                    glob[f] = vals[0]
                    for row in per:
                        for part in row:
                            part[f] = vals[0]
            kind = type(layer[0])
            shards = []
            for row in per:
                first = kind(**row[0])
                shards.append([first] + [kind(**p) if split else first
                                         for p in row[1:]])
            index = glob["index"]
            rows = int(layer[0].index.shape[0]) if index.ndim else 1
            out.append(ShardedCache(shards, index, glob.get("table"),
                                    glob.get("limit"), rows))
        return out

    def cache_dtype_str(self, cache) -> str:
        return dtype_name(first_part(cache[0]).k.dtype)

    def fingerprint_extra(self, pool) -> dict:
        """Layout-private geometry for ``config_fingerprint()``."""
        return {}

    def state_bytes_per_slot(self, cache, slots: int, max_len: int) -> int:
        """Decode-state bytes one slot pins at full span (scales
        included): the dense-equivalent per-slot K/V slab."""
        total = 0
        for c in cache:
            for rows, part in cache_parts(c):
                # a paged block pool's per-token figure comes from one dp
                # shard's mp shards; a dense cache's rows sum over all
                if self.paged and rows.start not in (None, 0):
                    continue
                for field in ("k", "v", "k_scale", "v_scale"):
                    a = getattr(part, field, None)
                    if a is None:
                        continue
                    nbytes = a.numel() * a.element_size()
                    if self.paged:
                        tokens = int(a.shape[0]) * int(a.shape[2])
                        total += nbytes // tokens * max_len
                    else:
                        total += nbytes // int(slots)
        return total


class DenseLayout(CacheLayout):
    """Preallocated ``[slots, H, max_len, D]`` K/V per slot."""

    name = "dense"

    def insert_row(self, pool_cache, row_cache, slot: int, length: int,
                   blocks=None):
        for cp, cr in zip(pool_cache, row_cache):
            for pp, rp, local in slot_parts(cp, cr, slot):
                pp.k[local].copy_(rp.k[0])
                pp.v[local].copy_(rp.v[0])
                if pp.k_scale is not None:
                    pp.k_scale[local].copy_(rp.k_scale[0])
                    pp.v_scale[local].copy_(rp.v_scale[0])
            cp.index[slot] = int(length)
        return pool_cache


class PagedLayout(CacheLayout):
    """Fixed-size K/V blocks addressed through a per-slot table; the
    allocator (free list, refcounts, scratch block) is pool policy on
    top."""

    name = "paged"
    paged = True
    spillable = True

    def insert_row(self, pool_cache, row_cache, slot: int, length: int,
                   blocks=None):
        # The row cache is an identity-tabled batch-1 pool (row block 1+j
        # holds logical block j).  ``blocks`` are ids within the slot's dp
        # shard; entries past the reservation are that shard's scratch
        # block: those copies dump pad garbage there, in any order,
        # harmlessly.
        ids = torch.as_tensor(blocks, dtype=torch.int64,
                              device=pool_cache[0].index.device)
        for cp, cr in zip(pool_cache, row_cache):
            for pp, rp, _ in slot_parts(cp, cr, slot):
                pp.k[ids] = rp.k[1:].to(pp.k.dtype)
                pp.v[ids] = rp.v[1:].to(pp.v.dtype)
                if pp.k_scale is not None:
                    # scales splice with their blocks, so a block is never
                    # read under another request's scale
                    pp.k_scale[ids] = rp.k_scale[1:]
                    pp.v_scale[ids] = rp.v_scale[1:]
            cp.table[slot] = ids.to(cp.table.dtype)
            cp.index[slot] = int(length)
        return pool_cache

    def fingerprint_extra(self, pool) -> dict:
        return {"block_size": pool._block_size,
                "num_blocks": pool._num_blocks}


class RecurrentLayout(CacheLayout):
    """The constant-size recurrence carry (``nn.ssm.RecurrentDecodeCache``:
    ``state [B, d_state]``, ``index`` and a scalar ``limit`` per layer):
    O(1) state per token, no table, no paging, no prefix index.

    ``limit`` is the pad discipline: the prefill narrows the update window
    to the true prompt length (positions past it are identity steps) and
    finalize re-opens it to ``max_len``, both with ``fill_``, since the
    captured decode step reads ``limit``, ``index`` and ``state`` by
    address."""

    name = "recurrent"
    positional = False
    spillable = True

    def begin_prefill(self, cache, true_len):
        for c in cache:
            for _, part in cache_parts(c):
                part.state.zero_()
            c.index.zero_()
            c.limit.fill_(int(true_len))
        return cache

    def finalize_prefill(self, cache, true_len, max_len, new_cache=None):
        for c, n in zip(cache, new_cache):
            for (_, part), (_, new) in zip(cache_parts(c), cache_parts(n)):
                part.state.copy_(new.state)
            c.index.fill_(int(true_len))
            c.limit.fill_(int(max_len))
        return cache

    def zero_cache(self, cache, max_len: int):
        # the window stays open: a pool decodes at any position
        for c in cache:
            for _, part in cache_parts(c):
                part.state.zero_()
            c.index.zero_()
            c.limit.fill_(int(max_len))
        return cache

    def commit_step(self, cache, new_cache):
        for c, n in zip(cache, new_cache):
            for (_, part), (_, new) in zip(cache_parts(c), cache_parts(n)):
                part.state.copy_(new.state)
            c.index.copy_(n.index)
        return cache

    def insert_row(self, pool_cache, row_cache, slot: int, length: int,
                   blocks=None):
        for cp, cr in zip(pool_cache, row_cache):
            for pp, rp, local in slot_parts(cp, cr, slot):
                pp.state[local].copy_(rp.state[0])
            cp.index[slot] = int(length)
        return pool_cache

    def freeze_step(self, new_cache, prev_cache, active):
        # the recurrence updated EVERY row's carry this step; an inactive
        # slot's update folded its stale token into the carry a resumed
        # or refilled request would inherit: restore the carry too
        for c, old in zip(new_cache, prev_cache):
            for (rows, new), (_, part) in zip(cache_parts(c),
                                              cache_parts(old)):
                part.state.copy_(torch.where(active[rows][:, None],
                                             new.state, part.state))
            old.index.copy_(torch.where(active, c.index, old.index))
        return prev_cache

    def field_axes(self, field: str):
        if field == "state":
            # slots over dp; the state vector stays whole per slot
            return ("dp", None)
        if field == "index":
            return ("dp",)
        if field == "limit":
            return ()  # the scalar window bound: replicated
        raise InvalidArgumentError(
            "unknown decode-cache field %r for layout 'recurrent'"
            % (field,))

    def cache_dtype_str(self, cache) -> str:
        return dtype_name(first_part(cache[0]).state.dtype)

    def state_bytes_per_slot(self, cache, slots: int, max_len: int) -> int:
        # constant in max_len: the model class's point
        return sum(part.state.numel() * part.state.element_size()
                   for c in cache for _, part in cache_parts(c)) // int(slots)

    def fingerprint_extra(self, pool) -> dict:
        return {"d_state": int(first_part(pool._cache[0]).state.shape[-1])}


CACHE_LAYOUTS = {layout.name: layout
                 for layout in (DenseLayout(), PagedLayout(),
                                RecurrentLayout())}


def get_layout(name: str) -> CacheLayout:
    """The registered layout singleton for ``name``, or a typed error
    naming the registry."""
    layout = CACHE_LAYOUTS.get(name)
    if layout is None:
        raise InvalidArgumentError(
            "cache_layout must be one of %s, got %r"
            % (sorted(CACHE_LAYOUTS), name))
    return layout

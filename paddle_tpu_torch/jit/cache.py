"""The cache-layout protocol (counterpart of the reference's
``jit/cache.py``): the operations the session and the pool perform on a
decode cache, one singleton per layout.

=================  ======================================================
operation           who calls it / what it decides
=================  ======================================================
``finalize_prefill`` DecodeSession.prefill, after the forward: commit the
                    true prompt length as the index (pad K/V past it is
                    never attended)
``insert_row``      GenerationPool admission: splice a batch-1 prefilled
                    row cache into a pool slot
``freeze_step``     GenerationPool decode step: inactive slots keep their
                    pre-step index
``cache_dtype_str`` / ``state_bytes_per_slot``  cache_stats() accounting
=================  ======================================================

Capabilities, which the pool's guards test instead of layout names:

- ``positional``: the cache addresses individual past positions (chunked
  prefill and prefix sharing are only meaningful here);
- ``paged``: the cache is a block pool behind a per-slot table;
- ``spillable``: preempt/resume can move a slot's state through the host
  spill tier.

Every operation writes the cache's own tensors in place and returns the
same layer caches: a captured CUDA graph reads the cache by address, so a
K/V buffer, a table or an index is never replaced by a new tensor.  The recurrent
layout of the reference (the only one that is not positional), and with it
the ``begin_prefill`` hook, waits for the port of ``nn/ssm.py``.
"""
from __future__ import annotations

import torch

from ..core.dtype import dtype_name
from ..core.errors import InvalidArgumentError

__all__ = ["CacheLayout", "DenseLayout", "PagedLayout", "CACHE_LAYOUTS",
           "get_layout"]


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

    def finalize_prefill(self, cache, true_len, max_len):
        """Commit the true prompt length after the prefill forward."""
        for c in cache:
            c.index.fill_(int(true_len))
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

    def cache_dtype_str(self, cache) -> str:
        return dtype_name(cache[0].k.dtype)

    def state_bytes_per_slot(self, cache, slots: int, max_len: int) -> int:
        """Decode-state bytes one slot pins at full span (scales
        included): the dense-equivalent per-slot K/V slab."""
        total = 0
        for c in cache:
            for field in ("k", "v", "k_scale", "v_scale"):
                a = getattr(c, field, None)
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
            cp.k[slot].copy_(cr.k[0])
            cp.v[slot].copy_(cr.v[0])
            if cp.k_scale is not None:
                cp.k_scale[slot].copy_(cr.k_scale[0])
                cp.v_scale[slot].copy_(cr.v_scale[0])
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
        # holds logical block j).  Entries of ``blocks`` past the
        # reservation are the scratch block: those copies dump pad garbage
        # there, in any order, harmlessly.
        ids = torch.as_tensor(blocks, dtype=torch.int64,
                              device=pool_cache[0].k.device)
        for cp, cr in zip(pool_cache, row_cache):
            cp.k[ids] = cr.k[1:].to(cp.k.dtype)
            cp.v[ids] = cr.v[1:].to(cp.v.dtype)
            if cp.k_scale is not None:
                # scales splice with their blocks, so a block is never read
                # under another request's scale
                cp.k_scale[ids] = cr.k_scale[1:]
                cp.v_scale[ids] = cr.v_scale[1:]
            cp.table[slot] = ids.to(cp.table.dtype)
            cp.index[slot] = int(length)
        return pool_cache


CACHE_LAYOUTS = {layout.name: layout
                 for layout in (DenseLayout(), PagedLayout())}


def get_layout(name: str) -> CacheLayout:
    """The registered layout singleton for ``name``, or a typed error
    naming the registry."""
    layout = CACHE_LAYOUTS.get(name)
    if layout is None:
        raise InvalidArgumentError(
            "cache_layout must be one of %s, got %r%s"
            % (sorted(CACHE_LAYOUTS), name,
               " (the recurrent layout is not ported yet)"
               if name == "recurrent" else ""))
    return layout

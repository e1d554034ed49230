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

Torch tensors are written in place, so ``insert_row`` copies into the
pool's own buffers and returns tuples that share them.  The recurrent
layout of the reference, and with it the ``begin_prefill`` hook and the
``positional``/``spillable`` flags that only it needs, waits for the port
of ``nn/ssm.py``.
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
    #: cache is a block pool behind a per-slot table
    paged: bool = False

    def finalize_prefill(self, cache, true_len, max_len):
        """Commit the true prompt length after the prefill forward."""
        return [c._replace(index=torch.full_like(c.index, int(true_len)))
                for c in cache]

    def insert_row(self, pool_cache, row_cache, slot: int, length: int,
                   blocks=None):
        raise NotImplementedError

    def freeze_step(self, new_cache, prev_cache, active):
        """Inactive slots keep their pre-step index (only the index moves
        per step on the positional layouts)."""
        return [c._replace(index=torch.where(active, c.index, old.index))
                for c, old in zip(new_cache, prev_cache)]

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
        out = []
        for cp, cr in zip(pool_cache, row_cache):
            cp.k[slot].copy_(cr.k[0])
            cp.v[slot].copy_(cr.v[0])
            if cp.k_scale is not None:
                cp.k_scale[slot].copy_(cr.k_scale[0])
                cp.v_scale[slot].copy_(cr.v_scale[0])
            index = cp.index.clone()
            index[slot] = int(length)
            out.append(cp._replace(index=index))
        return out


class PagedLayout(CacheLayout):
    """Fixed-size K/V blocks addressed through a per-slot table; the
    allocator (free list, refcounts, scratch block) is pool policy on
    top."""

    name = "paged"
    paged = True

    def insert_row(self, pool_cache, row_cache, slot: int, length: int,
                   blocks=None):
        # The row cache is an identity-tabled batch-1 pool (row block 1+j
        # holds logical block j).  Entries of ``blocks`` past the
        # reservation are the scratch block: those copies dump pad garbage
        # there, in any order, harmlessly.
        ids = torch.as_tensor(blocks, dtype=torch.int64,
                              device=pool_cache[0].k.device)
        out = []
        for cp, cr in zip(pool_cache, row_cache):
            cp.k[ids] = cr.k[1:].to(cp.k.dtype)
            cp.v[ids] = cr.v[1:].to(cp.v.dtype)
            if cp.k_scale is not None:
                # scales splice with their blocks, so a block is never read
                # under another request's scale
                cp.k_scale[ids] = cr.k_scale[1:]
                cp.v_scale[ids] = cr.v_scale[1:]
            table = cp.table.clone()
            table[slot] = ids.to(table.dtype)
            index = cp.index.clone()
            index[slot] = int(length)
            out.append(cp._replace(table=table, index=index))
        return out


CACHE_LAYOUTS = {layout.name: layout
                 for layout in (DenseLayout(), PagedLayout())}


def get_layout(name: str) -> CacheLayout:
    """The registered layout singleton for ``name``, or a typed error
    naming the registry."""
    layout = CACHE_LAYOUTS.get(name)
    if layout is None:
        raise InvalidArgumentError(
            "cache_layout must be one of %s, got %r"
            % (sorted(CACHE_LAYOUTS), name))
    return layout

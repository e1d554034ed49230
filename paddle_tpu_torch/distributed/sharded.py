"""Shard containers of the decode mesh (``jit/mesh.py``): a layer's decode
cache laid out over a dp x mp grid, the helpers the cache layouts and the
pool use to reach its shards, and the reader of a Linear's mp weight
slices.

They live outside ``jit`` because the layers (``nn``) read them and
``jit`` imports ``nn``; they import nothing of the port but its errors.
"""
from __future__ import annotations

from ..core.errors import InvalidArgumentError

__all__ = ["ShardedCache", "cache_parts", "first_part", "slot_parts",
           "is_sharded", "mesh_parts"]

# the row-leading bookkeeping fields: one tensor over every row, each dp
# shard a row view of it
_GLOBAL_FIELDS = ("index", "table", "limit")


class ShardedCache:
    """One layer's decode cache laid out over a ``DecodeMesh``.

    ``shards[d][m]`` is shard (d, m)'s cache (the layout's named tuple at
    its local shapes); ``index``, ``table`` (paged) and ``limit``
    (recurrent) are the whole-batch tensors whose dp shards are row views
    (a scalar index or ``limit`` is shared).  ``rows`` is the rows of one
    dp shard.  Iteration yields every distinct tensor once (the address
    set a captured step reads)."""

    __slots__ = ("shards", "index", "table", "limit", "rows")

    def __init__(self, shards, index, table=None, limit=None, rows=1):
        self.shards = tuple(tuple(row) for row in shards)
        self.index = index
        self.table = table
        self.limit = limit
        self.rows = int(rows)

    @property
    def dp(self) -> int:
        return len(self.shards)

    @property
    def mp(self) -> int:
        return len(self.shards[0])

    def parts(self) -> list:
        """``[(rows, shard cache)]`` for every distinct shard cache: the
        global row slice it covers and the named tuple."""
        out, seen = [], set()
        for d, row in enumerate(self.shards):
            rows = slice(d * self.rows, (d + 1) * self.rows)
            for part in row:
                if id(part) not in seen:
                    seen.add(id(part))
                    out.append((rows, part))
        return out

    def __iter__(self):
        seen = set()
        for t in (self.index, self.table, self.limit):
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                yield t
        for _, part in self.parts():
            for name, t in zip(part._fields, part):
                if t is not None and name not in _GLOBAL_FIELDS \
                        and id(t) not in seen:
                    seen.add(id(t))
                    yield t

    def _views(self, t, d):
        if t is None or t.ndim == 0:
            return t
        return t[d * self.rows:(d + 1) * self.rows]

    def _replace(self, **upd) -> "ShardedCache":
        """A new ShardedCache with the whole-batch ``index``/``table``
        replaced (every shard's row views rebuilt over them); the shard
        tensors are shared."""
        bad = set(upd) - {"index", "table"}
        if bad:
            raise InvalidArgumentError(
                "ShardedCache._replace takes index/table only, got %s"
                % sorted(bad))
        index = upd.get("index", self.index)
        table = upd.get("table", self.table)
        rows = self.rows
        if "index" in upd and index.ndim:
            rows = index.shape[0] // self.dp
        elif "table" in upd and table is not None:
            rows = table.shape[0] // self.dp
        new = ShardedCache((), index, table, self.limit, rows)
        shards = []
        for d, row in enumerate(self.shards):
            fields = {}
            if "index" in upd:
                fields["index"] = new._views(index, d)
            if "table" in upd:
                fields["table"] = new._views(table, d)
            first = row[0]._replace(**fields)
            shards.append([first if part is row[0] else
                           part._replace(**fields) for part in row])
        new.shards = tuple(tuple(r) for r in shards)
        return new

    def with_part_field(self, name: str, per_dp) -> "ShardedCache":
        """A new ShardedCache whose dp shard ``d`` holds ``per_dp[d]`` as
        field ``name``, a field mp replicates (the recurrence carry: every
        mp shard of a row is the same cache)."""
        new = ShardedCache((), self.index, self.table, self.limit,
                           self.rows)
        new.shards = tuple((row[0]._replace(**{name: per_dp[d]}),) * len(row)
                           for d, row in enumerate(self.shards))
        return new


def cache_parts(c) -> list:
    """``[(rows, shard cache)]`` of one layer's cache: every distinct
    shard with the global rows it covers, or ``[(slice(None), c)]`` for an
    unsharded cache."""
    if isinstance(c, ShardedCache):
        return c.parts()
    return [(slice(None), c)]


def first_part(c):
    """Shard (0, 0)'s cache, or ``c`` when unsharded (for dtypes and the
    per-shard shapes)."""
    return c.shards[0][0] if isinstance(c, ShardedCache) else c


def slot_parts(pool_c, row_c, slot: int) -> list:
    """``[(pool shard, row shard, local slot)]``: the shard caches of
    ``slot``'s dp shard in a pool layer ``pool_c``, beside the matching mp
    shard of a batch-1 row layer ``row_c`` (shard (0, m)), and the slot's
    row within its dp shard.  Unsharded: ``[(pool_c, row_c, slot)]``."""
    if not isinstance(pool_c, ShardedCache):
        return [(pool_c, row_c, slot)]
    d, local = divmod(int(slot), pool_c.rows)
    out, seen = [], set()
    for m, part in enumerate(pool_c.shards[d]):
        if id(part) not in seen:
            seen.add(id(part))
            out.append((part, row_c.shards[0][m], local))
    return out


def is_sharded(cache) -> bool:
    """Whether ``cache`` (one layer's) is laid out over a mesh."""
    return isinstance(cache, ShardedCache)


def mesh_parts(linear, mp: int) -> list:
    """``[(weight, bias)]`` of ``linear``'s ``mp`` shards as
    ``DecodeMesh.place_weights`` built them (``mp == 1``: the module's own
    tensors)."""
    if mp == 1:
        return [(linear.weight, linear.bias)]
    parts = linear.__dict__.get("_mesh_parts", {}).get(mp)
    if parts is None:
        raise InvalidArgumentError(
            "this model's weights were not placed on an mp=%d mesh: build "
            "the session or pool with mesh=DecodeMesh(dp, %d) (it places "
            "them), or call mesh.place_weights(model)" % (mp, mp))
    return parts

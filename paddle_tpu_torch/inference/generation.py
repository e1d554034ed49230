"""Slot-based continuous batching over the KV-cached decode engine
(counterpart of the reference's ``inference/generation.py``).

``GenerationPool`` packs concurrent requests into N cache SLOTS that share
one batched decode step (the slot-batched cache whose index is a per-row
``[slots]`` vector).  Per ``step()``:

1. free slots are refilled: queued requests and preempted (spilled) ones
   compete in one ordering, ``(priority desc, deadline asc, arrival)``,
   with an optional per-tenant slot cap.  A queued request either runs a
   bucketed batch-1 prefill (``DecodeSession.prefill``) whose row cache is
   spliced into the slot, or, under chunked prefill, is only admitted: its
   table row is mapped and its prompt runs in later chunks; a spilled
   request resumes with its K/V restored;
2. under chunked prefill, ONE fixed-shape ``[C]`` chunk of the oldest
   prefilling slot's prompt runs through that slot's table row;
3. one batched decode step advances every active slot a token; inactive
   slots (free or still prefilling) are masked -- their index does not
   advance, and on the paged layout their table rows point at the scratch
   block for the step, so a stale write can never land in a block another
   request owns;
4. the sampled ids (the one host download per step) are appended per
   request; rows that hit EOS or their budget release the slot.

The steps follow the reference's compiled-step protocol.  Each is an
:class:`~paddle_tpu_torch.jit.aot.AotFunction` keyed as the reference
keys its executables: ``"pool_decode"`` by the token vector and
``"prefill_chunk"`` by the ``[C]`` chunk, both captured as CUDA graphs on
the card, and ``"slot_insert"``/``"slot_admit"``, which run eagerly;
``compile_counts()`` reports them beside the session's.  The decode step's
inputs -- the token, the active mask, the per-row sampling config and the
draw counter -- live in static device buffers, rewritten by one upload
only when slot membership changes (admit, finish, cancel, preempt, resume,
reset); the step writes the sampled token and advances the draw counter
of active rows on the device, and the per-tick host work is the one
download of the token vector and the delivery.  The cache's tensors never
move: every write to them, a reset's included, is in place.

``cache_layout="paged"`` keeps K/V in a global pool of fixed-size blocks
behind a ``[slots, max_blocks]`` table, with a host-side allocator: block
0 is the reserved scratch block and is never handed out; a request
reserves its worst-case span at admission (so decode never runs out of
blocks) and the chosen candidate waits when blocks are scarce; blocks
carry refcounts and return to the free list when their count reaches 0.
Three paged-only features ride that allocator:

- ``prefill_chunk_tokens=C``: at most C tokens of prompt work per tick,
  written straight into the pool through the slot's table row (a batch-1
  view of the global cache), so a long prompt never stalls the resident
  requests' decode; only the final chunk's sample (the first token) is
  downloaded.  No bucket is needed.
- ``prefix_sharing=True`` (needs chunking): full prompt blocks enter a
  chain-hashed, token-verified index as chunks complete them; a new
  request maps the longest resident matching prefix into its table row
  read-only (refcounts bumped) and prefills only the rest.  Writes land at
  positions past the matched prefix only, in the request's own blocks.
- ``preempt(rid)`` spills a decoding request: its written blocks are
  downloaded in one batched copy (int8 scales with them), blocks it owned
  alone stay on the device in a reclaimable SPILLED tier, shared blocks
  stay with their other owners and unwritten ones return to the free
  list (``free + resident + spilled + scratch == num_blocks``).  Resume
  re-maps the device copies that survived and uploads from the host only
  the blocks that were reclaimed meanwhile; greedy decode continues
  byte-identically.  ``spill_tier="host"`` keeps the download in process
  memory; ``spill_tier="disk"`` writes it to a PTKV file under
  ``spill_dir`` (``serving/transfer.py``: tmp file, fsync, atomic
  rename), which survives a crash: a second engine's ``adopt_spill``
  parks the request from the file and resumes it without a re-prefill.
  ``export_kv`` hands a finished prefill off through the same format
  (``prefill_only=True`` parks requests after their first token).

Subclass hooks: ``_on_activated`` (a slot starts decoding; the
speculative pool prefills its draft there), ``_preempt_guard`` and
``_adopt_guard`` (vetoes), ``_on_resumed`` (a parked request decodes
again).  ``config_fingerprint()`` is the identity a journal or PTKV file
is checked against; it names nothing about the backend, so files cross
between this package and the reference at a matching configuration.

The serving layer's seams ride the tick: ``pool.step``,
``pool.prefill``, ``pool.alloc_blocks``, ``weights.refresh``,
``spill.write`` and ``xfer.write`` fire the fault plane
(``serving/faults.py``), and with a tracer installed the tick phases are
spans (``serving/trace.py``); with neither installed each is
one module-attribute test.

Multi-LoRA (``nn.lora``): the pool reads the model's bank geometry at
construction (``lora_config``); a request's ``adapter`` id is checked at
submit and at adoption and rides its record through preemption, spill,
resume, export and the journal.  The decode step's adapter ids are one
more field of its static inputs (the same single upload), made ambient
around the forward; the chunk step and the bucketed prefill take the
request's id the same way.  ``load_adapter``/``unload_adapter`` write bank
rows in place, so no captured graph moves.

``cache_layout="recurrent"`` serves constant-state models
(``nn.ssm.SSMLM``): a slot's decode state is one carry per layer, so
preemption downloads the slot's state rows in one copy and resume uploads
them into any free slot (no allocator); the PTKV payload is the whole
rows.  Chunked prefill, prefix sharing and the prefill tier need a
positional cache and are refused with typed errors naming the layout.

``mesh=DecodeMesh(dp, mp)`` shards the pool (``jit/mesh.py``): the slot
axis splits into ``dp`` equal contiguous shards (slot ``g`` is local slot
``g % (slots/dp)`` of shard ``g // (slots/dp)``), and on the paged layout
so does the block pool: ``num_blocks/dp`` blocks per shard, the first of
each its scratch block, one free list per shard.  A request's blocks all
live in its slot's shard (the admission picks the shard; a resume is
pinned to the shard it was preempted from), so no step reads K/V across
shards.  The allocator keeps global block ids, the tables hold each
shard's local ids.  ``cache_stats()["per_shard"]`` restates the
partition per shard.  The decode step's mp reductions take
``collective_quant`` (``distributed.qcollectives``); the prompt chunks
reduce in fp32.
"""
from __future__ import annotations

import collections
import gc
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.errors import (AlreadyExistsError, InvalidArgumentError,
                           NotFoundError, PreconditionNotMetError)
from ..jit.aot import (CAPTURE_GUARD, AotFunction, StaticInputs, cache_tensors,
                       kv_arg_bytes, module_tensors, shape_key)
from ..jit.cache import ShardedCache, cache_parts, first_part, get_layout
from ..jit.decode import (DecodeSession, check_sampling, classify_finish,
                          make_sampling_state, sample_logits_data,
                          step_buffers)
from ..nn import lora as _lora_mod

__all__ = ["GenerationPool", "kv_reachable_bytes", "DuplicateRequestError"]

# the serving fault plane and trace plane, bound lazily: the serving
# package imports this module, so importing it here at module scope would
# be circular.  After the first call each is one module-attribute read
# that does nothing while no plane or tracer is installed
_faults = None
_trace = None
_transfer = None


def _fire(point: str) -> None:
    global _faults
    if _faults is None:
        from ..serving import faults as _faults_mod
        _faults = _faults_mod
    _faults.fire(point)


def _trace_active():
    global _trace
    if _trace is None:
        from ..serving import trace as _trace_mod
        _trace = _trace_mod
    return _trace.active()


def _transfer_mod():
    global _transfer
    if _transfer is None:
        from ..serving import transfer as _transfer_module
        _transfer = _transfer_module
    return _transfer


def _device_edge(tr) -> None:
    """Under a deep-timing tracer, end the current span at the device
    edge: wait for the work queued on the current CUDA stream."""
    if tr.deep and torch.cuda.is_available():
        torch.cuda.current_stream().synchronize()


class DuplicateRequestError(AlreadyExistsError, InvalidArgumentError):
    """``submit()`` reused a request_id that is still queued, active, or
    awaiting collection."""


def kv_reachable_bytes(tokens, max_len: int, num_layers: int,
                       num_heads: int, head_dim: int, layout: str = "dense",
                       block_size: int = 32, dtype="float32") -> int:
    """KV-cache bytes a decode step can read for the given per-row token
    counts: dense reaches ``rows * max_len`` positions, paged only the
    mapped blocks (capped at max_len per row).  int8 counts its fp32
    scales too."""
    toks = [int(t) for t in
            (tokens if hasattr(tokens, "__len__") else [tokens])]
    dt = convert_dtype(dtype)
    itemsize = torch.empty((), dtype=dt).element_size()
    scale_bytes = 4 if dt == torch.int8 else 0
    per_token = 2 * num_layers * num_heads * (head_dim * itemsize
                                              + scale_bytes)
    if layout == "dense":
        return len(toks) * int(max_len) * per_token
    if layout != "paged":
        raise InvalidArgumentError(
            "layout must be 'dense' or 'paged', got %r" % (layout,))
    bs = int(block_size)
    return sum(min(-(-t // bs) * bs, int(max_len)) for t in toks) * per_token


def _gather_packed(tensors, idx):
    """``t.index_select(0, idx)`` of every tensor, written straight into
    ONE flat uint8 buffer on their device (each part at an 8-byte aligned
    offset, so it views back as its dtype): one copy of the selected rows,
    which then cross between host and device in one transfer.  Returns the
    buffer and the ``(offset, dtype, shape)`` specs :func:`_unpack` reads
    it with."""
    specs, off = [], 0
    for t in tensors:
        shape = (idx.numel(),) + tuple(t.shape[1:])
        specs.append((off, t.dtype, shape))
        off += -(-math.prod(shape) * t.element_size() // 8) * 8
    flat = torch.empty(off, dtype=torch.uint8, device=tensors[0].device)
    for t, part in zip(tensors, _unpack(flat, specs)):
        torch.index_select(t, 0, idx, out=part)
    return flat, specs


def _unpack(flat, specs):
    out = []
    for off, dt, shape in specs:
        n = math.prod(shape) * torch.empty((), dtype=dt).element_size()
        out.append(flat[off:off + n].view(dt).reshape(shape))
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _cache_fields(c):
    """A layer cache's spilled tensors: K, V and, for int8, their scales
    (they move with their blocks), or a recurrent layer's carry."""
    if hasattr(c, "state"):
        return (c.state,)
    return (c.k, c.v) + ((c.k_scale, c.v_scale)
                         if c.k_scale is not None else ())


def _shard_fields(c, shard: int) -> list:
    """The spilled fields of dp shard ``shard`` of one layer's cache: per
    field, the tensors holding it -- its mp shards, split on the head axis
    (one tensor for a carry, which mp replicates, or when unsharded)."""
    if not isinstance(c, ShardedCache):
        return [[f] for f in _cache_fields(c)]
    parts = list({id(p): p for p in c.shards[shard]}.values())
    return [list(fs) for fs in zip(*(_cache_fields(p) for p in parts))]


# per-request sampling config, resolved at submit: ``seed`` is always a
# concrete int, so the request's stream is a pure function of itself.
# ``draws`` is the stream offset at this submission: 0 for a fresh
# request, the committed token count for a prompt+committed resubmission,
# so its first draw lands where the interrupted run would have drawn
_SamplingConfig = collections.namedtuple(
    "_SamplingConfig", ["temperature", "top_k", "top_p", "seed", "draws"],
    defaults=(0,))

# scheduling metadata rides every queued request: ``priority`` (higher
# admits first), ``tenant`` (fairness-cap key), ``deadline`` (a number on
# the caller's clock, only ever compared; None sorts last) and ``seq``
# (arrival order, the FIFO tie-break); ``adapter`` is the request's LoRA
# bank row (0 = the base model)
_Request = collections.namedtuple(
    "_Request", ["rid", "ids", "max_new_tokens", "priority", "tenant",
                 "deadline", "seq", "sampling", "adapter"],
    defaults=(0,))


class _OfRequest:
    """A request's state in one stage (prefilling, decoding, spilled).  It
    holds the submitted ``_Request`` as ``req`` and reads the prompt and
    the scheduling metadata through it; no stage copies them."""

    __slots__ = ("req",)

    @property
    def rid(self):
        return self.req.rid


class _SlotState(_OfRequest):
    """One actively decoding slot.  ``req.ids`` (the prompt) is kept so
    that preemption can spill and resume it: the cache index to restore is
    ``len(req.ids) + len(tokens) - 1`` and the next draw is
    ``req.sampling.draws + len(tokens)``."""

    __slots__ = ("tokens", "remaining")

    def __init__(self, req: _Request, tokens, remaining: int):
        self.req = req
        self.tokens = tokens
        self.remaining = remaining


class _PrefillState(_OfRequest):
    """A slot admitted under chunked prefill whose prompt is still being
    processed: ``pos`` is the next absolute position to run (a shared
    prefix was mapped at admission and is never run again).
    ``indexed``/``chain_key`` track incremental prefix indexing: a full
    block enters the index as soon as a chunk completes it."""

    __slots__ = ("pos", "indexed", "chain_key")

    def __init__(self, req: _Request, pos: int, matched_blocks: int = 0,
                 chain_key=None):
        self.req = req
        self.pos = pos
        # matched blocks are already indexed: indexing resumes after them,
        # continuing their hash chain
        self.indexed = matched_blocks
        self.chain_key = chain_key


class _SpillState(_OfRequest):
    """One preempted request parked in the host spill tier.

    ``host`` holds the victim's WRITTEN blocks (per layer, a tuple of CPU
    tensors ``[written, ...block shape]``: K, V and, for int8, their
    scales).  ``dev_blocks[j]`` is the device block that still holds block
    ``j`` (resume re-maps it with no copy), or None once it was reclaimed
    or when it was shared at preempt time (the host copy is then the
    source).  ``total_blocks`` is the admission-time reservation,
    re-acquired in full at resume.  On the disk tier ``host`` is None and
    ``host_path`` names the PTKV file holding the written blocks."""

    __slots__ = ("tokens", "remaining", "total_blocks", "written",
                 "dev_blocks", "host", "host_bytes", "host_path", "shard")

    def __init__(self, st: _SlotState, total_blocks: int, written: int,
                 host, host_bytes: int, shard: int = 0):
        self.req = st.req
        # the dp shard its device copies live in (a resume is pinned there)
        self.shard = shard
        self.tokens = st.tokens
        self.remaining = st.remaining
        self.total_blocks = total_blocks
        self.written = written
        self.dev_blocks = [None] * written
        self.host = host
        self.host_bytes = host_bytes
        self.host_path = None


class _PrefixEntry:
    """One prefix-index chain link.  ``tokens`` (the exact ids the block
    covers) and ``parent_key`` guard against hash collisions: a match must
    compare equal on both before its K/V are shared.  ``blocks`` lists
    every resident block holding this content (identical prompts that
    prefilled concurrently each wrote their own bit-identical copy); a
    block leaves the list when its refcount reaches 0."""

    __slots__ = ("blocks", "tokens", "parent_key")

    def __init__(self, block: int, tokens: tuple, parent_key):
        self.blocks = [block]
        self.tokens = tokens
        self.parent_key = parent_key


class GenerationPool:
    """Continuous batching: submit prompts, drain one decode step at a
    time, collect per-request token arrays.  ``device=None`` is ``cuda``.
    """

    def __init__(self, model, max_len: int, slots: int = 4,
                 buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: Optional[int] = None,
                 cache_dtype="float32", seed: int = 0,
                 cache_layout: str = "dense", block_size: int = 32,
                 num_blocks: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_sharing: bool = False,
                 tenant_slot_cap: Optional[int] = None,
                 route: str = "auto", spill_tier: str = "host",
                 spill_dir: Optional[str] = None,
                 prefill_only: bool = False, device=None, mesh=None,
                 collective_quant: Optional[str] = None,
                 collective_quant_scale: Optional[str] = None):
        if slots < 1:
            raise InvalidArgumentError("GenerationPool needs slots >= 1")
        if mesh is not None:
            from ..jit.mesh import DecodeMesh

            if not isinstance(mesh, DecodeMesh):
                raise InvalidArgumentError(
                    "mesh must be a jit.mesh.DecodeMesh (or None for the "
                    "unsharded pool), got %r" % (type(mesh).__name__,))
        self._mesh = mesh
        self._dp = 1 if mesh is None else mesh.dp
        if slots % self._dp != 0:
            raise InvalidArgumentError(
                "dp=%d must divide slots=%d: the slot axis is sharded in "
                "equal contiguous chunks over the dp mesh axis, and the "
                "allocator maps logical slot g to (shard g // (slots/dp), "
                "local slot g %% (slots/dp))" % (self._dp, slots))
        self._slots_per_shard = int(slots) // self._dp
        self._mp = 1 if mesh is None else mesh.mp
        if tenant_slot_cap is not None and int(tenant_slot_cap) < 1:
            raise InvalidArgumentError(
                "tenant_slot_cap must be >= 1 slots per tenant (or None "
                "for no fairness cap), got %r" % (tenant_slot_cap,))
        # the layout first, so every guard below tests its capabilities
        self._layout = get_layout(cache_layout)
        if prefill_chunk_tokens is not None and not self._layout.paged:
            # the chunk path writes through the block table; the dense
            # layout keeps its one-shot bucketed prefill
            if not self._layout.positional:
                raise InvalidArgumentError(
                    "prefill_chunk_tokens cannot apply to cache_layout="
                    "'recurrent': a recurrence has no positional K/V to "
                    "chunk into -- its whole prefill is one bucketed "
                    "scan")
            raise InvalidArgumentError(
                "prefill_chunk_tokens is a paged-cache knob (chunk writes "
                "route through the block table); pass cache_layout="
                "'paged' (got %r)" % (cache_layout,))
        if prefill_chunk_tokens is not None \
                and int(prefill_chunk_tokens) < 1:
            raise InvalidArgumentError(
                "prefill_chunk_tokens must be >= 1 tokens of prompt work "
                "per tick, got %r" % (prefill_chunk_tokens,))
        if prefix_sharing and not self._layout.paged:
            if not self._layout.positional:
                raise InvalidArgumentError(
                    "prefix_sharing cannot apply to cache_layout="
                    "'recurrent': the recurrence folds the whole prefix "
                    "into one carry, so there are no per-position blocks "
                    "two requests could share")
            raise InvalidArgumentError(
                "prefix_sharing shares physical KV blocks through the "
                "block table; pass cache_layout='paged' (got %r)"
                % (cache_layout,))
        if prefix_sharing and prefill_chunk_tokens is None:
            # a hit skips to the unmatched suffix, and only the chunk path
            # can start a prompt mid-way
            raise InvalidArgumentError(
                "prefix_sharing needs prefill_chunk_tokens: admission "
                "skips the matched prefix and chunk-prefills only the "
                "suffix -- pass prefill_chunk_tokens=<tokens per tick> "
                "(e.g. the block size or a small multiple)")
        # the spill tier's backend: "host" parks preempted K/V in process
        # memory, "disk" in one PTKV file per victim under spill_dir (it
        # survives the process, and a second engine adopts it)
        if spill_tier not in ("host", "disk"):
            raise InvalidArgumentError(
                "spill_tier must be 'host' (process-RAM, dies with the "
                "engine) or 'disk' (crash-durable PTKV files under "
                "spill_dir), got %r" % (spill_tier,))
        if spill_tier == "disk":
            if not self._layout.spillable:
                raise InvalidArgumentError(
                    "spill_tier='disk' spills per-slot decode state "
                    "(paged K/V blocks, or a recurrent state carry); a "
                    "dense pool has no spill granularity -- pass "
                    "cache_layout='paged' or 'recurrent'")
            if spill_dir is None:
                raise InvalidArgumentError(
                    "spill_tier='disk' needs spill_dir= (the directory "
                    "the per-request spill files live in; a second "
                    "engine restores from the same directory)")
            os.makedirs(spill_dir, exist_ok=True)
        elif spill_dir is not None:
            raise InvalidArgumentError(
                "spill_dir is a spill_tier='disk' knob (got spill_dir "
                "with spill_tier=%r)" % (spill_tier,))
        if prefill_only and spill_tier != "disk":
            raise InvalidArgumentError(
                "prefill_only=True exports finished prefills over the "
                "K/V transfer contract, which lives in the disk spill "
                "tier -- pass spill_tier='disk' (and spill_dir=)")
        if prefill_only and not self._layout.positional:
            raise InvalidArgumentError(
                "prefill_only=True (the disaggregated prefill tier) is not "
                "wired for cache_layout='recurrent': a recurrent prefill is "
                "one scan, so there is nothing to disaggregate -- run a "
                "fused engine")
        self.spill_tier = spill_tier
        self._spill_dir = None if spill_dir is None else str(spill_dir)
        # the prefill tier: a request that survives its first token parks
        # (rid -> (slot, state)) until export_kv() hands it off
        self._prefill_only = bool(prefill_only)
        self._prefill_done: Dict[object, tuple] = {}
        self.on_prefill_done = None
        self.device = resolve_device(device)
        # the session owns the model, the sampling defaults and the
        # bucketed batch-1 prefill; it shares the pool's layout, so a paged
        # pool gets identity-tabled row caches whose blocks splice straight
        # into the global block pool
        self._session = DecodeSession(
            model, max_len, buckets=buckets, temperature=temperature,
            top_k=top_k, top_p=top_p, cache_dtype=cache_dtype,
            cache_layout=cache_layout, block_size=block_size, route=route,
            device=self.device, mesh=mesh, collective_quant=collective_quant,
            collective_quant_scale=collective_quant_scale)
        self._model = model
        # the LoRA bank geometry, (n_adapters, rank) or None, as the
        # session read it at construction; the bank's contents are
        # hot-swappable rows
        self._lora_cfg = self._session._lora_cfg
        self._cache_dtype = cache_dtype
        self._vocab = getattr(model, "vocab_size", None)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.cache_layout = cache_layout
        self._block_size = int(block_size)
        self._max_blocks = -(-self.max_len // self._block_size)
        if self._layout.paged:
            # default: full capacity (every slot at max_len) plus a
            # scratch block per dp shard.  Block s*(num_blocks/dp) is
            # shard s's scratch block (its local block 0): that shard's
            # unmapped table entries and inactive-slot writes land there
            if num_blocks is None:
                num_blocks = self._dp * (
                    1 + self._slots_per_shard * self._max_blocks)
            num_blocks = int(num_blocks)
            if num_blocks % self._dp != 0:
                raise InvalidArgumentError(
                    "dp=%d must divide num_blocks=%d: the block pool is "
                    "partitioned into equal per-shard spans (each with its "
                    "own scratch block and free list)"
                    % (self._dp, num_blocks))
            if num_blocks // self._dp < 2:
                raise InvalidArgumentError(
                    "paged pool needs >= 2 blocks per dp shard (one "
                    "scratch + one allocatable), got num_blocks=%d at "
                    "dp=%d" % (num_blocks, self._dp))
            self._num_blocks = num_blocks
            self._blocks_per_shard = num_blocks // self._dp
            # one free list per dp shard: a slot's blocks always live in
            # its own shard's partition
            self._free_by_shard: List[List[int]] = self._fresh_free_lists()
            self._slot_blocks: Dict[int, List[int]] = {}
            # refcount per resident block (absent = free): prefix sharing
            # bumps it per extra table row; a block returns to the free
            # list only when its count reaches 0
            self._block_refs: Dict[int, int] = {}
        elif num_blocks is not None:
            raise InvalidArgumentError(
                "num_blocks is a paged-cache knob; pass cache_layout="
                "'paged' (got %r)" % (cache_layout,))
        self._cache = self._new_cache()
        self._chunk_tokens = (None if prefill_chunk_tokens is None
                              else int(prefill_chunk_tokens))
        # the decode step's static inputs, rewritten from the host only
        # when slot membership changed
        self._steps = step_buffers(self.slots, self.device)
        self._membership_dirty = True
        # a captured step reads the weights and the cache by address: both
        # are watched, so a moved tensor drops the graph (drop_moved)
        weights = lambda: (module_tensors(model)  # noqa: E731
                           + cache_tensors(self._cache))
        # a mesh step's entry names its mesh (a mesh adds no key)
        mesh_meta = {} if mesh is None else {"mesh": mesh.describe()}
        kv_meta = lambda *a: {  # noqa: E731
            "kv_cache_bytes": kv_arg_bytes(self._cache), **mesh_meta}
        self._decode_fn = AotFunction(self._pool_decode, key_fn=shape_key,
                                      name="pool_decode", capture=True,
                                      watch=weights, meta_fn=kv_meta)
        self._insert_fn = AotFunction(self._layout.insert_row,
                                      key_fn=lambda *a: "slot_insert",
                                      name="slot_insert")
        # the chunk path's steps exist only when the knob is on, so a
        # plain pool's compile_counts() keys are the reference's
        self._chunk_fn = self._admit_fn = self._chunk_in = None
        if self._chunk_tokens is not None:
            i32, f32 = torch.int32, torch.float32
            # under a mesh the chunk also names its slot's dp shard
            mesh_fields = [] if mesh is None else [("shard", 1, i32)]
            self._chunk_in = StaticInputs(
                [("toks", self._chunk_tokens, i32),
                 ("table", self._max_blocks, i32), ("start", 1, i32),
                 ("last", 1, i32), ("top_k", 1, i32), ("seed", 1, i32),
                 ("step", 1, i32), ("adapter", 1, i32),
                 ("temperature", 1, f32), ("top_p", 1, f32)]
                + mesh_fields, self.device)
            self._chunk_fn = AotFunction(self._chunk_step, key_fn=shape_key,
                                         name="prefill_chunk", capture=True,
                                         watch=weights, meta_fn=kv_meta)
            self._admit_fn = AotFunction(self._write_row,
                                         key_fn=lambda *a: "slot_admit",
                                         name="slot_admit")
        self.prefix_sharing = bool(prefix_sharing)
        self._prefilling: Dict[int, _PrefillState] = {}
        # prefix index: chain-hash key -> entry naming resident full
        # blocks, and the reverse map a freed block leaves it through.
        # The epoch bumps on every allocator/index change; the head's
        # match memo is valid for one epoch
        self._prefix_index: Dict[int, _PrefixEntry] = {}
        self._block_keys: Dict[int, int] = {}
        self._prefix_epoch = 0
        self._head_match = None
        self._prefix_queries = 0
        self._prefix_hits = 0
        self._prefix_tokens_matched = 0
        self._prefix_blocks_matched = 0
        self._chunks_total = 0
        self._chunk_tokens_total = 0
        # matched prefix tokens of the LAST admission (None when sharing
        # is off), read by the engine's on_admit hook
        self.last_admit_prefix_tokens: Optional[int] = None
        self._sampling_seed = int(seed)
        self._seq = 0
        self._queue: collections.deque = collections.deque()
        self._active: Dict[int, _SlotState] = {}
        self._free: List[int] = list(range(self.slots))
        # scheduling: the per-tenant cap, and the host spill tier --
        # parked requests and the reverse map from a still-resident
        # spilled block to its (rid, logical block)
        self._tenant_cap = (None if tenant_slot_cap is None
                            else int(tenant_slot_cap))
        self._spilled: Dict[object, _SpillState] = {}
        self._spill_owner: Dict[int, tuple] = {}
        self._preempts_total = 0
        self._resumes_total = 0
        self._spill_bytes_total = 0
        self._upload_bytes_total = 0
        self._spill_reclaims_total = 0
        self._last_tok = np.zeros(self.slots, np.int32)
        self._results: Dict[object, np.ndarray] = {}
        self._finish_reasons: Dict[object, str] = {}
        self._used_rids: set = set()
        self._next_rid = 0
        # True when the last refill's chosen candidate could not reserve
        # its blocks
        self.admission_blocked = False
        # counters a caller can read to split a run into its phases
        self.prefills_total = 0
        self.decode_steps_total = 0
        # lifecycle hooks (the serving engine sets these): on_admit(rid,
        # slot, prompt_len) when a request takes a slot; on_token(rid,
        # token) for every emitted token including the first;
        # on_finish(rid, tokens, reason) when a request completes (not on
        # cancel/release); on_resume(rid, info) when a preempted request
        # decodes again
        self.on_admit = None
        self.on_token = None
        self.on_finish = None
        self.on_resume = None

    # -- mesh / shard mapping ------------------------------------------------
    @property
    def mesh(self):
        """The decode mesh (None for an unsharded pool)."""
        return self._mesh

    @property
    def dp_shards(self) -> int:
        """dp shards the slot axis is partitioned into (1 unsharded)."""
        return self._dp

    def _shard_of_slot(self, slot: int) -> int:
        """Logical slot -> dp shard: the slot axis splits into equal
        contiguous chunks in mesh order (local slot ``slot %
        slots_per_shard``); the scheduler above never sees shards."""
        return slot // self._slots_per_shard

    def _shard_of_block(self, b: int) -> int:
        """Physical block -> dp shard (the block pool's leading axis is
        partitioned like the slot axis)."""
        return b // self._blocks_per_shard

    def _shard_scratch(self, shard: int) -> int:
        """Shard ``shard``'s scratch block: its partition's first block
        (0 when dp == 1)."""
        return shard * self._blocks_per_shard

    def _fresh_free_lists(self) -> List[List[int]]:
        bps = self._blocks_per_shard
        return [list(range(s * bps + 1, (s + 1) * bps))
                for s in range(self._dp)]

    @property
    def _free_blocks(self) -> List[int]:
        """The free list: with dp == 1 the live list itself; under a mesh
        a flattened copy (mutate through ``_free_by_shard``)."""
        if self._dp == 1:
            return self._free_by_shard[0]
        return [b for fl in self._free_by_shard for b in fl]

    def _spilled_dev_count(self, shard: int = 0) -> int:
        """Device-resident spilled blocks of ``shard``'s partition
        (reclaimable on top of its free list for admission)."""
        if self._dp == 1:
            return len(self._spill_owner)
        return sum(1 for b in self._spill_owner
                   if self._shard_of_block(b) == shard)

    def _pop_free_slot(self, shard: Optional[int] = None) -> int:
        """Take a free slot -- the LAST free one (``_free.pop()`` order) --
        in ``shard`` when the paged allocator needs the slot's blocks in a
        given partition.  Callers check availability first."""
        if shard is None or self._dp == 1:
            return self._free.pop()
        for i in range(len(self._free) - 1, -1, -1):
            if self._shard_of_slot(self._free[i]) == shard:
                return self._free.pop(i)
        raise PreconditionNotMetError(
            "no free slot in dp shard %d (free slots: %s) -- callers must "
            "check shard availability before popping"
            % (shard, sorted(self._free)))

    def _choose_shard(self, req: _Request, need: int):
        """The dp shard a queued paged admission lands in: among shards
        with a free slot, one whose partition holds the reservation (free
        + reclaimable spilled, minus a prefix hit), preferring the longest
        prefix match, then the most headroom.  ``(shard, matched_blocks,
        matched_len, chain_key)``, or ``(None, [], 0, None)`` when no
        shard with a free slot can hold it now.  With dp == 1 this is the
        single free list's admission check."""
        shards = sorted({self._shard_of_slot(s) for s in self._free})
        best = best_key = None
        for s in shards:
            matched: tuple = ([], 0, None)
            if self.prefix_sharing:
                matched = self._match_prefix_memo(req, s)
            avail = len(self._free_by_shard[s]) + self._spilled_dev_count(s)
            if need - len(matched[0]) > avail:
                continue
            key = (matched[1], avail)
            if best_key is None or key > best_key:
                best, best_key = (s,) + tuple(matched), key
        if best is None:
            return None, [], 0, None
        return best

    # -- cache and allocator ---------------------------------------------
    def _new_cache(self):
        return self._session._gen_cache(
            self.slots, per_slot=True,
            num_blocks=(self._num_blocks if self._layout.paged else None))

    def _blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Blocks a request reserves at admission: its worst-case span
        (prompt + generated, capped at max_len)."""
        span = min(prompt_len + max_new_tokens, self.max_len)
        return -(-span // self._block_size)

    def _alloc_blocks(self, n: int, shard: int = 0) -> List[int]:
        """Pop ``n`` blocks at refcount 1 from ``shard``'s partition: its
        free list first, then -- under pressure -- reclaimed spilled
        device copies of the same shard."""
        self._prefix_epoch += 1
        fl = self._free_by_shard[shard]
        blocks = []
        for _ in range(n):
            if not fl:
                self._reclaim_one_spilled(shard)
            blocks.append(fl.pop())
        for b in blocks:
            self._block_refs[b] = 1
        return blocks

    def _free_block(self, b: int) -> None:
        """Return block ``b`` to its shard's free list."""
        self._free_by_shard[self._shard_of_block(b)].append(b)

    def _reclaim_one_spilled(self, shard: int = 0) -> None:
        """Drop ONE spilled block's device copy (of ``shard``'s partition)
        back to its free list (its owner resumes that block from the host
        copy).  Victim: lowest priority, then oldest arrival."""
        owners = [sp for sp in self._spilled.values()
                  if sp.shard == shard
                  and any(b is not None for b in sp.dev_blocks)]
        if not owners:
            raise PreconditionNotMetError(
                "allocator invariant broken: no free block and no "
                "reclaimable spilled block in dp shard %d (callers must "
                "check availability before allocating)" % (shard,))
        sp = min(owners, key=lambda s: (s.req.priority, s.req.seq))
        j = next(i for i, b in enumerate(sp.dev_blocks) if b is not None)
        b = sp.dev_blocks[j]
        sp.dev_blocks[j] = None
        self._spill_owner.pop(b, None)
        self._free_block(b)
        self._spill_reclaims_total += 1

    def _forget_block_key(self, b: int) -> None:
        """Remove ``b`` from the prefix index (an entry names only
        resident blocks: freed and spilled blocks both leave it)."""
        key = self._block_keys.pop(b, None)
        if key is not None:
            entry = self._prefix_index.get(key)
            if entry is not None:
                if b in entry.blocks:
                    entry.blocks.remove(b)
                if not entry.blocks:
                    del self._prefix_index[key]

    def _release_blocks(self, slot: int) -> None:
        """Decref every block the slot maps; blocks at 0 return to the
        free list and leave the prefix index.  A block another slot still
        shares stays resident."""
        if not self._layout.paged:
            return
        self._prefix_epoch += 1
        for b in self._slot_blocks.pop(slot, ()):
            left = self._block_refs.get(b, 1) - 1
            if left > 0:
                self._block_refs[b] = left
                continue
            self._block_refs.pop(b, None)
            self._free_block(b)
            self._forget_block_key(b)

    def _padded_row(self, blocks, shard: int = 0) -> np.ndarray:
        """A table row in ``shard``'s LOCAL block ids: ``blocks``, then the
        shard's scratch block, local 0 (unreserved logical blocks are
        never read)."""
        row = np.zeros(self._max_blocks, np.int64)
        row[:len(blocks)] = np.asarray(blocks, np.int64) \
            - self._shard_scratch(shard)
        return row

    def _write_row(self, slot: int, blocks, index: int) -> None:
        """Map ``slot``'s table row (``blocks``, scratch-padded) and set
        its cache index, in place in every layer's cache."""
        row = torch.from_numpy(self._padded_row(
            blocks, self._shard_of_slot(slot))).to(self.device)
        for c in self._cache:
            c.table[slot].copy_(row)
            c.index[slot] = int(index)

    def _masked_tables(self, cache, active):
        """Inactive slots' table rows point at their shard's scratch block
        (local 0) for the step: a stale write must not land in blocks a
        refilled request now owns.  The rows are replaced in a copy; the
        real rows (which a prefilling slot's chunks write through) are
        untouched."""
        return [c._replace(table=torch.where(active[:, None], c.table,
                                             torch.zeros_like(c.table)))
                for c in cache]

    # -- host API ----------------------------------------------------------
    def _resolve_sampling(self, temperature, top_k, top_p, seed) \
            -> _SamplingConfig:
        """None fields take the pool's defaults; a None seed takes
        ``pool_seed + seq`` (distinct per request, reproducible)."""
        sess = self._session
        t = sess.temperature if temperature is None else float(temperature)
        k = sess.top_k if top_k is None else int(top_k)
        p = sess.top_p if top_p is None else float(top_p)
        check_sampling(t, p)
        if seed is None:
            seed = self._sampling_seed + self._seq
        return _SamplingConfig(t, k, p, int(seed) & 0xFFFFFFFF)

    def submit(self, input_ids, max_new_tokens: int, request_id=None,
               priority: int = 0, tenant=None, deadline=None,
               temperature=None, top_k=None, top_p=None, seed=None,
               adapter: int = 0, _sampling=None):
        """Queue one prompt (1-D ids); returns the request id.

        ``priority`` (int, higher admits first), ``tenant`` (a hashable
        fairness-cap key) and ``deadline`` (a number on any consistent
        clock, only compared: earlier wins within a priority, None sorts
        last) order admission; the defaults are strict FIFO.  ``adapter``
        is the request's LoRA bank row (0, the base model, needs no bank).
        ``_sampling`` is the resubmission seam: an already-resolved config
        (with its ``draws`` offset) that is queued as it is."""
        if deadline is not None and (isinstance(deadline, bool)
                                     or not isinstance(deadline,
                                                       (int, float))):
            # the ordering compares deadlines with float('inf'): a
            # non-numeric one would raise mid-refill
            raise InvalidArgumentError(
                "deadline must be a number on the caller's clock (or None "
                "for no deadline), got %r" % (deadline,))
        ids = np.asarray(input_ids)
        if ids.ndim != 1:
            raise InvalidArgumentError(
                "GenerationPool.submit takes ONE prompt (1-D ids, got shape "
                "%s); batch parallelism comes from the slots" % (ids.shape,))
        if len(ids) < 1:
            raise InvalidArgumentError("prompt must contain at least one token")
        if self._vocab is not None and (int(ids.min()) < 0
                                        or int(ids.max()) >= self._vocab):
            raise InvalidArgumentError(
                "prompt token ids must be in [0, vocab_size=%d): got range "
                "[%d, %d]" % (self._vocab, int(ids.min()), int(ids.max())))
        if max_new_tokens < 1:
            raise InvalidArgumentError("max_new_tokens must be >= 1")
        adapter = self._check_adapter(adapter)
        if len(ids) + max_new_tokens > self.max_len:
            raise InvalidArgumentError(
                "prompt %d + max_new_tokens %d exceeds cache max_len %d"
                % (len(ids), max_new_tokens, self.max_len))
        # chunked prefill needs no bucket: every prompt runs as [C] chunks
        if self._chunk_tokens is None:
            self._session._bucket_for(len(ids))
        if self._layout.paged:
            # a request must fit ONE shard's empty partition: a slot's
            # blocks never span shards
            need = self._blocks_needed(len(ids), max_new_tokens)
            if need > self._blocks_per_shard - 1:
                where = ("the pool has only %d allocatable blocks"
                         % (self._num_blocks - 1)) if self._dp == 1 else (
                    "one dp shard has only %d allocatable blocks "
                    "(num_blocks=%d / dp=%d minus its scratch block; a "
                    "request's blocks never span shards)"
                    % (self._blocks_per_shard - 1, self._num_blocks,
                       self._dp))
                raise InvalidArgumentError(
                    "request needs %d KV blocks (prompt %d + max_new_tokens "
                    "%d at block_size %d) but %s; raise num_blocks or "
                    "lower max_new_tokens" % (need, len(ids), max_new_tokens,
                                              self._block_size, where))
        if request_id is not None:
            if request_id in self._used_rids:
                raise DuplicateRequestError(
                    "request_id %r is already queued, active, or awaiting "
                    "collection" % (request_id,))
            rid = request_id
        else:
            while self._next_rid in self._used_rids:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        self._used_rids.add(rid)
        self._seq += 1
        samp = _sampling if _sampling is not None else \
            self._resolve_sampling(temperature, top_k, top_p, seed)
        self._queue.append(_Request(rid, ids.astype(np.int32),
                                    int(max_new_tokens), int(priority),
                                    tenant, deadline, self._seq, samp,
                                    adapter))
        return rid

    def _check_adapter(self, adapter) -> int:
        """A submit's or an adoption's adapter id against the bank read at
        construction (0, the base model, is always valid)."""
        adapter = int(adapter)
        if adapter == 0:
            return 0
        if self._lora_cfg is None:
            raise InvalidArgumentError(
                "adapter=%d but the model has no LoRA bank attached: call "
                "nn.lora.attach_lora(model, n_adapters, rank) BEFORE "
                "constructing the pool (the bank must be in the parameter "
                "snapshot), then load_adapter" % adapter)
        n, _ = self._lora_cfg
        if not 0 <= adapter < n:
            raise InvalidArgumentError(
                "adapter id must be in [0, n_adapters=%d), got %d"
                % (n, adapter))
        return adapter

    def advance_auto_rids(self, floor: int) -> None:
        """Never auto-assign a request id below ``floor``: an engine that
        opens an existing journal calls this so its own traffic cannot
        reuse a crashed engine's auto ids."""
        self._next_rid = max(self._next_rid, int(floor))

    @staticmethod
    def _resubmit_sampling(cfg: Optional[_SamplingConfig],
                           committed: int) -> _SamplingConfig:
        """The config a prompt+committed resubmission carries: the same
        temperature, top-k, top-p and seed, with ``draws`` advanced by the
        committed tokens, so the re-prefill draws at the stream step the
        uninterrupted run would have used.  None (a hand-off that carried
        no config) is greedy."""
        if cfg is None:
            cfg = _SamplingConfig(0.0, 0, 1.0, 0)
        return cfg._replace(draws=cfg.draws + int(committed))

    # -- admission -----------------------------------------------------------
    def _tenant_counts(self) -> Optional[Dict]:
        """Live slots per tenant (active + prefilling), None without a
        fairness cap."""
        if self._tenant_cap is None:
            return None
        counts: Dict = {}
        for st in list(self._active.values()) \
                + list(self._prefilling.values()):
            tenant = st.req.tenant
            if tenant is not None:
                counts[tenant] = counts.get(tenant, 0) + 1
        return counts

    def tenant_at_cap(self, tenant) -> bool:
        """True when ``tenant`` holds its full share of slots right now
        (always False without a cap or for tenant-less requests)."""
        if self._tenant_cap is None or tenant is None:
            return False
        return self._tenant_counts().get(tenant, 0) >= self._tenant_cap

    def _pick_candidate(self, tenants):
        """The next request a free slot serves: queued admissions and
        parked resumes compete in ONE ordering, ``(priority desc,
        deadline asc, arrival asc)``; tenants at their cap are skipped.
        Returns ``("queued", _Request) | ("resume", _SpillState) |
        None``."""
        best = best_key = None
        inf = float("inf")
        cands = [("queued", r, r) for r in self._queue]
        cands += [("resume", sp.req, sp) for sp in self._spilled.values()]
        for kind, req, item in cands:
            if tenants is not None and req.tenant is not None \
                    and tenants.get(req.tenant, 0) >= self._tenant_cap:
                continue
            key = (-req.priority,
                   inf if req.deadline is None else req.deadline, req.seq)
            if best_key is None or key < best_key:
                best, best_key = (kind, item), key
        return best

    def _match_prefix(self, ids, shard: int = 0):
        """Longest resident block-aligned prefix of ``ids`` in the index
        whose blocks live in ``shard``'s partition: ``(blocks,
        matched_tokens, last_matched_chain_key)``.  Each link hashes the
        parent's key with the block's token ids and is verified token- and
        parent-equal, so a hash collision cannot splice another prompt's
        K/V.  The final prompt position is never matched: the first token
        is sampled from its logits."""
        bs = self._block_size
        limit = (len(ids) - 1) // bs
        blocks: List[int] = []
        key = None
        last_matched = None
        for j in range(limit):
            toks = tuple(int(t) for t in ids[j * bs:(j + 1) * bs])
            parent, key = key, hash((key, toks))
            entry = self._prefix_index.get(key)
            if entry is None or entry.tokens != toks \
                    or entry.parent_key != parent:
                break
            if self._dp == 1:
                cand = entry.blocks[-1]
            else:
                cand = next((b for b in reversed(entry.blocks)
                             if self._shard_of_block(b) == shard), None)
                if cand is None:
                    break
            blocks.append(cand)
            last_matched = key
        return blocks, len(blocks) * bs, last_matched

    def _match_prefix_memo(self, req: _Request, shard: int = 0):
        """``_match_prefix`` memoized per (candidate, epoch, shard): a
        blocked candidate would otherwise re-walk its chain every tick."""
        sig = (req.rid, self._prefix_epoch)
        if self._head_match is None or self._head_match[0] != sig:
            self._head_match = (sig, {})
        per_shard = self._head_match[1]
        if shard not in per_shard:
            per_shard[shard] = self._match_prefix(req.ids, shard)
        return per_shard[shard]

    def _index_full_blocks(self, slot: int, st: _PrefillState) -> None:
        """Index every PROMPT block whose last position is now written: a
        full block is immutable, so a shared prefix is matchable while its
        first owner still prefills the tail.  Blocks of generated tokens
        are never indexed."""
        bs = self._block_size
        blocks = self._slot_blocks.get(slot)
        if blocks is None:
            return
        if (st.indexed + 1) * bs <= st.pos:
            self._prefix_epoch += 1
        while (st.indexed + 1) * bs <= st.pos:
            j = st.indexed
            toks = tuple(int(t) for t in st.req.ids[j * bs:(j + 1) * bs])
            key = hash((st.chain_key, toks))
            entry = self._prefix_index.get(key)
            if entry is None:
                self._prefix_index[key] = _PrefixEntry(
                    blocks[j], toks, st.chain_key)
                self._block_keys[blocks[j]] = key
            elif entry.tokens == toks and entry.parent_key == st.chain_key:
                # a concurrent duplicate prompt wrote its own bit-identical
                # copy: list it, so the chain survives whichever owner
                # frees first
                if blocks[j] not in entry.blocks:
                    entry.blocks.append(blocks[j])
                    self._block_keys[blocks[j]] = key
            else:
                # a hash COLLISION with another chain: listing this block
                # would serve its K/V against the entry's tokens, and the
                # chain cannot match past this link anyway -- stop
                # indexing this prompt
                st.indexed = len(st.req.ids) // bs
                return
            st.chain_key = key
            st.indexed += 1

    def _admit_chunked(self, req: _Request, need: int, matched_blocks,
                       matched_len: int, chain_key, shard: int = 0) -> None:
        """Chunked admission: map the matched prefix blocks read-only
        (refcounts bumped), allocate fresh blocks for every position this
        request will write, set the table row and the index to
        ``matched_len``.  No prompt forward runs here.  ``shard`` (from
        ``_choose_shard``) pins the slot and every block to one dp
        partition."""
        _fire("pool.alloc_blocks")
        slot = self._pop_free_slot(shard)
        for b in matched_blocks:
            self._block_refs[b] += 1
        blocks = list(matched_blocks) + \
            self._alloc_blocks(need - len(matched_blocks), shard)
        self._slot_blocks[slot] = blocks
        self._admit_fn(slot, blocks, matched_len)
        self._prefilling[slot] = _PrefillState(
            req, matched_len, matched_blocks=len(matched_blocks),
            chain_key=chain_key)
        if self.prefix_sharing:
            self._prefix_queries += 1
            if matched_len:
                self._prefix_hits += 1
                self._prefix_tokens_matched += matched_len
                self._prefix_blocks_matched += len(matched_blocks)
            self.last_admit_prefix_tokens = matched_len
        else:
            self.last_admit_prefix_tokens = None
        if self.on_admit is not None:
            self.on_admit(req.rid, slot, len(req.ids))

    def _refill(self):
        """Fill free slots from the queue and the spill tier, in
        :meth:`_pick_candidate`'s order.  On the paged layout the chosen
        candidate waits (``admission_blocked``) until its reservation fits
        the free list plus the reclaimable spilled blocks (matched prefix
        blocks come off it): skipping ahead would starve long prompts."""
        self.admission_blocked = False
        while (self._queue or self._spilled) and self._free:
            pick = self._pick_candidate(self._tenant_counts())
            if pick is None:
                break  # every candidate is tenant-capped right now
            kind, item = pick
            if kind == "resume":
                if self._layout.paged:
                    # a resume is SHARD-PINNED: its device copies and its
                    # table row live in the shard it was preempted from
                    if self._dp > 1 and not any(
                            self._shard_of_slot(s) == item.shard
                            for s in self._free):
                        self.admission_blocked = True
                        break
                    # blocks still in the spill tier re-map for free; the
                    # tier's other entries in the shard are reclaimable on
                    # top
                    own = sum(1 for b in item.dev_blocks if b is not None)
                    need_fresh = item.total_blocks - own
                    avail = len(self._free_by_shard[item.shard]) \
                        + self._spilled_dev_count(item.shard) - own
                    if need_fresh > avail:
                        self.admission_blocked = True
                        break
                self._spilled.pop(item.rid)
                self._resume(item)
                continue
            req = item
            need = 0
            shard = None
            matched_blocks, matched_len, chain_key = [], 0, None
            if self._layout.paged:
                # the candidate waits until some shard with a free slot
                # holds its whole reservation (matched prefix blocks come
                # off it)
                need = self._blocks_needed(len(req.ids), req.max_new_tokens)
                shard, matched_blocks, matched_len, chain_key = \
                    self._choose_shard(req, need)
                if shard is None:
                    self.admission_blocked = True
                    break
            # remove by identity: _Request holds a numpy array
            for i, q in enumerate(self._queue):
                if q is req:
                    del self._queue[i]
                    break
            if self._chunk_tokens is not None:
                self._admit_chunked(req, need, matched_blocks, matched_len,
                                    chain_key, shard)
                continue
            cfg = req.sampling
            samp = make_sampling_state(1, cfg.temperature, cfg.top_k,
                                       cfg.top_p, seed=cfg.seed,
                                       step=cfg.draws, adapter=req.adapter)
            # prefill before taking the slot: a failing prefill leaks none
            _fire("pool.prefill")
            tr = _trace_active()
            if tr is None:
                row_cache, tok, _ = self._session.prefill(req.ids[None],
                                                          samp)
            else:
                with tr.span("tick.prefill", rid=req.rid,
                             prompt_tokens=len(req.ids)):
                    row_cache, tok, _ = self._session.prefill(
                        req.ids[None], samp)
                    _device_edge(tr)
            self.prefills_total += 1
            slot = self._pop_free_slot(shard)
            first = int(tok[0])
            if self._layout.paged:
                _fire("pool.alloc_blocks")
                blocks = self._alloc_blocks(need, shard)
                self._slot_blocks[slot] = blocks
                padded = self._padded_row(blocks, shard)
            else:
                padded = None
            self._insert_fn(self._cache, row_cache, slot, len(req.ids),
                            padded)
            self.last_admit_prefix_tokens = None
            if self.on_admit is not None:
                self.on_admit(req.rid, slot, len(req.ids))
            self._activate(slot, req, first)

    def _activate(self, slot: int, req: _Request, first: int) -> None:
        """Promote a slot to decoding with ``first`` (sampled at the last
        prompt position) committed: one path for both prefill modes, so
        the hook order (``on_admit`` at slot-take, then
        ``_on_activated``, then ``on_token``) is the same for both.  A
        prefill-only pool parks the request here instead."""
        self._active[slot] = _SlotState(req, [first], req.max_new_tokens - 1)
        self._last_tok[slot] = first
        self._membership_dirty = True
        finishes = req.max_new_tokens == 1 or (self.eos_id is not None
                                               and first == self.eos_id)
        if self._prefill_only and not finishes:
            self._prefill_done[req.rid] = (slot, self._active.pop(slot))
            if self.on_token is not None:
                self.on_token(req.rid, first)
            if self.on_prefill_done is not None:
                self.on_prefill_done(req.rid)
            return
        if not finishes:
            # a slot that finishes on its first token never decodes, so
            # the subclass hook would be wasted device work
            self._on_activated(slot, req.rid, req.ids)
        if self.on_token is not None:
            self.on_token(req.rid, first)
        if finishes:
            self._finish(slot)

    def _on_activated(self, slot: int, rid, ids) -> None:
        """Subclass hook: ``slot`` just started decoding with its first
        token committed (both prefill modes).  The speculative pool
        prefills its draft here."""

    # -- chunked prefill ---------------------------------------------------
    def _prefill_chunk(self, toks, slot: int, start: int, length: int,
                       sampling: _SamplingConfig, adapter: int = 0):
        """One fixed-shape chunk for ONE slot: run ``toks`` (``[C]``,
        ``length`` real tokens, zero-padded) from absolute position
        ``start`` through the slot's table row, and sample the token at
        offset ``length - 1`` with the request's config at draw 0 (only
        the final chunk's sample is ever read).  Returns it on the device.

        The chunk's inputs -- the tokens, a copy of the slot's table row,
        the start, the last offset, the config and the adapter id -- go to
        the static buffers in one upload, then the ``"prefill_chunk"`` step
        runs; the slot's index is set on the host side of the step."""
        cfg = sampling
        shard = self._shard_of_slot(slot)
        mesh_fields = {} if self._mesh is None else {"shard": shard}
        self._chunk_in.upload(
            toks=toks, table=self._padded_row(self._slot_blocks[slot], shard),
            start=start, last=length - 1,
            top_k=cfg.top_k, seed=cfg.seed, step=cfg.draws,
            adapter=adapter, temperature=cfg.temperature, top_p=cfg.top_p,
            **mesh_fields)
        tok = self._chunk_fn(self._chunk_in.toks)
        # the step advanced only the view's index
        for c in self._cache:
            c.index[slot] = int(start + length)
        return tok[0]

    def _chunk_step(self, toks):
        """The captured body of a chunk: a batch-1 view over the GLOBAL
        cache (the static table row and a [1] start index), so K/V land
        in the same blocks the batched step reads, with no copy of the
        pool.  Every written position is >= the start, and shared blocks
        end before it; pad positions land in the request's own future
        positions (masked until overwritten) or, past its reservation, in
        the scratch block."""
        b = self._chunk_in
        if self._mesh is None:
            views = [c._replace(table=b.table[None], index=b.start)
                     for c in self._cache]
            logits, _ = self._session._run_model(
                toks[None].long(), views,
                self._session._adapter_ids(b.adapter))
            row = logits[0]
        else:
            # every dp shard runs the chunk (a batch-1 chunk does not
            # split over dp), one row each: the owning shard through the
            # slot's table row, the others through their scratch block;
            # the owner's row is sampled
            dp = self._dp
            owner = torch.arange(dp, device=b.shard.device) == b.shard
            table = torch.where(owner[:, None],
                                b.table[None].expand(dp, -1),
                                torch.zeros_like(b.table)[None])
            start = b.start.expand(dp).contiguous()
            views = [c._replace(table=table, index=start)
                     for c in self._cache]
            logits, _ = self._session._run_model(
                toks[None].long().expand(dp, -1), views,
                self._session._adapter_ids(b.adapter.expand(dp)))
            row = logits.index_select(0, b.shard)[0]
        return sample_logits_data(row.index_select(0, b.last),
                                  b.temperature, b.top_k, b.top_p, b.seed,
                                  b.step)

    def _chunk_work(self) -> None:
        """At most ``prefill_chunk_tokens`` of prompt work this tick: one
        chunk of the OLDEST prefilling slot.  The final chunk's sample
        activates the slot; only that one is downloaded."""
        if not self._prefilling:
            return
        slot = next(iter(self._prefilling))
        st = self._prefilling[slot]
        ids = st.req.ids
        n = min(self._chunk_tokens, len(ids) - st.pos)
        toks = np.zeros(self._chunk_tokens, np.int64)
        toks[:n] = ids[st.pos:st.pos + n]
        _fire("pool.prefill")
        tr = _trace_active()
        if tr is None:
            tok_dev = self._prefill_chunk(toks, slot, st.pos, n,
                                          st.req.sampling, st.req.adapter)
        else:
            with tr.span("tick.prefill", rid=st.rid, chunk_tokens=n,
                         pos=st.pos, prompt_tokens=len(ids)):
                tok_dev = self._prefill_chunk(toks, slot, st.pos, n,
                                              st.req.sampling,
                                              st.req.adapter)
                _device_edge(tr)
        self._chunks_total += 1
        self._chunk_tokens_total += n
        st.pos += n
        if self.prefix_sharing:
            # blocks this chunk completed are immutable now: a queued
            # request sharing the prefix can match them at its admission
            self._index_full_blocks(slot, st)
        if st.pos < len(ids):
            return
        self._prefilling.pop(slot)
        self._activate(slot, st.req, int(tok_dev))

    # -- preemption and the host spill tier --------------------------------
    def _preempt_guard(self, slot: int, st: _SlotState) -> None:
        """Subclass veto point: raise a typed error when this slot cannot
        be preempted safely."""

    def can_preempt(self, request_id) -> bool:
        """True when ``preempt(request_id)`` would succeed now: the
        request is decoding on a spillable layout and no guard vetoes."""
        if not self._layout.spillable:
            return False
        for slot, st in self._active.items():
            if st.rid == request_id:
                try:
                    self._preempt_guard(slot, st)
                except Exception:  # noqa: BLE001 - a veto, reason unused
                    return False
                return True
        return False

    def preempt(self, request_id) -> dict:
        """Evict one decoding request into the host spill tier; returns
        ``{rid, slot, blocks_spilled, blocks_freed, spill_bytes,
        committed_tokens}``.

        The victim's WRITTEN blocks (K, V and int8 scales, every layer)
        are gathered on the device and downloaded in ONE copy -- the one
        host sync.  Then every block it held is decref'd: blocks it owned
        alone and wrote move to the spilled tier (device content kept,
        reclaimable), unwritten reservation blocks return to the free
        list, shared blocks stay with their other owners.  The slot is
        freed; ``_refill`` resumes the request in the normal ordering."""
        if not self._layout.spillable:
            raise PreconditionNotMetError(
                "preemption spills per-slot decode state to the host tier; "
                "a dense pool has no spill granularity -- use "
                "cache_layout='paged' (or 'recurrent')")
        slot = next((s for s, st in self._active.items()
                     if st.rid == request_id), None)
        if slot is None:
            raise NotFoundError(
                "request_id %r is not actively decoding (queued, "
                "prefilling, already-preempted and finished requests "
                "cannot be preempted; active: %s)"
                % (request_id,
                   sorted(str(st.rid) for st in self._active.values())))
        st = self._active[slot]
        self._preempt_guard(slot, st)
        if not self._layout.positional:
            return self._preempt_recurrent(slot, st)
        # K/V are written for positions [0, pos): the last committed
        # token's K/V is the next step's input, not yet written
        shard = self._shard_of_slot(slot)
        pos = len(st.req.ids) + len(st.tokens) - 1
        written = -(-pos // self._block_size)
        blocks = self._slot_blocks[slot]
        host = self._download_blocks(blocks[:written], shard)
        host_bytes = sum(_nbytes(t) for layer in host for t in layer)
        host_path = None
        if self.spill_tier == "disk":
            # the file is written before any allocator change: a failed
            # write (the spill.write seam, or a full disk) leaves the
            # pool as it was and the victim decoding
            host_path = self._spill_write(st, host, written)
            host = None  # the file is the survivor, not process memory
        del self._slot_blocks[slot]
        self._active.pop(slot)
        self._free.append(slot)
        self._membership_dirty = True
        self._prefix_epoch += 1
        sp = _SpillState(st, len(blocks), written, host, host_bytes, shard)
        sp.host_path = host_path
        freed = 0
        for j, b in enumerate(blocks):
            left = self._block_refs.get(b, 1) - 1
            if left > 0:
                # shared: the other owners keep it resident; the victim
                # restores it from its host copy
                self._block_refs[b] = left
                continue
            self._block_refs.pop(b, None)
            self._forget_block_key(b)
            if j < written:
                self._spill_owner[b] = (st.rid, j)
                sp.dev_blocks[j] = b
            else:
                self._free_block(b)
                freed += 1
        self._spilled[st.rid] = sp
        self._preempts_total += 1
        self._spill_bytes_total += host_bytes
        return {"rid": st.rid, "slot": slot, "blocks_spilled": written,
                "blocks_freed": freed, "spill_bytes": host_bytes,
                "committed_tokens": len(st.tokens)}

    def _preempt_recurrent(self, slot: int, st: _SlotState) -> dict:
        """Recurrent preemption: the victim's whole decode state is its
        slot's carry rows (one per layer), downloaded in one copy and
        parked in the host or disk tier; the slot is freed.  No allocator:
        resume uploads the carry into any free slot.  The carry covers
        positions ``[0, pos)``: the last committed token is the next
        step's input, as on the positional layouts."""
        host = [(rows[0][0],) for rows in self._download_rows([slot])]
        host_bytes = sum(_nbytes(t) for layer in host for t in layer)
        host_path = None
        if self.spill_tier == "disk":
            # written before the pool changes: a failed write leaves the
            # victim decoding
            host_path = self._spill_write(st, host, 0)
            host = None
        self._active.pop(slot)
        self._free.append(slot)
        self._membership_dirty = True
        sp = _SpillState(st, 0, 0, host, host_bytes,
                         self._shard_of_slot(slot))
        sp.host_path = host_path
        self._spilled[st.rid] = sp
        self._preempts_total += 1
        self._spill_bytes_total += host_bytes
        return {"rid": st.rid, "slot": slot, "blocks_spilled": 0,
                "blocks_freed": 0, "spill_bytes": host_bytes,
                "state_bytes": host_bytes,
                "committed_tokens": len(st.tokens)}

    def _resume_recurrent(self, sp: _SpillState) -> None:
        """Re-activate a recurrent victim: its carry rows (process memory,
        or its PTKV file, with the per-victim fallback of a re-queue as
        prompt + committed) are uploaded in one copy into any free slot's
        state rows, and the index and the last-token input restored."""
        if sp.host is not None:
            rows = [layer[0] for layer in sp.host]
        else:
            try:
                rows = self._spill_read_rows(sp, None)
            except Exception:  # noqa: BLE001 - per-victim fallback
                self._requeue_lost_spill(sp)
                return
        slot = self._free.pop()
        pos = len(sp.req.ids) + len(sp.tokens) - 1
        self._upload_rows([slot], [r[None] for r in rows])
        for c in self._cache:
            c.index[slot] = pos
        self._upload_bytes_total += sp.host_bytes
        self._spill_drop(sp)
        self._active[slot] = _SlotState(sp.req, sp.tokens, sp.remaining)
        self._last_tok[slot] = sp.tokens[-1]
        self._membership_dirty = True
        self._resumes_total += 1
        self._on_resumed(slot, sp)
        if self.on_resume is not None:
            self.on_resume(sp.rid, {
                "slot": slot, "blocks_remapped": 0, "blocks_uploaded": 0,
                "state_bytes": sp.host_bytes,
                "committed_tokens": len(sp.tokens)})

    def _resume(self, sp: _SpillState) -> None:
        """Re-activate one parked request in a free slot: re-map its
        still-resident spilled blocks in place, allocate fresh blocks for
        the rest and upload into them (in one copy) the host copies of the
        written ones, then restore the table row, the index and the
        last-token input.  The K/V are bit-exact, so greedy decode
        continues byte-identically; sampling continues at draw
        ``len(tokens)``.

        A disk-tier victim's file is read BEFORE any allocator change:
        the file can vanish or be damaged while parked, and then only
        this victim pays, re-queued as prompt + committed under its own
        id (byte-identical for greedy decode), never the whole pool.  The
        file is deleted once the request decodes again."""
        if not self._layout.positional:
            self._resume_recurrent(sp)
            return
        need_up = [j for j in range(sp.written) if sp.dev_blocks[j] is None]
        host_parts = None  # flat over layers and fields: [len(need_up), ...]
        if need_up:
            if sp.host is not None:
                sel = torch.as_tensor(need_up, dtype=torch.int64)
                host_parts = [f.index_select(0, sel) for layer in sp.host
                              for f in layer]
            else:
                try:
                    host_parts = self._spill_read_rows(sp, need_up)
                except Exception:  # noqa: BLE001 - per-victim fallback
                    self._requeue_lost_spill(sp)
                    return
        slot = self._pop_free_slot(sp.shard)
        blocks: List[int] = []
        upload: List[int] = []  # physical blocks, in need_up order
        for j in range(sp.total_blocks):
            b = sp.dev_blocks[j] if j < sp.written else None
            if b is not None:
                # the device copy survived: re-map it
                self._spill_owner.pop(b, None)
                self._block_refs[b] = 1
                blocks.append(b)
            else:
                nb = self._alloc_blocks(1, sp.shard)[0]
                blocks.append(nb)
                if j < sp.written:
                    upload.append(nb)
        self._slot_blocks[slot] = blocks
        if upload:
            base = self._shard_scratch(sp.shard)
            self._upload_bytes_total += self._upload_rows(
                [b - base for b in upload], host_parts, sp.shard)
        self._spill_drop(sp)
        pos = len(sp.req.ids) + len(sp.tokens) - 1
        self._write_row(slot, blocks, pos)
        self._active[slot] = _SlotState(sp.req, sp.tokens, sp.remaining)
        self._last_tok[slot] = sp.tokens[-1]
        self._membership_dirty = True
        self._prefix_epoch += 1
        self._resumes_total += 1
        self._on_resumed(slot, sp)
        if self.on_resume is not None:
            self.on_resume(sp.rid, {
                "slot": slot,
                "blocks_remapped": len(blocks) - len(upload)
                - (sp.total_blocks - sp.written),
                "blocks_uploaded": len(upload),
                "committed_tokens": len(sp.tokens)})

    def _on_resumed(self, slot: int, sp: _SpillState) -> None:
        """Subclass hook: a preempted request decodes again in ``slot``
        with its K/V restored."""

    # -- moving blocks between the card and the host ----------------------
    def _download_blocks(self, blocks, shard: int = 0) -> list:
        """The K/V (and int8 scales) of ``blocks`` (of ``shard``'s
        partition) in every layer, as CPU tensors ``[len(blocks), ...]``
        per layer and field, all heads: gathered on the device into one
        buffer, downloaded in ONE copy."""
        base = self._shard_scratch(shard)
        return self._download_rows([b - base for b in blocks], shard)

    def _download_rows(self, rows, shard: Optional[int] = None) -> list:
        """Rows ``rows`` (local to dp shard ``shard``; for a carry, slots
        and their shard when ``shard`` is None) of every layer's spilled
        fields as CPU tensors per layer and field, the mp shards joined on
        the head axis: one gather into one buffer, ONE download."""
        if shard is None:
            shard = self._shard_of_slot(rows[0])
            rows = [r % self._slots_per_shard for r in rows]
        gather = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        layers = [_shard_fields(c, shard) for c in self._cache]
        flat, specs = _gather_packed(
            [t for layer in layers for f in layer for t in f], gather)
        parts = iter(_unpack(flat.cpu(), specs))
        return [tuple(torch.cat([next(parts) for _ in f], dim=1)
                      if len(f) > 1 else next(parts) for f in layer)
                for layer in layers]

    def _upload_rows(self, rows, host_parts, shard: Optional[int] = None):
        """Write ``host_parts`` (flat over layers and fields, all heads,
        ``[len(rows), ...]`` each) into rows ``rows`` of every layer's
        spilled fields (as :meth:`_download_rows` addresses them), split
        over the mp shards on the head axis, in ONE upload.  Returns the
        bytes uploaded."""
        if shard is None:
            shard = self._shard_of_slot(rows[0])
            rows = [r % self._slots_per_shard for r in rows]
        ids = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        targets, pieces = [], []
        fields = [f for c in self._cache for f in _shard_fields(c, shard)]
        for f, part in zip(fields, host_parts):
            h = part.shape[1] // len(f) if len(f) > 1 else None
            for m, t in enumerate(f):
                targets.append(t)
                pieces.append(part if h is None
                              else part[:, m * h:(m + 1) * h].contiguous())
        dev = self._upload_parts(pieces)
        for t, part in zip(targets, dev):
            t.index_copy_(0, ids, part)
        return sum(_nbytes(t) for t in dev)

    def _upload_parts(self, parts) -> list:
        """Host tensors to the pool's device in ONE copy: packed into one
        flat buffer (pinned when the device is a card), then viewed back
        per part on the device."""
        specs, off = [], 0
        for t in parts:
            specs.append((off, t.dtype, tuple(t.shape)))
            off += -(-_nbytes(t) // 8) * 8
        flat = torch.empty(off, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        for t, part in zip(parts, _unpack(flat, specs)):
            part.copy_(t)
        return _unpack(flat.to(self.device, non_blocking=True), specs)

    # -- the disk tier and the K/V hand-off ----------------------------------
    def _spill_path(self, rid) -> str:
        """The PTKV file a request's spilled K/V live in: a pure function
        of the rid (the reference's naming), so a second engine pointed
        at the same directory finds a crashed engine's files.  The type
        tag keeps int 1 and str "1" apart."""
        tag = "i" if isinstance(rid, (int, np.integer)) else "s"
        safe = "".join(c if c.isalnum() or c in "-_" else "~%02x" % ord(c)
                       for c in str(rid))
        return os.path.join(self._spill_dir, "spill-%s%s.npz" % (tag, safe))

    def _spill_write(self, st: _SlotState, host, written: int,
                     seam: str = "spill.write") -> str:
        """Write one request's written blocks (``host``: per layer, CPU
        tensors) to its PTKV file with this pool's fingerprint and the
        resume metadata.  Fires ``seam`` (``spill.write`` for preemption,
        ``xfer.write`` for exports); a transient failure is retried once,
        then propagates and the caller leaves the pool untouched."""
        arrays, names = {}, {}
        for i, layer in enumerate(host):
            for j, t in enumerate(layer):
                name = "l%d_f%d" % (i, j)
                if t.dtype == torch.bfloat16:
                    t = t.view(torch.int16)
                    names[name] = "bfloat16"
                arrays[name] = t.numpy()
        cfg = st.req.sampling
        meta = {"rid": str(st.rid), "prompt_len": int(len(st.req.ids)),
                "committed": len(st.tokens), "written": int(written),
                "cache_layout": self.cache_layout,
                "layers": len(host), "fields": len(host[0]),
                "cache_dtype": self._layout.cache_dtype_str(self._cache),
                # the request's own sampling config rides the header, so
                # an adopting engine resumes its stream, not its defaults
                "sampling": [float(cfg.temperature), int(cfg.top_k),
                             float(cfg.top_p), int(cfg.seed),
                             int(cfg.draws)],
                "adapter": int(st.req.adapter)}
        if self._layout.positional:
            meta["block_size"] = self._block_size
        else:
            # the recurrent payload is whole carry rows (written == 0)
            meta["d_state"] = int(self._cache[0].state.shape[-1])
        return _transfer_mod().write_transfer(
            self._spill_path(st.rid), self.config_fingerprint(), meta,
            arrays, seam=seam, rid=st.rid, dtype_names=names)

    def _spill_read_rows(self, sp: _SpillState, rows) -> list:
        """Logical blocks ``rows`` of a disk-tier victim's file (None: the
        whole arrays, a recurrent carry), flat over layers and fields, as
        writable CPU tensors (copied out of the read-only mapping, which
        is closed before returning)."""
        r = _transfer_mod().TransferReader(sp.host_path)
        try:
            nf = len(_cache_fields(first_part(self._cache[0])))
            out = []
            for i in range(len(self._cache)):
                for j in range(nf):
                    name = "l%d_f%d" % (i, j)
                    arr = r.arrays[name]
                    arr = (np.array(arr) if rows is None
                           else np.ascontiguousarray(arr[rows]))
                    if r.dtypes[name] == "bfloat16":
                        out.append(torch.from_numpy(arr.view(np.int16))
                                   .view(torch.bfloat16))
                    else:
                        out.append(torch.from_numpy(arr))
            return out
        finally:
            r.close(keep=False)

    def _spill_drop(self, sp: _SpillState) -> None:
        """Delete a spill record's disk file, if it has one (resume,
        cancel and reset consume the parked copy)."""
        path = sp.host_path
        if path is not None:
            sp.host_path = None
            try:
                os.remove(path)
            except OSError:
                pass

    def _requeue_lost_spill(self, sp: _SpillState) -> None:
        """A parked victim's file could not be read: free its device
        copies, drop the file and queue it again as prompt + committed
        under its own id (the engine's recovery primitive, one victim)."""
        self._prefix_epoch += 1
        for b in sp.dev_blocks:
            if b is not None:
                self._spill_owner.pop(b, None)
                self._free_block(b)
        self._spill_drop(sp)
        self._used_rids.discard(sp.rid)
        ids = np.concatenate([sp.req.ids, np.asarray(sp.tokens, np.int32)])
        self.submit(ids, sp.remaining, request_id=sp.rid,
                    priority=sp.req.priority, tenant=sp.req.tenant,
                    deadline=sp.req.deadline, adapter=sp.req.adapter,
                    _sampling=self._resubmit_sampling(sp.req.sampling,
                                                      len(sp.tokens)))

    def _adopt_guard(self, ids, tokens) -> None:
        """Subclass veto for :meth:`adopt_spill` (the speculative pool
        needs draft bucket coverage for the resume-time re-prefill)."""

    def adopt_spill(self, request_id, input_ids, tokens,
                    max_new_tokens: int, priority: int = 0, tenant=None,
                    deadline=None) -> bool:
        """Adopt a crashed engine's disk-spilled K/V for ``request_id``:
        park the request in this pool's spill tier with its file as the
        source, so the next refill resumes it through the upload path
        with no re-prefill (the file holds bit-exact K/V for positions
        ``[0, prompt + committed - 1)``).

        Returns False -- the caller falls back to prompt+committed
        resubmit -- whenever adoption cannot be exact: the tier is off, no
        file, a file whose metadata disagrees with the journal's committed
        count (STALE: deleted, it can never be adopted), a fingerprint or
        shape/dtype/block-size mismatch with this pool (left on disk: it
        may be another configuration's), or a subclass veto.  Never
        raises for a bad file."""
        if self.spill_tier != "disk" or not self._layout.spillable:
            return False
        if request_id in self._used_rids:
            return False
        ids = np.asarray(input_ids).astype(np.int32)
        tokens = [int(t) for t in tokens]
        if len(tokens) < 1 or int(max_new_tokens) - len(tokens) < 1:
            return False
        path = self._spill_path(request_id)
        if not os.path.exists(path):
            return False
        first = first_part(self._cache[0])
        recurrent = not self._layout.positional
        bs = self._block_size
        if recurrent:
            # the carry is O(1): no blocks, only a free slot at resume
            written = total = 0
        else:
            pos = int(len(ids)) + len(tokens) - 1
            written = -(-pos // bs)
            total = self._blocks_needed(len(ids), int(max_new_tokens))
            if total > self._blocks_per_shard - 1:
                return False
        nf = len(_cache_fields(first))
        xfer = _transfer_mod()
        from ..serving import log as _slog
        try:
            r = xfer.TransferReader(path)
        except xfer.TransferVersionError as e:
            # an OLDER format under our naming can never be adopted:
            # delete it; a NEWER one belongs to a newer engine
            if e.found < xfer.VERSION:
                try:
                    os.remove(path)
                except OSError:
                    pass
            _slog.emit("xfer.reject", rid=str(request_id),
                       reason="version", found=e.found,
                       deleted=e.found < xfer.VERSION)
            return False
        except xfer.TransferFormatError as e:
            _slog.emit("xfer.reject", rid=str(request_id),
                       reason="legacy_npz" if e.legacy_npz else "format",
                       detail=str(e))
            return False
        except Exception:  # noqa: BLE001 - a bad file falls back, always
            return False
        try:
            try:
                xfer.check_fingerprint(r.fingerprint,
                                       self.config_fingerprint())
            except xfer.TransferFingerprintError as e:
                _slog.emit("xfer.reject", rid=str(request_id),
                           reason="fingerprint", keys=list(e.keys))
                return False
            meta = r.meta
            if (meta.get("committed") != len(tokens)
                    or meta.get("prompt_len") != len(ids)
                    or meta.get("written") != written):
                r.close(keep=False)
                try:
                    os.remove(path)
                except OSError:
                    pass
                return False
            structural_ok = (
                meta.get("layers") == len(self._cache)
                and meta.get("fields") == nf
                and meta.get("cache_dtype")
                == self._layout.cache_dtype_str(self._cache))
            if recurrent:
                structural_ok = (
                    structural_ok
                    and meta.get("d_state") == int(first.state.shape[-1])
                    and tuple(r.arrays["l0_f0"].shape)
                    == tuple(first.state.shape[1:]))
            else:
                # the file holds every head: the mp shards' heads joined
                heads = int(first.k.shape[1]) * self._mp
                structural_ok = (
                    structural_ok and meta.get("block_size") == bs
                    and tuple(r.arrays["l0_f0"].shape)
                    == (written, heads) + tuple(first.k.shape[2:]))
            if not structural_ok:
                return False
            host_bytes = int(r.nbytes)
        except Exception:  # noqa: BLE001 - a bad file falls back, always
            return False
        finally:
            r.close(keep=False)
        try:
            self._adopt_guard(ids, tokens)
        except Exception:  # noqa: BLE001 - subclass veto -> resubmit
            return False
        # an adapter this pool's bank cannot address (no bank, or an id out
        # of range) falls back: a fleet hot-loads it before retrying
        try:
            adapter = self._check_adapter(meta.get("adapter", 0) or 0)
        except InvalidArgumentError:
            return False
        msamp = meta.get("sampling")
        sampling = (_SamplingConfig(0.0, 0, 1.0, 0) if msamp is None else
                    _SamplingConfig(float(msamp[0]), int(msamp[1]),
                                    float(msamp[2]), int(msamp[3]),
                                    int(msamp[4]) if len(msamp) > 4
                                    else 0))
        self._seq += 1
        req = _Request(request_id, ids, int(max_new_tokens), int(priority),
                       tenant, deadline, self._seq, sampling, adapter)
        st = _SlotState(req, tokens, int(max_new_tokens) - len(tokens))
        # no device copies pin the shard: park where the most blocks are
        # free (a carry needs no blocks)
        shard = 0 if recurrent else max(
            range(self._dp), key=lambda s: len(self._free_by_shard[s]))
        sp = _SpillState(st, total, written, None, host_bytes, shard)
        sp.host_path = path
        self._spilled[request_id] = sp
        self._used_rids.add(request_id)
        return True

    def detach_spilled(self, request_id) -> dict:
        """Forget a disk-parked victim but KEEP its file, for a peer
        engine sharing the spill directory to ``adopt_spill`` under the
        same id: its device copies return to the free list.  A victim on
        the host tier has no file to hand over
        (``PreconditionNotMetError``)."""
        sp = self._spilled.get(request_id)
        if sp is None:
            raise NotFoundError(
                "request_id %r is not parked in the spill tier"
                % (request_id,))
        if sp.host_path is None:
            raise PreconditionNotMetError(
                "request %r is parked on the host tier (no transfer "
                "file) -- only disk-tier victims detach for migration"
                % (request_id,))
        del self._spilled[request_id]
        self._prefix_epoch += 1
        for b in sp.dev_blocks:
            if b is not None:
                self._spill_owner.pop(b, None)
                self._free_block(b)
        self._used_rids.discard(request_id)
        path, sp.host_path = sp.host_path, None
        return {"rid": request_id, "path": path,
                "committed_tokens": len(sp.tokens),
                "spill_bytes": sp.host_bytes}

    def export_kv(self, request_id) -> dict:
        """Hand off a parked prefill-complete request (``prefill_only``
        pools): its written blocks are downloaded in one copy and written
        to its PTKV file at the ``xfer.write`` seam, then its slot and
        blocks are freed.  The file plus the returned committed state is
        the hand-off; a peer re-parks it with :meth:`adopt_spill`.  The
        write comes before any allocator change, so a failed write leaves
        the request parked."""
        parked = self._prefill_done.get(request_id)
        if parked is None:
            raise NotFoundError(
                "request_id %r is not parked prefill-complete (not a "
                "prefill_only pool, not yet prefilled, cancelled, or "
                "already exported)" % (request_id,))
        slot, st = parked
        pos = len(st.req.ids) + len(st.tokens) - 1
        written = -(-pos // self._block_size)
        host = self._download_blocks(self._slot_blocks[slot][:written],
                                     self._shard_of_slot(slot))
        transfer_bytes = sum(_nbytes(t) for layer in host for t in layer)
        path = self._spill_write(st, host, written, seam="xfer.write")
        del self._prefill_done[request_id]
        self._free.append(slot)
        self._release_blocks(slot)
        self._used_rids.discard(request_id)
        self._membership_dirty = True
        cfg = st.req.sampling
        return {"rid": request_id, "path": path,
                "transfer_bytes": int(transfer_bytes),
                "blocks_written": int(written),
                "committed_tokens": len(st.tokens),
                "prompt_len": int(len(st.req.ids)),
                "max_new_tokens": len(st.tokens) + st.remaining,
                "priority": st.req.priority, "tenant": st.req.tenant,
                "deadline": st.req.deadline,
                "sampling": [float(cfg.temperature), int(cfg.top_k),
                             float(cfg.top_p), int(cfg.seed),
                             int(cfg.draws)],
                "adapter": int(st.req.adapter)}

    def config_fingerprint(self) -> dict:
        """The JSON-stable identity byte-identical replay depends on: the
        pool class, the sampling discipline marker (sampling is
        per-request data, so no values), the LoRA bank's geometry
        (``{"n_adapters", "rank"}`` or None: its contents are data), the
        cache layout, dtype and geometry, and the mesh (``{"dp", "mp"}``,
        None unsharded: a file written under one mesh shape is refused by
        another).  It is the reference's dict for the same configuration
        and names
        nothing about the backend, so journals and PTKV files cross
        between the two packages; a differing configuration is refused
        with both sides named."""
        fp = {
            "pool_type": type(self).__name__,
            "sampling": "per-request",
            "lora": (None if self._lora_cfg is None
                     else {"n_adapters": int(self._lora_cfg[0]),
                           "rank": int(self._lora_cfg[1])}),
            "eos_id": None if self.eos_id is None else int(self.eos_id),
            "max_len": self.max_len,
            "slots": self.slots,
            "vocab_size": None if self._vocab is None else int(self._vocab),
            "cache_layout": self.cache_layout,
            "cache_dtype": self._layout.cache_dtype_str(self._cache),
            "mesh": (None if self._mesh is None
                     else {"dp": int(self._mesh.dp),
                           "mp": int(self._mesh.mp)}),
        }
        fp.update(self._layout.fingerprint_extra(self))
        return fp

    def spill_stats(self) -> dict:
        """Spill-tier accounting: preempt/resume totals, parked requests,
        reclaimable device-resident spilled blocks (part of the exact
        free/resident/spilled/scratch partition), written blocks held on
        the host, and the download/upload byte totals."""
        return {
            "enabled": self._layout.spillable,
            "spill_tier": self.spill_tier,
            "preempts_total": self._preempts_total,
            "resumes_total": self._resumes_total,
            "spilled_requests": len(self._spilled),
            "spilled_blocks_device": len(self._spill_owner),
            "spilled_blocks_host": sum(sp.written
                                       for sp in self._spilled.values()),
            "spill_bytes_total": self._spill_bytes_total,
            "upload_bytes_total": self._upload_bytes_total,
            "reclaims_total": self._spill_reclaims_total,
        }

    # -- the tick ------------------------------------------------------------
    def _sync_step_inputs(self) -> None:
        """Rewrite the decode step's static inputs (one upload) when slot
        membership changed since the last step; otherwise they already
        hold what the last step fed back.  Free and prefilling slots
        decode greedily on the base model (their output is discarded).  A
        slot's next draw is its token count: the prefill drew step 0."""
        if not self._membership_dirty:
            return
        n = self.slots
        active = np.zeros(n, np.int32)
        temp = np.zeros(n, np.float32)
        tk = np.zeros(n, np.int32)
        tp = np.ones(n, np.float32)
        seed = np.zeros(n, np.int64)
        step = np.zeros(n, np.int64)
        adapter = np.zeros(n, np.int32)
        for slot, st in self._active.items():
            cfg = st.req.sampling
            active[slot] = 1
            temp[slot], tk[slot], tp[slot], seed[slot] = cfg[:4]
            step[slot] = cfg.draws + len(st.tokens)
            adapter[slot] = st.req.adapter
        self._steps.upload(tok=self._last_tok, active=active,
                           temperature=temp, top_k=tk, top_p=tp, seed=seed,
                           step=step, adapter=adapter)
        self._membership_dirty = False

    def _pool_decode(self, tok):
        """One batched decode step over every slot (``tok`` is the static
        token buffer): inactive slots are frozen (index unchanged, token
        forced to 0) and, on the paged layout, write into the scratch
        block through a masked copy of the tables, the pool's own rows
        untouched.  The sampled token overwrites ``tok`` and active rows'
        draw counters advance, on the device.  Returns the token buffer
        and the step's logits [slots, V]."""
        st = self._steps
        active = st.active.bool()
        cache = self._cache
        if self._layout.paged:
            cache = self._masked_tables(cache, active)
        logits, new_cache = self._session._run_model(
            tok[:, None].long(), cache,
            self._session._adapter_ids(st.adapter), collective_seam=True)
        nxt = sample_logits_data(logits[:, 0], st.temperature, st.top_k,
                                 st.top_p, st.seed, st.step)
        self._layout.freeze_step(new_cache, self._cache, active)
        tok.copy_(torch.where(active, nxt, torch.zeros_like(nxt)))
        st.step.add_(st.active)
        return tok, logits[:, 0]

    def step(self) -> bool:
        """Refill free slots, run at most one prefill chunk, then ONE
        batched decode step; False when the pool is drained (nothing
        queued, prefilling, active or spilled).

        ``pool.step`` is the step's fault seam.  With a tracer installed
        each phase is a span: ``tick.admit`` (the refill, bucketed
        prefills included), ``tick.decode`` (the graph replay; under deep
        timing it ends when the card finishes), ``tick.sample`` (the
        token download) and ``tick.deliver`` (committing tokens and
        firing the hooks)."""
        _fire("pool.step")
        tr = _trace_active()
        if tr is None:
            self._refill()
        else:
            with tr.span("tick.admit"):
                self._refill()
        if self._chunk_tokens is not None:
            # prompt work before the decode step: a prompt whose last
            # chunk ran this tick decodes its second token this tick too
            self._chunk_work()
        if not self._active:
            return bool(self._queue or self._prefilling or self._spilled
                        or self._prefill_done)
        self._sync_step_inputs()
        if tr is None:
            tok, _ = self._decode_fn(self._steps.tok)
            # the designed sync point: one download of the token vector
            host = tok.cpu().numpy().copy()
        else:
            with tr.span("tick.decode"):
                tok, _ = self._decode_fn(self._steps.tok)
                _device_edge(tr)
            with tr.span("tick.sample"):
                host = tok.cpu().numpy().copy()
        self.decode_steps_total += 1
        self._last_tok = host
        if tr is None:
            self._deliver(host)
        else:
            with tr.span("tick.deliver"):
                self._deliver(host)
        return bool(self._active or self._queue or self._prefilling
                    or self._spilled or self._prefill_done)

    def refresh_weights(self) -> None:
        """Make later steps serve the model's current weights (call after
        changing them, e.g. ``load_state_dict``).  The steps read the
        parameters by address, eagerly and inside captured graphs alike:
        weights written in place need nothing more, and a captured graph
        whose parameters or buffers were REPLACED (``load_state_dict(...,
        assign=True)``, ``param.data = ...``, ``module.to``) is dropped, so
        its key's next call warms up and captures again on the new tensors;
        ``compile_counts()`` does not move.  A changed shape or dtype
        raises ``InvalidArgumentError``: a step keeps the shapes and dtypes
        it was captured with, as the reference's executables do."""
        _fire("weights.refresh")
        if self._mesh is not None:
            # the mp shards' weight slices are copies: refresh them in
            # place, so captured steps keep reading them by address
            self._mesh.place_weights(self._model)
        for fn in self._captured_steps():
            fn.drop_moved()

    # -- multi-LoRA hot swap ------------------------------------------------
    @property
    def lora_config(self):
        """``(n_adapters, rank)`` of the bank read at construction, or
        None."""
        return self._lora_cfg

    def load_adapter(self, idx: int, weights) -> None:
        """Write one adapter's weights into bank row ``idx`` (in place,
        ``nn.lora.load_adapter``) and make the next tick serve them: the
        bank never moves, so no graph is dropped or captured and
        ``cost_version()`` does not move."""
        _lora_mod.load_adapter(self._model, idx, weights)
        self.refresh_weights()

    def unload_adapter(self, idx: int) -> None:
        """Zero bank row ``idx`` back to the identity.  Refuses while any
        request (queued, prefilling, decoding, spilled or parked
        prefill-complete) is pinned to it: it would continue under the
        base model mid-stream."""
        if self._lora_cfg is not None:
            idx_i = int(idx)
            live = [st.req.adapter for st in self._active.values()]
            live += [st.req.adapter for st in self._prefilling.values()]
            live += [sp.req.adapter for sp in self._spilled.values()]
            live += [st.req.adapter for _, st in self._prefill_done.values()]
            live += [rq.adapter for rq in self._queue]
            if idx_i in live:
                raise PreconditionNotMetError(
                    "adapter %d still has live requests pinned to it; "
                    "drain or cancel them before unloading -- an in-flight "
                    "request would silently fall back to the base model "
                    "mid-stream" % idx_i)
        _lora_mod.unload_adapter(self._model, idx)
        self.refresh_weights()

    def _steps_all(self) -> list:
        """Every step wrapper of the pool and its session."""
        return [fn for fn in vars(self).values()
                if isinstance(fn, AotFunction)] + [
            fn for fn in vars(self._session).values()
            if isinstance(fn, AotFunction)]

    def release_device(self) -> None:
        """Give the pool's card memory back now: destroy every captured
        graph (their private pools return to the allocator) and drop the
        cache, the session's caches and the step buffers, then empty the
        allocator's cache.  The pool is unusable afterwards; its counts
        and cost reports stay readable."""
        with CAPTURE_GUARD:
            for fn in self._steps_all():
                fn.release_graphs()
            self._drop_device_state()
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def _drop_device_state(self) -> None:
        self._cache = None
        self._steps = None
        self._chunk_in = None
        self._session._batches = {}
        self._spilled = {}
        self._spill_owner = {}

    def _captured_steps(self) -> list:
        """The capturing steps that read the model's weights."""
        return [fn for fn in (self._decode_fn, self._chunk_fn,
                              self._session._decode_fn) if fn is not None]

    def _deliver(self, tok) -> None:
        """Commit the step's token to every active slot; finish rows that
        hit EOS or their budget."""
        for slot in list(self._active):
            state = self._active[slot]
            t = int(tok[slot])
            state.tokens.append(t)
            state.remaining -= 1
            if self.on_token is not None:
                self.on_token(state.rid, t)
            if state.remaining == 0 or (self.eos_id is not None
                                        and t == self.eos_id):
                self._finish(slot)

    def _finish(self, slot: int):
        state = self._active.pop(slot)
        self._membership_dirty = True
        tokens = np.asarray(state.tokens, np.int32)
        self._results[state.rid] = tokens
        reason = classify_finish(tokens, self.eos_id)
        self._finish_reasons[state.rid] = reason
        self._free.append(slot)
        # the slot's stale table row is masked to scratch in every step
        # until a refill overwrites it, so its blocks are reusable now
        self._release_blocks(slot)
        if self.on_finish is not None:
            self.on_finish(state.rid, tokens, reason)

    def release(self, slot: int):
        """Free ``slot`` (decoding or still prefilling) and decref its
        blocks without recording a result; returns the request id it
        served."""
        state = self._active.pop(slot, None) \
            or self._prefilling.pop(slot, None)
        if state is None:
            raise NotFoundError(
                "slot %r is not active or prefilling (active slots: %s, "
                "prefilling: %s)" % (slot, sorted(self._active),
                                     sorted(self._prefilling)))
        self._free.append(slot)
        self._membership_dirty = True
        self._release_blocks(slot)
        self._used_rids.discard(state.rid)
        return state.rid

    def cancel(self, request_id):
        """Abort one request wherever it lives: ``"queued"``, ``"active"``
        (slot and blocks freed mid-generation, mid-prefill included),
        ``"preempted"`` (its spilled device blocks freed, its host copy
        dropped) or ``"finished"`` (the uncollected result dropped).
        ``on_finish`` does not fire."""
        for i, req in enumerate(self._queue):
            if req.rid == request_id:
                del self._queue[i]
                self._used_rids.discard(request_id)
                return "queued"
        for slot, state in list(self._active.items()) \
                + list(self._prefilling.items()):
            if state.rid == request_id:
                self.release(slot)
                return "active"
        sp = self._spilled.pop(request_id, None)
        if sp is not None:
            self._prefix_epoch += 1
            for b in sp.dev_blocks:
                if b is not None:
                    self._spill_owner.pop(b, None)
                    self._free_block(b)
            self._used_rids.discard(request_id)
            self._spill_drop(sp)
            return "preempted"
        parked = self._prefill_done.pop(request_id, None)
        if parked is not None:
            # a prefill-complete request cancelled before its export
            slot, _st = parked
            self._free.append(slot)
            self._release_blocks(slot)
            self._used_rids.discard(request_id)
            self._membership_dirty = True
            return "prefill-done"
        if request_id in self._results:
            del self._results[request_id]
            self._finish_reasons.pop(request_id, None)
            self._used_rids.discard(request_id)
            return "finished"
        raise NotFoundError(
            "request_id %r is not queued, active, preempted, or awaiting "
            "collection" % (request_id,))

    def collect(self, request_id):
        """Pop one finished request's ``(tokens, finish_reason)``."""
        if request_id not in self._results:
            raise NotFoundError(
                "request_id %r has no finished result (still queued or "
                "active, cancelled, or already collected)" % (request_id,))
        tokens = self._results.pop(request_id)
        self._used_rids.discard(request_id)
        return tokens, self._finish_reasons.pop(request_id, None)

    def reset(self):
        """Discard every request and all cache and allocator state --
        queue, slots, results, free list, spill tier, prefix index and
        the K/V themselves (the index and the spilled blocks name blocks
        of the cache being discarded, so they go with it) -- while KEEPING
        the steps' keys and graphs: the cache is zeroed in place, so a
        captured step still reads it, and ``compile_counts()`` does not
        change."""
        self._queue.clear()
        self._active.clear()
        self._prefilling.clear()
        self._free = list(range(self.slots))
        self._last_tok = np.zeros(self.slots, np.int32)
        self._membership_dirty = True
        self._results.clear()
        self._finish_reasons.clear()
        self._used_rids.clear()
        # disk-tier files die with the pool too: stale K/V under a
        # recurring rid would be worse than no file
        for sp in self._spilled.values():
            self._spill_drop(sp)
        self._spilled.clear()
        self._spill_owner.clear()
        self._prefill_done.clear()
        self.admission_blocked = False
        if self._layout.paged:
            self._free_by_shard = self._fresh_free_lists()
            self._slot_blocks = {}
            self._block_refs = {}
            self._prefix_index.clear()
            self._block_keys.clear()
            self._prefix_epoch += 1
            self._head_match = None
        self._layout.zero_cache(self._cache, self.max_len)

    # -- compiled-step contract -------------------------------------------
    def compile_counts(self) -> dict:
        """The shape keys each step has met: the session's ``prefill``
        and ``decode``, ``pool_decode`` and ``slot_insert``, and with
        chunked prefill ``prefill_chunk`` and ``slot_admit`` -- one key
        per step shape, never one per prompt length.  On the card a key
        of ``pool_decode``/``prefill_chunk`` holds one captured CUDA
        graph; on the CPU a key is only a distinct shape."""
        counts = self._session.compile_counts()
        counts["pool_decode"] = self._decode_fn._cache_size()
        counts["slot_insert"] = self._insert_fn._cache_size()
        if self._chunk_fn is not None:
            counts["prefill_chunk"] = self._chunk_fn._cache_size()
            counts["slot_admit"] = self._admit_fn._cache_size()
        return counts

    def cost_version(self) -> int:
        """The cost reports' version: moves only when a step meets a new
        shape (its key counted) or, on the card, captures its graph (the
        graph's pool measured).  The engine re-reads :meth:`cost_report`
        only when this moves."""
        return self._session.cost_version() + sum(
            fn.cost_revision for fn in (self._decode_fn, self._insert_fn,
                                        self._chunk_fn, self._admit_fn)
            if fn is not None)

    def _derived_costs(self, step_entry: Optional[dict],
                       tokens_per_step_per_slot: float = 1.0,
                       basis: str = "decode step advances every slot one "
                                    "token") -> dict:
        """One batched step's FLOPs and bytes divided over the tokens it
        commits (shared with the speculative pool).  ``step_entry`` is the
        steady-state step's cost entry (None before its first call).
        ``hbm_reserved_bytes`` is None where the entry has no temp bytes
        (the CPU, or before the capture)."""
        if not step_entry or "flops" not in step_entry:
            return {}
        tokens = self.slots * float(tokens_per_step_per_slot)
        out = {
            "step_flops": step_entry["flops"],
            "step_bytes_accessed": step_entry["bytes_accessed"],
            "hbm_reserved_bytes": step_entry.get("hbm_reserved_bytes"),
            "kv_cache_bytes": step_entry.get("kv_cache_bytes"),
            "flops_per_token": step_entry["flops"] / tokens,
            "bytes_per_token": step_entry["bytes_accessed"] / tokens,
            "tokens_per_step": tokens,
            "basis": basis,
        }
        if self._mesh is not None:
            # one single-controller step runs every shard: the counts are
            # mesh totals (the reference's per-device SPMD analyses times
            # dp x mp); the collective columns are per device
            out["mesh"] = self._mesh.describe()
            out["basis"] += ("; one program over dp x mp = %d shards -- "
                             "counts are mesh totals"
                             % self._mesh.devices_n)
            out.update(self._session.collective_report())
        return out

    def cost_report(self) -> dict:
        """The cost entry of every step key this pool ran (``jit.aot``:
        counted once per key at its first call), plus ``derived``: the
        batched decode step's FLOPs and bytes divided over the ``slots``
        tokens it commits, behind the engine's ``serving_step_flops`` /
        ``serving_step_bytes_accessed`` / ``serving_hbm_reserved_bytes``
        gauges.  ``kv_cache_bytes`` equals ``cache_stats()["pool_bytes"]``
        for every layout and dtype.  A read: it counts, captures and
        synchronizes nothing, and adds no key."""
        rep = self._session.cost_report()
        rep["pool_decode"] = self._decode_fn.cost_report()
        rep["slot_insert"] = self._insert_fn.cost_report()
        if self._chunk_fn is not None:
            rep["prefill_chunk"] = self._chunk_fn.cost_report()
            rep["slot_admit"] = self._admit_fn.cost_report()
        rep["derived"] = self._derived_costs(self._decode_fn.last_cost())
        return rep

    # -- introspection -------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        """Slots currently decoding."""
        return len(self._active)

    @property
    def prefilling_count(self) -> int:
        """Slots whose prompt is still being chunk-prefilled."""
        return len(self._prefilling)

    @property
    def prefill_chunk_tokens(self) -> Optional[int]:
        """The per-tick prompt-work bound (None: one-shot prefill)."""
        return self._chunk_tokens

    @property
    def preempted_count(self) -> int:
        """Requests parked in the spill tier."""
        return len(self._spilled)

    @property
    def prefill_done_count(self) -> int:
        """Prefill-complete requests parked for export (0 unless
        ``prefill_only=True``)."""
        return len(self._prefill_done)

    def has_prefill_done(self, request_id) -> bool:
        """Whether ``request_id`` is parked prefill-complete."""
        return request_id in self._prefill_done

    def run(self) -> Dict[object, np.ndarray]:
        """Drain queue and slots; {request_id: np.int32 tokens}."""
        while self.step():
            pass
        out, self._results = self._results, {}
        self._used_rids -= set(out)
        for rid in out:
            self._finish_reasons.pop(rid, None)
        return out

    def generate(self, prompts, max_new_tokens: int) -> List[np.ndarray]:
        """Submit all, drain, return in submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        results = self.run()
        return [results[r] for r in rids]

    def _shared_block_count(self) -> int:
        """Block references beyond each block's first owner: the memory
        prefix sharing saves right now."""
        if not self._layout.paged:
            return 0
        return sum(r - 1 for r in self._block_refs.values() if r > 1)

    def reset_prefix_stats(self) -> None:
        """Zero the cumulative hit/query/chunk counters (between a warm-up
        and a measured run)."""
        self._prefix_queries = self._prefix_hits = 0
        self._prefix_tokens_matched = self._prefix_blocks_matched = 0
        self._chunks_total = self._chunk_tokens_total = 0

    def prefix_stats(self) -> dict:
        """Prefix-sharing and chunked-prefill accounting: queries and hits
        are cumulative over admissions; ``blocks_shared_now`` is live."""
        q = self._prefix_queries
        return {
            "enabled": self.prefix_sharing,
            "queries": q,
            "hits": self._prefix_hits,
            "hit_rate": (self._prefix_hits / q) if q else 0.0,
            "tokens_matched": self._prefix_tokens_matched,
            "blocks_matched": self._prefix_blocks_matched,
            "blocks_shared_now": self._shared_block_count(),
            "indexed_blocks": len(self._prefix_index),
            "prefill_chunk_tokens": self._chunk_tokens,
            "prefill_chunks_total": self._chunks_total,
            "prefill_chunk_tokens_total": self._chunk_tokens_total,
        }

    def prefix_digest(self, since_epoch: Optional[int] = None
                      ) -> Optional[dict]:
        """The chain-hash keys in the prefix index, stamped with the
        allocator epoch: with ``since_epoch`` equal to the current epoch
        the key set is left out (nothing changed).  None when sharing is
        off."""
        if not self.prefix_sharing:
            return None
        d = {"epoch": self._prefix_epoch, "block_size": self._block_size,
             "indexed_blocks": len(self._prefix_index)}
        if since_epoch is None or since_epoch != self._prefix_epoch:
            d["keys"] = frozenset(self._prefix_index)
        return d

    def cache_stats(self) -> dict:
        """Live KV accounting: layout, allocator occupancy, and the bytes
        a decode step can reach now against a dense preallocation.  A
        recurrent pool's state is ``[slots, d_state]`` per layer, so what
        a step reaches is what the pool holds, whatever the context;
        ``state_bytes_per_slot`` is the per-slot figure every layout
        stamps, the denominator of slots per GB.

        ``per_shard`` restates the partition per dp shard (one entry,
        the totals, when unsharded), the figure a per-device capacity
        decision reads; under a mesh ``mesh`` describes it, the
        ``collective_*`` columns carry the decode step's mp-reduction
        bytes, and ``pool_bytes_per_device`` is one shard's share."""
        first = first_part(self._cache[0])
        mesh_stats = {}
        if self._mesh is not None:
            mesh_stats["mesh"] = self._mesh.describe()
            mesh_stats["collective_quant"] = self._session.collective_quant
        if not self._layout.positional:
            total = sum(_nbytes(part.state) for c in self._cache
                        for _, part in cache_parts(c))
            stats = {"cache_layout": self.cache_layout,
                     "cache_dtype": self._layout.cache_dtype_str(self._cache),
                     "decode_route": self._session.route,
                     "d_state": int(first.state.shape[-1]),
                     "num_layers": len(self._cache),
                     "state_bytes_per_slot":
                         self._layout.state_bytes_per_slot(
                             self._cache, self.slots, self.max_len),
                     "reachable_bytes": total, "pool_bytes": total}
            # a recurrence has no row-parallel seams: the mode is stamped,
            # no collective columns exist
            stats.update(mesh_stats)
            stats["per_shard"] = [
                {"shard": s, "reachable_bytes": total // self._dp,
                 "pool_bytes": total // self._dp} for s in range(self._dp)]
            if self._mesh is not None:
                # the carry is whole per slot: mp does not shard it
                stats["pool_bytes_per_device"] = total // self._dp
            return stats
        dims = dict(max_len=self.max_len, num_layers=len(self._cache),
                    num_heads=int(first.k.shape[1]) * self._mp,
                    head_dim=first.k.shape[3], dtype=first.k.dtype)
        dense_bytes = kv_reachable_bytes([self.max_len] * self.slots,
                                         layout="dense", **dims)
        stats = {"cache_layout": self.cache_layout,
                 "cache_dtype": self._layout.cache_dtype_str(self._cache),
                 "decode_route": self._session.route,
                 "state_bytes_per_slot": self._layout.state_bytes_per_slot(
                     self._cache, self.slots, self.max_len),
                 "dense_equiv_bytes": dense_bytes}
        if mesh_stats:
            stats.update(mesh_stats)
            stats.update(self._session.collective_report())
        if self._layout.paged:
            bs = self._block_size
            # each unique resident block once (a shared block occupies its
            # memory once), at its readable tokens: logical block j covers
            # [j*bs, (j+1)*bs) capped at max_len
            seen: Dict[int, int] = {}
            for blocks in self._slot_blocks.values():
                for j, b in enumerate(blocks):
                    seen.setdefault(b, j)
            per_token = dense_bytes // (self.slots * self.max_len)

            def readable(j):
                return max(0, min((j + 1) * bs, self.max_len) - j * bs)

            reachable = per_token * sum(readable(j) for j in seen.values())
            pool_bytes = self._num_blocks * bs * per_token
            stats.update(block_size=bs, num_blocks=self._num_blocks,
                         free_blocks=sum(map(len, self._free_by_shard)),
                         mapped_blocks=len(self._block_refs),
                         spilled_blocks=len(self._spill_owner),
                         reachable_bytes=reachable,
                         shared_blocks=self._shared_block_count(),
                         pool_bytes=pool_bytes)
            if self._dp == 1:
                mapped_by = [len(self._block_refs)]
                spilled_by = [len(self._spill_owner)]
                reach_by = [reachable]
            else:
                mapped_by = [0] * self._dp
                for b in self._block_refs:
                    mapped_by[self._shard_of_block(b)] += 1
                spilled_by = [0] * self._dp
                for b in self._spill_owner:
                    spilled_by[self._shard_of_block(b)] += 1
                reach_by = [0] * self._dp
                for b, j in seen.items():
                    reach_by[self._shard_of_block(b)] += \
                        per_token * readable(j)
            stats["per_shard"] = [{
                "shard": s,
                "num_blocks": self._blocks_per_shard,
                "scratch_block": self._shard_scratch(s),
                "free_blocks": len(self._free_by_shard[s]),
                "mapped_blocks": mapped_by[s],
                "spilled_blocks": spilled_by[s],
                "reachable_bytes": reach_by[s],
                "pool_bytes": pool_bytes // self._dp,
            } for s in range(self._dp)]
        else:
            stats.update(reachable_bytes=dense_bytes, pool_bytes=dense_bytes)
            stats["per_shard"] = [
                {"shard": s, "reachable_bytes": dense_bytes // self._dp,
                 "pool_bytes": dense_bytes // self._dp}
                for s in range(self._dp)]
        if self._mesh is not None:
            # one shard's bytes: dp splits the slot/block axis, mp the
            # head axis of every K/V (and scale) tensor
            stats["pool_bytes_per_device"] = \
                stats["pool_bytes"] // self._mesh.devices_n
        return stats

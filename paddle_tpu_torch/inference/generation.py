"""Slot-based continuous batching over the KV-cached decode engine
(counterpart of the reference's ``inference/generation.py``, its first
sub-slice).

``GenerationPool`` packs concurrent requests into N cache SLOTS that share
one batched decode step (the slot-batched cache whose index is a per-row
``[slots]`` vector).  Per ``step()``:

1. free slots are refilled from the queue, FIFO: each admitted request
   runs a bucketed batch-1 prefill (``DecodeSession.prefill``) and its row
   cache is spliced into the slot;
2. one batched decode step advances every active slot a token; inactive
   slots are masked -- their index does not advance, and on the paged
   layout their table rows point at the scratch block for the step, so a
   stale write can never land in a block another request now owns;
3. the sampled ids (the one host download per step) are appended per
   request; rows that hit EOS or their budget release the slot.

``cache_layout="paged"`` keeps K/V in a global pool of fixed-size blocks
behind a ``[slots, max_blocks]`` table, with a host-side allocator: block
0 is the reserved scratch block and is never handed out; a request
reserves its worst-case span at admission (so decode never runs out of
blocks) and the queue head waits when blocks are scarce; blocks carry
refcounts and return to the free list when a request finishes or is
cancelled.

Not ported yet (later sub-slices): chunked prefill and prefix sharing,
priority scheduling, preemption and the spill tiers, meshes, LoRA.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.errors import (AlreadyExistsError, InvalidArgumentError,
                           NotFoundError)
from ..jit.cache import get_layout
from ..jit.decode import (DecodeSession, check_sampling, classify_finish,
                          make_sampling_state, sample_logits_data)

__all__ = ["GenerationPool", "kv_reachable_bytes", "DuplicateRequestError"]


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


# per-request sampling config, resolved at submit: ``seed`` is always a
# concrete int, so the request's stream is a pure function of itself
_SamplingConfig = collections.namedtuple(
    "_SamplingConfig", ["temperature", "top_k", "top_p", "seed"])

_Request = collections.namedtuple(
    "_Request", ["rid", "ids", "max_new_tokens", "sampling"])


class _SlotState:
    """One actively decoding slot."""

    __slots__ = ("rid", "ids", "tokens", "remaining", "sampling")

    def __init__(self, rid, ids, tokens, remaining: int, sampling):
        self.rid = rid
        self.ids = ids
        self.tokens = tokens
        self.remaining = remaining
        self.sampling = sampling


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
                 num_blocks: Optional[int] = None, route: str = "auto",
                 device=None):
        if slots < 1:
            raise InvalidArgumentError("GenerationPool needs slots >= 1")
        self.device = resolve_device(device)
        self._layout = get_layout(cache_layout)
        # the session owns the model, the sampling defaults and the
        # bucketed batch-1 prefill; it shares the pool's layout, so a paged
        # pool gets identity-tabled row caches whose blocks splice straight
        # into the global block pool
        self._session = DecodeSession(
            model, max_len, buckets=buckets, temperature=temperature,
            top_k=top_k, top_p=top_p, cache_dtype=cache_dtype,
            cache_layout=cache_layout, block_size=block_size, route=route,
            device=self.device)
        self._model = model
        self._cache_dtype = cache_dtype
        self._vocab = getattr(model, "vocab_size", None)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.eos_id = eos_id
        self.cache_layout = cache_layout
        self._block_size = int(block_size)
        self._max_blocks = -(-self.max_len // self._block_size)
        if cache_layout == "paged":
            # default: full capacity (every slot at max_len) plus scratch
            if num_blocks is None:
                num_blocks = 1 + self.slots * self._max_blocks
            num_blocks = int(num_blocks)
            if num_blocks < 2:
                raise InvalidArgumentError(
                    "paged pool needs >= 2 blocks (one scratch + one "
                    "allocatable), got num_blocks=%d" % num_blocks)
            self._num_blocks = num_blocks
            self._free_blocks: List[int] = list(range(1, num_blocks))
            self._slot_blocks: Dict[int, List[int]] = {}
            # refcount per resident block (absent = free); a block returns
            # to the free list only when its count reaches 0
            self._block_refs: Dict[int, int] = {}
        elif num_blocks is not None:
            raise InvalidArgumentError(
                "num_blocks is a paged-cache knob; pass cache_layout="
                "'paged' (got %r)" % (cache_layout,))
        self._cache = self._new_cache()
        self._sampling_seed = int(seed)
        self._seq = 0
        self._queue: collections.deque = collections.deque()
        self._active: Dict[int, _SlotState] = {}
        self._free: List[int] = list(range(self.slots))
        self._last_tok = np.zeros(self.slots, np.int32)
        self._results: Dict[object, np.ndarray] = {}
        self._finish_reasons: Dict[object, str] = {}
        self._used_rids: set = set()
        self._next_rid = 0
        self.admission_blocked = False
        # counters a caller can read to split a run into its phases
        self.prefills_total = 0
        self.decode_steps_total = 0
        # lifecycle hooks (the serving engine sets these): on_admit(rid,
        # slot, prompt_len); on_token(rid, token) for every emitted token
        # including the prefill's first; on_finish(rid, tokens, reason)
        # when a request completes (not on cancel/release)
        self.on_admit = None
        self.on_token = None
        self.on_finish = None

    # -- cache and allocator ---------------------------------------------
    def _new_cache(self):
        return self._model.gen_decode_cache(
            self.slots, self.max_len, self._cache_dtype, per_slot=True,
            layout=self.cache_layout, block_size=self._block_size,
            num_blocks=(self._num_blocks if self.cache_layout == "paged"
                        else None))

    def _blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Blocks a request reserves at admission: its worst-case span
        (prompt + generated, capped at max_len)."""
        span = min(prompt_len + max_new_tokens, self.max_len)
        return -(-span // self._block_size)

    def _alloc_blocks(self, n: int) -> List[int]:
        """Pop ``n`` free blocks at refcount 1 (callers check there are
        enough)."""
        blocks = [self._free_blocks.pop() for _ in range(n)]
        for b in blocks:
            self._block_refs[b] = 1
        return blocks

    def _release_blocks(self, slot: int) -> None:
        """Decref every block the slot maps; blocks at 0 return to the
        free list."""
        if self.cache_layout != "paged":
            return
        for b in self._slot_blocks.pop(slot, ()):
            left = self._block_refs.get(b, 1) - 1
            if left > 0:
                self._block_refs[b] = left
                continue
            self._block_refs.pop(b, None)
            self._free_blocks.append(b)

    def _masked_tables(self, cache, active):
        """Inactive slots' table rows point at the scratch block for the
        step: a stale write must not land in blocks a refilled request now
        owns."""
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
               temperature=None, top_k=None, top_p=None, seed=None):
        """Queue one prompt (1-D ids); returns the request id."""
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
        if len(ids) + max_new_tokens > self.max_len:
            raise InvalidArgumentError(
                "prompt %d + max_new_tokens %d exceeds cache max_len %d"
                % (len(ids), max_new_tokens, self.max_len))
        self._session._bucket_for(len(ids))
        if self.cache_layout == "paged":
            need = self._blocks_needed(len(ids), max_new_tokens)
            if need > self._num_blocks - 1:
                raise InvalidArgumentError(
                    "request needs %d KV blocks (prompt %d + max_new_tokens "
                    "%d at block_size %d) but the pool has only %d "
                    "allocatable blocks; raise num_blocks or lower "
                    "max_new_tokens" % (need, len(ids), max_new_tokens,
                                        self._block_size,
                                        self._num_blocks - 1))
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
        samp = self._resolve_sampling(temperature, top_k, top_p, seed)
        self._queue.append(_Request(rid, ids.astype(np.int32),
                                    int(max_new_tokens), samp))
        return rid

    def _refill(self):
        """Admit queued requests FIFO into free slots.  On the paged
        layout the head waits (``admission_blocked``) until its whole
        reservation is free -- skipping ahead would starve long prompts."""
        self.admission_blocked = False
        while self._queue and self._free:
            req = self._queue[0]
            need = 0
            if self.cache_layout == "paged":
                need = self._blocks_needed(len(req.ids), req.max_new_tokens)
                if need > len(self._free_blocks):
                    self.admission_blocked = True
                    break
            self._queue.popleft()
            cfg = req.sampling
            samp = make_sampling_state(1, cfg.temperature, cfg.top_k,
                                       cfg.top_p, seed=cfg.seed)
            # prefill before taking the slot: a failing prefill leaks none
            row_cache, tok, _ = self._session.prefill(req.ids[None], samp)
            self.prefills_total += 1
            slot = self._free.pop()
            first = int(tok[0])
            if self.cache_layout == "paged":
                blocks = self._alloc_blocks(need)
                self._slot_blocks[slot] = blocks
                # unreserved logical blocks point at scratch: never read
                padded = np.zeros(self._max_blocks, np.int64)
                padded[:need] = blocks
            else:
                padded = None
            self._cache = self._layout.insert_row(self._cache, row_cache,
                                                  slot, len(req.ids), padded)
            if self.on_admit is not None:
                self.on_admit(req.rid, slot, len(req.ids))
            self._activate(slot, req, first)

    def _activate(self, slot: int, req: _Request, first: int) -> None:
        self._active[slot] = _SlotState(req.rid, req.ids, [first],
                                        req.max_new_tokens - 1, req.sampling)
        self._last_tok[slot] = first
        if self.on_token is not None:
            self.on_token(req.rid, first)
        if req.max_new_tokens == 1 or (self.eos_id is not None
                                       and first == self.eos_id):
            self._finish(slot)

    def _step_inputs(self):
        """Host-built per-slot vectors for one step: token, active mask
        and the sampling config (free slots decode greedily; their output
        is discarded)."""
        active = np.zeros(self.slots, bool)
        temp = np.zeros(self.slots, np.float32)
        tk = np.zeros(self.slots, np.int32)
        tp = np.ones(self.slots, np.float32)
        seed = np.zeros(self.slots, np.int64)
        step = np.zeros(self.slots, np.int64)
        for slot, st in self._active.items():
            active[slot] = True
            cfg = st.sampling
            temp[slot], tk[slot], tp[slot], seed[slot] = cfg
            # the prefill drew step 0; the next draw is the token count
            step[slot] = len(st.tokens)
        return active, (temp, tk, tp, seed, step)

    def _pool_decode(self, toks, active, samp):
        """One batched decode step over every slot: inactive slots are
        frozen (index unchanged, token forced to 0) and, on the paged
        layout, write into the scratch block; the original table rows are
        kept in the pool's cache."""
        cache = self._cache
        if self.cache_layout == "paged":
            cache = self._masked_tables(cache, active)
        logits, new_cache = self._session._run_model(toks[:, None], cache)
        tok = sample_logits_data(logits[:, 0], *samp)
        new_cache = self._layout.freeze_step(new_cache, cache, active)
        if self.cache_layout == "paged":
            new_cache = [c._replace(table=old.table)
                         for c, old in zip(new_cache, self._cache)]
        self._cache = new_cache
        return torch.where(active, tok, torch.zeros_like(tok))

    def step(self) -> bool:
        """Refill free slots and run ONE batched decode step; False when
        the pool is drained (no queued or active requests)."""
        self._refill()
        if not self._active:
            return bool(self._queue)
        active, samp = self._step_inputs()
        dev = self.device
        tok = self._pool_decode(
            torch.from_numpy(self._last_tok).to(dev).long(),
            torch.from_numpy(active).to(dev), samp)
        self.decode_steps_total += 1
        host = tok.cpu().numpy().astype(np.int32)
        self._last_tok = host
        self._deliver(host)
        return bool(self._active or self._queue)

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
        """Free ``slot`` (and its blocks) without recording a result;
        returns the request id it served."""
        state = self._active.pop(slot, None)
        if state is None:
            raise NotFoundError(
                "slot %r is not active (active slots: %s)"
                % (slot, sorted(self._active)))
        self._free.append(slot)
        self._release_blocks(slot)
        self._used_rids.discard(state.rid)
        return state.rid

    def cancel(self, request_id):
        """Abort one request wherever it lives: ``"queued"``, ``"active"``
        (slot and blocks freed mid-generation) or ``"finished"`` (the
        uncollected result dropped).  ``on_finish`` does not fire."""
        for i, req in enumerate(self._queue):
            if req.rid == request_id:
                del self._queue[i]
                self._used_rids.discard(request_id)
                return "queued"
        for slot, state in list(self._active.items()):
            if state.rid == request_id:
                self.release(slot)
                return "active"
        if request_id in self._results:
            del self._results[request_id]
            self._finish_reasons.pop(request_id, None)
            self._used_rids.discard(request_id)
            return "finished"
        raise NotFoundError(
            "request_id %r is not queued, active, or awaiting collection"
            % (request_id,))

    def collect(self, request_id):
        """Pop one finished request's ``(tokens, finish_reason)``."""
        if request_id not in self._results:
            raise NotFoundError(
                "request_id %r has no finished result (still queued or "
                "active, cancelled, or already collected)" % (request_id,))
        tokens = self._results.pop(request_id)
        self._used_rids.discard(request_id)
        return tokens, self._finish_reasons.pop(request_id, None)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._active)

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

    def cache_stats(self) -> dict:
        """Live KV accounting: layout, allocator occupancy, and the bytes
        a decode step can reach now against a dense preallocation."""
        first = self._cache[0]
        dims = dict(max_len=self.max_len, num_layers=len(self._cache),
                    num_heads=first.k.shape[1], head_dim=first.k.shape[3],
                    dtype=first.k.dtype)
        dense_bytes = kv_reachable_bytes([self.max_len] * self.slots,
                                         layout="dense", **dims)
        stats = {"cache_layout": self.cache_layout,
                 "cache_dtype": self._layout.cache_dtype_str(self._cache),
                 "decode_route": self._session.route,
                 "state_bytes_per_slot": self._layout.state_bytes_per_slot(
                     self._cache, self.slots, self.max_len),
                 "dense_equiv_bytes": dense_bytes}
        if self.cache_layout == "paged":
            bs = self._block_size
            per_token = dense_bytes // (self.slots * self.max_len)
            reachable = per_token * sum(
                max(0, min((j + 1) * bs, self.max_len) - j * bs)
                for blocks in self._slot_blocks.values()
                for j in range(len(blocks)))
            stats.update(block_size=bs, num_blocks=self._num_blocks,
                         free_blocks=len(self._free_blocks),
                         mapped_blocks=len(self._block_refs),
                         reachable_bytes=reachable,
                         pool_bytes=self._num_blocks * bs * per_token)
        else:
            stats.update(reachable_bytes=dense_bytes, pool_bytes=dense_bytes)
        return stats

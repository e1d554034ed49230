"""Slot-batched speculative decoding: the draft/verify pool (counterpart
of the reference's ``inference/speculative.py``).

``SpeculativePool`` is ``GenerationPool`` with the decode step replaced by
a speculative ROUND (``jit/speculative.py`` has the single-request
anatomy): a small draft model runs ``k`` batched greedy steps over its own
dense fp32 slot cache, then the target judges every slot's ``[pending,
d_1..d_k]`` chunk in ONE per-slot chunk forward with a ``[slots]`` index
vector, so every slot accepts a different prefix length in the same
fixed-shape step.  The chunk's queries run kernel K1 on a paged target
(K2 on a dense one) at Lq = k+1; the draft's steps and its fixup run K2
at Lq 1.  Rejection rewinds each row's index; the rejected drafts' K/V
become stale rows the next chunk overwrites (paged writes past a slot's
reservation land in the scratch block through the padded table, and
positions past the table's span go there too).

Each round is three captured steps over static buffers, all replayed as
CUDA graphs on the card:

- ``draft_decode`` (one key, replayed ``k`` times): reads the last column
  of the chunk buffer ``[slots, spec_k+1]``, shifts the buffer left by
  one column and writes the draft's token into the last column, so after
  ``k`` steps its last ``k+1`` columns are ``[pending, d_1..d_k]``;
- ``verify`` (one key per ``k``, as the reference compiles one executable
  per chunk width): the target forward over that view, acceptance, the
  index rewind and the emission on the device; it writes ``emitted`` and
  ``m`` into one output buffer (the round's single download) and the
  next pending token into a buffer of its own;
- ``draft_fixup`` (one key): the catch-up write of ``d_k`` and the draft
  index rewind (``k`` is a device scalar, so one step serves every
  ``k``), then the pending token goes into the chunk's last column: the
  steady state feeds back on the device.

Each active slot commits 1 to ``k+1`` tokens a round, all of them exactly
what target-only greedy decode would have emitted; an EOS inside an
accepted chunk truncates the commit at the EOS.  Greedy only.  The
reference's ``cost_report`` is not ported yet.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from ..jit.aot import AotFunction, shape_key
from ..jit.cache import get_layout
from ..jit.decode import DecodeSession, truncate_at_eos
from ..jit.speculative import (acceptance_summary, check_draft_compatible,
                               greedy_accept)
from .generation import GenerationPool, _device_edge, _fire, _trace_active

__all__ = ["SpeculativePool"]


class SpeculativePool(GenerationPool):
    """Continuous batching whose step is a draft/verify round.

    ``model`` is the target; ``draft_model`` a (typically much smaller)
    causal model sharing the target's token id space.  The target cache
    takes the usual ``cache_layout``/``cache_dtype`` knobs; the draft
    keeps a dense fp32 slot cache.  ``time_split=True`` accumulates a
    draft/verify wall-clock split, synchronizing the device at each
    phase (a measurement mode, not for serving)."""

    def __init__(self, model, draft_model, max_len: int, spec_k: int = 4,
                 slots: int = 4, buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, cache_dtype="float32",
                 seed: int = 0, cache_layout: str = "dense",
                 block_size: int = 32, num_blocks: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, time_split: bool = False,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_sharing: bool = False,
                 tenant_slot_cap: Optional[int] = None,
                 route: str = "auto", spill_tier: str = "host",
                 spill_dir: Optional[str] = None, device=None):
        if float(temperature) != 0.0:
            raise InvalidArgumentError(
                "speculative decoding is greedy-only (temperature=0): "
                "got temperature=%r; use GenerationPool for sampled "
                "generation" % (temperature,))
        if int(spec_k) < 1:
            raise InvalidArgumentError(
                "spec_k must be >= 1 draft tokens per round, got %r"
                % (spec_k,))
        check_draft_compatible(draft_model, model)
        # top_k/top_p are accepted so the pool stays a drop-in under the
        # engine's **pool_kwargs (ignored at temperature 0)
        super().__init__(model, max_len, slots=slots, buckets=buckets,
                         eos_id=eos_id, cache_dtype=cache_dtype, seed=seed,
                         top_k=top_k, top_p=top_p,
                         cache_layout=cache_layout, block_size=block_size,
                         num_blocks=num_blocks,
                         prefill_chunk_tokens=prefill_chunk_tokens,
                         prefix_sharing=prefix_sharing,
                         tenant_slot_cap=tenant_slot_cap, route=route,
                         spill_tier=spill_tier, spill_dir=spill_dir,
                         device=device)
        self.spec_k = int(spec_k)
        # the draft session owns the draft model and its bucketed batch-1
        # prefill; its own decode step is unused
        self._draft_session = DecodeSession(
            draft_model, max_len, buckets=buckets, temperature=0.0,
            route=route, device=self.device)
        self._draft_cache = draft_model.gen_decode_cache(
            self.slots, self.max_len, "float32", per_slot=True)
        i32 = torch.int32
        # the round's static buffers (graphs read them by address)
        self._chunk = torch.zeros((self.slots, self.spec_k + 1), dtype=i32,
                                  device=self.device)
        self._chunk_views = {}
        self._out = torch.zeros((self.slots, self.spec_k + 2), dtype=i32,
                                device=self.device)
        self._m = self._out[:, -1]
        self._pending = torch.zeros(self.slots, dtype=i32,
                                    device=self.device)
        self._k_dev = torch.full((1,), self.spec_k, dtype=i32,
                                 device=self.device)
        self._draft_decode_fn = AotFunction(
            self._draft_decode, key_fn=lambda chunk: shape_key(chunk[:, -1]),
            name="draft_decode", capture=True)
        self._draft_fixup_fn = AotFunction(
            self._draft_fixup, key_fn=lambda chunk: shape_key(chunk[:, -1]),
            name="draft_fixup", capture=True)
        self._draft_insert_fn = AotFunction(
            get_layout("dense").insert_row, key_fn=lambda *a: "draft_insert",
            name="draft_insert")
        self._verify_fn = AotFunction(self._pool_verify, key_fn=shape_key,
                                      name="verify", capture=True)
        # the RUNTIME spec-K (<= the spec_k ceiling): the serving ladder
        # steps it down under SLO burn and back up when the alert clears
        self._spec_k_active = self.spec_k
        self._drafted = 0
        self._accepted = 0
        self._rounds = 0
        self._time_split = bool(time_split)
        self._draft_time_s = 0.0
        self._verify_time_s = 0.0

    # -- the captured steps ------------------------------------------------
    def _draft_decode(self, chunk):
        """One batched greedy draft step: the token in the chunk's last
        column in, the chunk shifted left one column and the draft's
        token written into the last.  Inactive slots are frozen (index
        unchanged, token 0)."""
        active = self._steps.active.bool()
        cache = self._draft_cache
        logits, new = self._draft_session._run_model(
            chunk[:, -1:].long(), cache)
        tok = logits[:, 0].argmax(dim=-1).to(torch.int32)
        for c, n in zip(cache, new):
            c.index.copy_(torch.where(active, n.index, c.index))
        chunk[:, :-1].copy_(chunk[:, 1:].clone())
        chunk[:, -1].copy_(torch.where(active, tok, torch.zeros_like(tok)))
        return chunk

    def _pool_verify(self, view):
        """One per-slot chunk forward of the target over ``view`` =
        ``[pending, d_1..d_k]`` ([slots, k+1], a view of the chunk
        buffer).  Acceptance, emission and the index rewind happen on the
        device.  Inactive slots are frozen: on the paged layout their
        table rows are routed to the scratch block for this step (a
        masked copy; the real rows, which a prefilling slot's chunks
        write through, are untouched), their index is kept and their
        emission zeroed."""
        active = self._steps.active.bool()
        cache = self._cache
        idx0 = cache[0].index.clone()
        if self._layout.paged:
            cache = self._masked_tables(cache, active)
        logits, _ = self._session._run_model(view.long(), cache)
        m, emitted = greedy_accept(logits, view, active)
        new_idx = torch.where(active, idx0 + m + 1, idx0)
        for c in self._cache:
            c.index.copy_(new_idx)
        k1 = view.shape[1]
        self._out[:, :k1].copy_(emitted)
        self._m.copy_(m)
        # each row's LAST emitted token: the next round's draft input
        self._pending.copy_(emitted.gather(1, m[:, None].long())[:, 0])
        return self._out

    def _draft_fixup(self, chunk):
        """Post-verify draft maintenance: the catch-up write of ``d_k``
        (the chunk's last column; fully accepted rows never wrote its
        K/V) and the rejection rewind, every active row's index moving to
        ``idx - k + m + 1`` (for catch-up rows, the position just
        written).  Rows with a partial acceptance also write ``d_k`` at a
        stale position the next round overwrites.  Then the pending
        tokens go into the last column for the next round."""
        active = self._steps.active.bool()
        cache = self._draft_cache
        idx_pre = cache[0].index.clone()
        self._draft_session._run_model(chunk[:, -1:].long(), cache)
        new_idx = torch.where(active, idx_pre - self._k_dev + self._m + 1,
                              idx_pre)
        for c in cache:
            c.index.copy_(new_idx)
        chunk[:, -1].copy_(self._pending)
        return chunk

    # -- host API --------------------------------------------------------
    def _draft_prefill_into(self, slot: int, ids) -> None:
        """Prefill the draft over ``ids`` (batch 1, bucketed) and splice
        its row cache into the draft slot cache; the draft's own first
        token is discarded."""
        row_cache, _tok, _ = self._draft_session.prefill(
            ids[None], self._draft_session.sampling_state(1, seed=0))
        self._draft_insert_fn(self._draft_cache, row_cache, slot, len(ids))

    def _on_activated(self, slot, rid, ids):
        """The draft-side twin of slot activation, for both prefill
        modes."""
        self._draft_prefill_into(slot, ids)

    def submit(self, input_ids, max_new_tokens: int, request_id=None,
               priority: int = 0, tenant=None, deadline=None,
               temperature=None, top_k=None, top_p=None, seed=None,
               _sampling=None):
        req_t = _sampling.temperature if _sampling is not None \
            else temperature
        if req_t is not None and float(req_t) != 0.0:
            raise InvalidArgumentError(
                "speculative decoding is greedy-only (temperature=0); "
                "got per-request temperature=%r -- submit sampled "
                "requests to a plain GenerationPool/ServingEngine"
                % (req_t,))
        ids = np.asarray(input_ids)
        if self._chunk_tokens is not None and ids.ndim == 1 and ids.size:
            # the target needs no bucket under chunked prefill, but the
            # draft still prefills through its buckets at activation:
            # fail at submit, not mid-tick
            self._draft_session._bucket_for(ids.shape[0])
        return super().submit(input_ids, max_new_tokens,
                              request_id=request_id, priority=priority,
                              tenant=tenant, deadline=deadline,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, seed=seed, _sampling=_sampling)

    def set_spec_k(self, k: int) -> None:
        """Change the runtime draft count per round within ``[1,
        spec_k]`` (the degradation ladder's reduce-spec-K rung).  Takes
        effect next round; greedy output is the same at every setting.
        The first round at a new ``k`` captures one verify step for the
        narrower chunk; the draft steps are shared by every setting."""
        k = int(k)
        if not 1 <= k <= self.spec_k:
            raise InvalidArgumentError(
                "spec_k override must be in [1, %d] (the constructed "
                "spec_k is the ceiling -- headroom was reserved for it at "
                "construction), got %r" % (self.spec_k, k))
        if k != self._spec_k_active:
            self._k_dev.fill_(k)
        self._spec_k_active = k

    @property
    def spec_k_active(self) -> int:
        """The runtime draft count per round."""
        return self._spec_k_active

    def _preempt_guard(self, slot, st) -> None:
        """A preempted slot's draft is re-prefilled at resume over prompt
        + committed[:-1]: its bucket must exist (a typed error at the
        decision point, not a mid-refill surprise)."""
        self._draft_session._bucket_for(
            len(st.req.ids) + max(0, len(st.tokens) - 1))

    def _adopt_guard(self, ids, tokens) -> None:
        """Adopting a disk-spilled request ends in a resume, which
        re-prefills the draft: the same bucket coverage as
        ``_preempt_guard``."""
        self._draft_session._bucket_for(
            len(ids) + max(0, len(tokens) - 1))

    def config_fingerprint(self) -> dict:
        """The base fingerprint plus the draft ceiling: adopting across
        pool variants is a configuration change an operator makes
        deliberately, not a silent fallback."""
        fp = super().config_fingerprint()
        fp["spec_k"] = self.spec_k
        return fp

    def _on_resumed(self, slot, sp) -> None:
        """Re-prefill the draft for a resumed slot over prompt +
        committed[:-1], the positions the target cache was restored to
        (the last committed token is the next round's pending).  The
        draft only shapes proposals: this restores the acceptance rate,
        the tokens are the target's either way."""
        ids = sp.req.ids if len(sp.tokens) <= 1 else np.concatenate(
            [sp.req.ids, np.asarray(sp.tokens[:-1], np.int32)])
        self._draft_prefill_into(slot, ids)

    def _sync_step_inputs(self) -> None:
        """The base upload on membership changes, then the pending tokens
        into the chunk's last column."""
        if not self._membership_dirty:
            return
        super()._sync_step_inputs()
        self._chunk[:, -1].copy_(self._steps.tok)

    def step(self) -> bool:
        """Refill free slots, run at most one prefill chunk, then ONE
        speculative round (``k`` draft steps, one verify, one draft
        fixup); every active slot commits 1 to ``k + 1`` tokens.  False
        when the pool is drained.  The seams and spans are the plain
        pool's: ``tick.decode`` covers the round (with ``spec_k``),
        ``tick.sample`` its one download."""
        _fire("pool.step")
        tr = _trace_active()
        if tr is None:
            self._refill()
        else:
            with tr.span("tick.admit"):
                self._refill()
        if self._chunk_tokens is not None:
            self._chunk_work()
        if not self._active:
            return bool(self._queue or self._prefilling or self._spilled)
        self._sync_step_inputs()
        if tr is None:
            out = self._spec_round()
            host = out.cpu().numpy()
        else:
            with tr.span("tick.decode", spec_k=self._spec_k_active):
                out = self._spec_round()
                _device_edge(tr)
            with tr.span("tick.sample"):
                host = out.cpu().numpy()
        self.decode_steps_total += 1
        if tr is None:
            self._deliver_round(host)
        else:
            with tr.span("tick.deliver"):
                self._deliver_round(host)
        return bool(self._active or self._queue or self._prefilling
                    or self._spilled)

    def _spec_round(self):
        """The round's device work; returns the output buffer ``[slots,
        spec_k+2]``: ``emitted`` in the first ``k+1`` columns, ``m`` in
        the last."""
        k = self._spec_k_active
        sync = self._time_split and self.device.type == "cuda"
        t0 = time.perf_counter() if self._time_split else 0.0
        for _ in range(k):
            self._draft_decode_fn(self._chunk)
        if self._time_split:
            if sync:
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            self._draft_time_s += t1 - t0
        view = self._chunk_views.get(k)
        if view is None:
            view = self._chunk_views[k] = self._chunk[:, self.spec_k - k:]
        out = self._verify_fn(view)
        if self._time_split:
            if sync:
                torch.cuda.synchronize(self.device)
            self._verify_time_s += time.perf_counter() - t1
        self._draft_fixup_fn(self._chunk)
        return out

    def _deliver_round(self, out) -> None:
        """Commit each slot's accepted chunk from the round's one
        download: acceptance accounting, ``on_token`` per token, EOS and
        budget finishes."""
        k = self._spec_k_active
        m_host = out[:, -1]
        self._rounds += 1
        self._drafted += k * len(self._active)
        self._accepted += int(m_host[list(self._active)].sum())
        for slot in list(self._active):
            state = self._active[slot]
            take = out[slot, :int(m_host[slot]) + 1] \
                .astype(np.int32)[:state.remaining]
            take = truncate_at_eos(take, self.eos_id)
            state.tokens.extend(int(x) for x in take)
            state.remaining -= len(take)
            if self.on_token is not None:
                for x in take:
                    self.on_token(state.rid, int(x))
            self._last_tok[slot] = int(take[-1])
            if state.remaining == 0 or \
                    (self.eos_id is not None and
                     int(take[-1]) == self.eos_id):
                self._finish(slot)

    def reset(self):
        """Base reset plus the draft's state, zeroed in place (the
        captured steps read the draft cache and the round's buffers by
        address); every step key and graph is kept."""
        super().reset()
        for c in self._draft_cache:
            for t in c:
                if t is not None:
                    t.zero_()
        self._chunk.zero_()
        self._out.zero_()
        self._pending.zero_()

    def acceptance_stats(self) -> dict:
        """The acceptance record plus ``spec_k_active`` (and the
        ``draft_time_s``/``verify_time_s`` split with ``time_split``)."""
        stats = acceptance_summary(self.spec_k, self._rounds,
                                   self._drafted, self._accepted)
        stats["spec_k_active"] = self._spec_k_active
        if self._time_split:
            stats["draft_time_s"] = self._draft_time_s
            stats["verify_time_s"] = self._verify_time_s
        return stats

    def reset_acceptance_stats(self) -> None:
        """Zero the acceptance and time accounting (between a warm-up and
        a measured run)."""
        self._drafted = self._accepted = self._rounds = 0
        self._draft_time_s = self._verify_time_s = 0.0

    def compile_counts(self) -> dict:
        """The base pool's keys without its unused 1-token steps, plus
        the speculative steps: none of them grows with rounds or
        acceptance lengths; ``verify`` has one key per ``k`` met."""
        counts = super().compile_counts()
        counts.pop("decode", None)
        counts.pop("pool_decode", None)
        counts["verify"] = self._verify_fn._cache_size()
        counts["draft_prefill"] = self._draft_session._prefill_fn \
            ._cache_size()
        counts["draft_decode"] = self._draft_decode_fn._cache_size()
        counts["draft_fixup"] = self._draft_fixup_fn._cache_size()
        counts["draft_insert"] = self._draft_insert_fn._cache_size()
        return counts

    def cost_version(self) -> int:
        return (super().cost_version()
                + self._draft_session.cost_version()
                + sum(fn.compiles for fn in (
                    self._verify_fn, self._draft_decode_fn,
                    self._draft_fixup_fn, self._draft_insert_fn)))

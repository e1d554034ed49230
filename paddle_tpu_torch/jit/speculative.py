"""Speculative decoding: the draft/verify split over the decode session
(counterpart of the reference's ``jit/speculative.py``).

A small DRAFT model guesses K tokens with its ordinary decode step; the
TARGET judges all of them in ONE ``[B, K+1]`` chunk forward through its
decode cache (the multi-token append of the dense and paged decode
forwards, whose queries ride kernels K2 and K1 at Lq = K+1 <= 8).

Greedy acceptance: the chunk ``[pending, d_1..d_K]`` yields the target's
greedy continuations ``g_0..g_K``; drafts are accepted while ``d_i ==
g_{i-1}``, then the target's own ``g_m`` is emitted (the correction, or
the bonus token when everything matched).  Every emitted token is
therefore EXACTLY what target-only greedy decode would have produced:
speculation changes the cost per token, never the tokens.

Rejection rewinds by MOVING THE CACHE INDEX: the rejected drafts' K/V
stay as stale rows past the index (never attended, overwritten by the
next chunk), for both layouts and both cache dtypes (an int8 position's
scale is fixed at its write, so it rewinds with its value).

:func:`greedy_accept` is device code with no branch and no host read, so
a captured verify step runs it; the acceptance length is data, never a
shape, so there is one verify step per chunk width whatever the
acceptance lengths.

``SpeculativeDecodeSession`` is the single-request unit (batch 1: an
aligned batch would stall every row on the slowest acceptance);
``inference.SpeculativePool`` is the slot-batched serving variant.  The
reference's ``cost_report`` is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.errors import InvalidArgumentError
from .aot import AotFunction, shape_key
from .decode import DecodeSession, truncate_at_eos

__all__ = ["SpeculativeDecodeSession", "check_draft_compatible",
           "model_vocab_size", "greedy_accept", "acceptance_summary"]


def model_vocab_size(model) -> Optional[int]:
    """The model's token id space, from ``vocab_size`` or the word
    embedding table; None when neither is discoverable."""
    v = getattr(model, "vocab_size", None)
    if v is None:
        w = getattr(getattr(model, "word_embeddings", None), "weight",
                    None)
        v = None if w is None else int(w.shape[0])
    return None if v is None else int(v)


def check_draft_compatible(draft_model, target_model) -> None:
    """Typed error unless draft and target share one token id space,
    checked at construction (a mismatch would otherwise decode ids that
    name different strings under the two models)."""
    dv = model_vocab_size(draft_model)
    tv = model_vocab_size(target_model)
    if dv is not None and tv is not None and dv != tv:
        raise InvalidArgumentError(
            "speculative decoding needs the draft and target models to "
            "share one token id space: draft vocab_size=%d != target "
            "vocab_size=%d -- a draft token id would name a different "
            "string under the target" % (dv, tv))


def greedy_accept(logits, chunk, active=None):
    """The greedy acceptance rule, shared by the session and the pool.

    Given the target's ``logits`` [B, K+1, V] over a verify chunk
    ``[pending, d_1..d_K]`` (int [B, K+1]), returns ``(m [B], emitted
    [B, K+1])``: ``m`` counts the drafts accepted before the first
    mismatch (a cumulative product of ``d_i == g_{i-1}`` zeroes
    everything after it), ``emitted`` is ``d_1..d_m``, then the target's
    own ``g_m``, then zeros.  ``active`` [B] bool, when given, zeroes the
    inactive rows' ``m`` and emission.  Both come back as int32."""
    k = chunk.shape[1] - 1
    g = logits.argmax(dim=-1)                               # [B, K+1]
    draft = chunk[:, 1:].long()
    match = (draft == g[:, :-1]).long()
    m = match.cumprod(dim=1).sum(dim=1)                     # [B]
    if active is not None:
        m = torch.where(active, m, torch.zeros_like(m))
    j = torch.arange(k + 1, device=chunk.device)[None, :]
    g_at_m = g.gather(1, m[:, None])
    draft_pad = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    mm = m[:, None]
    emitted = torch.where(j < mm, draft_pad,
                          torch.where(j == mm, g_at_m,
                                      torch.zeros_like(draft_pad)))
    if active is not None:
        emitted = torch.where(active[:, None], emitted,
                              torch.zeros_like(emitted))
    return m.to(torch.int32), emitted.to(torch.int32)


def acceptance_summary(spec_k: int, rounds: int, drafted: int,
                       accepted: int) -> dict:
    """The shared ``acceptance_stats()`` record: accepted draft tokens /
    drafted (0.0 before any round)."""
    return {
        "spec_k": spec_k,
        "rounds": rounds,
        "drafted": drafted,
        "accepted": accepted,
        "acceptance_rate": accepted / drafted if drafted else 0.0,
    }


class SpeculativeDecodeSession:
    """Single-request speculative generation with a fixed set of steps:
    the draft's ``DecodeSession`` prefill and decode step (the catch-up
    step reuses it), and for the target one prefill per bucket plus ONE
    fixed-K verify step.

    Greedy only (``temperature`` must be 0).  ``cache_layout`` and
    ``cache_dtype`` configure the TARGET cache; the draft keeps a dense
    fp32 cache.  ``device=None`` is ``cuda``; both models must live on
    the session's device."""

    def __init__(self, target_model, draft_model, max_len: int,
                 spec_k: int = 4, buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, cache_dtype="float32",
                 cache_layout: str = "dense", block_size: int = 32,
                 route: str = "auto", device=None):
        if float(temperature) != 0.0:
            raise InvalidArgumentError(
                "speculative decoding is greedy-only (temperature=0): "
                "got temperature=%r; sampled speculation needs the "
                "rejection-sampling acceptance rule to preserve the "
                "target distribution -- use DecodeSession for sampled "
                "generation" % (temperature,))
        if int(spec_k) < 1:
            raise InvalidArgumentError(
                "spec_k must be >= 1 draft tokens per round, got %r"
                % (spec_k,))
        check_draft_compatible(draft_model, target_model)
        self.spec_k = int(spec_k)
        self._target = DecodeSession(
            target_model, max_len, buckets=buckets, temperature=0.0,
            cache_dtype=cache_dtype, cache_layout=cache_layout,
            block_size=block_size, route=route, device=device)
        self.device = self._target.device
        self._draft = DecodeSession(
            draft_model, max_len, buckets=buckets, temperature=0.0,
            route=route, device=self.device)
        self.max_len = self._target.max_len
        self.cache_layout = cache_layout
        # one verify key: the [1, K+1] chunk; captured on the card
        self._verify_fn = AotFunction(self._verify, key_fn=shape_key,
                                      name="verify", capture=True)
        self._drafted = 0
        self._accepted = 0
        self._rounds = 0

    def _verify(self, chunk):
        """The chunk ``[1, K+1]`` through the target's batch-1 cache; the
        index is rewound in place to the accepted prefix.  Returns
        ``(emitted [1, K+1], m [1])``; positions past ``m`` are pad."""
        sess = self._target
        cache, _ = sess._batches[1]
        idx0 = cache[0].index.clone()
        logits, _ = sess._run_model(chunk.long(), cache)
        m, emitted = greedy_accept(logits, chunk)
        new_idx = idx0 + m[0] + 1
        for c in cache:
            c.index.copy_(new_idx)
        return emitted, m

    def generate(self, input_ids, max_new_tokens: int, seed=None,
                 eos_id: Optional[int] = None):
        """Greedy speculative generation; np.int32 ``[1, max_new_tokens]``
        token-identical to ``DecodeSession.generate`` on the target
        alone.  An EOS inside an accepted chunk truncates the commit at
        the EOS; rows past their EOS are padded with it.  ``seed`` is
        accepted for signature parity (greedy never draws)."""
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[0] != 1:
            raise InvalidArgumentError(
                "SpeculativeDecodeSession generates ONE request at a "
                "time (got batch %d): aligned speculative batches would "
                "stall every row on the slowest acceptance; use "
                "inference.SpeculativePool for slot-batched speculative "
                "serving" % (ids.shape[0],))
        t = ids.shape[1]
        if max_new_tokens < 1:
            raise InvalidArgumentError(
                "max_new_tokens must be >= 1, got %r" % (max_new_tokens,))
        k = self.spec_k
        if t + max_new_tokens + k > self.max_len:
            # the final verify chunk may write up to K draft positions
            # past the last budgeted token
            raise InvalidArgumentError(
                "speculative decoding writes up to spec_k=%d draft "
                "positions past the accepted prefix: prompt %d + "
                "max_new_tokens %d + spec_k %d exceeds cache max_len %d;"
                " raise max_len or lower max_new_tokens/spec_k"
                % (k, t, max_new_tokens, k, self.max_len))
        del seed
        _, tok, _ = self._target.prefill(
            ids, self._target.sampling_state(1, seed=0))
        # the draft prefills the same prompt; its own first token is
        # discarded: the target's is the ground truth it continues from
        cache_d, dtok, _ = self._draft.prefill(
            ids, self._draft.sampling_state(1, seed=0))
        toks = [int(tok[0])]
        done = eos_id is not None and toks[0] == int(eos_id)
        chunk = torch.zeros((1, k + 1), dtype=torch.int32,
                            device=self.device)
        dtok.fill_(toks[0])
        while len(toks) < max_new_tokens and not done:
            # the draft step reads and overwrites its token buffer
            chunk[0, 0] = toks[-1]
            for j in range(k):
                chunk[:, j + 1] = self._draft._decode_fn(dtok)
            emitted, m = self._verify_fn(chunk)
            m_h = int(m[0])
            emitted_h = emitted[0, :m_h + 1].cpu().numpy().astype(np.int32)
            self._drafted += k
            self._accepted += m_h
            self._rounds += 1
            if m_h == k:
                # every draft accepted: d_K's K/V were never written (it
                # was the draft's last output) -- one catch-up step of
                # the same decode step writes them, its output unused
                self._draft._decode_fn(dtok)
            else:
                new_idx = t + len(toks) + m_h
                for c in cache_d:
                    c.index.fill_(new_idx)
            take = truncate_at_eos(
                emitted_h[:max_new_tokens - len(toks)], eos_id)
            toks.extend(int(x) for x in take)
            if eos_id is not None and take.size and \
                    int(take[-1]) == int(eos_id):
                done = True
            elif take.size < m_h + 1:
                break  # budget exhausted mid-chunk
            else:
                dtok.fill_(toks[-1])
        out = np.asarray(toks, np.int32)[None]
        if out.shape[1] < max_new_tokens:
            pad = np.full((1, max_new_tokens - out.shape[1]),
                          eos_id, np.int32)
            out = np.concatenate([out, pad], axis=1)
        return out

    def acceptance_stats(self) -> dict:
        """The shared :func:`acceptance_summary` record."""
        return acceptance_summary(self.spec_k, self._rounds,
                                  self._drafted, self._accepted)

    def compile_counts(self) -> dict:
        """The step keys: the target's prefill bucket(s) and ONE verify
        step whatever the acceptance lengths; the draft's prefill
        bucket(s) and its one decode step (the catch-up reuses it)."""
        return {
            "prefill": self._target._prefill_fn._cache_size(),
            "verify": self._verify_fn._cache_size(),
            "draft_prefill": self._draft._prefill_fn._cache_size(),
            "draft_decode": self._draft._decode_fn._cache_size(),
        }

    def cost_version(self) -> int:
        return (self._target.cost_version() + self._draft.cost_version()
                + self._verify_fn.compiles)

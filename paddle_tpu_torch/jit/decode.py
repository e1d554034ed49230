"""KV-cached autoregressive decoding: the bucketed prefill and the
single-token decode step (counterpart of the reference's ``jit/decode.py``).

The reference compiles exactly two functions with ``jax.jit``.  PyTorch
runs eagerly, so here the same two functions are plain methods:

- ``prefill(ids)``: one causal forward over the bucket-padded prompt that
  writes every position's K/V into a preallocated cache; the cache index
  is then set to the TRUE length, so pad K/V is never attended, and the
  first token is sampled at ``true_len - 1``;
- ``_decode(cache, tok)``: one token in, one token out, with identical
  shapes every step.

Sampling config rides each row as data (``SamplingState``: per-row
temperature/top-k/top-p/seed and the row's draw counter), so a batch may
mix greedy and sampled rows.  Row r draws from a ``torch.Generator`` on
the logits' device (Philox on the card) seeded from ``(seed[r],
step[r])``: a pure function of the request's own seed and draw index.
It is not JAX's threefry stream, so sampled tokens are held by their
invariants and by this determinism, never by equality with the
reference.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device, same_device
from ..core.errors import InvalidArgumentError
from ..nn.layer.transformer import normalize_cache_dtype
from ..ops.flash_attention import decode_route, normalize_decode_route
from .cache import get_layout

__all__ = ["DecodeSession", "sample_logits_data", "SamplingState",
           "make_sampling_state", "check_sampling", "default_buckets",
           "FINISH_EOS", "FINISH_LENGTH", "classify_finish",
           "truncate_at_eos"]

FINISH_EOS = "eos"
FINISH_LENGTH = "length"


def classify_finish(tokens, eos_id) -> str:
    """``FINISH_EOS`` if the row ended on ``eos_id``, else
    ``FINISH_LENGTH``."""
    toks = np.asarray(tokens)
    if eos_id is not None and toks.size and int(toks[-1]) == int(eos_id):
        return FINISH_EOS
    return FINISH_LENGTH


def truncate_at_eos(tokens, eos_id):
    """Truncate a 1-D token array at the first ``eos_id`` (inclusive)."""
    toks = np.asarray(tokens)
    if eos_id is None or toks.size == 0:
        return toks
    hits = np.nonzero(toks == int(eos_id))[0]
    if hits.size:
        return toks[:int(hits[0]) + 1]
    return toks


class SamplingState(NamedTuple):
    """Per-row sampling config as host vectors ``[B]``: ``temperature``
    (0 = greedy), ``top_k`` (<= 0 or >= vocab keeps all), ``top_p`` (1
    keeps all), ``seed`` and ``step`` (the row's draw counter)."""

    temperature: np.ndarray
    top_k: np.ndarray
    top_p: np.ndarray
    seed: np.ndarray
    step: np.ndarray


def check_sampling(temperature, top_p) -> None:
    """Typed validation shared by the session and the pool's submit."""
    if float(temperature) < 0.0 or not 0.0 < float(top_p) <= 1.0:
        raise InvalidArgumentError(
            "sampling config: temperature must be >= 0 and top_p in "
            "(0, 1]; got temperature=%r top_p=%r" % (temperature, top_p))


def make_sampling_state(batch: int, temperature=0.0, top_k=0, top_p=1.0,
                        seed=None, step=0) -> SamplingState:
    """A ``[batch]`` :class:`SamplingState`; scalars broadcast, a scalar
    ``seed`` gives row r the stream ``seed + r``, ``seed=None`` draws a
    base seed from torch's default generator."""
    def vec(x, dtype):
        a = np.asarray(x, dtype)
        return np.broadcast_to(a, (batch,)).copy() if a.ndim == 0 else a

    if seed is None:
        seed = int(torch.randint(0, 2 ** 31 - 1, ()).item())
    s = np.asarray(seed, np.int64) & 0xFFFFFFFF
    if s.ndim == 0:
        s = (s + np.arange(batch, dtype=np.int64)) & 0xFFFFFFFF
    return SamplingState(vec(temperature, np.float32), vec(top_k, np.int32),
                         vec(top_p, np.float32), s, vec(step, np.int64))


def _stream_seed(seed: int, step: int) -> int:
    """One 63-bit generator seed per (request seed, draw index)."""
    return ((int(seed) & 0xFFFFFFFF) << 31 ^ (int(step) & 0x7FFFFFFF)) \
        & 0x7FFFFFFFFFFFFFFF


def sample_logits_data(logits, temperature, top_k, top_p, seed, step):
    """Token ids [B] (int32, on the logits' device) from logits [B, V]
    with the config as per-row data.

    ``temperature == 0`` rows are greedy argmax.  Other rows: temperature
    scaling, top-k truncation (ties at the k-th value keep both), nucleus
    truncation (tokens whose exclusive prefix mass under the sorted
    distribution already reaches ``top_p`` are dropped), then one draw
    from a generator seeded by :func:`_stream_seed`."""
    temp = np.asarray(temperature, np.float32)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    rows = np.nonzero(temp > 0)[0]
    if rows.size == 0:
        return greedy
    v = logits.shape[-1]
    dev = logits.device
    ridx = torch.as_tensor(rows, device=dev)
    t = torch.as_tensor(temp[rows], device=dev)
    tk = torch.as_tensor(np.asarray(top_k, np.int64)[rows], device=dev)
    tp = torch.as_tensor(np.asarray(top_p, np.float32)[rows], device=dev)
    scaled = logits[ridx].float() / t[:, None]
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    kk = tk.clamp(1, v)
    kth = sorted_desc.gather(1, (kk - 1)[:, None])
    apply_k = ((tk > 0) & (tk < v))[:, None]
    keep = torch.where(apply_k, scaled >= kth, torch.ones_like(scaled,
                                                              dtype=bool))
    probs = torch.softmax(sorted_desc, dim=-1)
    cut = (probs.cumsum(dim=-1) - probs) >= tp[:, None]
    kept_min = torch.where(cut, torch.full_like(sorted_desc, float("inf")),
                           sorted_desc).amin(dim=-1, keepdim=True)
    keep = keep & (scaled >= kept_min)
    masked = torch.where(keep, scaled, torch.finfo(torch.float32).min)
    dist = torch.softmax(masked, dim=-1)
    out = greedy.clone()
    seeds = np.asarray(seed, np.int64)
    steps = np.asarray(step, np.int64)
    for i, r in enumerate(rows):
        gen = torch.Generator(device=dev)
        gen.manual_seed(_stream_seed(seeds[r], steps[r]))
        out[int(r)] = torch.multinomial(dist[i], 1, generator=gen)[0] \
            .to(torch.int32)
    return out


def default_buckets(max_len: int, lo: int = 64) -> List[int]:
    """Power-of-two prefill buckets up to ``max_len`` (inclusive cap)."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


class DecodeSession:
    """Batched autoregressive generation: a bucketed prefill and a
    fixed-shape decode step.

    All rows of a ``generate`` batch share one prompt length (a scalar
    cache index); mixed-length serving is ``GenerationPool``'s
    slot-batched layer on top of this class.  ``device=None`` is
    ``cuda``; the model must live on the session's device."""

    def __init__(self, model, max_len: int,
                 buckets: Optional[Sequence[int]] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, cache_dtype="float32",
                 cache_layout: str = "dense", block_size: int = 32,
                 route: str = "auto", device=None):
        self.device = resolve_device(device)
        self.route = normalize_decode_route(route)
        if not hasattr(model, "gen_decode_cache"):
            raise InvalidArgumentError(
                "DecodeSession needs a model with gen_decode_cache() and "
                "forward(..., cache=...) (e.g. models.TransformerLM); got %r"
                % type(model).__name__)
        if getattr(model, "causal", True) is False:
            raise InvalidArgumentError(
                "DecodeSession requires a causal model (got causal=False): "
                "bidirectional encoders cannot decode incrementally")
        model_dev = next(model.parameters()).device
        if not same_device(model_dev, self.device):
            raise InvalidArgumentError(
                "the model lives on %s but the session runs on %s: build "
                "the model with the same device=" % (model_dev, self.device))
        self._model = model
        self.max_len = int(max_len)
        max_position = getattr(model, "max_position", None)
        if max_position is not None and self.max_len > max_position:
            raise InvalidArgumentError(
                "max_len=%d exceeds the model's position-embedding table "
                "(max_position=%d)" % (max_len, max_position))
        bks = list(buckets) if buckets is not None \
            else default_buckets(self.max_len)
        self.buckets = sorted(int(b) for b in bks if b <= self.max_len)
        if not self.buckets:
            raise InvalidArgumentError(
                "no prefill bucket <= max_len=%d (got %r)" % (max_len, bks))
        check_sampling(temperature, top_p)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._cache_dtype = normalize_cache_dtype(cache_dtype)
        self._layout = get_layout(cache_layout)
        if self._layout.name not in getattr(model, "cache_layouts",
                                            ("dense", "paged")):
            raise InvalidArgumentError(
                "model %s does not serve cache_layout=%r"
                % (type(model).__name__, cache_layout))
        if int(block_size) < 1:
            raise InvalidArgumentError(
                "block_size must be >= 1, got %r" % (block_size,))
        self.cache_layout = cache_layout
        self.block_size = int(block_size)

    @contextlib.contextmanager
    def _inference(self):
        """Decode is always inference: dropout off for the call (each
        module's mode restored after), no autograd, the session's route
        ambient for every attention call under the layer stack."""
        modes = [(m, m.training) for m in self._model.modules()]
        self._model.eval()
        try:
            with torch.no_grad(), decode_route(self.route):
                yield
        finally:
            for m, t in modes:
                m.training = t

    def _run_model(self, ids, cache):
        with self._inference():
            return self._model(ids, cache=cache)

    @staticmethod
    def _sample(logits, samp: SamplingState):
        tok = sample_logits_data(logits, samp.temperature, samp.top_k,
                                 samp.top_p, samp.seed, samp.step)
        return tok, samp._replace(step=samp.step + 1)

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if b >= length:
                return b
        raise InvalidArgumentError(
            "prompt length %d exceeds the largest prefill bucket %d "
            "(available buckets: %s, max_len=%d); shorten the prompt or "
            "construct the session/pool with buckets=[..., %d]"
            % (length, self.buckets[-1], self.buckets, self.max_len, length))

    def sampling_state(self, batch: int, seed=None) -> SamplingState:
        """A ``[batch]`` state from the session's sampling defaults."""
        return make_sampling_state(batch, self.temperature, self.top_k,
                                   self.top_p, seed=seed)

    def prefill(self, input_ids, sampling: Optional[SamplingState] = None):
        """The bucketed prefill: ``(cache, first_token [B] int32 on the
        device, samp')`` with ``samp'`` advanced past the prefill draw."""
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        b, t = ids.shape
        if t < 1:
            raise InvalidArgumentError(
                "prompt must contain at least one token")
        bucket = self._bucket_for(t)
        padded = np.zeros((b, bucket), np.int64)
        padded[:, :t] = ids
        samp = self.sampling_state(b) if sampling is None else sampling
        cache = self._model.gen_decode_cache(
            b, self.max_len, self._cache_dtype, layout=self.cache_layout,
            block_size=self.block_size)
        logits, cache = self._run_model(
            torch.from_numpy(padded).to(self.device), cache)
        cache = self._layout.finalize_prefill(cache, t, self.max_len)
        return (cache,) + self._sample(logits[:, t - 1], samp)

    def _decode(self, cache, tok, samp: SamplingState):
        """One token in, one token out."""
        logits, cache = self._run_model(tok[:, None].long(), cache)
        return (cache,) + self._sample(logits[:, 0], samp)

    def generate(self, input_ids, max_new_tokens: int, seed=None):
        """Autoregressive generation; np.int32 [B, max_new_tokens].  The
        token feeds back on the device; one download at the end."""
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        t = ids.shape[1]
        if max_new_tokens < 1:
            raise InvalidArgumentError(
                "max_new_tokens must be >= 1, got %r" % (max_new_tokens,))
        if t + max_new_tokens > self.max_len:
            raise InvalidArgumentError(
                "prompt %d + max_new_tokens %d exceeds cache max_len %d"
                % (t, max_new_tokens, self.max_len))
        samp = self.sampling_state(ids.shape[0], seed=seed)
        cache, tok, samp = self.prefill(ids, samp)
        toks = [tok]
        for _ in range(max_new_tokens - 1):
            cache, tok, samp = self._decode(cache, tok, samp)
            toks.append(tok)
        return torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)

"""KV-cached autoregressive decoding: the bucketed prefill and the
single-token decode step (counterpart of the reference's ``jit/decode.py``).

The reference compiles exactly two functions per session with
``jax.jit``; here they are two :class:`~.aot.AotFunction` wrappers:

- ``"prefill"`` (``prefill(ids)``), keyed by the bucket-padded ids: one
  causal forward over the padded prompt that writes every position's K/V
  into the session's cache; the cache index is then set to the TRUE
  length, so pad K/V is never attended, and the first token is sampled at
  ``true_len - 1``.  It runs eagerly;
- ``"decode"``, keyed by the token vector: one token in, one token out,
  with identical shapes every step.  On the card it is captured as a CUDA
  graph and replayed.

A graph reads its tensors by address, so the session keeps ONE cache and
one set of step buffers per batch size and resets them in place for each
prompt; the token and the draw counter feed back on the device, in those
buffers.  The layout's hooks (``jit.cache``) reset the cache before a
prefill and commit each step into it in place, so the recurrent layout's
carry, index and window bound are read by address too.  A model that had
a LoRA bank at construction gets its per-row adapter ids from the same
buffers, made ambient around the forward (``nn.lora.adapter_ids``).

``mesh=DecodeMesh(dp, mp)`` runs the steps over a decode mesh
(``jit/mesh.py``): the session places the model's weights (each mp
shard's slices) and builds its caches over the mesh.  The decode step
runs inside the collective seam (``distributed.qcollectives``), where the
row-parallel reductions take ``collective_quant`` (the mesh's by default:
"none", fp32, or "int8", the two-stage quantized sum) and record their
per-device wire bytes; the prefill always reduces in fp32.

Sampling config rides each row as data (per-row temperature/top-k/top-p/
seed and the row's draw counter), so a batch may mix greedy and sampled
rows; :func:`sample_logits` is the scalar-config form.
:func:`sample_logits_data` is branch-free device work: it filters every
row, draws one uniform per row from a counter-based hash of (seed, step)
and inverts the filtered distribution's CDF, then keeps the argmax on
greedy rows.  It is not JAX's threefry stream, so sampled tokens are held
by their invariants and by determinism, never by equality with the
reference:

- a row's token is a pure function of (its logits row, its config, its
  seed, its step), whatever its slot and whatever the other rows hold;
- greedy rows and ``top_k == 1`` rows give the argmax;
- a draw lies in the row's top-k set and its nucleus, with the filtered
  distribution's probabilities.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device, same_device
from ..core.errors import InvalidArgumentError
from ..distributed import qcollectives as _qc
from ..nn.layer.transformer import normalize_cache_dtype
from ..nn.lora import adapter_ids, lora_config
from ..ops.flash_attention import decode_route, normalize_decode_route
from .aot import (AotFunction, StaticInputs, cache_tensors, kv_arg_bytes,
                  module_tensors, shape_key)
from .cache import get_layout

__all__ = ["DecodeSession", "sample_logits", "sample_logits_data",
           "SamplingState", "make_sampling_state", "check_sampling",
           "step_buffers",
           "default_buckets",
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
    keeps all), ``seed``, ``step`` (the row's draw counter) and
    ``adapter`` (the row's LoRA adapter id, ``nn.lora``; 0 is the
    reserved identity row, the base model)."""

    temperature: np.ndarray
    top_k: np.ndarray
    top_p: np.ndarray
    seed: np.ndarray
    step: np.ndarray
    adapter: np.ndarray


def check_sampling(temperature, top_p) -> None:
    """Typed validation shared by the session and the pool's submit."""
    if float(temperature) < 0.0 or not 0.0 < float(top_p) <= 1.0:
        raise InvalidArgumentError(
            "sampling config: temperature must be >= 0 and top_p in "
            "(0, 1]; got temperature=%r top_p=%r" % (temperature, top_p))


def make_sampling_state(batch: int, temperature=0.0, top_k=0, top_p=1.0,
                        seed=None, step=0, adapter=0) -> SamplingState:
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
                         vec(top_p, np.float32), s, vec(step, np.int64),
                         vec(adapter, np.int32))


_M32 = 0xFFFFFFFF


def _mul32(h, m: int):
    """``h * m mod 2**32`` for int64 ``h`` in [0, 2**32) and a 32-bit
    constant ``m``, in 16-bit halves so no product leaves int64."""
    lo, hi = m & 0xFFFF, m >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2**32) whose
    every output bit depends on every input bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _uniform(seed, step):
    """One uniform in [0, 1) per row: a counter-based hash of the row's
    (seed, step), its top 24 bits as a float32."""
    s = seed.long() & _M32
    t = step.long() & _M32
    h = _fmix32(_fmix32(_fmix32(s) ^ t) ^ 0x9E3779B9)
    return (h >> 8).float() * (1.0 / (1 << 24))


def _filtered_probs(rows, temperature, top_k, top_p):
    """The sampling distribution of logit rows [R, V] under per-row
    ``temperature``/``top_k``/``top_p`` tensors [R] (temperature > 0):
    temperature scaling, top-k truncation (ties at the k-th value keep
    both), nucleus truncation (tokens whose exclusive prefix mass under
    the sorted distribution already reaches ``top_p`` are dropped)."""
    v = rows.shape[-1]
    scaled = rows.float() / temperature[:, None]
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    kk = top_k.clamp(1, v)
    kth = sorted_desc.gather(1, (kk - 1)[:, None])
    apply_k = ((top_k > 0) & (top_k < v))[:, None]
    keep = torch.where(apply_k, scaled >= kth, torch.ones_like(scaled,
                                                              dtype=bool))
    probs = torch.softmax(sorted_desc, dim=-1)
    cut = (probs.cumsum(dim=-1) - probs) >= top_p[:, None]
    kept_min = torch.where(cut, torch.full_like(sorted_desc, float("inf")),
                           sorted_desc).amin(dim=-1, keepdim=True)
    keep = keep & (scaled >= kept_min)
    masked = torch.where(keep, scaled, torch.finfo(torch.float32).min)
    return torch.softmax(masked, dim=-1)


def sample_logits(logits, generator=None, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0):
    """Token ids [B] (int32, on the logits' device) from logits [B, V]
    under ONE scalar config (the reference's ``sample_logits``; its
    ``key`` is a ``torch.Generator`` here).

    ``temperature == 0`` is greedy argmax (the generator unused);
    otherwise temperature scaling, then optional top-k, then optional
    nucleus truncation, then one draw per row from ``generator``."""
    if temperature < 0.0:
        raise InvalidArgumentError(
            "temperature must be >= 0 (0 = greedy), got %r" % temperature)
    if not 0.0 < top_p <= 1.0:
        # top_p == 0 would mask EVERY token and degrade to uniform sampling
        raise InvalidArgumentError(
            "top_p must be in (0, 1], got %r" % top_p)
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    b, dev = logits.shape[0], logits.device
    dist = _filtered_probs(
        logits, torch.full((b,), float(temperature), device=dev),
        torch.full((b,), int(top_k), dtype=torch.int64, device=dev),
        torch.full((b,), float(top_p), device=dev))
    return torch.multinomial(dist, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def sample_logits_data(logits, temperature, top_k, top_p, seed, step):
    """Token ids [B] (int32, on the logits' device) from logits [B, V]
    with the config as per-row data (tensors or host vectors [B]).

    Branch-free: every row is filtered as in :func:`sample_logits` (a
    greedy row's temperature clamped to 1 first), draws one uniform from
    :func:`_uniform` of its (seed, step) and takes the first token whose
    cumulative filtered probability exceeds it; ``temperature == 0`` rows
    keep the argmax instead.  No host read, so a captured step can run
    it."""
    dev = logits.device
    temp = torch.as_tensor(temperature, device=dev).float()
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    probs = _filtered_probs(
        logits, safe_t, torch.as_tensor(top_k, device=dev).long(),
        torch.as_tensor(top_p, device=dev).float())
    cdf = probs.cumsum(dim=-1)
    u = _uniform(torch.as_tensor(seed, device=dev),
                 torch.as_tensor(step, device=dev))
    drawn = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None],
                               right=True)[:, 0]
    # a rounding of u * total up to the total must not pick a token past
    # the last one with mass
    vocab = torch.arange(probs.shape[-1], device=dev)
    last = torch.where(probs > 0, vocab, torch.zeros_like(vocab)).amax(-1)
    drawn = torch.minimum(drawn, last)
    greedy = logits.argmax(dim=-1)
    return torch.where(temp > 0, drawn, greedy).to(torch.int32)


def step_buffers(n: int, device) -> StaticInputs:
    """The static per-row inputs of an ``n``-row decode step: the token
    fed in, the active mask, the sampling config, the draw counter and the
    LoRA adapter id (made ambient around the forward, so the step reads
    the ids by address)."""
    i32, f32 = torch.int32, torch.float32
    return StaticInputs([("tok", n, i32), ("active", n, i32),
                         ("top_k", n, i32), ("seed", n, i32),
                         ("step", n, i32), ("adapter", n, i32),
                         ("temperature", n, f32), ("top_p", n, f32)],
                        device)


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
                 route: str = "auto", device=None, mesh=None,
                 collective_quant: Optional[str] = None,
                 collective_quant_scale: Optional[str] = None):
        self.device = resolve_device(device)
        self.route = normalize_decode_route(route)
        if mesh is not None:
            from .mesh import DecodeMesh

            if not isinstance(mesh, DecodeMesh):
                raise InvalidArgumentError(
                    "mesh must be a jit.mesh.DecodeMesh (or None for "
                    "single-device decode), got %r"
                    % (type(mesh).__name__,))
            mesh.check_device(self.device)
            # each mp shard's weight slices, before any step reads them
            mesh.place_weights(model)
        self.mesh = mesh
        # the mp reductions' mode: the mesh's by default (an interconnect
        # property), a per-session kwarg overrides
        if collective_quant is None:
            collective_quant = "none" if mesh is None \
                else mesh.collective_quant
        if collective_quant_scale is None:
            collective_quant_scale = "block" if mesh is None \
                else mesh.collective_quant_scale
        self.collective_quant = _qc.normalize_collective_quant(
            collective_quant)
        self.collective_quant_scale = _qc.normalize_collective_scale(
            collective_quant_scale)
        if self.collective_quant != "none" and mesh is None:
            raise InvalidArgumentError(
                "collective_quant=%r needs a DecodeMesh: the quantized "
                "collectives replace the mp reductions, and an unsharded "
                "session has none (pass mesh=DecodeMesh(dp, mp) or "
                "collective_quant='none')" % (self.collective_quant,))
        # the collective bytes of ONE decode step, written by the seam's
        # sink after each eager run of the step (a replay runs no Python
        # and moves the same bytes); mp == 1 meshes install no seam
        self._collective_trace: Optional[dict] = None
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
        if cache_layout == "recurrent" and self._cache_dtype != "float32":
            # the carry is the exact serving state: refused here, not in
            # the first prefill
            raise InvalidArgumentError(
                "cache_layout='recurrent' supports only "
                "cache_dtype='float32' (got %r): the recurrence carry is "
                "the exact decode state, not a re-read cache"
                % (cache_dtype,))
        self._layout = get_layout(cache_layout)
        supported = getattr(model, "cache_layouts", ("dense", "paged"))
        if self._layout.name not in supported:
            raise InvalidArgumentError(
                "model %s supports cache_layouts=%r, not %r: positional "
                "K/V layouts ('dense'/'paged') belong to attention models, "
                "'recurrent' to constant-state models like nn.ssm.SSMLM"
                % (type(model).__name__, tuple(supported),
                   self._layout.name))
        if int(block_size) < 1:
            raise InvalidArgumentError(
                "block_size must be >= 1, got %r" % (block_size,))
        self.cache_layout = cache_layout
        self.block_size = int(block_size)
        # the LoRA bank geometry, read once: a bank attached later is not
        # served (its ids are never made ambient)
        self._lora_cfg = lora_config(model)
        # one cache and one set of step buffers per batch size, reused
        # (reset in place) by every prompt of that size: a captured
        # decode graph reads them by address
        self._batches = {}
        self._prefill_fn = AotFunction(
            self._prefill_step, key_fn=lambda ids, *r: shape_key(ids),
            name="prefill")
        self._decode_fn = AotFunction(
            self._decode_step, key_fn=shape_key, name="decode",
            capture=True, watch=lambda: module_tensors(self._model),
            reads=lambda tok: cache_tensors(self._batches[tok.shape[0]][0]),
            meta_fn=lambda tok: {"kv_cache_bytes": kv_arg_bytes(
                self._batches[tok.shape[0]][0])})

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

    def _run_model(self, ids, cache, adapter=None,
                   collective_seam: bool = False):
        """One forward of ``ids`` [B, L] through ``cache``.  The cache may
        be a batch-1 VIEW of a pool's global cache -- ``table`` a [1, MB]
        copy of one slot's row and ``index`` a [1] tensor holding the
        chunk's start -- so a prompt chunk writes its K/V straight into
        the pool's physical blocks; the pool then sets its own index.
        ``adapter`` (a static [B] id buffer, or None for the base model)
        is the ambient per-row LoRA selection of the forward.
        ``collective_seam`` opts a DECODE step into the mesh's collective
        seam (the prefill stays dense)."""
        seam = self._collective_seam() if collective_seam \
            else contextlib.nullcontext()
        with self._inference(), adapter_ids(adapter), seam:
            return self._model(ids, cache=cache)

    @contextlib.contextmanager
    def _collective_seam(self):
        """The collective seam for one decode step, installed only when
        the mesh has an mp axis to reduce over.  Mode "none" records the
        dense ring bytes beside the fp32 reduction, so the comparison
        column exists.  The sink is published after the step, so a failed
        step leaves no half-recorded figures."""
        if self.mesh is None or self.mesh.mp == 1:
            yield
            return
        rec = {"mode": self.collective_quant,
               "scale_mode": self.collective_quant_scale,
               "calls": 0, "wire_bytes": 0, "dense_bytes": 0, "tokens": 0}
        with _qc.collective_quant(self.collective_quant, self.mesh,
                                  scale_mode=self.collective_quant_scale,
                                  sink=rec):
            yield
        self._collective_trace = rec

    def _gen_cache(self, batch: int, per_slot: bool = False,
                   num_blocks=None, dtype=None):
        """The model's decode cache for ``batch`` rows in the session's
        layout, over the mesh when there is one."""
        dtype = self._cache_dtype if dtype is None else dtype
        if self.mesh is not None:
            return self.mesh.build_cache(
                self._model, batch, self.max_len, dtype,
                layout=self.cache_layout, per_slot=per_slot,
                block_size=self.block_size, num_blocks=num_blocks)
        return self._model.gen_decode_cache(
            batch, self.max_len, dtype, per_slot=per_slot,
            layout=self.cache_layout, block_size=self.block_size,
            num_blocks=num_blocks)

    def _adapter_ids(self, ids):
        """``ids`` when the model had a LoRA bank at construction, else
        None (the base model, whatever is attached since)."""
        return ids if self._lora_cfg is not None else None

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if b >= length:
                return b
        raise InvalidArgumentError(
            "prompt length %d exceeds the largest prefill bucket %d "
            "(available buckets: %s, max_len=%d); shorten the prompt or "
            "construct the session/pool with buckets=[..., %d]"
            % (length, self.buckets[-1], self.buckets, self.max_len, length))

    def sampling_state(self, batch: int, seed=None,
                       adapter=0) -> SamplingState:
        """A ``[batch]`` state from the session's sampling defaults."""
        return make_sampling_state(batch, self.temperature, self.top_k,
                                   self.top_p, seed=seed, adapter=adapter)

    def _batch(self, b: int):
        """The session's cache and step buffers for batch size ``b``."""
        st = self._batches.get(b)
        if st is None:
            st = self._batches[b] = (self._gen_cache(b),
                                     step_buffers(b, self.device))
        return st

    def _prefill_step(self, ids, true_len: int, cache, bufs):
        """The prompt forward from position 0 (the cache reset in place by
        the layout; stale K/V past the index are masked), the true length
        committed, the first token sampled at ``true_len - 1`` into
        ``bufs.tok``."""
        self._layout.begin_prefill(cache, true_len)
        logits, new = self._run_model(ids.long(), cache,
                                      self._adapter_ids(bufs.adapter))
        self._layout.finalize_prefill(cache, true_len, self.max_len, new)
        tok = sample_logits_data(logits[:, true_len - 1], bufs.temperature,
                                 bufs.top_k, bufs.top_p, bufs.seed,
                                 bufs.step)
        bufs.tok.copy_(tok)
        bufs.step.add_(1)
        return bufs.tok

    def _decode_step(self, tok):
        """One token in, one token out: ``tok`` (the batch's token
        buffer) is read, then overwritten with the sampled token; the
        index and the draw counter advance in place."""
        cache, bufs = self._batches[tok.shape[0]]
        logits, new = self._run_model(tok[:, None].long(), cache,
                                      self._adapter_ids(bufs.adapter),
                                      collective_seam=True)
        self._layout.commit_step(cache, new)
        tok.copy_(sample_logits_data(logits[:, 0], bufs.temperature,
                                     bufs.top_k, bufs.top_p, bufs.seed,
                                     bufs.step))
        bufs.step.add_(1)
        return tok

    def prefill(self, input_ids, sampling: Optional[SamplingState] = None):
        """The bucketed prefill: ``(cache, first_token [B] int32 on the
        device, samp')`` with ``samp'`` advanced past the prefill draw.
        The cache and the token are the session's own buffers for this
        batch size: the next prefill or decode of that size overwrites
        them."""
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        b, t = ids.shape
        if t < 1:
            raise InvalidArgumentError(
                "prompt must contain at least one token")
        bucket = self._bucket_for(t)
        padded = np.zeros((b, bucket), np.int32)
        padded[:, :t] = ids
        samp = self.sampling_state(b) if sampling is None else sampling
        cache, bufs = self._batch(b)
        bufs.upload(tok=0, active=1, temperature=samp.temperature,
                    top_k=samp.top_k, top_p=samp.top_p, seed=samp.seed,
                    step=samp.step, adapter=samp.adapter)
        tok = self._prefill_fn(torch.from_numpy(padded).to(self.device), t,
                               cache, bufs)
        return cache, tok, samp._replace(step=samp.step + 1)

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
        _, tok, _ = self.prefill(ids, samp)
        toks = [tok.clone()]
        for _ in range(max_new_tokens - 1):
            toks.append(self._decode_fn(tok).clone())
        return torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)

    def compile_counts(self) -> dict:
        """``{"prefill": n, "decode": n}``: the shape keys each step has
        met.  On the card a decode key holds one captured CUDA graph; on
        the CPU a key is only a distinct shape."""
        return {"prefill": self._prefill_fn._cache_size(),
                "decode": self._decode_fn._cache_size()}

    def cost_report(self) -> dict:
        """``{"prefill": {key: entry}, "decode": {key: entry}}``: each step
        key's cost entry (``jit.aot``: FLOPs, bytes accessed, the memory
        fields; the decode step's ``kv_cache_bytes``).  A read: it counts,
        captures and synchronizes nothing."""
        return {"prefill": self._prefill_fn.cost_report(),
                "decode": self._decode_fn.cost_report()}

    def cost_version(self) -> int:
        """The cost report's version: moves only when a step meets a new
        shape or, on the card, captures its graph."""
        return self._prefill_fn.cost_revision + self._decode_fn.cost_revision

    def collective_report(self) -> dict:
        """Per-token wire bytes of the decode step's mp reductions, from
        the shapes the seam recorded (never measured):
        ``collective_bytes_per_token`` is what the mode moves,
        ``collective_dense_bytes_per_token`` the fp32 ring equivalent
        (equal under "none", below it under "int8").  ``{}`` before the
        first decode step, off-mesh, or at mp == 1 (no mp reductions)."""
        rec = self._collective_trace
        if not rec or not rec.get("tokens"):
            return {}
        t = float(rec["tokens"])
        return {
            "collective_quant": self.collective_quant,
            "collective_quant_scale": self.collective_quant_scale,
            "collective_bytes_per_token": rec["wire_bytes"] / t,
            "collective_dense_bytes_per_token": rec["dense_bytes"] / t,
            "collective_calls_per_step": int(rec["calls"]),
            "collective_basis": "per-device ring wire bytes of the "
                                "decode step's row-parallel reductions "
                                "(from their shapes) over the per-device "
                                "tokens the step commits",
        }

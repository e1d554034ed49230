"""Gated linear-recurrence decoder blocks, the O(1)-cache model class
(counterpart of the reference's ``nn/ssm.py``).

A decoder whose per-token decode state is a constant ``[B, d_state]``
carry per layer instead of an O(seq) attention prefix, served through the
``"recurrent"`` cache layout (``jit.cache.RecurrentLayout``): a slot's
whole decode state is ``layers x d_state`` floats.

The recurrence is the diagonal gated form:

    a_t = sigmoid(x_t W_a + b_a)            per-channel decay in (0, 1)
    u_t = x_t W_in + b_in                   candidate state
    s_t = a_t * s_{t-1} + (1 - a_t) * u_t   the O(1) carry
    y_t = (s_t * silu(x_t W_g + b_g)) W_out  (output gate + projection)

run SEQUENTIALLY, one position at a time, as the reference's ``lax.scan``:
the bucketed prefill, the one-token decode step and an eager loop then
reduce in the same fp32 operation order.  Each step is a product, a sum
and the window select, each its own op (no ``lerp``, ``addcmul`` or
associative scan, which round differently); ``(1 - a_t) * u_t`` is
computed for all positions at once, which gives each element the same
value as computing it in the step.

Padded buckets: a positional cache may hold garbage K/V at pad positions
because its index keeps them from being attended, but a recurrence folds
every update into the carry.  The cache therefore carries a scalar
``limit``: positions ``>= limit`` are identity steps, so the carry at the
end of a padded bucket is the carry at the true prompt length.  The
session's prefill narrows ``limit`` to the true length and re-opens it to
``max_len`` for decode, in place (``RecurrentLayout.begin_prefill`` /
``finalize_prefill``).

A forward with a cache returns a new carry and index; the callers commit
them into the cache's own tensors (the layout's ``commit_step`` /
``freeze_step``), which a captured decode graph reads by address.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
from torch import nn

from .. import tensor as T
from ..core.device import resolve_device
from ..core.dtype import dtype_name
from ..core.errors import InvalidArgumentError
from ..distributed.sharded import is_sharded
from .layer.common import Dropout, Embedding, Linear
from .layer.norm import LayerNorm
from .layer.layers import Layer

__all__ = ["RecurrentDecodeCache", "GatedSSMBlock", "SSMLM"]

#: One layer's decode state: ``state [B, d_state]`` (the fp32 carry),
#: ``index`` (positions consumed: a scalar for aligned batches, ``[B]`` per
#: slot for the pool) and ``limit`` (the scalar update-window bound).
RecurrentDecodeCache = collections.namedtuple(
    "RecurrentDecodeCache", ["state", "index", "limit"])


class GatedSSMBlock(Layer):
    """Pre-norm gated linear-recurrence block with a residual path."""

    def __init__(self, hidden_size: int, d_state: int, dropout: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.d_state = int(d_state)
        kw = dict(device=device, generator=generator)
        self.norm = LayerNorm(hidden_size, device=device)
        self.in_proj = Linear(hidden_size, d_state, **kw)
        self.decay_proj = Linear(hidden_size, d_state, **kw)
        self.gate_proj = Linear(hidden_size, d_state, **kw)
        self.out_proj = Linear(d_state, hidden_size, **kw)
        self.out_dropout = Dropout(dropout)

    def forward(self, x, cache: Optional[RecurrentDecodeCache] = None):
        """``[B, L, H] -> [B, L, H]`` (and the successor cache when one is
        given).  Without ``cache`` the scan starts from a zero carry over
        the exact sequence; with it the chunk continues from the carry
        (``L == 1`` is the decode step, a larger ``L`` the bucketed
        prefill, whose pad tail the ``limit`` window makes identity
        steps)."""
        h = self.norm(x)
        u = self.in_proj(h)
        a = torch.sigmoid(self.decay_proj(h))
        g = torch.nn.functional.silu(self.gate_proj(h))
        b, length = u.shape[0], u.shape[1]
        inflow = (1.0 - a) * u
        if cache is None:
            s = torch.zeros((b, self.d_state), dtype=u.dtype,
                            device=u.device)
            y, _ = self._scan(a, inflow, s, None)
            return x + self.out_dropout(self.out_proj(y * g))
        if is_sharded(cache):
            # the carry shards over dp (each shard's rows, its own state
            # tensor); the weights replicate, so the projections above ran
            # once over every row
            n = b // cache.dp
            ys, states = [], []
            for d, row in enumerate(cache.shards):
                rows = slice(d * n, (d + 1) * n)
                y, s = self._scan(a[rows], inflow[rows], row[0].state,
                                  self._keep(row[0], length, u.device))
                ys.append(y)
                states.append(s)
            y = torch.cat(ys, dim=0)
            new = cache.with_part_field("state", states)._replace(
                index=cache.index + length)
        else:
            y, s = self._scan(a, inflow, cache.state,
                              self._keep(cache, length, u.device))
            new = RecurrentDecodeCache(s, cache.index + length, cache.limit)
        return x + self.out_dropout(self.out_proj(y * g)), new

    @staticmethod
    def _keep(cache, length: int, device):
        """[B or 1, L, 1]: positions below the cache's window bound
        (``limit``) update the carry; the rest are identity steps."""
        idx = cache.index.to(torch.int64)
        step = torch.arange(length, device=device)
        pos = (idx[:, None] + step[None, :] if idx.ndim
               else (idx + step)[None, :])
        return (pos < cache.limit)[:, :, None]

    @staticmethod
    def _scan(a, inflow, s, keep):
        """The sequential recurrence from carry ``s`` over ``L`` positions:
        the stacked states ``[B, L, d_state]`` and the final carry."""
        states = []
        for t in range(a.shape[1]):
            s_new = a[:, t] * s + inflow[:, t]
            if keep is not None:
                s_new = torch.where(keep[:, t], s_new, s)
            states.append(s_new)
            s = s_new
        return torch.stack(states, dim=1), s


class SSMLM(Layer):
    """Recurrent (SSM) language model with tied input/output embeddings:
    ``TransformerLM``'s ``forward(input_ids, cache=...)`` /
    ``gen_decode_cache`` surface, so ``DecodeSession``/``GenerationPool``/
    ``ServingEngine`` serve it, on the ``"recurrent"`` layout only.  No
    position embeddings: ``max_len`` is bounded only by the caller's
    budget.  Parameter names and shapes are the reference's
    (``convert.load_reference_params``); ``device=None`` builds on
    ``cuda`` and weights are initialised from a generator seeded with
    ``seed``."""

    #: layouts gen_decode_cache builds (DecodeSession checks at
    #: construction)
    cache_layouts = ("recurrent",)
    causal = True

    def __init__(self, vocab_size: int = 30528, hidden_size: int = 768,
                 num_layers: int = 12, d_state: Optional[int] = None,
                 dropout: float = 0.0, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.vocab_size = int(vocab_size)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.d_state = int(d_state) if d_state else 2 * int(hidden_size)
        kw = dict(device=dev, generator=gen)
        self.word_embeddings = Embedding(vocab_size, hidden_size, **kw)
        self.embed_dropout = Dropout(dropout)
        self.blocks = nn.ModuleList([
            GatedSSMBlock(hidden_size, self.d_state, dropout=dropout, **kw)
            for _ in range(num_layers)])
        self.final_norm = LayerNorm(hidden_size, device=dev)

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.weight.device

    def gen_decode_cache(self, batch_size: int, max_length: int,
                         dtype="float32", per_slot: bool = False,
                         layout: str = "recurrent", block_size: int = 32,
                         num_blocks: Optional[int] = None):
        """Per-layer :data:`RecurrentDecodeCache`: a zero ``[batch,
        d_state]`` fp32 carry, a zero index (``[batch]`` when
        ``per_slot``) and ``limit = max_length``, on the model's device.
        Only ``layout="recurrent"`` and fp32 exist: the carry is the exact
        decode state, so quantizing it would change every later token."""
        if layout != "recurrent":
            raise InvalidArgumentError(
                "SSMLM keeps a constant-size recurrence carry, not "
                "positional K/V: cache_layout=%r does not exist for this "
                "model class -- construct the session/pool with "
                "cache_layout='recurrent' (the 'dense'/'paged' layouts "
                "belong to attention models like TransformerLM)"
                % (layout,))
        try:
            name = dtype_name(dtype)
        except (InvalidArgumentError, KeyError):
            name = str(dtype)
        if name != "float32":
            raise InvalidArgumentError(
                "recurrent decode state supports only dtype='float32' "
                "(got %r): the carry is the EXACT serving state -- "
                "quantizing it would change every subsequent token, not "
                "just re-read precision" % (dtype,))
        dev = self.device
        caches = []
        for _ in range(self.num_layers):
            index = torch.zeros((batch_size,) if per_slot else (),
                                dtype=torch.int32, device=dev)
            caches.append(RecurrentDecodeCache(
                torch.zeros((batch_size, self.d_state), device=dev), index,
                torch.full((), int(max_length), dtype=torch.int32,
                           device=dev)))
        return caches

    def forward(self, input_ids, attn_mask=None, token_type_ids=None,
                cache=None):
        """Logits ``[B, L, V]`` (and the successor caches when given).
        ``attn_mask``/``token_type_ids`` are accepted for surface parity
        with ``TransformerLM`` and ignored: causality is structural in a
        recurrence."""
        h = self.embed_dropout(self.word_embeddings(input_ids))
        emb = self.word_embeddings.weight
        if cache is not None:
            new_cache = []
            for block, c in zip(self.blocks, cache):
                h, nc = block(h, cache=c)
                new_cache.append(nc)
            h = self.final_norm(h)
            return T.matmul(h, emb, transpose_y=True), new_cache
        for block in self.blocks:
            h = block(h)
        return T.matmul(self.final_norm(h), emb, transpose_y=True)

    def flops_per_token(self, seq_len: int) -> float:
        """Analytic fwd+bwd FLOPs a token (MFU accounting): 6 x the
        matmul parameters; the recurrence is O(d_state) elementwise."""
        per_layer = 3 * self.hidden_size * self.d_state \
            + self.d_state * self.hidden_size
        matmul_params = self.num_layers * per_layer \
            + self.vocab_size * self.hidden_size
        return 6.0 * matmul_params

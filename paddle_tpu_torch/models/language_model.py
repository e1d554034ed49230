"""Transformer language model with a tied LM head, its configurations and
its LM loss (counterpart of the reference's ``models/language_model.py``).

Not ported yet: ``TransformerForSequenceClassification`` and sequence
parallelism."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import tensor as T
from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer


# causal masks a model keeps (an [L, L] mask is 16 MB in fp32 at L 2048)
_CAUSAL_MASKS_MAX = 8


def bert_base_config() -> dict:
    """BERT-base pretrain config (the reference's ``bert_base_config``)."""
    return dict(
        vocab_size=30528,  # 30522 padded to a multiple of 64
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        max_position=512,
        causal=False,
    )


def ernie_base_config() -> dict:
    """ERNIE-3.0-base-style encoder config (the reference's
    ``ernie_base_config``): BERT-base geometry with token-type
    embeddings."""
    return dict(
        vocab_size=40000,  # ERNIE zh vocab (39979) padded to 64
        hidden_size=768,
        num_layers=12,
        num_heads=12,
        intermediate_size=3072,
        max_position=2048,
        causal=False,
        type_vocab_size=4,
    )


def gpt_1p3b_config() -> dict:
    """GPT-3 1.3B (the reference's ``gpt_1p3b_config``)."""
    return dict(
        vocab_size=50304,  # 50257 padded to a multiple of 64
        hidden_size=2048,
        num_layers=24,
        num_heads=16,
        intermediate_size=8192,
        max_position=2048,
        causal=True,
    )


class TransformerLM(nn.Module):
    """Transformer language model with tied input/output embeddings.

    Parameter names and shapes are the reference's, so
    ``convert.load_reference_params`` carries a reference model's weights
    across by name.  ``device=None`` builds on ``cuda`` (and raises on a
    machine without one); weights are initialised from a
    ``torch.Generator`` seeded with ``seed`` on that device."""

    #: decode-cache layouts gen_decode_cache builds
    cache_layouts = ("dense", "paged")

    def __init__(self, vocab_size: int = 30528, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: Optional[int] = None,
                 max_position: int = 512, dropout: float = 0.1,
                 activation: str = "gelu", causal: bool = True,
                 normalize_before: bool = True, type_vocab_size: int = 0,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        intermediate_size = intermediate_size or 4 * hidden_size
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.causal = causal
        kw = dict(device=dev, generator=gen)
        self.word_embeddings = Embedding(vocab_size, hidden_size, **kw)
        self.position_embeddings = Embedding(max_position, hidden_size, **kw)
        # segment embeddings (BERT/ERNIE token types); 0 disables
        self.token_type_embeddings = (
            Embedding(type_vocab_size, hidden_size, **kw)
            if type_vocab_size else None)
        self.embed_dropout = Dropout(dropout)
        layer = TransformerEncoderLayer(hidden_size, num_heads,
                                        intermediate_size, dropout=dropout,
                                        activation=activation,
                                        normalize_before=normalize_before,
                                        **kw)
        self.encoder = TransformerEncoder(layer, num_layers)
        self.final_norm = LayerNorm(hidden_size, device=dev)
        # one causal mask per (seq_len, dtype, device): the attention's
        # identity-cached mask detection then reads each back only once
        self._causal_masks: dict = {}

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.weight.device

    def gen_decode_cache(self, batch_size: int, max_length: int,
                         dtype="float32", per_slot: bool = False,
                         layout: str = "dense", block_size: int = 32,
                         num_blocks: Optional[int] = None):
        """Per-layer preallocated decode caches (see
        ``MultiHeadAttention.gen_decode_cache``).  Causal models only."""
        if not self.causal:
            raise InvalidArgumentError(
                "decode caching requires a causal model: a causal=False "
                "(bidirectional) encoder cannot decode incrementally — new "
                "tokens would change every earlier position's hidden state")
        return self.encoder.gen_decode_cache(batch_size, max_length, dtype,
                                             per_slot, layout, block_size,
                                             num_blocks)

    def _causal_mask(self, seq_len: int, dtype):
        """Additive mask, 0 on and below the diagonal and finfo.min above;
        the same tensor for every call with the same key."""
        key = (seq_len, dtype, self.device)
        mask = self._causal_masks.get(key)
        if mask is None:
            if len(self._causal_masks) >= _CAUSAL_MASKS_MAX:
                self._causal_masks.clear()  # bounded: one per length seen
            idx = torch.arange(seq_len, device=self.device)
            allow = idx[None, :] <= idx[:, None]
            mask = torch.where(allow, 0.0, torch.finfo(torch.float32).min) \
                .to(dtype)
            self._causal_masks[key] = mask
        return mask

    def encode(self, input_ids, attn_mask=None, token_type_ids=None,
               cache=None):
        """Final hidden states [B, L, H].  With ``cache`` the input is an
        incremental chunk: positions start at the cache index, causality
        over the cached prefix is enforced inside the attention, and
        ``(hidden, new_cache)`` is returned.  A decode mesh's cache
        (``ShardedCache`` per layer) runs each layer's attention and MLP
        per shard; the embeddings, norms and the tied head replicate, so
        they run once over every row, in slot order."""
        seq_len = input_ids.shape[1]
        step = torch.arange(seq_len, device=input_ids.device)
        if cache is not None:
            idx = cache[0].index.to(torch.int64)
            pos = idx + step if idx.ndim == 0 else idx[:, None] + step[None]
            # a prompt chunk's pad tail may run past the table: those
            # positions are discarded, so clamp them as JAX's gather does
            pos = pos.clamp(max=self.max_position - 1)
        else:
            pos = step
        h = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if self.token_type_embeddings is not None \
                and token_type_ids is not None:
            h = h + self.token_type_embeddings(token_type_ids)
        h = self.embed_dropout(h)
        if cache is not None:
            h, new_cache = self.encoder(h, attn_mask, cache)
            return self.final_norm(h), new_cache
        if attn_mask is None and self.causal:
            attn_mask = self._causal_mask(seq_len, h.dtype)
        return self.final_norm(self.encoder(h, attn_mask))

    def forward(self, input_ids, attn_mask=None, token_type_ids=None,
                cache=None):
        """Logits [B, L, vocab] (tied head: h @ E^T, through the installed
        ``matmul``, a white op under autocast); with ``cache``,
        ``(logits, new_cache)``."""
        emb = self.word_embeddings.weight
        if cache is not None:
            h, new_cache = self.encode(input_ids, attn_mask, token_type_ids,
                                       cache)
            return T.matmul(h, emb, transpose_y=True), new_cache
        h = self.encode(input_ids, attn_mask, token_type_ids)
        return T.matmul(h, emb, transpose_y=True)

    def flops_per_token(self, seq_len: int) -> float:
        """Analytic fwd+bwd FLOPs/token for MFU accounting (PaLM appendix
        B): 6 * matmul params + the attention term 12 * L * H * seq."""
        h, l = self.hidden_size, self.num_layers
        ff, v = self.intermediate_size, self.vocab_size
        per_layer = 4 * h * h + 2 * h * ff  # qkvo + mlp matmul params
        matmul_params = l * per_layer + v * h  # + lm head (tied)
        attn = 12 * l * h * seq_len  # fwd+bwd qk^T and av matmuls
        return 6.0 * matmul_params + attn


class TransformerLMCriterion(nn.Module):
    """Next-token (``shift_labels=True``) or masked LM loss: softmax cross
    entropy over the vocabulary, mean over the positions."""

    def __init__(self, shift_labels: bool = True):
        super().__init__()
        self.shift_labels = shift_labels

    def forward(self, logits, labels):
        if self.shift_labels:
            logits = logits[:, :-1, :]
            labels = labels[:, 1:]
        v = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, v), labels.reshape(-1),
                               reduction="mean")

"""Causal transformer language model with a tied LM head (counterpart of
the reference's ``models/language_model.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..core.errors import InvalidArgumentError
from ..nn.layer.common import Dropout, Embedding
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer


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
                 normalize_before: bool = True, device=None, seed: int = 0):
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
        self.embed_dropout = Dropout(dropout)
        layer = TransformerEncoderLayer(hidden_size, num_heads,
                                        intermediate_size, dropout=dropout,
                                        activation=activation,
                                        normalize_before=normalize_before,
                                        **kw)
        self.encoder = TransformerEncoder(layer, num_layers)
        self.final_norm = LayerNorm(hidden_size, device=dev)

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
        idx = torch.arange(seq_len, device=self.device)
        allow = idx[None, :] <= idx[:, None]
        return torch.where(allow, 0.0, torch.finfo(torch.float32).min) \
            .to(dtype)

    def encode(self, input_ids, attn_mask=None, cache=None):
        """Final hidden states [B, L, H].  With ``cache`` the input is an
        incremental chunk: positions start at the cache index, causality
        over the cached prefix is enforced inside the attention, and
        ``(hidden, new_cache)`` is returned."""
        seq_len = input_ids.shape[1]
        step = torch.arange(seq_len, device=input_ids.device)
        if cache is not None:
            idx = cache[0].index.to(torch.int64)
            pos = idx + step if idx.ndim == 0 else idx[:, None] + step[None]
        else:
            pos = step
        h = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        h = self.embed_dropout(h)
        if cache is not None:
            h, new_cache = self.encoder(h, attn_mask, cache)
            return self.final_norm(h), new_cache
        if attn_mask is None and self.causal:
            attn_mask = self._causal_mask(seq_len, h.dtype)
        return self.final_norm(self.encoder(h, attn_mask))

    def forward(self, input_ids, attn_mask=None, cache=None):
        """Logits [B, L, vocab] (tied head: h @ E^T); with ``cache``,
        ``(logits, new_cache)``."""
        if cache is not None:
            h, new_cache = self.encode(input_ids, attn_mask, cache)
            return torch.matmul(h, self.word_embeddings.weight.t()), new_cache
        h = self.encode(input_ids, attn_mask)
        return torch.matmul(h, self.word_embeddings.weight.t())

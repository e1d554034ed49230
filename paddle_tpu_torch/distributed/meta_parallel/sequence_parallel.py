"""Sequence parallelism (counterpart of the reference's
``meta_parallel/sequence_parallel.py``): ring attention and Ulysses over
the ``sep`` group's ranks.

The reference's functions are per-rank bodies inside ``shard_map``.  The
port's ranks share one device and run in rank order, so each function
here takes the LIST of the ranks' sequence blocks ([B, H, L/n, D] each,
rank order) and returns the list of their outputs; the collectives are
written out over it:

- ``ring_attention``: rank r starts with its own K/V block, and after
  each step every rank hands its block to the next (``p2p.send_next``),
  so at step i rank r holds block ``(r - i) mod n``; each block's
  attention is folded into the rank's online softmax (float32 running
  numerator, denominator and max), as the reference's ``_block_attn``
  composition -- not a kernel in either package.  Under ``causal`` a
  block from a later rank is wholly masked: the reference computes it
  under a ``finfo.min / 2`` bias, which makes its weight exactly 0 beside
  the rank's diagonal block (always folded first), so the port skips it.
- ``ulysses_attention``: an all-to-all regroups the blocks so that rank j
  holds heads ``[j H/n, (j+1) H/n)`` over the WHOLE sequence, attends
  there through ``ops.flash_attention`` (K3 on the card), and a second
  all-to-all returns each rank its sequence block of every head.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from ...core.errors import InvalidArgumentError
from ..collective import Group, p2p

__all__ = ["ring_attention", "ulysses_attention", "split_sequence",
           "gather_sequence", "sep_attention"]


def split_sequence(x, group: Group,
                   seq_axis: int = 1) -> List[torch.Tensor]:
    """The ranks' sequence blocks of a global tensor (views, rank
    order)."""
    n = group.nranks
    length = x.shape[seq_axis]
    if length % n:
        raise InvalidArgumentError(
            "sequence length %d not divisible by sep degree %d"
            % (length, n))
    return list(torch.split(x, length // n, dim=seq_axis))


def gather_sequence(blocks, group=None, seq_axis: int = 1):
    """The ranks' blocks back into the whole sequence."""
    return torch.cat(list(blocks), dim=seq_axis)


def _check_blocks(q, k, v, group, api):
    n = group.nranks
    if not (len(q) == len(k) == len(v) == n):
        raise InvalidArgumentError(
            "%s: need the %d ranks' blocks of q, k and v, got %d/%d/%d"
            % (api, n, len(q), len(k), len(v)))
    if q[0].ndim != 4:
        raise InvalidArgumentError(
            "%s expects [B, H, Lblk, D] blocks, got %s"
            % (api, tuple(q[0].shape)))
    return n


def _block_attn(q, k, v, scale, bias):
    """One [Lq, Lk] block: (numerator, denominator, running max)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return torch.matmul(p, v), p.sum(dim=-1, keepdim=True), m


def ring_attention(q, k, v, group: Group, causal: bool = False,
                   sm_scale: Optional[float] = None) -> List[torch.Tensor]:
    """Blockwise ring attention: ``q``/``k``/``v`` the ranks' blocks;
    equal to full attention over the gathered sequence (causal on global
    positions)."""
    n = _check_blocks(q, k, v, group, "ring_attention")
    d = q[0].shape[-1]
    lq = q[0].shape[2]
    dtype = q[0].dtype
    scale = torch.tensor(sm_scale if sm_scale is not None
                         else 1.0 / math.sqrt(d), dtype=dtype)
    neg = torch.finfo(torch.float32).min / 2
    diag = torch.where(
        torch.ones(lq, k[0].shape[2], dtype=torch.bool,
                   device=q[0].device).tril(),
        torch.zeros((), dtype=dtype, device=q[0].device),
        torch.full((), neg, dtype=dtype, device=q[0].device))
    o = [None] * n
    den = [None] * n
    mx = [None] * n
    kb, vb = list(k), list(v)
    for i in range(n):
        for r in range(n):
            src = (r - i) % n
            if causal and src > r:
                continue  # wholly masked: weight exactly 0 (see above)
            bias = diag if causal and src == r else None
            num_i, den_i, m_i = _block_attn(q[r], kb[r], vb[r], scale, bias)
            m_i = m_i.float()
            if o[r] is None:
                o[r], den[r], mx[r] = num_i.float(), den_i.float(), m_i
                continue
            new_m = torch.maximum(mx[r], m_i)
            corr = torch.exp(mx[r] - new_m)
            corr_i = torch.exp(m_i - new_m)
            o[r] = o[r] * corr + num_i.float() * corr_i
            den[r] = den[r] * corr + den_i.float() * corr_i
            mx[r] = new_m
        if i + 1 < n:
            kb, vb = p2p.send_next(kb, group), p2p.send_next(vb, group)
    return [(o[r] / den[r].clamp_min(1e-30)).to(dtype) for r in range(n)]


def ulysses_attention(q, k, v, group: Group, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      attn_fn=None) -> List[torch.Tensor]:
    """Ulysses: all-to-all sequence blocks -> head groups over the whole
    sequence, ``attn_fn(q, k, v, causal=, sm_scale=)`` on each (default
    ``ops.flash_attention.flash_attention``: K3), all-to-all back."""
    n = _check_blocks(q, k, v, group, "ulysses_attention")
    h = q[0].shape[1]
    if h % n:
        raise InvalidArgumentError(
            "ulysses needs heads %% sep == 0, got H=%d n=%d" % (h, n))
    hn = h // n
    if attn_fn is None:
        from ...ops.flash_attention import flash_attention as attn_fn

    def seq2head(blocks):  # rank j: heads j over the whole sequence
        return [torch.cat([b[:, j * hn:(j + 1) * hn] for b in blocks],
                          dim=2) for j in range(n)]

    outs = [attn_fn(qj, kj, vj, causal=causal, sm_scale=sm_scale)
            for qj, kj, vj in zip(seq2head(q), seq2head(k), seq2head(v))]
    lb = q[0].shape[2]
    # rank i: its sequence block of every head group, in head order
    return [torch.cat([o[:, :, i * lb:(i + 1) * lb] for o in outs], dim=1)
            for i in range(n)]


def sep_attention(q, k, v, group: Group, mode: str = "ring",
                  causal: bool = False, sm_scale: Optional[float] = None):
    """Global [B, H, L, D] q/k/v through the ``mode`` attention over the
    group's ranks: split along L, attend, gather."""
    inner = ring_attention if mode == "ring" else ulysses_attention
    blocks = [split_sequence(t, group, seq_axis=2) for t in (q, k, v)]
    return gather_sequence(inner(*blocks, group, causal=causal,
                                 sm_scale=sm_scale), seq_axis=2)

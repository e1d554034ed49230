"""The split-key (flash-decoding) arithmetic of K1/K2 on the CPU.

The CUDA kernels cut a row's visible keys into contiguous spans, one CTA
each, and combine the spans' partials (m, l, acc) in split order.  Here
the same cut is made in torch: each span's partial is computed with the
twins' floored arithmetic (running max floored at -1e30, so a fully
masked span gives m = -1e30, l = 0, acc = 0), the partials go through
``decode_combine_plain``, and the result is held against the reference's
Pallas kernels in interpret mode at atol 1e-5 (the same math in another
summation order).  The kernels themselves are held against the twins on
the card by ``test_torch_cuda_kernels.py``.

Also: the split count depends on static shapes alone, and the Python
mirror of the kernel's geometry agrees with the CUDA source.
"""
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import decode_kernels as dk

fa = importlib.import_module("paddle_tpu.ops.flash_attention")
pd = importlib.import_module("paddle_tpu.ops.pallas_decode")

ATOL = 1e-5
SPAN_KEYS = 32  # a split's span is a multiple of this many keys


def _spans(n_keys: int, splits: int):
    """[(k0, k1)] of each split, as the kernel cuts [0, n_keys)."""
    per = -(-max(n_keys, 1) // splits)
    span = -(-per // SPAN_KEYS) * SPAN_KEYS
    return [(i * span, min(n_keys, (i + 1) * span)) for i in range(splits)]


def _partial(q, k, v, qpos, sm_scale, bias, k0, k1):
    """(m, l, acc) of keys [k0, k1) for one row: q [H, Lq, D], k/v
    [H, S, D] fp32, qpos [Lq], bias [H|1, Lq, S] or None."""
    h, lq, d = q.shape
    if k1 <= k0:
        return (torch.full((h, lq), -1e30), torch.zeros(h, lq),
                torch.zeros(h, lq, d))
    s = torch.matmul(q, k[:, k0:k1].transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias[..., k0:k1]
    pos = torch.arange(k0, k1)
    s = s.masked_fill(pos[None, None, :] > qpos[None, :, None].long(),
                      float("-inf"))
    m = s.amax(dim=-1).clamp(min=-1e30)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.matmul(p, v[:, k0:k1])


def _split_attend(q, k, v, qpos, sm_scale, bias, splits):
    """The kernels' split-and-combine over gathered fp32 K/V [B, H, S, D]."""
    b = q.shape[0]
    s_len = k.shape[2]
    ms, ls, accs = [], [], []
    for r in range(b):
        n_keys = 0 if int(qpos[r].max()) < 0 else \
            min(int(qpos[r].max()), s_len - 1) + 1
        br = None if bias is None else bias[min(r, bias.shape[0] - 1)]
        parts = [_partial(q[r], k[r], v[r], qpos[r], sm_scale, br, k0, k1)
                 for k0, k1 in _spans(n_keys, splits)]
        ms.append(torch.stack([p[0] for p in parts], dim=1))
        ls.append(torch.stack([p[1] for p in parts], dim=1))
        accs.append(torch.stack([p[2] for p in parts], dim=1))
    return dk.decode_combine_plain(torch.stack(ms), torch.stack(ls),
                                   torch.stack(accs))


def _inputs(rng, b, h, bs, d, mb, lq, quant):
    nb = 1 + b * mb
    q = rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(nb, h, bs, d).astype(np.float32)
    v = rng.randn(nb, h, bs, d).astype(np.float32)
    k[0] = v[0] = 1e4  # poisoned scratch: must never reach a softmax
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    table[1, 3:] = 0  # row 1's unmapped tail points at the scratch block
    ks = vs = None
    if quant:
        k, ks = (np.array(a) for a in fa.quantize_kv(jnp.asarray(k)))
        v, vs = (np.array(a) for a in fa.quantize_kv(jnp.asarray(v)))
    s = mb * bs
    qpos = rng.randint(0, s, (b, lq)).astype(np.int32)
    qpos[0] = -1                                  # a row that sees no key
    qpos[1] = np.minimum(qpos[1], 3 * bs - 1)     # inside its mapped blocks
    qpos[2] = 2 * SPAN_KEYS - 1                   # ends on a span edge
    return q, k, v, table, ks, vs, qpos


def _gather(pool, scale, table):
    """Dequantized fp32 [B, H, MB*bs, D] through the table."""
    t = torch.from_numpy(table).long()
    b, mb = t.shape
    x = torch.from_numpy(pool)[t].float()          # [B, MB, H, bs, D]
    if scale is not None:
        x = x * torch.from_numpy(scale)[t][..., None]
    _, _, h, bs, d = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b, h, mb * bs, d)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("lq", [1, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_split_combine_matches_reference_kernel(quant, lq, splits):
    # S = 160: five chunks, so 2, 3 and 7 splits leave spans that are
    # partial, fully masked (past a row's q_pos) and empty (past n_keys)
    rng = np.random.RandomState(31 * lq + 7 * splits + quant)
    b, h, bs, d, mb = 4, 2, 8, 16, 20
    q, k, v, table, ks, vs, qpos = _inputs(rng, b, h, bs, d, mb, lq, quant)
    bias = rng.randn(1, h, lq, mb * bs).astype(np.float32) if lq == 8 \
        else None
    want = np.asarray(pd.paged_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(qpos), 0.25,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        bias=None if bias is None else jnp.asarray(bias), interpret=True))
    got = _split_attend(torch.from_numpy(q), _gather(k, ks, table),
                        _gather(v, vs, table), torch.from_numpy(qpos), 0.25,
                        None if bias is None else torch.from_numpy(bias),
                        splits)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert np.all(got[0].numpy() == 0.0)


def test_combine_plain_empty_and_single_split():
    # every split empty: the row writes 0; one split: plain normalization
    m = torch.full((1, 1, 3, 2), -1e30)
    out = dk.decode_combine_plain(m, torch.zeros(1, 1, 3, 2),
                                  torch.zeros(1, 1, 3, 2, 4))
    assert torch.equal(out, torch.zeros(1, 1, 2, 4))
    acc = torch.arange(8.0).reshape(1, 1, 1, 2, 4)
    l = torch.tensor([2.0, 4.0]).reshape(1, 1, 1, 2)
    out = dk.decode_combine_plain(torch.zeros(1, 1, 1, 2), l, acc)
    torch.testing.assert_close(out, acc[:, :, 0] / l[:, :, 0, :, None],
                               rtol=0, atol=0)


@pytest.mark.parametrize("b,h,s,bs,want", [
    (8, 16, 2048, 32, 3),     # the serving shape: 384 CTAs, one wave
    (1, 16, 2048, 32, 25),    # one request still fills the card
    (64, 16, 2048, 32, 1),    # enough (row, head) pairs: no split
    (8, 16, 2048, None, 3),   # dense: the same rule
    (1, 1, 100, 8, 1),        # short capacity: a split covers >= 64 keys
])
def test_num_splits_from_static_shapes(b, h, s, bs, want):
    assert dk.num_splits(b, h, s, bs) == want


def test_num_splits_keeps_table_slice_in_bounds():
    # block size 1 at a long capacity: spans shrink until a CTA's table
    # entries fit the kernel's 2048-entry slice
    splits = dk.num_splits(64, 16, 16384, 1)
    assert dk._table_slots(16384, splits, 1) <= dk._MAX_TABLE_SLOTS
    assert dk._table_slots(16384, splits - 1, 1) > dk._MAX_TABLE_SLOTS


def test_geometry_mirrors_cuda_source():
    src = os.path.join(os.path.dirname(dk.__file__), os.pardir, "csrc",
                       "decode_attention.cu")
    with open(src) as f:
        text = f.read()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             text).group(1))

    assert const("kSpanKeys") == dk._SPAN_KEYS == SPAN_KEYS
    assert const("kMaxTableSlots") == dk._MAX_TABLE_SLOTS
    assert const("kMaxLq") == dk.MAX_KERNEL_QUERY_CHUNK
    assert const("kMaxD") == dk.MAX_KERNEL_HEAD_DIM

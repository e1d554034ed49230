"""The port's decode attention (``paddle_tpu_torch.ops``) against the
reference.

- The plain twins of K1/K2 (what the CPU runs in place of the CUDA
  kernels) against the reference's Pallas kernels in interpret mode:
  paged and dense x {fp32, int8} x Lq in {1, 4, 8}, with per-row and
  scalar lengths, q_pos, bias, stale table rows, a poisoned scratch block
  and a row that sees no key (atol 1e-5: the same math in another
  summation order).
- The composition route against the reference's composition (atol 1e-5).
- int8 quantization against the reference's, and the routing seam.

The CUDA kernels themselves are held against these twins on the card by
``test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.ops import decode_kernels as dk
from paddle_tpu_torch.ops import flash_attention as pfa

fa = importlib.import_module("paddle_tpu.ops.flash_attention")
pd = importlib.import_module("paddle_tpu.ops.pallas_decode")

ATOL = 1e-5


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x).copy())


def _j(x):
    return None if x is None else jnp.asarray(x)


def _paged_inputs(rng, b=3, h=2, bs=8, d=16, mb=4, lq=1, quant=False):
    """A pool with a poisoned scratch block and a shuffled table whose
    rows map other rows' blocks past their lengths (stale rows)."""
    nb = 1 + b * mb
    q = rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(nb, h, bs, d).astype(np.float32)
    v = rng.randn(nb, h, bs, d).astype(np.float32)
    k[0] = v[0] = 1e4  # poisoned scratch: must never reach a softmax
    table = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    table[1, 2:] = 0  # row 1's unmapped tail points at the scratch block
    ks = vs = None
    if quant:
        k, ks = (np.asarray(a) for a in fa.quantize_kv(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in fa.quantize_kv(jnp.asarray(v)))
    return q, k, v, table, ks, vs


def _qpos(rng, b, lq, s):
    qp = rng.randint(0, s, (b, lq)).astype(np.int32)
    qp[0] = -1   # a row that sees no key emits 0
    qp[1] = np.minimum(qp[1], 15)  # row 1 stays inside its mapped blocks
    return qp


@pytest.mark.parametrize("lq", [1, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_plain_twin_matches_reference_kernel(lq, quant):
    rng = np.random.RandomState(lq + 10 * quant)
    q, k, v, table, ks, vs = _paged_inputs(rng, lq=lq, quant=quant)
    s = table.shape[1] * k.shape[2]
    qpos = _qpos(rng, q.shape[0], lq, s)
    bias = rng.randn(1, q.shape[1], lq, s).astype(np.float32) \
        if lq == 4 else None
    want = np.asarray(pd.paged_decode_attention_kernel(
        _j(q), _j(k), _j(v), _j(table), _j(qpos), 0.25, k_scale=_j(ks),
        v_scale=_j(vs), bias=_j(bias), interpret=True))
    got = dk.paged_decode_attention_kernel(
        _t(q), _t(k), _t(v), _t(table), _t(qpos), 0.25, k_scale=_t(ks),
        v_scale=_t(vs), bias=_t(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[0] == 0.0)
    assert dk.launch_counts()["paged_decode_attention_kernel"] == 0


@pytest.mark.parametrize("lq", [1, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_dense_plain_twin_matches_reference_kernel(lq, quant):
    # S=40: no power-of-two tile divides it in the reference (tile 8)
    rng = np.random.RandomState(100 + lq + 10 * quant)
    b, h, s, d = 2, 3, 40, 16
    q = rng.randn(b, h, lq, d).astype(np.float32)
    k = rng.randn(b, h, s, d).astype(np.float32)
    v = rng.randn(b, h, s, d).astype(np.float32)
    ks = vs = None
    if quant:
        k, ks = (np.asarray(a) for a in fa.quantize_kv(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in fa.quantize_kv(jnp.asarray(v)))
    qpos = _qpos(rng, b, lq, s)
    bias = rng.randn(b, 1, lq, s).astype(np.float32) if lq == 8 else None
    want = np.asarray(pd.decode_attention_kernel(
        _j(q), _j(k), _j(v), _j(qpos), 0.25, k_scale=_j(ks),
        v_scale=_j(vs), bias=_j(bias), interpret=True))
    got = dk.decode_attention_kernel(
        _t(q), _t(k), _t(v), _t(qpos), 0.25, k_scale=_t(ks),
        v_scale=_t(vs), bias=_t(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("lengths", [
    pytest.param(np.int32(13), id="scalar"),
    pytest.param(np.array([5, 17, 32], np.int32), id="per-row"),
])
def test_paged_lengths_and_qpos_through_the_route(lengths):
    # lengths and q_pos reach the twin in the kernels' index form
    # (_effective_qpos), compared with the reference's forced kernel route
    rng = np.random.RandomState(7)
    q, k, v, _, _, _ = _paged_inputs(rng, lq=4)
    table = (1 + np.arange(12, dtype=np.int32)).reshape(3, 4)
    qpos = rng.randint(0, 32, (3, 4)).astype(np.int32)
    want = np.asarray(fa.paged_decode_attention(
        _j(q), _j(k), _j(v), _j(table), lengths=_j(lengths), q_pos=_j(qpos),
        route="pallas"))
    got = pfa.paged_decode_attention(
        _t(q), _t(k), _t(v), _t(table), lengths=_t(lengths), q_pos=_t(qpos),
        route="kernel").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_composition_matches_reference_composition(quant):
    rng = np.random.RandomState(3)
    q, k, v, table, ks, vs = _paged_inputs(rng, lq=2, quant=quant)
    table = (1 + np.arange(12, dtype=np.int32)).reshape(3, 4)
    lengths = np.array([5, 17, 32], np.int32)
    want = np.asarray(fa.paged_decode_attention(
        _j(q), _j(k), _j(v), _j(table), lengths=_j(lengths), k_scale=_j(ks),
        v_scale=_j(vs), route="composition"))
    got = pfa.paged_decode_attention(
        _t(q), _t(k), _t(v), _t(table), lengths=_t(lengths), k_scale=_t(ks),
        v_scale=_t(vs), route="composition").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # dense composition with a [B, L] q_pos (the slot-batched form)
    kd = rng.randn(3, 2, 24, 16).astype(np.float32)
    vd = rng.randn(3, 2, 24, 16).astype(np.float32)
    qpos = rng.randint(0, 24, (3, 2)).astype(np.int32)
    want = np.asarray(fa.decode_attention(
        _j(q), _j(kd), _j(vd), q_pos=_j(qpos), route="composition"))
    got = pfa.decode_attention(_t(q), _t(kd), _t(vd), q_pos=_t(qpos),
                               route="composition").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_quantize_kv_matches_reference():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 3, 5, 16) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # the eps floor
    wq, ws = (np.asarray(a) for a in fa.quantize_kv(jnp.asarray(x)))
    gq, gs = pfa.quantize_kv(torch.from_numpy(x))
    assert gq.dtype == torch.int8 and tuple(gs.shape) == x.shape[:-1]
    np.testing.assert_array_equal(gq.numpy(), wq)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-6)
    np.testing.assert_allclose(pfa.dequantize_kv(gq, gs).numpy(),
                               np.asarray(fa.dequantize_kv(_j(wq), _j(ws))),
                               rtol=1e-6)


def test_routing_seam():
    rng = np.random.RandomState(5)
    q, k, v, table, _, _ = _paged_inputs(rng, lq=1)
    qt, kt, vt, tt = _t(q), _t(k), _t(v), _t(table)
    qpos = torch.full((3, 1), 20, dtype=torch.int32)
    with pytest.raises(InvalidArgumentError):
        pfa.paged_decode_attention(qt, kt, vt, tt, q_pos=qpos, route="pallas")
    with pytest.raises(InvalidArgumentError):
        with pfa.decode_route("fast"):
            pass
    # "auto" on a CPU tensor takes the kernel wrapper, i.e. the plain twin
    twin = dk.paged_decode_attention_plain(qt, kt, vt, tt, qpos, 0.25)
    with pfa.decode_route("auto"):
        got = pfa.paged_decode_attention(qt, kt, vt, tt, q_pos=qpos)
    torch.testing.assert_close(got, twin, rtol=0, atol=0)
    # a chunk longer than 8 (prefill) stays on the composition
    q9 = torch.from_numpy(rng.randn(3, 2, 9, 16).astype(np.float32))
    qp9 = torch.full((3, 9), 20, dtype=torch.int32)
    comp = pfa.paged_decode_attention(q9, kt, vt, tt, q_pos=qp9,
                                      route="composition")
    for route in ("auto", "kernel"):
        torch.testing.assert_close(
            pfa.paged_decode_attention(q9, kt, vt, tt, q_pos=qp9,
                                       route=route), comp, rtol=0, atol=0)
    # a CUDA-only wrapper never falls back: bad shapes raise typed errors
    with pytest.raises(InvalidArgumentError):
        dk.paged_decode_attention_kernel(q9, kt, vt, tt, qp9, 0.25)
    with pytest.raises(InvalidArgumentError):
        dk.decode_attention_kernel(qt, kt, vt, qpos, 0.25,
                                   k_scale=torch.ones(13, 2, 8))

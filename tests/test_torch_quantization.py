"""``quantization`` of the port against the reference's on the CPU.

- fake quantization: values within one level (``scale / 127``) of the
  reference's, the same at all but 1 in 1000 elements (the two divide
  and round in their own order); the straight-through gradients equal;
- a QAT model (``ImperativeQuantAware`` over Linear and Conv2D) trained
  3 SGD steps by ``TrainStep`` from the same weights: losses within 1e-4
  relative, each ``_act_scale`` within 1e-6 relative and advanced once a
  step;
- ``Int8Linear``: outputs equal to the reference's within 1e-6 of their
  largest magnitude on shapes ``_int_mm`` accepts and refuses (few rows,
  K or N not a multiple of 8, K over one 1024-chunk), its integer
  product exactly numpy's;
- PTQ: the converted model within 20% of the fp32 logits' largest
  magnitude (13% here: inputs beyond the range calibrated on 4 batches
  are clipped, and this net is 3 layers of random weights), and within
  1e-5 of the reference's converted model, which clips the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import quantization as rq

import paddle_tpu_torch as ptt
from paddle_tpu_torch import load_reference_params, quantization as pq


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_values_and_straight_through_gradients(bits):
    x = _x(0, 64, 33) * 3.0
    scale = np.float32(2.5)  # clips the tail
    cot = _x(1, 64, 33)
    want, vjp = jax.vjp(lambda a: rq._fake_qdq(a, bits), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(cot))
    want_s, vjp_s = jax.vjp(lambda a, s: rq._fake_qdq_scaled(a, s, bits),
                            jnp.asarray(x), jnp.asarray(scale))
    want_sg, want_ssg = vjp_s(jnp.asarray(cot))
    for fn, args, w, wg in (
            (pq.fake_quant_dequant_abs_max, (bits,), want, want_g),
            (pq.fake_quant_dequant_moving_scale,
             (torch.tensor(scale), bits), want_s, want_sg)):
        t = torch.from_numpy(x).requires_grad_(True)
        out = fn(t, *args)
        out.backward(torch.from_numpy(cot))
        w = np.asarray(w)
        level = np.abs(x).max() / (2 ** (bits - 1) - 1)
        diff = np.abs(out.detach().numpy() - w)
        assert diff.max() <= level * 1.0001
        assert (diff > 0).mean() <= 1e-3
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(wg))
    assert float(want_ssg) == 0.0


def test_quant_abs_max_and_dequant_match_reference():
    w = _x(2, 16, 24)
    q, s = pq.quant_abs_max(torch.from_numpy(w))
    rq_q, rs = rq.quant_abs_max(w)
    assert s == rs
    np.testing.assert_array_equal(q.numpy(), rq_q)
    np.testing.assert_allclose(pq.dequant(q, s).numpy(),
                               np.asarray(rq.dequant(rq_q, rs)), rtol=0,
                               atol=1e-7)


def _qat_pair():
    pt.seed(1)

    def build(nn):
        return nn.Sequential(nn.Conv2D(2, 4, 3, padding=1), nn.ReLU(),
                             nn.Flatten(), nn.Linear(4 * 6 * 6, 8),
                             nn.ReLU(), nn.Linear(8, 3))

    ref = build(pt.nn)
    port = build(ptt.nn)
    load_reference_params(port, {n: np.asarray(p.value)
                                 for n, p in ref.named_parameters()})
    return ref, port


def test_qat_step_matches_reference():
    ref, port = _qat_pair()
    rq.ImperativeQuantAware().quantize(ref)
    pq.ImperativeQuantAware().quantize(port)
    assert sum(isinstance(m, pq.QuantedLinear) for m in port.modules()) == 2
    assert sum(isinstance(m, pq.QuantedConv2D) for m in port.modules()) == 1
    ropt = pt.optimizer.SGD(0.1, parameters=ref.parameters())
    popt = ptt.optimizer.SGD(0.1, parameters=port.parameters())
    rstep = pt.jit.TrainStep(
        ref, lambda m, x, y: pt.nn.functional.cross_entropy(m(x), y), ropt)
    pstep = ptt.TrainStep(
        port, lambda m, x, y: ptt.nn.functional.cross_entropy(m(x), y),
        popt)
    rng = np.random.RandomState(5)
    scales = []
    for i in range(3):
        x = rng.randn(8, 2, 6, 6).astype(np.float32) * (1 + i)
        y = rng.randint(0, 3, 8).astype(np.int64)
        want = float(np.asarray(rstep(x, y).value))
        got = float(pstep(x, y))
        assert abs(got - want) <= 1e-4 * abs(want)
        ref_s = [float(np.asarray(m._act_scale.value))
                 for _, m in ref.named_sublayers()
                 if isinstance(m, rq._QuantedBase)]
        port_s = [float(m._act_scale) for m in port.modules()
                  if isinstance(m, pq._QuantedBase)]
        np.testing.assert_allclose(port_s, ref_s, rtol=1e-6)
        scales.append(port_s)
    assert all(a != b for a, b in zip(scales[0], scales[1]))
    assert all(a != b for a, b in zip(scales[1], scales[2]))


@pytest.mark.parametrize("m,k,n", [(32, 64, 24), (4, 64, 24), (32, 30, 24),
                                   (32, 64, 10), (40, 2056, 16)])
def test_int8_linear_matches_reference(m, k, n):
    rng = np.random.RandomState(m + k + n)
    w_q = rng.randint(-128, 128, (k, n)).astype(np.int8)
    bias = rng.randn(n).astype(np.float32)
    x = rng.randn(2, m // 2 if m > 1 else 1, k).astype(np.float32) * 2
    ref = rq.Int8Linear(w_q, 0.03, pt.to_tensor(bias), 3.5)
    port = pq.Int8Linear(torch.from_numpy(w_q), 0.03,
                         torch.from_numpy(bias), 3.5)
    want = np.asarray(ref(pt.to_tensor(x)).value)
    before = dict(pq.Int8Linear.routes)
    got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert pq.Int8Linear.routes["chunked"] == before["chunked"] + 1
    a = rng.randint(-128, 128, (m, k)).astype(np.int8)
    prod, route = pq._int8_matmul(torch.from_numpy(a),
                                  torch.from_numpy(w_q))
    assert route == "chunked" and prod.dtype == torch.int32
    np.testing.assert_array_equal(prod.numpy(),
                                  a.astype(np.int64) @ w_q.astype(np.int64))


def test_ptq_convert_is_close_to_fp32_and_to_the_reference(tmp_path):
    ref, port = _qat_pair()
    rng = np.random.RandomState(7)
    calib = [rng.randn(8, 2, 6, 6).astype(np.float32) for _ in range(4)]
    x = rng.randn(16, 2, 6, 6).astype(np.float32)
    port.eval()
    ref.eval()
    with torch.no_grad():
        fp32 = port(torch.from_numpy(x)).numpy()
    rptq, pptq = rq.ImperativePTQ(), pq.ImperativePTQ()
    rptq.quantize(ref)
    pptq.quantize(port)
    with torch.no_grad():
        for c in calib:
            ref(pt.to_tensor(c))
            port(torch.from_numpy(c))
    rptq.convert(ref)
    pptq.convert(port)
    assert sum(isinstance(m, pq.Int8Linear) for m in port.modules()) == 2
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(ref(pt.to_tensor(x)).value)
    scale = np.abs(fp32).max()
    assert np.abs(got - fp32).max() <= 0.2 * scale
    assert np.abs(got - want).max() <= 1e-5 * scale
    # the converted model saves as a jit.save artifact whose program
    # gives the same logits at another batch
    from paddle_tpu_torch.jit import InputSpec, load

    path = str(tmp_path / "int8")
    pptq.save_quantized_model(port, path,
                              input_spec=[InputSpec([None, 2, 6, 6])])
    loaded = load(path, device="cpu")
    np.testing.assert_array_equal(loaded(torch.from_numpy(x[:5])).numpy(),
                                  got[:5])

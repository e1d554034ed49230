"""The port's initializers and ``ParamAttr`` against the reference on the
CPU.

Threefry and torch share no stream, so an initializer is held by its
shape, its fans (``_fan_in_out`` on paddle's layouts) and the moments of
64k draws -- each sample mean and variance within 3 sigma of the
distribution's -- never by value; the deterministic ones (``Constant``,
``Assign``, ``Dirac``) and ``calculate_gain`` exactly.  ``ParamAttr``'s
learning rate, regularizer, ``trainable=False``, ``need_clip``, name and
``bias_attr=False`` are held by an optimizer step (1e-6); a regularizer
in ``Embedding``'s ``weight_attr`` makes lazy Adam's update dense, as in
the reference (1e-6 relative against its update).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import initializer as RI

import paddle_tpu_torch as ptt
from paddle_tpu_torch import TrainStep, optimizer
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, Embedding, LayerNorm,
                                 Linear, ParamAttr)
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer.conv import Conv2D
from paddle_tpu_torch.regularizer import L2Decay

N = 1 << 16
SHAPES = [(256,), (64, 32), (16, 8, 3, 3), (8, 4, 2, 3, 3)]
# a standard normal truncated to [-2, 2]: its variance
TRUNC2_VAR = 1.0 - 4.0 * math.exp(-2.0) / math.sqrt(2.0 * math.pi) \
    / math.erf(2.0 / math.sqrt(2.0))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _moments_hold(t, mean, var, what):
    """Sample mean and variance of ``t`` within 3 sigma of the
    distribution's (``var``'s sigma from the fourth moment bound of a
    bounded or normal law: ``var * sqrt(2 / n)`` times 1.5)."""
    x = t.double().reshape(-1)
    n = x.numel()
    assert abs(float(x.mean()) - mean) <= 3 * math.sqrt(var / n), what
    assert abs(float(x.var(unbiased=True)) - var) \
        <= 3 * 1.5 * var * math.sqrt(2.0 / n), what


@pytest.mark.parametrize("shape", SHAPES + [(7, 5, 2)])
def test_fans_match_reference(shape):
    from paddle_tpu.nn.initializer import _fan_in_out as ref_fans

    assert I._fan_in_out(shape) == ref_fans(shape)


def _std_case(name, shape):
    fi, fo = I._fan_in_out(shape)
    return {
        "Normal": (I.Normal(0.5, 2.0), RI.Normal(0.5, 2.0), 0.5, 4.0),
        "XavierNormal": (I.XavierNormal(), RI.XavierNormal(), 0.0,
                         2.0 / (fi + fo)),
        "XavierUniform": (I.XavierUniform(), RI.XavierUniform(), 0.0,
                          2.0 / (fi + fo)),
        "KaimingNormal": (I.KaimingNormal(), RI.KaimingNormal(), 0.0,
                          2.0 / fi),
        "KaimingUniform": (I.KaimingUniform(), RI.KaimingUniform(), 0.0,
                           2.0 / fi),
        "KaimingLeaky": (I.KaimingNormal(negative_slope=0.2,
                                         nonlinearity="leaky_relu"),
                         RI.KaimingNormal(negative_slope=0.2,
                                          nonlinearity="leaky_relu"),
                         0.0, 2.0 / (1 + 0.04) / fi),
        "Uniform": (I.Uniform(-3.0, 1.0), RI.Uniform(-3.0, 1.0), -1.0,
                    16.0 / 12.0),
        "TruncatedNormal": (I.TruncatedNormal(1.0, 0.5),
                            RI.TruncatedNormal(1.0, 0.5), 1.0,
                            0.25 * TRUNC2_VAR),
    }[name]


RANDOM = ["Normal", "XavierNormal", "XavierUniform", "KaimingNormal",
          "KaimingUniform", "KaimingLeaky", "Uniform", "TruncatedNormal"]


@pytest.mark.parametrize("shape", [(256, 256), (64, 16, 8, 8)])
@pytest.mark.parametrize("name", RANDOM)
def test_random_initializer_moments(name, shape):
    ours, ref, mean, var = _std_case(name, shape)
    t = ours(shape, generator=_gen())
    assert tuple(t.shape) == shape and t.dtype == torch.float32
    _moments_hold(t, mean, var, name)
    # the reference's draws have the same law: its moments hold too
    pt.seed(0)
    _moments_hold(torch.from_numpy(np.array(ref(shape, "float32"))), mean,
                  var, "reference " + name)
    # a seeded generator repeats its draws
    torch.testing.assert_close(ours(shape, generator=_gen()), t, rtol=0,
                               atol=0)


@pytest.mark.parametrize("name", ["XavierUniform", "KaimingUniform",
                                  "Uniform", "TruncatedNormal"])
def test_bounded_initializers_stay_in_bounds(name):
    shape = (256, 256)
    ours, _, mean, var = _std_case(name, shape)
    t = ours(shape, generator=_gen(1))
    if name == "TruncatedNormal":
        lo, hi = 1.0 - 2 * 0.5, 1.0 + 2 * 0.5
    else:
        half = math.sqrt(3.0 * var)
        lo, hi = mean - half, mean + half
    assert float(t.min()) >= lo - 1e-6 and float(t.max()) <= hi + 1e-6
    assert t.numel() == N


@pytest.mark.parametrize("shape", [(64, 32), (32, 64), (8, 4, 3, 3)])
def test_orthogonal(shape):
    t = I.Orthogonal(gain=2.0)(shape, generator=_gen())
    pt.seed(0)
    ref = np.array(RI.Orthogonal(gain=2.0)(shape, "float32"))
    assert tuple(t.shape) == shape == ref.shape
    for m in (t.double().reshape(-1, shape[-1]),
              torch.from_numpy(ref).double().reshape(-1, shape[-1])):
        small = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
        torch.testing.assert_close(
            small, 4.0 * torch.eye(small.shape[0], dtype=torch.float64),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["constant", "assign", "dirac",
                                  "dirac-groups"])
def test_deterministic_initializers_equal_reference(case):
    shape = (6, 3, 3, 3) if case.startswith("dirac") else (4, 5)
    value = np.arange(20, dtype=np.float32).reshape(4, 5) / 7
    ours, ref = {
        "constant": (I.Constant(0.25), RI.Constant(0.25)),
        "assign": (I.Assign(value), RI.Assign(value)),
        "dirac": (I.Dirac(), RI.Dirac()),
        "dirac-groups": (I.Dirac(groups=2), RI.Dirac(groups=2)),
    }[case]
    np.testing.assert_array_equal(ours(shape).numpy(),
                                  np.asarray(ref(shape, "float32")))


@pytest.mark.parametrize("args", [("sigmoid",), ("tanh",), ("relu",),
                                  ("leaky_relu",), ("leaky_relu", 0.2),
                                  ("selu",), ("conv2d",), ("linear",)])
def test_calculate_gain(args):
    assert I.calculate_gain(*args) == RI.calculate_gain(*args)


def test_linear_default_draws_are_unchanged():
    """``Linear``'s XavierNormal draws what the port drew before the
    initializers existed: one ``normal_`` of std sqrt(2 / (in + out))."""
    lin = Linear(48, 80, device="cpu", generator=_gen(3))
    want = torch.empty(48, 80).normal_(0.0, math.sqrt(2.0 / 128),
                                       generator=_gen(3))
    torch.testing.assert_close(lin.weight.detach(), want, rtol=0, atol=0)
    assert not lin.bias.detach().any()


def test_conv_default_init_moments():
    conv = Conv2D(64, 128, 3, device="cpu", generator=_gen())
    assert tuple(conv.weight.shape) == (128, 64, 3, 3)
    _moments_hold(conv.weight.detach(), 0.0, 2.0 / (64 * 9), "conv")
    assert not conv.bias.detach().any()


# -- ParamAttr ----------------------------------------------------------------

def _sgd_step(layer, x, opt_kw=None):
    opt = optimizer.SGD(0.5, parameters=layer.parameters(), **(opt_kw or {}))
    before = {n: p.detach().clone() for n, p in layer.named_parameters()}
    layer(x).square().sum().backward()
    grads = {n: (None if p.grad is None else p.grad.clone())
             for n, p in layer.named_parameters()}
    opt.step()
    opt.clear_grad()
    return before, grads


def test_param_attr_learning_rate_and_regularizer():
    lin = Linear(4, 3, device="cpu", generator=_gen(),
                 weight_attr=ParamAttr(learning_rate=0.1,
                                       regularizer=L2Decay(0.5)),
                 bias_attr=ParamAttr(initializer=I.Constant(0.3)))
    assert lin.weight.optimize_attr == {"learning_rate": 0.1}
    torch.testing.assert_close(lin.bias.detach(), torch.full((3,), 0.3))
    x = torch.from_numpy(np.random.RandomState(0).randn(5, 4).astype(
        np.float32))
    before, grads = _sgd_step(lin, x)
    want_w = before["weight"] - 0.5 * 0.1 * (grads["weight"]
                                             + 0.5 * before["weight"])
    want_b = before["bias"] - 0.5 * grads["bias"]
    torch.testing.assert_close(lin.weight.detach(), want_w, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(lin.bias.detach(), want_b, rtol=1e-6,
                               atol=1e-6)


def test_param_attr_trainable_false_left_out_of_trainstep():
    lin = Linear(4, 3, device="cpu", generator=_gen(),
                 weight_attr=ParamAttr(trainable=False), bias_attr=False)
    assert lin.bias is None and not lin.weight.requires_grad
    assert [n for n, _ in lin.named_parameters()] == ["weight"]
    head = Linear(3, 2, device="cpu", generator=_gen(1))
    model = torch.nn.Sequential(lin, head)
    w0 = lin.weight.detach().clone()
    h0 = head.weight.detach().clone()
    opt = optimizer.Momentum(0.1, parameters=model.parameters())
    step = TrainStep(model, lambda m, x: m(x).square().mean(), opt)
    x = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    for _ in range(2):
        step(x)
    torch.testing.assert_close(lin.weight.detach(), w0, rtol=0, atol=0)
    assert not torch.equal(head.weight.detach(), h0)


def test_param_attr_need_clip_and_name():
    a = Linear(4, 4, device="cpu", generator=_gen(),
               weight_attr=ParamAttr(name="kept", need_clip=False),
               bias_attr=False)
    assert a.weight.param_name == "kept" and a.weight.need_clip is False
    x = torch.from_numpy(np.random.RandomState(1).randn(8, 4).astype(
        np.float32) * 100)
    before, grads = _sgd_step(a, x, dict(grad_clip=ClipGradByGlobalNorm(
        1e-3)))
    # need_clip=False: the global-norm clip leaves its gradient whole
    torch.testing.assert_close(a.weight.detach(), before["weight"]
                               - 0.5 * grads["weight"], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("weight_attr,bias_attr", [
    (False, False), (None, False), (False, None)])
def test_layer_norm_attrs_false(weight_attr, bias_attr):
    ln = LayerNorm(6, weight_attr=weight_attr, bias_attr=bias_attr,
                   device="cpu")
    assert (ln.weight is None) == (weight_attr is False)
    assert (ln.bias is None) == (bias_attr is False)
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 6).astype(
        np.float32))
    ref = pt.nn.LayerNorm(6, weight_attr=weight_attr, bias_attr=bias_attr)
    np.testing.assert_allclose(ln(x).detach().numpy(),
                               np.asarray(ref(pt.to_tensor(x.numpy())).value),
                               rtol=1e-5, atol=1e-6)


def test_root_create_parameter():
    p = ptt.create_parameter([3, 4], name="w0", place="cpu",
                             default_initializer=I.Constant(2.0))
    assert p.param_name == "w0" and p.requires_grad
    torch.testing.assert_close(p.detach(), torch.full((3, 4), 2.0))
    b = ptt.create_parameter([4], is_bias=True, place="cpu",
                             attr=ParamAttr(learning_rate=0.5))
    assert not b.detach().any() and b.optimize_attr["learning_rate"] == 0.5
    assert ptt.nn.create_parameter([2], attr=False) is None


IDS = ([[4, 9, 4]], [[9, 1]], [[4, 9, 4]])


@pytest.fixture(scope="module")
def reference_regularized_lazy_adam():
    """The reference's sparse embedding with an L2 regularizer in its
    weight_attr under lazy Adam, 3 steps: (initial, final) weights."""
    pt.seed(0)
    emb = pt.nn.Embedding(60, 4, sparse=True, weight_attr=pt.ParamAttr(
        regularizer=pt.regularizer.L2Decay(0.1)))
    w0 = np.asarray(emb.weight.value).copy()
    opt = pt.optimizer.Adam(0.05, parameters=emb.parameters(),
                            lazy_mode=True)
    for ids in IDS:
        emb(pt.to_tensor(np.asarray(ids, np.int64))).sum().backward()
        opt.step()
        opt.clear_grad()
    return w0, np.asarray(emb.weight.value)


def test_embedding_weight_attr_regularizer_densifies(
        reference_regularized_lazy_adam):
    w0, want = reference_regularized_lazy_adam
    emb = Embedding(60, 4, sparse=True, device="cpu",
                    weight_attr=ParamAttr(regularizer=L2Decay(0.1)))
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(w0))
    opt = optimizer.Adam(0.05, parameters=emb.parameters(), lazy_mode=True)
    for ids in IDS:
        emb(torch.tensor(ids)).sum().backward()
        opt.step()
        opt.clear_grad()
    got = emb.weight.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # dense: the decay moved rows no id met
    untouched = np.setdiff1d(np.arange(60), [1, 4, 9])
    assert not np.array_equal(got[untouched], w0[untouched])

"""The vision training path of the port against the reference on the CPU:
convolutions, pools, ``batch_norm``, the 28 activations, LeNet under
``TrainStep``, ResNet50 at full width, and ResNet18 (``layers=[1, 1, 1,
1]``) for the layout, stem, O2 and recompute checks.

Inputs are made with numpy from a seed and handed to both packages;
parameters and BatchNorm buffers cross with ``load_reference_params``.
The reference's functionals are called raw (``jnp``), their gradients by
``jax.vjp``.  Tolerances, all fp32:

- convolutions: forward and input/weight/bias gradients 1e-5, relative
  to each array's largest magnitude (O(1) outputs; a gradient sums many
  positions);
- pools 1e-6; ``batch_norm`` output 1e-5, running statistics after 3
  training calls 1e-6 relative;
- activations: forward and gradient 1e-6 (``gelu``/``selu``/``mish``/
  ``softplus``/``log_sigmoid``/``softmax``/``log_softmax``, whose
  transcendental kernels differ, 1e-5);
- LeNet: logits, 3 Adam steps' losses and parameters 1e-5;
- ResNet50 (25.6 M parameters): eval logits on 2 x 3 x 32 x 32 within
  1e-4 of their largest magnitude; train-mode logits, and the running
  statistics after one ``TrainStep``, on 2 x 3 x 96 x 96 within 1e-4 of
  the largest magnitude.  The train-mode check takes 96 x 96: at 32 x 32
  layer4 is 1 x 1, each BatchNorm there normalizes 2 values per channel,
  and a rounding difference is amplified up to 1/sqrt(epsilon) ~ 316
  times per layer (the reference against itself, NCHW against NHWC,
  differs by 2.6 in logits of magnitude 6.5 there);
- ResNet18: NHWC and the s2d stem against NCHW 1e-5; recompute's
  gradients and running statistics against the plain block's 1e-6.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn.functional import activation as ract
from paddle_tpu.nn.functional import conv as rconv
from paddle_tpu.nn.functional import norm as rnorm
from paddle_tpu.nn.functional import pooling as rpool

from paddle_tpu_torch import (InvalidArgumentError, TrainStep, amp,
                              load_reference_params, optimizer)
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision.models import LeNet, resnet18, resnet50

CONV_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rng(*key):
    """A numpy generator seeded by ``key`` (the same in every process)."""
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def reference_arrays(ref) -> dict:
    out = {n: np.asarray(p.value) for n, p in ref.named_parameters()}
    out.update({n: np.asarray(b.value) for n, b in ref.named_buffers()})
    return out


def _vjp_both(ref_fn, port_fn, arrays, tol, grad_of=None):
    """Forward of both on ``arrays`` and the gradients of ``sum(out *
    cot)`` with respect to each array (or those in ``grad_of``)."""
    grad_of = range(len(arrays)) if grad_of is None else grad_of
    want, vjp = jax.vjp(ref_fn, *[jnp.asarray(a) for a in arrays])
    cot = _rng("cot", want.shape).randn(*want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    ts = [_t(a, i in grad_of) for i, a in enumerate(arrays)]
    got = port_fn(*ts)
    _close(got.detach().numpy(), np.asarray(want), tol)
    got.backward(torch.from_numpy(cot))
    for i in grad_of:
        _close(ts[i].grad.numpy(), np.asarray(want_grads[i]), tol)


def _close(got, want, tol):
    """Within ``tol`` relative to ``want``'s largest magnitude (at least
    1): a gradient summed over many positions is held at the scale of its
    terms, not at an element that cancelled to near zero."""
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# -- convolutions ------------------------------------------------------------

GRID = [(1, 0, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (1, 1, 1, 2), (2, 2, 2, 4)]
SPATIAL = {1: (13,), 2: (11, 9), 3: (7, 6, 5)}
FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _conv_inputs(n, fmt, groups, cin=4, cout=8, k=3, seed=0):
    rng = _rng("conv", n, fmt, groups, seed)
    sp = SPATIAL[n]
    shape = (2,) + sp + (cin,) if fmt.endswith("C") else (2, cin) + sp
    x = rng.randn(*shape).astype(np.float32)
    # weights of std 1 / sqrt(fan_in): O(1) outputs
    w = (rng.randn(cout, cin // groups, *(k,) * n)
         / np.sqrt(cin // groups * k ** n)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("n,channel_last", [(n, last) for n in (1, 2, 3)
                                             for last in (False, True)])
@pytest.mark.parametrize("stride,padding,dilation,groups", GRID)
def test_conv_matches_reference(n, channel_last, stride, padding, dilation,
                                groups):
    fmt = FORMATS[n][channel_last]
    x, w, b = _conv_inputs(n, fmt, groups)
    ref = {1: rconv.conv1d, 2: rconv.conv2d, 3: rconv.conv3d}[n]
    ours = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[n]
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    _vjp_both(lambda x, w, b: ref(x, w, b, **kw),
              lambda x, w, b: ours(x, w, b, **kw), [x, w, b], CONV_TOL)


@pytest.mark.parametrize("padding", ["SAME", "VALID", "same", [1, 2],
                                     [(0, 2), (1, 0)], [2, 0, 1, 1]])
@pytest.mark.parametrize("fmt,stride", [(f, s) for f in ("NCHW", "NHWC")
                                         for s in (1, 2)])
def test_conv2d_padding_forms(padding, stride, fmt):
    x, w, b = _conv_inputs(2, fmt, 1, k=4, seed=1)
    kw = dict(stride=stride, padding=padding, data_format=fmt)
    _vjp_both(lambda x, w, b: rconv.conv2d(x, w, b, **kw),
              lambda x, w, b: F.conv2d(x, w, b, **kw), [x, w, b], CONV_TOL)


TRANSPOSE = [(1, 0, 0, 1), (2, 1, 0, 1), (2, 1, 1, 1), (3, 2, 2, 1),
             (2, 1, 1, 2), (2, [1, 0], 0, 1), (1, [2, 0], 0, 2),
             (2, [0, 1], 1, 1), (1, "SAME", 0, 1), (1, "VALID", 0, 2)]


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("stride,padding,output_padding,dilation",
                         TRANSPOSE)
def test_conv_transpose_matches_reference(n, stride, padding,
                                          output_padding, dilation):
    if isinstance(padding, list):
        padding = padding * n if n > 1 else padding[:1]
    rng = _rng("convt", n, stride, str(padding), output_padding, dilation)
    x = rng.randn(2, 4, *SPATIAL[n][:n]).astype(np.float32)
    w = (rng.randn(4, 6, *(3,) * n) / np.sqrt(4 * 3 ** n)).astype(
        np.float32)  # [in, out, *k]
    b = rng.randn(6).astype(np.float32)
    ref = {1: rconv.conv1d_transpose, 2: rconv.conv2d_transpose,
           3: rconv.conv3d_transpose}[n]
    ours = {1: F.conv1d_transpose, 2: F.conv2d_transpose,
            3: F.conv3d_transpose}[n]
    kw = dict(stride=stride, padding=padding, output_padding=output_padding,
              dilation=dilation)
    _vjp_both(lambda x, w, b: ref(x, w, b, **kw),
              lambda x, w, b: ours(x, w, b, **kw), [x, w, b], CONV_TOL)


def test_conv2d_transpose_nhwc():
    rng = _rng("convt-nhwc")
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    w = (rng.randn(4, 6, 3, 3) / 6.0).astype(np.float32)
    kw = dict(stride=2, padding=1, output_padding=1, data_format="NHWC")
    _vjp_both(lambda x, w: rconv.conv2d_transpose(x, w, None, **kw),
              lambda x, w: F.conv2d_transpose(x, w, None, **kw), [x, w],
              CONV_TOL)


@pytest.mark.parametrize("kw", [
    dict(stride=1, padding=0, output_padding=1),      # op >= stride, dil
    dict(stride=2, padding="SAME"),                    # a string at s 2
    dict(stride=1, padding="VALID", output_padding=1),  # op with a string
    dict(stride=1, padding=0, groups=2),               # groups > 1
])
def test_conv_transpose_refusals(kw):
    x = torch.zeros(1, 4, 5, 5)
    w = torch.zeros(4, 3, 3, 3)
    with pytest.raises(InvalidArgumentError):
        F.conv2d_transpose(x, w, **kw)
    with pytest.raises(Exception):
        rconv.conv2d_transpose(jnp.zeros((1, 4, 5, 5)),
                               jnp.zeros((4, 3, 3, 3)), **kw)


def test_conv_layers_carry_reference_weights():
    pt.seed(0)
    for ref, ours, x in (
            (pt.nn.Conv2D(3, 5, 3, padding=1, data_format="NHWC"),
             pnn.Conv2D(3, 5, 3, padding=1, data_format="NHWC",
                        device="cpu"), np.ones((1, 6, 6, 3), np.float32)),
            (pt.nn.Conv1DTranspose(3, 4, 3, stride=2),
             pnn.Conv1DTranspose(3, 4, 3, stride=2, device="cpu"),
             np.ones((1, 3, 5), np.float32)),
            (pt.nn.Conv3D(2, 3, 2, bias_attr=False),
             pnn.Conv3D(2, 3, 2, bias_attr=False, device="cpu"),
             np.ones((1, 2, 3, 3, 3), np.float32))):
        load_reference_params(ours, reference_arrays(ref))
        np.testing.assert_allclose(ours(_t(x)).detach().numpy(),
                                   np.asarray(ref(pt.to_tensor(x)).value),
                                   **CONV_TOL)


# -- pools --------------------------------------------------------------------

POOLS = [
    # (n, kernel, stride, padding, ceil_mode)
    (1, 3, 2, 1, False), (1, 3, 2, 0, True), (1, 2, None, 1, True),
    (2, 2, 2, 0, False), (2, 3, 2, 1, False), (2, 3, 2, 1, True),
    (2, (3, 2), (2, 1), [1, 0], True), (2, 2, 2, "SAME", False),
    (2, 3, 2, [(0, 2), (1, 1)], False), (3, 2, 2, 1, True),
    (3, 3, 1, 1, False),
]
POOL_SPATIAL = {1: (9,), 2: (9, 7), 3: (5, 6, 5)}


def _pool_x(n, channel_last, key):
    sp = POOL_SPATIAL[n]
    shape = (2,) + sp + (3,) if channel_last else (2, 3) + sp
    return _rng("pool", n, channel_last, key).randn(*shape).astype(
        np.float32)


@pytest.mark.parametrize("n,k,s,p,ceil,channel_last", [
    case + (last,) for case in POOLS for last in (False, True)
    if not (last and case[0] == 1)])  # the 1-D max pool is NCL only
def test_max_pool_matches_reference(n, k, s, p, ceil, channel_last):
    fmt = FORMATS[n][channel_last]
    x = _pool_x(n, channel_last, "max")
    ref = {1: rpool.max_pool1d, 2: rpool.max_pool2d, 3: rpool.max_pool3d}[n]
    ours = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[n]
    want = ref(jnp.asarray(x), k, s, p, False, ceil, fmt)
    got = ours(_t(x), k, s, p, False, ceil, fmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("n,k,s,p,ceil", POOLS)
def test_avg_pool_matches_reference(n, k, s, p, ceil, exclusive):
    x = _pool_x(n, False, "avg")
    fmt = FORMATS[n][0]
    if n == 1:
        want = rpool.avg_pool1d(jnp.asarray(x), k, s, p, exclusive, ceil,
                                fmt)
        got = F.avg_pool1d(_t(x), k, s, p, exclusive, ceil, fmt)
    else:
        ref = {2: rpool.avg_pool2d, 3: rpool.avg_pool3d}[n]
        ours = {2: F.avg_pool2d, 3: F.avg_pool3d}[n]
        want = ref(jnp.asarray(x), k, s, p, ceil, exclusive, None, fmt)
        got = ours(_t(x), k, s, p, ceil, exclusive, None, fmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)


@pytest.mark.parametrize("ceil", [False, True])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_avg_pool2d_divisor_override(fmt, ceil):
    x = _pool_x(2, fmt == "NHWC", "div")
    want = rpool.avg_pool2d(jnp.asarray(x), 3, 2, 1, ceil, True, 5, fmt)
    got = F.avg_pool2d(_t(x), 3, 2, 1, ceil, True, 5, fmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)


ADAPTIVE = [(1, 3), (1, 4), (2, (3, 7)), (2, (4, 3)), (2, 1), (3, (5, 2, 5)),
            (3, (2, 4, 3))]


@pytest.mark.parametrize("mode", ["avg", "max"])
@pytest.mark.parametrize("n,out", ADAPTIVE)
def test_adaptive_pools_match_reference(n, out, mode):
    x = _pool_x(n, False, "adaptive")
    name = "adaptive_%s_pool%dd" % (mode, n)
    want = getattr(rpool, name)(jnp.asarray(x), out)
    got = getattr(F, name)(_t(x), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)


@pytest.mark.parametrize("out", [1, (3, 2)])
def test_adaptive_avg_pool2d_nhwc(out):
    x = _pool_x(2, True, "adaptive-nhwc")
    want = rpool.adaptive_avg_pool2d(jnp.asarray(x), out, "NHWC")
    got = F.adaptive_avg_pool2d(_t(x), out, "NHWC")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POOL_TOL)


def test_pool_layers():
    x = _pool_x(2, False, "layers")
    for ours, ref in (
            (pnn.MaxPool2D(3, 2, 1, ceil_mode=True),
             pt.nn.MaxPool2D(3, 2, 1, ceil_mode=True)),
            (pnn.AvgPool2D(3, 2, 1, exclusive=False),
             pt.nn.AvgPool2D(3, 2, 1, exclusive=False)),
            (pnn.AdaptiveAvgPool2D((2, 3)), pt.nn.AdaptiveAvgPool2D((2, 3))),
            (pnn.AdaptiveMaxPool2D(2), pt.nn.AdaptiveMaxPool2D(2))):
        np.testing.assert_allclose(ours(_t(x)).numpy(),
                                   np.asarray(ref(pt.to_tensor(x)).value),
                                   **POOL_TOL)


# -- batch_norm -----------------------------------------------------------------

BN_SHAPES = {"NCHW": (4, 3, 5, 6), "NHWC": (4, 5, 6, 3), "NCL": (5, 3, 7),
             "NC": (8, 3)}


@pytest.mark.parametrize("fmt", list(BN_SHAPES))
def test_batch_norm_training_matches_reference(fmt):
    rng = _rng("bn", fmt)
    w = rng.rand(3).astype(np.float32) + 0.5
    b = rng.randn(3).astype(np.float32)
    rm0 = rng.randn(3).astype(np.float32)
    rv0 = rng.rand(3).astype(np.float32) + 0.5
    data_format = "NCHW" if fmt == "NC" else fmt
    rm, rv = jnp.asarray(rm0), jnp.asarray(rv0)
    pm, pv = _t(rm0), _t(rv0)
    for call in range(3):
        x = (rng.randn(*BN_SHAPES[fmt]) * 2 + 1).astype(np.float32)
        want, rm, rv = rnorm.batch_norm(jnp.asarray(x), rm, rv, jnp.asarray(w),
                                        jnp.asarray(b), True, 0.9, 1e-5,
                                        data_format)
        got = F.batch_norm(_t(x), pm, pv, _t(w), _t(b), training=True,
                           data_format=data_format)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(pm.numpy(), np.asarray(rm), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6)


@pytest.mark.parametrize("training,use_global_stats", [
    (False, None), (False, True), (True, None), (True, True)])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_global_stats(fmt, training, use_global_stats):
    rng = _rng("bn-global", fmt, training, use_global_stats)
    x = rng.randn(*BN_SHAPES[fmt]).astype(np.float32)
    rm0 = rng.randn(3).astype(np.float32)
    rv0 = rng.rand(3).astype(np.float32) + 0.5
    w = rng.rand(3).astype(np.float32) + 0.5
    want, nm, nv = rnorm.batch_norm(jnp.asarray(x), jnp.asarray(rm0),
                                    jnp.asarray(rv0), jnp.asarray(w), None,
                                    training, 0.9, 1e-5, fmt,
                                    use_global_stats)
    pm, pv = _t(rm0), _t(rv0)
    got = F.batch_norm(_t(x), pm, pv, _t(w), None, training, 0.9, 1e-5, fmt,
                       use_global_stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pm.numpy(), np.asarray(nm), rtol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(nv), rtol=1e-6)
    if not training or use_global_stats:
        np.testing.assert_array_equal(pm.numpy(), rm0)


def test_batch_norm_gradients_match_reference():
    rng = _rng("bn-grad")
    x = rng.randn(4, 3, 5, 6).astype(np.float32)
    w = rng.rand(3).astype(np.float32) + 0.5
    b = rng.randn(3).astype(np.float32)
    z = np.zeros(3, np.float32)

    def ref(x, w, b):
        return rnorm.batch_norm(x, jnp.zeros(3), jnp.ones(3), w, b, True)[0]

    def ours(x, w, b):
        return F.batch_norm(x, _t(z), _t(z + 1), w, b, training=True)

    _vjp_both(ref, ours, [x, w, b], dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("cls,shape,ok", [
    ("BatchNorm1D", (4, 3), True), ("BatchNorm1D", (4, 3, 5), True),
    ("BatchNorm1D", (4, 3, 5, 5), False), ("BatchNorm2D", (4, 3, 5, 5), True),
    ("BatchNorm2D", (4, 3, 5), False), ("BatchNorm3D", (2, 3, 4, 4, 4), True),
    ("BatchNorm3D", (4, 3, 5, 5), False)])
def test_batch_norm_layers(cls, shape, ok):
    ours = getattr(pnn, cls)(3, device="cpu")
    ref = getattr(pt.nn, cls)(3)
    assert sorted(n for n, _ in ours.named_buffers()) == ["_mean",
                                                          "_variance"]
    x = _rng("bn-layer", cls, shape).randn(*shape).astype(np.float32)
    if not ok:
        with pytest.raises(InvalidArgumentError):
            ours(_t(x))
        return
    want = np.asarray(ref(pt.to_tensor(x)).value)
    np.testing.assert_allclose(ours(_t(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours._mean.numpy(),
                               np.asarray(ref._mean.value), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ours._variance.numpy(),
                               np.asarray(ref._variance.value), rtol=1e-6)


def test_fluid_batch_norm_act():
    x = _rng("bn-act").randn(4, 3, 5, 5).astype(np.float32)
    ours = pnn.BatchNorm(3, act="relu", device="cpu")
    ref = pt.nn.BatchNorm(3, act="relu")
    np.testing.assert_allclose(ours(_t(x)).detach().numpy(),
                               np.asarray(ref(pt.to_tensor(x)).value),
                               rtol=1e-5, atol=1e-5)


# -- activations ----------------------------------------------------------------

ACT_TOL = dict(rtol=1e-6, atol=1e-6)
TRANSCENDENTAL = dict(rtol=1e-5, atol=1e-5)
ACTIVATIONS = {
    # name: (extra args, tolerance)
    "relu": ((), ACT_TOL), "relu6": ((), ACT_TOL), "sigmoid": ((), ACT_TOL),
    "tanh": ((), ACT_TOL), "gelu": ((), TRANSCENDENTAL),
    "gelu-tanh": ((True,), TRANSCENDENTAL),
    "leaky_relu": ((0.2,), ACT_TOL), "elu": ((0.7,), ACT_TOL),
    "selu": ((), TRANSCENDENTAL), "silu": ((), ACT_TOL),
    "swish": ((), ACT_TOL), "mish": ((), TRANSCENDENTAL),
    "softplus": ((2.0, 3.0), TRANSCENDENTAL), "softsign": ((), ACT_TOL),
    "softshrink": ((0.4,), ACT_TOL), "hardshrink": ((0.4,), ACT_TOL),
    "hardtanh": ((-0.5, 1.5), ACT_TOL), "hardsigmoid": ((), ACT_TOL),
    "hardswish": ((), ACT_TOL), "tanhshrink": ((), ACT_TOL),
    "thresholded_relu": ((0.3,), ACT_TOL),
    "log_sigmoid": ((), TRANSCENDENTAL), "maxout": ((2, 1), ACT_TOL),
    "softmax": ((1,), TRANSCENDENTAL), "log_softmax": ((1,), TRANSCENDENTAL),
    "glu": ((1,), ACT_TOL), "relu_": ((), ACT_TOL),
}


@pytest.mark.parametrize("case", list(ACTIVATIONS))
def test_activation_matches_reference(case):
    name = case.split("-")[0]
    args, tol = ACTIVATIONS[case]
    # away from each kink, so a gradient is one-sided on neither side
    x = _rng("act", case).randn(4, 6, 5).astype(np.float32) * 2.0
    for kink in (0.0, 0.3, 0.4, -0.4, 0.5, -0.5, 1.5, 3.0, -3.0, 6.0):
        x = np.where(np.abs(x - kink) < 1e-2, x + 3e-2, x)
    ref = getattr(ract, name)
    ours = getattr(F, name)
    if name == "relu_":
        def ours(t):  # in place on a non-leaf: paddle's relu_
            t2 = t * 1.0
            out = F.relu_(t2)
            assert out is t2
            return out
    _vjp_both(lambda t: ref(t, *args), lambda t: ours(t, *args), [x], tol)


def test_prelu_matches_reference():
    rng = _rng("prelu")
    x = rng.randn(2, 4, 3, 3).astype(np.float32)
    for w in (np.array([0.25], np.float32),
              rng.rand(4).astype(np.float32)):
        _vjp_both(ract.prelu, F.prelu, [x, w], ACT_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_softmax_dtype(dtype, tol):
    x = _rng("softmax-dtype").randn(3, 5).astype(np.float32)
    for name in ("softmax", "log_softmax"):
        want = getattr(ract, name)(jnp.asarray(x), -1, dtype)
        got = getattr(F, name)(_t(x), -1, dtype)
        assert str(got.dtype) == "torch." + str(want.dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax(hard):
    torch.manual_seed(0)
    x = _t(_rng("gumbel").randn(64, 10).astype(np.float32), True)
    y = F.gumbel_softmax(x, temperature=0.5, hard=hard)
    torch.testing.assert_close(y.sum(-1), torch.ones(64))
    if hard:
        assert set(torch.unique(y.detach()).tolist()) <= {0.0, 1.0}
    y[:, 0].sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


@pytest.mark.parametrize("name", ["elu_", "softmax_", "tanh_"])
def test_inplace_activations(name):
    x = _rng("inplace", name).randn(3, 4).astype(np.float32)
    t = _t(x)
    out = getattr(F, name)(t)
    assert out is t
    np.testing.assert_allclose(
        t.numpy(), np.asarray(getattr(ract, name[:-1])(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layer,args", [
    ("ReLU", ()), ("GELU", (True,)), ("LeakyReLU", (0.1,)),
    ("Hardtanh", (-2.0, 2.0)), ("Softplus", (2.0,)), ("Softmax", (0,)),
    ("LogSoftmax", ()), ("Maxout", (2,)), ("PReLU", (4, 0.1)),
    ("ThresholdedReLU", (0.5,)), ("GLU", (1,)), ("Hardsigmoid", ())])
def test_activation_layers(layer, args):
    x = _rng("act-layer", layer).randn(2, 4, 3).astype(np.float32)
    kw = {"device": "cpu"} if layer == "PReLU" else {}
    ours = getattr(pnn, layer)(*args, **kw)
    ref = getattr(pt.nn, layer)(*args)
    if layer == "PReLU":
        load_reference_params(ours, reference_arrays(ref))
    np.testing.assert_allclose(ours(_t(x)).detach().numpy(),
                               np.asarray(ref(pt.to_tensor(x)).value),
                               rtol=1e-5, atol=1e-6)


# -- containers and loss layers ----------------------------------------------------

def test_containers_name_as_the_reference():
    pt.seed(0)
    ref = pt.nn.Sequential(("stem", pt.nn.Linear(3, 4)), ("act", pt.nn.ReLU()),
                           ("head", pt.nn.Linear(4, 2)))
    ours = pnn.Sequential(("stem", pnn.Linear(3, 4, device="cpu")),
                          ("act", pnn.ReLU()),
                          ("head", pnn.Linear(4, 2, device="cpu")))
    load_reference_params(ours, reference_arrays(ref))
    x = _rng("seq").randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(ours(_t(x)).detach().numpy(),
                               np.asarray(ref(pt.to_tensor(x)).value),
                               rtol=1e-6, atol=1e-6)
    assert len(ours) == 3 and isinstance(ours[1], pnn.ReLU)
    assert isinstance(ours[1:], pnn.Sequential) and len(ours[1:]) == 2
    pos = pnn.Sequential(pnn.Linear(2, 2, device="cpu"), pnn.ReLU())
    assert [n for n, _ in pos.named_parameters()] == ["0.weight", "0.bias"]
    ll = pnn.LayerList([pnn.Linear(2, 2, device="cpu")])
    ll.append(pnn.ReLU()).insert(0, pnn.Tanh())
    assert [type(m).__name__ for m in ll] == ["Tanh", "Linear", "ReLU"]
    assert [n for n, _ in ll.named_parameters()] == ["1.weight", "1.bias"]
    pl = pnn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    pl.append(torch.nn.Parameter(torch.ones(3)))
    assert [n for n, _ in pl.named_parameters()] == ["0", "1"] \
        and len(pl) == 2
    ld = pnn.LayerDict({"a": pnn.ReLU()})
    ld["b"] = pnn.Linear(2, 2, device="cpu")
    assert list(ld.keys()) == ["a", "b"] and "b" in ld
    assert isinstance(ld.pop("a"), pnn.ReLU) and len(ld) == 1
    with pytest.raises(InvalidArgumentError):
        ld.update([pnn.ReLU()])


LOSS_LAYERS = {
    "CrossEntropyLoss": ((), "logits", "class"),
    "CrossEntropyLoss-smooth": ((None, -100, "sum", False, -1, True, 0.1),
                                "logits", "class"),
    "MSELoss": (("sum",), "x", "x"), "L1Loss": ((), "x", "x"),
    "NLLLoss": ((), "logp", "class"), "BCELoss": ((), "prob", "target"),
    "BCEWithLogitsLoss": ((), "x", "target"),
    "SmoothL1Loss": (("mean", 0.5), "x", "x"),
    "KLDivLoss": (("sum",), "logp", "prob"),
    "HingeEmbeddingLoss": ((), "x", "sign"),
}


@pytest.mark.parametrize("case", list(LOSS_LAYERS))
def test_loss_layers_match_reference(case):
    name = case.split("-")[0]
    args, kin, klab = LOSS_LAYERS[case]
    rng = _rng("loss", case)
    logits = rng.randn(6, 5).astype(np.float32)
    values = {
        "logits": logits, "x": rng.randn(6, 5).astype(np.float32),
        "logp": np.asarray(jax.nn.log_softmax(logits)),
        "prob": np.asarray(jax.nn.softmax(logits)),
        "class": rng.randint(0, 5, (6,)).astype(np.int64),
        "target": rng.randint(0, 2, (6, 5)).astype(np.float32),
        "sign": np.where(rng.rand(6, 5) > 0.5, 1.0, -1.0).astype(np.float32)}
    x, y = values[kin], values[klab]
    want = getattr(pt.nn, name)(*args)(pt.to_tensor(x), pt.to_tensor(y))
    got = getattr(pnn, name)(*args)(_t(x), _t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               rtol=1e-5, atol=1e-6)


def test_margin_ranking_and_hsigmoid_layers():
    rng = _rng("loss-more")
    a, b = (rng.randn(6).astype(np.float32) for _ in range(2))
    lab = np.where(rng.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    want = pt.nn.MarginRankingLoss(0.2)(pt.to_tensor(a), pt.to_tensor(b),
                                        pt.to_tensor(lab))
    got = pnn.MarginRankingLoss(0.2)(_t(a), _t(b), _t(lab))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.value),
                               rtol=1e-6)
    pt.seed(0)
    ref = pt.nn.HSigmoidLoss(4, 6)
    ours = pnn.HSigmoidLoss(4, 6, device="cpu")
    load_reference_params(ours, reference_arrays(ref))
    x = rng.randn(5, 4).astype(np.float32)
    y = rng.randint(0, 6, (5,)).astype(np.int64)
    np.testing.assert_allclose(
        ours(_t(x), _t(y)).detach().numpy(),
        np.asarray(ref(pt.to_tensor(x), pt.to_tensor(y)).value), rtol=1e-5,
        atol=1e-6)
    assert isinstance(pnn.CTCLoss(blank=1), torch.nn.Module)


# -- LeNet ------------------------------------------------------------------------

def test_lenet_forward_and_adam_steps_match_reference():
    from paddle_tpu.jit import TrainStep as RefTrainStep
    from paddle_tpu.vision.models import LeNet as RefLeNet

    pt.seed(0)
    ref = RefLeNet()
    port = LeNet(device="cpu")
    load_reference_params(port, reference_arrays(ref))
    rng = np.random.RandomState(0)
    x = rng.rand(16, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (16,)).astype(np.int64)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               np.asarray(ref(pt.to_tensor(x)).value),
                               rtol=1e-5, atol=1e-5)
    rcrit, crit = pt.nn.CrossEntropyLoss(), pnn.CrossEntropyLoss()
    ropt = pt.optimizer.Adam(1e-3, parameters=ref.parameters())
    rstep = RefTrainStep(ref, lambda m, a, b: rcrit(m(a), b), ropt)
    opt = optimizer.Adam(1e-3, parameters=port.parameters())
    step = TrainStep(port, lambda m, a, b: crit(m(a), b), opt)
    want = [float(np.asarray(rstep(x, y).value)) for _ in range(3)]
    got = [float(step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    arrays = reference_arrays(ref)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), arrays[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


# -- ResNet50 at full width -----------------------------------------------------------

@pytest.fixture(scope="module")
def resnet50_pair():
    """The reference's ResNet50 (seed 0) and the port's carrying its
    parameters and buffers, both at 1000 classes; each compared once in
    eval mode (32 x 32), then once in train mode (96 x 96), after which
    the port runs one TrainStep on the same batch."""
    from paddle_tpu.vision.models import resnet50 as ref_resnet50

    pt.seed(0)
    ref = ref_resnet50(num_classes=1000)
    port = resnet50(num_classes=1000, device="cpu")
    load_reference_params(port, reference_arrays(ref))
    out = {"params": sum(p.numel() for p in port.parameters())}
    rng = np.random.RandomState(0)
    small = rng.randn(2, 3, 32, 32).astype(np.float32)
    ref.eval()
    port.eval()
    with torch.no_grad():
        out["eval"] = (np.asarray(ref(pt.to_tensor(small)).value),
                       port(_t(small)).numpy())
    ref.train()
    port.train()
    x = rng.randn(2, 3, 96, 96).astype(np.float32)
    y = rng.randint(0, 1000, (2,)).astype(np.int64)
    want = np.asarray(ref(pt.to_tensor(x)).value)
    with torch.no_grad(), F.norm.frozen_running_stats():
        got = port(_t(x)).numpy()
    out["train"] = (want, got)
    crit = pnn.CrossEntropyLoss()
    opt = optimizer.Momentum(0.1, parameters=port.parameters())
    TrainStep(port, lambda m, a, b: crit(m(a), b), opt)(x, y)
    out["stats"] = ({n: np.asarray(b.value) for n, b in ref.named_buffers()},
                    {n: b.numpy() for n, b in port.named_buffers()})
    return out


def test_resnet50_full_width_logits(resnet50_pair):
    assert resnet50_pair["params"] == 25557032
    for mode in ("eval", "train"):
        want, got = resnet50_pair[mode]
        assert got.shape == want.shape == (2, 1000)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=mode)


def test_resnet50_running_stats_after_one_step(resnet50_pair):
    want, got = resnet50_pair["stats"]
    assert sorted(want) == sorted(got) and len(got) == 2 * 53
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0,
                                   atol=1e-4 * np.abs(want[n]).max(),
                                   err_msg=n)


def test_resnet_checks_and_pretrained():
    from paddle_tpu_torch.vision.models import ResNet
    from paddle_tpu_torch.vision.models.resnet import BasicBlock

    with pytest.raises(ValueError):
        ResNet(BasicBlock, depth=20, device="cpu")
    with pytest.raises(ValueError):
        resnet18(data_format="NDHWC", device="cpu")
    with pytest.raises(ValueError):
        resnet18(space_to_depth_stem=True, device="cpu")
    with pytest.raises(NotImplementedError):
        resnet50(pretrained=True, device="cpu")


# -- ResNet18, layers [1, 1, 1, 1] ---------------------------------------------------

SMALL = dict(num_classes=10, layers=[1, 1, 1, 1])


def _small(**kw):
    return resnet18(**SMALL, device="cpu", **kw)


def test_load_reference_params_carries_buffers():
    """Eval logits match only once the reference's running statistics
    cross with its parameters; a missing buffer is named in the error."""
    from paddle_tpu.vision.models import resnet18 as ref_resnet18

    pt.seed(0)
    ref = ref_resnet18(**SMALL)
    rng = np.random.RandomState(1)
    ref(pt.to_tensor(rng.randn(4, 3, 32, 32).astype(np.float32)))  # stats
    ref.eval()
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    want = np.asarray(ref(pt.to_tensor(x)).value)
    arrays = reference_arrays(ref)
    params_only = {n: a for n, a in arrays.items()
                   if not n.endswith(("_mean", "_variance"))}
    port = _small()
    with pytest.raises(InvalidArgumentError, match=r"bn1\._mean"):
        load_reference_params(port, params_only)
    # the parameters with the port's fresh statistics: not the same network
    fresh = {n: b.numpy() for n, b in port.named_buffers()}
    load_reference_params(port, dict(params_only, **fresh))
    port.eval()
    with torch.no_grad():
        assert not np.allclose(port(_t(x)).numpy(), want, rtol=1e-3)
    load_reference_params(port, arrays)
    with torch.no_grad():
        np.testing.assert_allclose(port(_t(x)).numpy(), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("variant", ["nhwc", "s2d"])
def test_resnet_nhwc_and_s2d_equal_nchw(variant, train):
    base = _small()
    other = _small(data_format="NHWC", space_to_depth_stem=variant == "s2d")
    other.load_state_dict(base.state_dict())
    # 64 x 64: layer4's BatchNorms in train mode normalize 16 values per
    # channel (1 x 1 at 32 x 32 leaves 4, which amplify rounding)
    x = _t(np.random.RandomState(0).randn(4, 3, 64, 64).astype(np.float32))
    base.train(train)
    other.train(train)
    want = base(x)
    got = other(x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    if train:
        want.sum().backward()
        got.sum().backward()
        # the s2d scatter gives the canonical 7x7 weight its gradient
        np.testing.assert_allclose(other.conv1.weight.grad.numpy(),
                                   base.conv1.weight.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)
        for n, b in base.named_buffers():
            np.testing.assert_allclose(dict(other.named_buffers())[n].numpy(),
                                       b.numpy(), rtol=1e-5, atol=1e-6)


def test_resnet_o2_dtypes_as_the_reference():
    """conv weight bf16; BN weight, bias and _mean float32; the BN output
    float32 (its weight promotes it); logits bf16 -- the reference's."""
    from paddle_tpu.vision.models import resnet18 as ref_resnet18

    pt.seed(0)
    ref = ref_resnet18(**SMALL)
    ropt = pt.optimizer.Momentum(0.1, parameters=ref.parameters())
    ref, ropt = pt.amp.decorate(ref, ropt, level="O2", dtype="bfloat16")
    port = _small()
    opt = optimizer.Momentum(0.1, parameters=port.parameters())
    port, opt = amp.decorate(port, opt, level="O2", dtype="bfloat16")
    x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)

    def dtypes(m, t, name):
        conv = m.conv1(t)
        bn = m.bn1(conv)
        return [name(v.dtype) for v in (
            m.conv1.weight, m.bn1.weight, m.bn1.bias, m.bn1._mean, conv, bn,
            m.relu(bn), m(t))]

    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        want = dtypes(ref, pt.to_tensor(x), str)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = dtypes(port, _t(x), lambda d: str(d)[6:])
    assert got == want == ["bfloat16", "float32", "float32", "float32",
                           "bfloat16", "float32", "float32", "bfloat16"]


def test_recompute_block_equals_plain_block():
    """A residual block under recompute: the same output and gradients as
    the plain block, and its BatchNorms' running statistics advanced
    once."""
    torch.manual_seed(0)
    plain = _small().layer2[0]
    checked = _small().layer2[0]
    x = torch.randn(4, 64, 8, 8)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = plain(xa)
    yb = recompute(checked, xb)
    torch.testing.assert_close(yb, ya, rtol=0, atol=0)
    cot = torch.randn_like(ya)
    ya.backward(cot)
    yb.backward(cot)
    torch.testing.assert_close(xb.grad, xa.grad, rtol=1e-6, atol=1e-6)
    for (n, p), q in zip(plain.named_parameters(), checked.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-6,
                                   msg=n)
    for (n, b), c in zip(plain.named_buffers(), checked.buffers()):
        torch.testing.assert_close(c, b, rtol=0, atol=0, msg=n)
    assert plain.bn1._mean.abs().sum() > 0


def test_recompute_preserves_rng_state():
    torch.manual_seed(0)
    x = torch.randn(64, 32, requires_grad=True)

    def region(t):
        return torch.nn.functional.dropout(t, 0.5, training=True) * 3.0

    out = recompute(region, x)
    out.backward(torch.ones_like(out))
    # the second run drew the first run's mask: the gradient is that mask
    # (dropout keeps with scale 2, times 3)
    torch.testing.assert_close(x.grad, (out.detach() != 0).float() * 6.0)


@pytest.mark.parametrize("o2", [False, True])
def test_resnet_remat_trainstep_equals_plain(o2):
    """``TrainStep`` over a ResNet whose blocks run under recompute: the
    same losses, weights and running statistics as without it; in O2 bf16
    too, where the second run happens outside ``auto_cast`` and must cast
    as the first did."""
    def wrap(model):
        for name, sub in model.named_modules():
            if name.startswith("layer") and name.count(".") == 1:
                orig = sub.forward
                sub.forward = (lambda *a, __o=orig: recompute(__o, *a))
        return model

    x = np.random.RandomState(0).randn(4, 3, 32, 32).astype(np.float32)
    y = np.arange(4, dtype=np.int64)
    crit = pnn.CrossEntropyLoss()

    def loss_fn(m, a, b):
        if not o2:
            return crit(m(a), b)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(a), b)

    runs = []
    for remat in (False, True):
        model = _small()
        if remat:
            wrap(model)
        opt = optimizer.Momentum(0.1, parameters=model.parameters())
        if o2:
            model, opt = amp.decorate(model, opt, level="O2",
                                      dtype="bfloat16")
        step = TrainStep(model, loss_fn, opt)
        runs.append(([float(step(x, y)) for _ in range(2)],
                     {n: t.detach().clone() for n, t in
                      list(model.named_parameters())
                      + list(model.named_buffers())}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for n, t in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][n], t, rtol=1e-5, atol=1e-6,
                                   msg=n)

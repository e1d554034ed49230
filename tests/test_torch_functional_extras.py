"""The port's vision functions and layers against the reference on the
CPU: ``nn/functional/common.py``'s dropouts, ``pad``, ``unfold``,
``interpolate``/``upsample`` (six modes, both ``align_mode``s, bicubic's
antialiased shrink), ``pixel_shuffle``, ``bilinear``, ``temporal_shift``
and ``diag_embed``; ``nn/functional/norm.py``'s ``instance_norm``,
``group_norm``, ``local_response_norm`` and ``normalize``;
``nn/functional/vision.py``'s ``affine_grid``/``grid_sample``; the
layers of ``nn/layer/{common,norm}.py`` that wrap them, and
``nn/utils``' spectral and weight norm.

Inputs are made with numpy from a seed and handed to both packages; the
reference's functionals are called raw (``jnp``), their gradients by
``jax.vjp``; layer parameters cross with ``load_reference_params``.
Tolerances, all fp32, relative to each array's largest magnitude (at
least 1):

- resampling, pads, unfold, shuffles, ``bilinear``, ``diag_embed``,
  ``temporal_shift``: forward and gradient 1e-6 (index arithmetic and one
  multiply-add; bicubic 1e-5: a weight matrix contracted in another
  order);
- norms, ``normalize``, ``grid_sample``/``affine_grid``, the spectral and
  weight norms: 1e-5 (``rsqrt`` against ``1 / sqrt``, reductions in
  another order).

Dropout's masks are torch's, not threefry's: ``dropout2d``/``dropout3d``/
``alpha_dropout`` are held to the reference at ``p`` 0 and in eval mode,
and by their invariants (whole channels dropped, kept values scaled by
``1 / (1 - p)``; alpha dropout's affine constants).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn.functional import common as rcommon
from paddle_tpu.nn.functional import norm as rnorm
from paddle_tpu.nn.functional import vision as rvision

from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F

TIGHT = 1e-6
LOOSE = 1e-5


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _both(ref_fn, port_fn, arrays, tol, grad=True):
    """Forward of both on ``arrays``; with ``grad``, the gradients of
    ``sum(out * cot)`` with respect to every floating array."""
    if not grad:
        want = jax.jit(ref_fn)(*[jnp.asarray(a) for a in arrays])
        got = port_fn(*[torch.from_numpy(np.array(a)) for a in arrays])
        _close(got.numpy(), want, tol)
        return got
    want, vjp = jax.vjp(jax.jit(ref_fn), *[jnp.asarray(a) for a in arrays])
    cot = _rng("cot", want.shape).randn(*want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(np.array(a)).requires_grad_(True)
          for a in arrays]
    got = port_fn(*ts)
    _close(got.detach().numpy(), want, tol)
    got.backward(torch.from_numpy(cot))
    for t, g in zip(ts, want_grads):
        _close(t.grad.numpy(), g, tol)
    return got


def _arrays(ref):
    out = {n: np.asarray(p.value) for n, p in ref.named_parameters()}
    out.update({n: np.asarray(b.value) for n, b in ref.named_buffers()})
    return out


# -- dropouts -----------------------------------------------------------------

@pytest.mark.parametrize("fn,shape,fmt", [
    ("dropout2d", (2, 3, 5, 4), "NCHW"), ("dropout2d", (2, 5, 4, 3), "NHWC"),
    ("dropout3d", (2, 3, 2, 5, 4), "NCDHW"),
    ("dropout3d", (2, 2, 5, 4, 3), "NDHWC")])
def test_channel_dropout_invariants(fn, shape, fmt):
    x = torch.from_numpy(_rng(fn, fmt).rand(*shape).astype(np.float32) + 1)
    f = getattr(F, fn)
    # p 0 and eval mode: the input, as the reference's
    for kw in (dict(p=0.0), dict(p=0.5, training=False)):
        want = getattr(rcommon, fn)(jnp.asarray(x.numpy()),
                                    data_format=fmt, **kw)
        np.testing.assert_array_equal(f(x, data_format=fmt, **kw).numpy(),
                                      np.asarray(want))
    torch.manual_seed(0)
    out = f(x, p=0.5, data_format=fmt).numpy()
    chan = 1 if fmt.startswith("NC") else len(shape) - 1
    axes = tuple(i for i in range(len(shape)) if i not in (0, chan))
    kept = (out != 0).all(axis=axes)
    dropped = (out == 0).all(axis=axes)
    assert (kept | dropped).all() and kept.any() and dropped.any()
    np.testing.assert_allclose(out[out != 0], (x.numpy() * 2.0)[out != 0],
                               rtol=1e-6)


def test_alpha_dropout_invariants():
    x = _rng("alpha").randn(64, 64).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(F.alpha_dropout(t, 0.0).numpy(), x)
    np.testing.assert_array_equal(
        F.alpha_dropout(t, 0.3, training=False).numpy(),
        np.asarray(rcommon.alpha_dropout(jnp.asarray(x), 0.3,
                                         training=False)))
    torch.manual_seed(0)
    p = 0.3
    out = F.alpha_dropout(t, p).numpy()
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2))) ** 0.5
    b = -a * alpha_p * p
    dropped = np.isclose(out, a * alpha_p + b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[~dropped], a * x[~dropped] + b,
                               rtol=1e-5, atol=1e-6)
    assert 0.2 < dropped.mean() < 0.4


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_axis_and_mode(mode):
    x = torch.ones(4, 6, 5)
    torch.manual_seed(0)
    out = F.dropout(x, 0.5, axis=1, mode=mode).numpy()
    assert set(np.unique(out)) <= {0.0, 2.0 if mode == "upscale_in_train"
                                   else 1.0}
    assert (out == out[:1, :, :1]).all()  # one draw per index of axis 1
    want = np.asarray(rcommon.dropout(jnp.ones((4, 6, 5)), 0.5,
                                      training=False, mode=mode))
    np.testing.assert_array_equal(
        F.dropout(x, 0.5, training=False, mode=mode).numpy(), want)


def test_dropout_layers():
    x = torch.ones(2, 3, 4, 4)
    for layer in (pnn.Dropout2D(0.5), pnn.Dropout3D(0.5),
                  pnn.AlphaDropout(0.5), pnn.Dropout(0.5, axis=[0, 1])):
        layer.eval()
        xi = x if not isinstance(layer, pnn.Dropout3D) else x[..., None]
        np.testing.assert_array_equal(layer(xi).numpy(), xi.numpy())


# -- pad ----------------------------------------------------------------------

PAD_CASES = [
    # (shape, pad, data_format)
    ((2, 3, 5, 6), [1, 2, 2, 1], "NCHW"),
    ((2, 5, 6, 3), [2, 1, 0, 2], "NHWC"),
    ((2, 3, 7), [2, 3], "NCL"),
    ((2, 3, 4, 5, 6), [1, 0, 2, 1, 1, 2], "NCDHW"),
    ((2, 3, 5, 6), [0, 0, 0, 0, 1, 2, 2, 1], "NCHW"),   # 2 * ndim, first axis
    ((3, 6), [1, 2, 3, 4], "NCHW"),                     # 2 * ndim on 2-D
]


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("case", range(len(PAD_CASES)))
def test_pad_matches_reference(case, mode):
    shape, pads, fmt = PAD_CASES[case]
    x = _rng("pad", case).randn(*shape).astype(np.float32)
    _both(lambda a: rcommon.pad(a, pads, mode, 0.5, fmt),
          lambda a: F.pad(a, pads, mode, 0.5, fmt), [x], TIGHT)


def test_pad_reflect_beyond_one_period():
    x = np.arange(4, dtype=np.float32).reshape(1, 1, 4)
    for mode in ("reflect", "circular", "replicate"):
        want = rcommon.pad(jnp.asarray(x), [7, 9], mode, data_format="NCL")
        np.testing.assert_array_equal(
            F.pad(torch.from_numpy(x), [7, 9], mode,
                  data_format="NCL").numpy(), np.asarray(want))


@pytest.mark.parametrize("cls,shape,pads,fmt", [
    ("Pad1D", (2, 3, 6), [1, 2], "NCL"),
    ("Pad2D", (2, 3, 5, 6), [1, 2, 0, 1], "NCHW"),
    ("Pad3D", (2, 3, 3, 4, 5), [1, 1, 0, 2, 1, 0], "NCDHW")])
def test_pad_layers(cls, shape, pads, fmt):
    x = _rng(cls).randn(*shape).astype(np.float32)
    want = getattr(pt.nn, cls)(pads, mode="reflect")(pt.to_tensor(x))
    got = getattr(pnn, cls)(pads, mode="reflect")(torch.from_numpy(x))
    _close(got.numpy(), want.value, TIGHT)


# -- unfold, pixel_shuffle, bilinear, temporal_shift, diag_embed --------------

@pytest.mark.parametrize("k,s,p,d", [(3, 1, 0, 1), (2, 2, 1, 1),
                                     ((3, 2), (2, 1), [1, 0], (1, 2)),
                                     (3, 1, [1, 0, 2, 1], 1)])
def test_unfold_matches_reference(k, s, p, d):
    x = _rng("unfold", str(k)).randn(2, 3, 7, 8).astype(np.float32)
    _both(lambda a: rcommon.unfold(a, k, s, p, d),
          lambda a: F.unfold(a, k, s, p, d), [x], TIGHT)
    _close(pnn.Unfold(k, s, p, d)(torch.from_numpy(x)).numpy(),
           rcommon.unfold(jnp.asarray(x), k, s, p, d), TIGHT)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_pixel_shuffle_matches_reference(fmt):
    shape = (2, 18, 3, 4) if fmt == "NCHW" else (2, 3, 4, 18)
    x = _rng("ps", fmt).randn(*shape).astype(np.float32)
    _both(lambda a: rcommon.pixel_shuffle(a, 3, fmt),
          lambda a: F.pixel_shuffle(a, 3, fmt), [x], TIGHT)
    _close(pnn.PixelShuffle(3, fmt)(torch.from_numpy(x)).numpy(),
           rcommon.pixel_shuffle(jnp.asarray(x), 3, fmt), TIGHT)


def test_bilinear_function_and_layer():
    rng = _rng("bilinear")
    x1 = rng.randn(4, 5).astype(np.float32)
    x2 = rng.randn(4, 3).astype(np.float32)
    w = rng.randn(6, 5, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    _both(rcommon.bilinear, F.bilinear, [x1, x2, w, b], TIGHT)
    pt.seed(0)
    ref = pt.nn.Bilinear(5, 3, 6)
    port = pnn.Bilinear(5, 3, 6, device="cpu")
    load_reference_params(port, _arrays(ref))
    _close(port(torch.from_numpy(x1), torch.from_numpy(x2)).detach().numpy(),
           ref(pt.to_tensor(x1), pt.to_tensor(x2)).value, TIGHT)


@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_temporal_shift_matches_reference(ratio):
    x = _rng("tsm", ratio).randn(6, 8, 3, 2).astype(np.float32)
    _both(lambda a: rcommon.temporal_shift(a, 3, ratio),
          lambda a: F.temporal_shift(a, 3, ratio), [x], TIGHT)


@pytest.mark.parametrize("offset,dim1,dim2", [(0, -2, -1), (1, -2, -1),
                                              (-2, 0, 2), (2, 1, 0)])
def test_diag_embed_matches_reference(offset, dim1, dim2):
    x = _rng("diag", offset).randn(2, 3).astype(np.float32)
    _both(lambda a: rcommon.diag_embed(a, offset, dim1, dim2),
          lambda a: F.diag_embed(a, offset, dim1, dim2), [x], TIGHT)


# -- interpolate --------------------------------------------------------------

INTERP = [
    # (mode, shape, size, scale_factor, align_corners, align_mode, fmt)
    ("nearest", (2, 3, 5, 7), (9, 4), None, False, 0, "NCHW"),
    ("nearest", (2, 3, 5, 7), (9, 4), None, True, 0, "NCHW"),
    ("nearest", (2, 5, 7, 3), None, 1.7, False, 0, "NHWC"),
    ("nearest", (2, 3, 9), None, 0.5, False, 0, "NCL"),
    ("linear", (2, 3, 9), 13, None, False, 0, "NCL"),
    ("linear", (2, 3, 9), 5, None, False, 1, "NCL"),
    ("bilinear", (2, 3, 5, 7), (9, 4), None, False, 0, "NCHW"),
    ("bilinear", (2, 3, 5, 7), (9, 4), None, True, 0, "NCHW"),
    ("bilinear", (2, 3, 5, 7), (9, 4), None, False, 1, "NCHW"),
    ("bilinear", (2, 5, 7, 3), None, (2.0, 0.6), False, 0, "NHWC"),
    ("bilinear", (2, 3, 6, 6), (1, 1), None, True, 0, "NCHW"),
    ("trilinear", (1, 2, 3, 4, 5), (5, 3, 7), None, False, 0, "NCDHW"),
    ("trilinear", (1, 2, 3, 4, 5), (5, 3, 7), None, True, 0, "NCDHW"),
    ("trilinear", (1, 2, 3, 4, 5), (5, 3, 7), None, False, 1, "NCDHW"),
    ("area", (2, 3, 8, 9), (3, 4), None, False, 0, "NCHW"),
    ("area", (2, 8, 9, 3), (4, 2), None, False, 0, "NHWC"),
    ("bicubic", (2, 3, 5, 7), (11, 13), None, False, 0, "NCHW"),  # grow
    ("bicubic", (2, 3, 16, 12), (5, 7), None, False, 0, "NCHW"),  # shrink
    ("bicubic", (2, 9, 10, 3), None, 0.5, False, 0, "NHWC"),      # shrink
    ("bicubic", (2, 3, 6, 8), (6, 3), None, False, 0, "NCHW"),    # one axis
]


@pytest.mark.parametrize("case", range(len(INTERP)))
def test_interpolate_matches_reference(case):
    mode, shape, size, scale, align, amode, fmt = INTERP[case]
    x = _rng("interp", case).randn(*shape).astype(np.float32)
    tol = LOOSE if mode == "bicubic" else TIGHT
    _both(lambda a: rcommon.interpolate(a, size, scale, mode, align, amode,
                                        fmt),
          lambda a: F.interpolate(a, size, scale, mode, align, amode, fmt),
          [x], tol)


def test_bicubic_shrink_antialiases():
    """A 3x shrink of a checkerboard averages it out (the widened kernel),
    where torch's own bicubic samples it at pixel centres."""
    board = np.indices((24, 24)).sum(0) % 2
    x = torch.from_numpy(board.astype(np.float32))[None, None]
    out = F.interpolate(x, (8, 8), mode="bicubic")[0, 0]
    inner = out[2:-2, 2:-2]
    assert float((inner - 0.5).abs().max()) < 0.05
    plain = torch.nn.functional.interpolate(x, (8, 8), mode="bicubic")
    assert float((plain[0, 0, 2:-2, 2:-2] - 0.5).abs().max()) > 0.4


@pytest.mark.parametrize("cls,kw", [
    ("Upsample", dict(size=(7, 9), mode="bilinear", align_mode=1)),
    ("Upsample", dict(scale_factor=2, mode="bicubic")),
    ("UpsamplingBilinear2D", dict(size=(7, 9))),
    ("UpsamplingNearest2D", dict(scale_factor=2))])
def test_upsample_layers(cls, kw):
    x = _rng(cls, str(kw)).randn(2, 3, 4, 5).astype(np.float32)
    want = getattr(pt.nn, cls)(**kw)(pt.to_tensor(x)).value
    got = getattr(pnn, cls)(**kw)(torch.from_numpy(x))
    _close(got.numpy(), want, LOOSE)
    up = F.upsample(torch.from_numpy(x), kw.get("size"),
                    kw.get("scale_factor"), kw.get("mode", "nearest"))
    _close(up.numpy(), rcommon.upsample(jnp.asarray(x), kw.get("size"),
                                        kw.get("scale_factor"),
                                        kw.get("mode", "nearest")), LOOSE)


def test_interpolate_refusals():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(pt_error()):
        F.interpolate(x, (2, 2), mode="lanczos")
    with pytest.raises(pt_error()):
        F.interpolate(x)


def pt_error():
    from paddle_tpu_torch import InvalidArgumentError

    return InvalidArgumentError


# -- norms --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 7), (2, 4, 5, 6), (2, 4, 3, 4, 5)])
def test_instance_norm_matches_reference(shape):
    rng = _rng("inorm", shape)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    w = rng.randn(shape[1]).astype(np.float32)
    b = rng.randn(shape[1]).astype(np.float32)
    _both(lambda a, c, d: rnorm.instance_norm(a, c, d),
          lambda a, c, d: F.instance_norm(a, c, d), [x, w, b], LOOSE)


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_group_norm_matches_reference(groups):
    rng = _rng("gnorm", groups)
    x = (rng.randn(2, 8, 5, 6) * 2 - 1).astype(np.float32)
    w = rng.randn(8).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    _both(lambda a, c, d: rnorm.group_norm(a, groups, c, d),
          lambda a, c, d: F.group_norm(a, groups, c, d), [x, w, b], LOOSE)


@pytest.mark.parametrize("size", [1, 3, 4, 5])
def test_local_response_norm_matches_reference(size):
    x = _rng("lrn", size).randn(2, 7, 4, 5).astype(np.float32)
    _both(lambda a: rnorm.local_response_norm(a, size, 1e-2, 0.75, 2.0),
          lambda a: F.local_response_norm(a, size, 1e-2, 0.75, 2.0), [x],
          LOOSE)


@pytest.mark.parametrize("p,axis", [(2, 1), (1, -1), (3, 0)])
def test_normalize_matches_reference(p, axis):
    x = _rng("normalize", p).randn(3, 4, 5).astype(np.float32)
    _both(lambda a: rnorm.normalize(a, p, axis),
          lambda a: F.normalize(a, p, axis), [x], LOOSE)


def test_norm_refusals():
    x = torch.zeros(2, 6, 3, 3)
    with pytest.raises(pt_error()):
        F.group_norm(x, 4)
    with pytest.raises(pt_error()):
        F.instance_norm(x, data_format="NHWC")


@pytest.mark.parametrize("cls,args,shape", [
    ("GroupNorm", (2, 6), (2, 6, 4, 5)),
    ("InstanceNorm1D", (6,), (2, 6, 7)),
    ("InstanceNorm2D", (6,), (2, 6, 4, 5)),
    ("InstanceNorm3D", (6,), (2, 6, 3, 4, 5)),
    ("LocalResponseNorm", (5,), (2, 6, 4, 5))])
def test_norm_layers_carry_reference_parameters(cls, args, shape):
    pt.seed(1)
    ref = getattr(pt.nn, cls)(*args)
    port = getattr(pnn, cls)(*args, **({} if cls == "LocalResponseNorm"
                                        else {"device": "cpu"}))
    arrays = _arrays(ref)
    rng = _rng("layer", cls)
    # perturbed weights and biases, so the affine part is held too
    arrays = {n: a + rng.randn(*a.shape).astype(np.float32)
              for n, a in arrays.items()}
    assert sorted(arrays) == sorted(n for n, _ in port.named_parameters())
    load_reference_params(port, arrays)
    for n, a in arrays.items():
        getattr(ref, n).set_value(a)
    x = rng.randn(*shape).astype(np.float32)
    _close(port(torch.from_numpy(x)).detach().numpy(),
           ref(pt.to_tensor(x)).value, LOOSE)


def test_instance_norm_without_affine():
    port = pnn.InstanceNorm2D(3, weight_attr=False, device="cpu")
    assert port.scale is None and port.bias is None
    x = _rng("inorm-plain").randn(2, 3, 4, 4).astype(np.float32)
    _close(port(torch.from_numpy(x)).numpy(),
           rnorm.instance_norm(jnp.asarray(x)), LOOSE)


@pytest.mark.parametrize("dim,power_iters", [(0, 1), (1, 2), (2, 3)])
def test_spectral_norm_layer_matches_reference(dim, power_iters):
    shape = [4, 3, 5]
    pt.seed(2)
    ref = pt.nn.SpectralNorm(shape, dim=dim, power_iters=power_iters)
    port = pnn.SpectralNorm(shape, dim=dim, power_iters=power_iters,
                            device="cpu")
    load_reference_params(port, _arrays(ref))
    rng = _rng("sn", dim)
    w = rng.randn(*shape).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    u0 = port.weight_u.detach().clone()
    # the reference's own tape: u and v enter sigma as constants
    rw = pt.to_tensor(w, stop_gradient=False)
    want = ref(rw)
    (want * pt.to_tensor(cot)).sum().backward()
    tw = torch.from_numpy(w).requires_grad_(True)
    got = port(tw)
    got.backward(torch.from_numpy(cot))
    _close(got.detach().numpy(), want.value, LOOSE)
    _close(tw.grad.numpy(), rw.grad.value, LOOSE)
    # the stored vectors are read, never written, and take no gradient
    assert torch.equal(port.weight_u, u0)
    assert not port.weight_u.requires_grad
    with pytest.raises(ValueError):
        pnn.SpectralNorm(shape, power_iters=0, device="cpu")


def test_spectral_norm_hook_matches_reference():
    pt.seed(3)
    ref = pt.nn.Linear(5, 4)
    pt.nn.utils.spectral_norm(ref, n_power_iterations=2)
    port = pnn.Linear(5, 4, device="cpu")
    pnn.utils.spectral_norm(port, n_power_iterations=2)
    load_reference_params(port, _arrays(ref))
    assert sorted(_arrays(ref)) == ["bias", "weight_orig", "weight_u",
                                    "weight_v"]
    x = _rng("snhook").randn(3, 5).astype(np.float32)
    for train in (True, True, False):
        ref.train() if train else ref.eval()
        port.train(train)
        want = ref(pt.to_tensor(x)).value
        got = port(torch.from_numpy(x))
        _close(got.detach().numpy(), want, LOOSE)
        _close(port.weight_u.numpy(), ref.weight_u.value, LOOSE)
    with pytest.raises(RuntimeError):
        pnn.utils.spectral_norm(port)
    got.sum().backward()
    assert port.weight_orig.grad is not None


@pytest.mark.parametrize("dim", [0, 1, None, -1])
def test_weight_norm_matches_reference(dim):
    pt.seed(4)
    ref = pt.nn.Conv2D(3, 4, 3)
    pt.nn.utils.weight_norm(ref, dim=dim)
    port = pnn.Conv2D(3, 4, 3, device="cpu")
    pnn.utils.weight_norm(port, dim=dim)
    arrays = _arrays(ref)
    assert sorted(arrays) == ["bias", "weight_g", "weight_v"]
    load_reference_params(port, arrays)
    x = _rng("wn", dim).randn(2, 3, 6, 6).astype(np.float32)
    got = port(torch.from_numpy(x))
    _close(got.detach().numpy(), ref(pt.to_tensor(x)).value, LOOSE)
    got.sum().backward()
    assert port.weight_g.grad is not None and port.weight_v.grad is not None
    pnn.utils.remove_weight_norm(port)
    pt.nn.utils.remove_weight_norm(ref)
    assert sorted(n for n, _ in port.named_parameters()) == ["bias",
                                                             "weight"]
    _close(port(torch.from_numpy(x)).detach().numpy(),
           ref(pt.to_tensor(x)).value, LOOSE)
    with pytest.raises(ValueError):
        pnn.utils.remove_weight_norm(port)


# -- the other common layers --------------------------------------------------

def test_flatten_identity_cosine_pairwise():
    rng = _rng("misc")
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    y = rng.randn(2, 3, 4, 5).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert pnn.Flatten()(tx).shape == (2, 60)
    assert pnn.Flatten(0, 1)(tx).shape == (6, 4, 5)
    assert pnn.Identity(3, k=1)(tx) is tx
    _close(pnn.CosineSimilarity(axis=1)(tx, ty).numpy(),
           pt.nn.CosineSimilarity(axis=1)(pt.to_tensor(x),
                                          pt.to_tensor(y)).value, LOOSE)
    for p, keep in ((2.0, False), (1.0, True)):
        _close(pnn.PairwiseDistance(p, keepdim=keep)(tx, ty).numpy(),
               pt.nn.PairwiseDistance(p, keepdim=keep)(
                   pt.to_tensor(x), pt.to_tensor(y)).value, LOOSE)


# -- affine_grid / grid_sample ------------------------------------------------

@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_matches_reference(align):
    theta = _rng("theta", align).randn(3, 2, 3).astype(np.float32)
    for shape in ([3, 2, 5, 7], [3, 1, 1, 4]):
        _both(lambda t: rvision.affine_grid(t, shape, align),
              lambda t: F.affine_grid(t, shape, align), [theta], LOOSE)
    with pytest.raises(pt_error()):
        F.affine_grid(torch.zeros(3, 3, 3), [3, 2, 5, 7])


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample_matches_reference(mode, padding, align):
    rng = _rng("gs", mode, padding, align)
    x = rng.randn(2, 3, 6, 7).astype(np.float32)
    # coordinates past [-1, 1] exercise each padding mode; none on a
    # half-pixel tie (nearest rounds half to even in both)
    grid = (rng.rand(2, 5, 4, 2) * 3.4 - 1.7).astype(np.float32)

    def ref_fn(a, g):
        return rvision.grid_sample(a, g, mode, padding, align)

    def port_fn(a, g):
        return F.grid_sample(a, g, mode, padding, align)

    want, vjp = jax.vjp(jax.jit(ref_fn), jnp.asarray(x), jnp.asarray(grid))
    cot = rng.randn(*want.shape).astype(np.float32)
    gx, _ = vjp(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = port_fn(tx, torch.from_numpy(grid))
    _close(got.detach().numpy(), want, LOOSE)
    got.backward(torch.from_numpy(cot))
    _close(tx.grad.numpy(), gx, LOOSE)


def test_grid_sample_refusals():
    x, g = torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 1, 2)
    with pytest.raises(pt_error()):
        F.grid_sample(x, g, mode="bicubic")
    with pytest.raises(pt_error()):
        F.grid_sample(x, g, padding_mode="wrap")

"""The port's custom-op door against the reference's: K4's twin and the
registered op against the Pallas kernel (interpret mode), gradients
through the tape, ``TrainStep``, the registry's contract,
``incubate.autograd`` and ``incubate.operators``.

Inputs are made with numpy and handed to both packages.  Tolerances: K4
is bit-equal to the Pallas kernel wherever the result is normal (a bf16
or f16 product is exact in fp32 and doubling is exact), and within 1 ulp
of the subnormal grid below that (see the test); gradients and the Scaler's TrainStep losses 1e-6 (fp32 elementwise
math); ``incubate.autograd`` 1e-5 relative; the masked softmaxes 1e-6 in
f32 and 2e-2 in bf16 (the reference rounds the exponentials to bf16, the
port's softmax rounds only its result).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.errors import InvalidArgumentError as RefInvalidArgument
from paddle_tpu.incubate import autograd as RA
from paddle_tpu.incubate import get_custom_op as ref_get_custom_op
from paddle_tpu.incubate import register_custom_op as ref_register
from paddle_tpu.jit import TrainStep as RefTrainStep

import paddle_tpu_torch as ptt
from paddle_tpu_torch import InvalidArgumentError, TrainStep
from paddle_tpu_torch.incubate import autograd as A
from paddle_tpu_torch.incubate import (get_custom_op, register_custom_op,
                                       registered_custom_ops)
from paddle_tpu_torch.ops import custom_kernels as ck
from paddle_tpu_torch.optimizer import SGD

# the reference's registry is process-global, and test_incubate.py may
# share this worker: this file's Pallas copy has a name of its own
NAME = "torch_parity_scale_mul2"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _pallas_scale_mul(x, y):
    """A copy of tests/test_incubate.py's Pallas kernel, run in interpret
    mode on the CPU."""
    from jax.experimental import pallas as pl

    def kern(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] * y_ref[...] * 2.0

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x, y)


def _scale_mul_bwd(residuals, cot):
    x, y = residuals
    return 2.0 * cot * y, 2.0 * cot * x


@pytest.fixture(scope="module")
def ops():
    """(reference op, port op), registered once per process."""
    try:
        ref = ref_get_custom_op(NAME)
    except RefInvalidArgument:
        ref = ref_register(NAME, _pallas_scale_mul,
                           backward=_scale_mul_bwd)
    try:
        port = get_custom_op(NAME)
    except InvalidArgumentError:
        port = register_custom_op(NAME, ck.scale_mul,
                                  backward=_scale_mul_bwd)
    return ref, port


def _pair(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _np(t):
    """A port tensor or a reference Tensor/array as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(getattr(t, "value", t)).astype(np.float32)


# -- K4 ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2,), (7,), (3, 5, 129), (2, 64, 256)])
def test_scale_mul_twin_and_op_match_pallas(ops, dtype, shape):
    _, port_op = ops
    x, y = _pair(shape, len(shape))
    want = np.asarray(_pallas_scale_mul(jax.numpy.asarray(x, dtype),
                                        jax.numpy.asarray(y, dtype)))
    tx = torch.from_numpy(x).to(DTYPES[dtype])
    ty = torch.from_numpy(y).to(DTYPES[dtype])
    want = want.astype(np.float32)
    # below twice the smallest normal the reference rounds x * y onto the
    # subnormal grid and then doubles, the port rounds 2 x y once: 1 ulp
    fi = torch.finfo(DTYPES[dtype])
    sub = np.abs(want) < 2 * fi.tiny
    before = ck.launch_counts()
    for got in (ck.scale_mul_plain(tx, ty), ck.scale_mul(tx, ty),
                port_op(tx, ty)):
        assert got.dtype == DTYPES[dtype] and tuple(got.shape) == shape
        np.testing.assert_array_equal(_np(got)[~sub], want[~sub])
        assert np.abs(_np(got) - want)[sub].max(initial=0) \
            <= fi.smallest_normal * fi.eps
    assert ck.launch_counts() == before  # the CPU runs the twin


def test_scale_mul_wrapper_refuses_mismatches():
    x = torch.ones(4)
    for y in (torch.ones(3), torch.ones(4, dtype=torch.float16),
              np.ones(4, np.float32)):
        with pytest.raises(InvalidArgumentError):
            ck.scale_mul(x, y)


def test_gradients_through_the_tape_match_reference(ops):
    ref_op, port_op = ops
    x, y = _pair((3, 5), 1)
    w = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    rx = pt.to_tensor(x, stop_gradient=False)
    ry = pt.to_tensor(y, stop_gradient=False)
    (ref_op(rx, ry) * pt.to_tensor(w)).sum().backward()
    px = ptt.to_tensor(x, place="cpu", stop_gradient=False)
    py = ptt.to_tensor(y, place="cpu", stop_gradient=False)
    out = port_op(px, py)
    assert out.requires_grad
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), _np(rx.grad), rtol=1e-6)
    np.testing.assert_allclose(py.grad.numpy(), _np(ry.grad), rtol=1e-6)


def test_reference_values_through_the_door(ops):
    """tests/test_incubate.py's values, through the port's op."""
    _, op = ops
    x = ptt.to_tensor([1.0, 2.0], place="cpu", stop_gradient=False)
    y = ptt.to_tensor([3.0, 4.0], place="cpu", stop_gradient=False)
    out = op(x, y)
    np.testing.assert_array_equal(_np(out), [6.0, 16.0])
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [6.0, 8.0])
    np.testing.assert_array_equal(y.grad.numpy(), [2.0, 4.0])


def test_create_graph_through_the_op_matches_reference(ops):
    """Double grad through the port's op (its backward is torch ops) against
    the reference's double grad of the same function written with plain
    ops: the reference cannot differentiate its Pallas op twice (JAX has no
    derivative of ``pallas_call`` to linearize the forward again)."""
    _, port_op = ops
    x = np.array([0.5, -1.5, 2.0], np.float32)
    rx = pt.to_tensor(x, stop_gradient=False)
    rg = pt.grad((rx * (rx * rx) * 2.0).sum(), rx, create_graph=True)
    rgg = pt.grad(rg.sum(), rx)
    px = ptt.to_tensor(x, place="cpu", stop_gradient=False)
    pg = ptt.grad(port_op(px, px * px).sum(), px, create_graph=True)
    pgg = ptt.grad(pg.sum(), px)
    np.testing.assert_allclose(_np(pg), _np(rg), rtol=1e-6)  # 6 x^2
    np.testing.assert_allclose(_np(pgg), _np(rgg), rtol=1e-6)  # 12 x


def test_trainstep_over_the_op_matches_reference(ops):
    """The Scaler of tests/test_incubate.py: 3 SGD(0.1) steps."""
    ref_op, port_op = ops
    x = np.array([1.0, 2.0], np.float32)

    class RefScaler(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter(
                [2], default_initializer=pt.nn.initializer.Constant(1.0))

        def forward(self, a):
            return ref_op(a, self.w).sum()

    class Scaler(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(2))

        def forward(self, a):
            return port_op(a, self.w).sum()

    ref_m = RefScaler()
    ref_step = RefTrainStep(ref_m, lambda m, a: m(a),
                            pt.optimizer.SGD(0.1,
                                             parameters=ref_m.parameters()),
                            donate=False)
    want = [float(ref_step(pt.to_tensor(x))) for _ in range(3)]
    m = Scaler()
    step = TrainStep(m, lambda mm, a: mm(a),
                     SGD(0.1, parameters=m.parameters()))
    got = [float(step(x)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[-1] < got[0]


# -- the registry's contract ----------------------------------------------


def test_registry_semantics(ops):
    with pytest.raises(InvalidArgumentError, match="already registered"):
        register_custom_op(NAME, ck.scale_mul)
    with pytest.raises(InvalidArgumentError, match="no custom op"):
        get_custom_op("never_registered")
    with pytest.raises(InvalidArgumentError):
        register_custom_op("", ck.scale_mul)
    assert registered_custom_ops()[NAME] is ops[1]


def test_num_diff_args_gives_zero_gradients_like_reference():
    x, y = _pair((4,), 3)
    bwd = lambda res, cot: (2.0 * cot * res[1],)  # noqa: E731
    ref = ref_register("torch_parity_ndiff", _pallas_scale_mul, backward=bwd,
                       num_diff_args=1)
    port = register_custom_op("torch_parity_ndiff", ck.scale_mul,
                              backward=bwd, num_diff_args=1)
    rx = pt.to_tensor(x, stop_gradient=False)
    ry = pt.to_tensor(y, stop_gradient=False)
    ref(rx, ry).sum().backward()
    px = ptt.to_tensor(x, place="cpu", stop_gradient=False)
    py = ptt.to_tensor(y, place="cpu", stop_gradient=False)
    port(px, py).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), _np(rx.grad), rtol=1e-6)
    np.testing.assert_array_equal(py.grad.numpy(), _np(ry.grad))
    assert not py.grad.any()


def test_wrong_cotangent_count_raises_like_reference():
    bwd = lambda res, cot: (2.0 * cot,)  # noqa: E731 - one for two inputs
    ref = ref_register("torch_parity_badbwd", _pallas_scale_mul, backward=bwd)
    port = register_custom_op("torch_parity_badbwd", ck.scale_mul,
                              backward=bwd)
    x = np.ones(3, np.float32)
    with pytest.raises(RefInvalidArgument, match="cotangents"):
        ref(pt.to_tensor(x, stop_gradient=False), pt.to_tensor(x)) \
            .sum().backward()
    with pytest.raises(InvalidArgumentError, match="cotangents"):
        port(ptt.to_tensor(x, place="cpu", stop_gradient=False),
             torch.from_numpy(x)).sum().backward()


def test_no_backward_output_carries_no_graph():
    ref = ref_register("torch_parity_nobwd", _pallas_scale_mul)
    port = register_custom_op("torch_parity_nobwd", ck.scale_mul)
    x = np.array([1.0, 2.0], np.float32)
    r = ref(pt.to_tensor(x, stop_gradient=False), pt.to_tensor(x))
    p = port(ptt.to_tensor(x, place="cpu", stop_gradient=False),
             torch.from_numpy(x))
    assert r.stop_gradient and not p.requires_grad
    np.testing.assert_array_equal(_np(p), _np(r))
    with pytest.raises(InvalidArgumentError, match="takes tensors"):
        port(x, x)


# -- incubate.autograd ------------------------------------------------------

RTOL = 1e-5


def _both(x):
    return pt.to_tensor(x), torch.from_numpy(np.array(x, np.float32))


def test_grad_and_double_grad_match_reference():
    x = np.array([1.0, 2.0, -3.0], np.float32)
    rx, px = _both(x)

    def f(a):
        return (a * a * a).sum()

    np.testing.assert_allclose(_np(A.grad(f)(px)), _np(RA.grad(f)(rx)),
                               rtol=RTOL)
    gg = A.grad(lambda a: A.grad(f)(a).sum())(px)
    np.testing.assert_allclose(
        _np(gg), _np(RA.grad(lambda a: RA.grad(f)(a).sum())(rx)), rtol=RTOL)
    assert not gg.requires_grad


def test_grad_argnums_and_has_aux_match_reference():
    x, y = _pair((3,), 4)
    (rx, px), (ry, py) = _both(x), _both(y)

    def f(a, b):
        return (a * a * b).sum(), a * 2

    (rga, rgb), raux = RA.grad(f, argnums=(0, 1), has_aux=True)(rx, ry)
    (pga, pgb), paux = A.grad(f, argnums=(0, 1), has_aux=True)(px, py)
    for got, want in ((pga, rga), (pgb, rgb), (paux, raux)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)
    with pytest.raises(InvalidArgumentError, match="scalar"):
        A.grad(lambda a: a * 2)(px)


def test_hvp_jvp_vjp_match_reference():
    x = np.array([1.0, 2.0], np.float32)
    v = np.array([1.0, -1.0], np.float32)
    (rx, px), (rv, pv) = _both(x), _both(v)

    def quartic(a):
        return (a * a * a * a).sum()

    np.testing.assert_allclose(_np(A.hvp(quartic, px, pv)),
                               _np(RA.hvp(quartic, rx, rv)), rtol=RTOL)
    square = lambda a: a * a  # noqa: E731
    for got, want in zip(A.jvp(square, px, pv), RA.jvp(square, rx, rv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)
    for got, want in zip(A.jvp(square, px), RA.jvp(square, rx)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)
    for got, want in zip(A.vjp(lambda a: (a * a).sum(), px),
                         RA.vjp(lambda a: (a * a).sum(), rx)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)
    for got, want in zip(A.vjp(square, px, pv), RA.vjp(square, rx, rv)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL)


def test_jacobian_hessian_match_reference():
    x = np.array([1.0, 2.0, 0.5], np.float32)
    rx, px = _both(x)

    def vec(a):
        return a * a * a

    def cubic(a):
        return (a * a * a).sum()

    jac, rjac = A.Jacobian(vec, px), RA.Jacobian(vec, rx)
    np.testing.assert_allclose(_np(jac.values), _np(rjac.values), rtol=RTOL)
    np.testing.assert_allclose(_np(jac[1, 1]), _np(rjac[1, 1]), rtol=RTOL)
    hes, rhes = A.Hessian(cubic, px), RA.Hessian(cubic, rx)
    np.testing.assert_allclose(_np(hes.values), _np(rhes.values), rtol=RTOL)
    np.testing.assert_allclose(_np(hes[2]), _np(rhes[2]), rtol=RTOL)


def test_incubate_autograd_through_the_custom_op(ops):
    """First order through both packages' ops; second order through the
    port's op against the reference on the same function in plain ops (see
    the create_graph test above)."""
    ref_op, port_op = ops
    x = np.array([0.5, -1.0, 1.5], np.float32)
    rx, px = _both(x)

    def rf(a):
        return ref_op(a, a * a).sum()

    def plain(a):
        return (a * (a * a) * 2.0).sum()

    def pf(a):
        return port_op(a, a * a).sum()

    np.testing.assert_allclose(_np(A.grad(pf)(px)), _np(RA.grad(rf)(rx)),
                               rtol=RTOL)
    np.testing.assert_allclose(
        _np(A.Jacobian(lambda a: port_op(a, a), px).values),
        _np(RA.Jacobian(lambda a: ref_op(a, a), rx).values), rtol=RTOL)
    np.testing.assert_allclose(
        _np(A.grad(lambda a: A.grad(pf)(a).sum())(px)),
        _np(RA.grad(lambda a: RA.grad(plain)(a).sum())(rx)), rtol=RTOL)
    np.testing.assert_allclose(_np(A.Hessian(pf, px).values),
                               _np(RA.Hessian(plain, rx).values), rtol=RTOL)
    np.testing.assert_allclose(_np(A.hvp(pf, px, px)),
                               _np(RA.hvp(plain, rx, rx)), rtol=RTOL)


# -- incubate.operators -----------------------------------------------------

OP_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
          "bfloat16": dict(rtol=0, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk", [(5, 5), (3, 7)], ids=["square",
                                                         "lk>lq"])
def test_softmax_mask_fuse_ops_match_reference(dtype, lq, lk):
    rng = np.random.RandomState(lq * lk)
    x = rng.randn(2, 3, lq, lk).astype(np.float32)
    m = rng.randn(2, 3, lq, lk).astype(np.float32)
    rx, px = pt.to_tensor(x).astype(dtype), torch.from_numpy(x).to(
        DTYPES[dtype])
    want = pt.incubate.softmax_mask_fuse_upper_triangle(rx)
    got = ptt.incubate.softmax_mask_fuse_upper_triangle(px)
    assert got.dtype == DTYPES[dtype]
    np.testing.assert_allclose(_np(got), _np(want), **OP_TOL[dtype])
    assert not _np(got)[..., 0, lk - lq + 1:].any()  # masked keys: 0
    want = pt.incubate.softmax_mask_fuse(rx, pt.to_tensor(m))
    got = ptt.incubate.softmax_mask_fuse(px, torch.from_numpy(m))
    assert got.dtype == DTYPES[dtype]
    np.testing.assert_allclose(_np(got), _np(want), **OP_TOL[dtype])


def test_softmax_mask_fuse_upper_triangle_refuses_like_reference():
    x = np.zeros((1, 1, 6, 4), np.float32)
    with pytest.raises(RefInvalidArgument, match="Lk >= Lq"):
        pt.incubate.softmax_mask_fuse_upper_triangle(pt.to_tensor(x))
    with pytest.raises(InvalidArgumentError, match="Lk >= Lq"):
        ptt.incubate.softmax_mask_fuse_upper_triangle(torch.from_numpy(x))
    with pytest.raises(InvalidArgumentError, match="rank 3"):
        ptt.incubate.softmax_mask_fuse_upper_triangle(torch.zeros(1, 4, 4))


# -- to_tensor ----------------------------------------------------------------


def test_to_tensor_follows_reference_dtype_and_stop_gradient():
    for data in (1.5, [1.0, 2.0], np.arange(3.0)):
        want = pt.to_tensor(data)
        got = ptt.to_tensor(data, place="cpu")
        assert str(got.dtype) == "torch." + str(want.dtype)  # float32
        np.testing.assert_array_equal(got.numpy(), _np(want))
        assert not got.requires_grad and want.stop_gradient
    got = ptt.to_tensor([1.0], place="cpu", stop_gradient=False)
    assert got.requires_grad and got.is_leaf
    assert ptt.to_tensor(np.arange(3.0), dtype="float64",
                         place="cpu").dtype == torch.float64
    src = torch.ones(2)
    copy = ptt.to_tensor(src, place="cpu")
    copy[0] = 5.0
    assert src[0] == 1.0  # a copy, as paddle.to_tensor makes
    with pytest.raises(InvalidArgumentError):
        ptt.to_tensor([1, 2], place="cpu", stop_gradient=False)

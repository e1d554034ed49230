"""The port's ``tensor`` surface against the reference on the CPU: the
cases of ``tests/test_tensor_ops.py`` (each op on the same numpy inputs
through both packages, and against numpy as that file holds it), a sweep
calling every ported op once in each package on the same inputs, each
op's autocast colour by the amp lists' names, the ``name=`` keyword, the
in-place variants, and ``tensor.random`` by its invariants and its
determinism under ``seed()`` (the two packages' generators differ, so
draws are not compared across them).

Values are compared, not dtypes: the reference's int64 is int32 while
JAX runs without x64.  Tolerance: 1e-5 relative and 1e-6 absolute on
floats (fp32 formulas in another order; decompositions by other LAPACK
drivers at 1e-4, ``DECOMP``); integers and booleans exact.  Where a
decomposition's factors are defined up to sign, the sign-free parts are
compared (singular values, |R|, eigenvalues).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp

RTOL, ATOL = 1e-5, 1e-6
DECOMP = 1e-4
f32 = np.float32


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(getattr(x, "value", x))


def _to_ref(v):
    if isinstance(v, np.ndarray):
        return pt.to_tensor(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_to_ref(x) for x in v)
    return v


def _to_port(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    if isinstance(v, (list, tuple)):
        return type(v)(_to_port(x) for x in v)
    return v


def _same(got, want, tol=RTOL, path="out"):
    """Values equal (floats within ``tol``), recursively over tuples."""
    if isinstance(want, (tuple, list)) and not isinstance(
            got, torch.Tensor):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, tol, "%s[%d]" % (path, i))
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating) or np.issubdtype(
            g.dtype, np.floating):
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=tol,
                                   atol=tol * 0.1, err_msg=path)
    else:
        np.testing.assert_array_equal(g, w, err_msg=path)


# ops with no tensor input: the port takes the device as place=
PLACED = {"zeros", "ones", "full", "empty", "arange", "linspace", "eye"}


def _both(name, *args, **kw):
    """``name`` through both packages on the same inputs: (port, ref),
    held equal."""
    pkw = dict(kw, place="cpu") if name in PLACED else kw
    got = getattr(ptt, name)(*_to_port(args), **pkw)
    want = getattr(pt, name)(*_to_ref(args), **kw)
    _same(got, want)
    return got, want


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# -- tests/test_tensor_ops.py ------------------------------------------------


class TestCreation:
    def test_to_tensor(self):
        x = ptt.to_tensor([[1.0, 2.0], [3.0, 4.0]], place="cpu")
        assert x.dtype == torch.float32  # python floats -> float32
        _same(x, pt.to_tensor([[1.0, 2.0], [3.0, 4.0]]))
        assert ptt.to_tensor([1, 2], place="cpu").dtype in (torch.int32,
                                                            torch.int64)

    def test_full_like_arange(self):
        got, _ = _both("full", [2, 3], 7)
        np.testing.assert_allclose(_np(got), np.full((2, 3), 7.0))
        got, _ = _both("arange", 1, 10, 2)
        np.testing.assert_allclose(_np(got), np.arange(1, 10, 2))
        got, _ = _both("linspace", 0, 1, 5)
        np.testing.assert_allclose(_np(got), np.linspace(0, 1, 5),
                                   rtol=1e-6)

    def test_eye_diag_tri(self):
        _both("eye", 3, 4)
        got, _ = _both("diag", np.array([1.0, 2.0], f32))
        np.testing.assert_allclose(_np(got), np.diag([1.0, 2.0]))
        x = np.arange(9.0, dtype=f32).reshape(3, 3)
        _both("tril", x)
        got, _ = _both("triu", x, 1)
        np.testing.assert_allclose(_np(got), np.triu(x, 1))

    def test_numel(self):
        assert ptt.numel(ptt.ones([3, 4], place="cpu")) == 12 \
            == pt.numel(pt.ones([3, 4]))


class TestMath:
    def test_binary(self, rng):
        a, b = rng.randn(3, 4).astype(f32), rng.rand(3, 4).astype(f32) + 1
        for name, want in (("add", a + b), ("subtract", a - b),
                           ("multiply", a * b), ("divide", a / b),
                           ("maximum", np.maximum(a, b))):
            got, _ = _both(name, a, b)
            np.testing.assert_allclose(_np(got), want, rtol=1e-6)

    def test_reductions(self, rng):
        x = rng.randn(4, 5).astype(f32)
        np.testing.assert_allclose(_np(_both("sum", x, axis=1)[0]),
                                   x.sum(1), rtol=1e-5)
        np.testing.assert_allclose(
            _np(_both("mean", x, axis=0, keepdim=True)[0]),
            x.mean(0, keepdims=True), rtol=1e-5)
        np.testing.assert_allclose(_np(_both("max", x)[0]), x.max())
        np.testing.assert_allclose(_np(_both("std", x)[0]), x.std(ddof=1),
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(_both("logsumexp", x, axis=1)[0]),
                                   np.log(np.exp(x).sum(1)), rtol=1e-5)

    def test_scale_addn_clip(self, rng):
        x = rng.randn(3, 3).astype(f32)
        np.testing.assert_allclose(_np(_both("scale", x, 2.0, 1.0)[0]),
                                   x * 2 + 1, rtol=1e-6)
        np.testing.assert_allclose(
            _np(_both("scale", x, 2.0, 1.0, bias_after_scale=False)[0]),
            (x + 1) * 2, rtol=1e-6)
        np.testing.assert_allclose(_np(_both("add_n", [x, x, x])[0]),
                                   3 * x, rtol=1e-6)
        np.testing.assert_allclose(_np(_both("clip", x, -0.5, 0.5)[0]),
                                   np.clip(x, -0.5, 0.5))

    def test_cumsum(self, rng):
        x = rng.randn(3, 4).astype(f32)
        np.testing.assert_allclose(_np(_both("cumsum", x, axis=1)[0]),
                                   np.cumsum(x, 1), rtol=1e-5)
        np.testing.assert_allclose(_np(_both("cumsum", x)[0]), np.cumsum(x),
                                   rtol=1e-5)


class TestManipulation:
    def test_reshape_flatten_squeeze(self, rng):
        x = rng.randn(2, 3, 4).astype(f32)
        assert list(_both("reshape", x, [4, 6])[0].shape) == [4, 6]
        assert list(_both("flatten", x, 1, 2)[0].shape) == [2, 12]
        assert list(_both("unsqueeze", x, [0, 2])[0].shape) == [1, 2, 1, 3, 4]
        assert list(_both("squeeze", np.ones((1, 3, 1), f32),
                          axis=0)[0].shape) == [3, 1]

    def test_concat_split_stack(self, rng):
        x = rng.randn(4, 6).astype(f32)
        parts, _ = _both("split", x, [2, -1], axis=1)
        assert [list(p.shape) for p in parts] == [[4, 2], [4, 4]]
        np.testing.assert_allclose(_np(ptt.concat(parts, axis=1)), x)
        s, _ = _both("stack", [x, x], axis=0)
        assert list(s.shape) == [2, 4, 6]
        us, _ = _both("unstack", np.stack([x, x]), axis=0)
        np.testing.assert_allclose(_np(us[1]), x)

    def test_gather_scatter(self):
        x = np.arange(12.0, dtype=f32).reshape(4, 3)
        idx = np.array([0, 2])
        got, _ = _both("gather", x, idx)
        np.testing.assert_allclose(_np(got), [[0, 1, 2], [6, 7, 8]])
        out, _ = _both("scatter", x, idx, np.ones((2, 3), f32))
        np.testing.assert_allclose(_np(out)[[0, 2]], np.ones((2, 3)))

    def test_gather_nd(self):
        x = np.arange(24.0, dtype=f32).reshape(2, 3, 4)
        out, _ = _both("gather_nd", x, np.array([[0, 1], [1, 2]]))
        np.testing.assert_allclose(_np(out), [x[0, 1], x[1, 2]])

    def test_tile_expand_transpose(self, rng):
        x = rng.randn(2, 3).astype(f32)
        assert list(_both("tile", x, [2, 2])[0].shape) == [4, 6]
        assert list(_both("expand", np.ones((1, 3), f32),
                          [5, 3])[0].shape) == [5, 3]
        np.testing.assert_allclose(_np(_both("transpose", x, [1, 0])[0]),
                                   x.T)

    def test_take_put_along_axis(self, rng):
        x = rng.randn(3, 4).astype(f32)
        idx = np.array([[0], [1], [2]])
        got, _ = _both("take_along_axis", x, idx, 1)
        np.testing.assert_allclose(_np(got), np.take_along_axis(x, idx, 1))
        out, _ = _both("put_along_axis", x, idx, 9.0, 1)
        assert _np(out)[1, 1] == 9.0


class TestLinalg:
    def test_matmul(self, rng):
        a = rng.randn(2, 3, 4).astype(f32)
        b = rng.randn(2, 4, 5).astype(f32)
        np.testing.assert_allclose(_np(_both("matmul", a, b)[0]), a @ b,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            _np(_both("matmul", a, b.swapaxes(-1, -2).copy(),
                      transpose_y=True)[0]), a @ b, rtol=1e-5)

    def test_norm_dot(self, rng):
        x = rng.randn(3, 4).astype(f32)
        np.testing.assert_allclose(_np(_both("norm", x)[0]),
                                   np.linalg.norm(x), rtol=1e-5)
        v = rng.randn(4).astype(f32)
        np.testing.assert_allclose(_np(_both("dot", v, v)[0]), v @ v,
                                   rtol=1e-5)

    def test_einsum(self, rng):
        a = rng.randn(3, 4).astype(f32)
        b = rng.randn(4, 5).astype(f32)
        np.testing.assert_allclose(
            _np(_both("einsum", "ij,jk->ik", a, b)[0]), a @ b, rtol=1e-5)


class TestSearchLogic:
    def test_argmax_topk_sort(self, rng):
        x = rng.randn(3, 5).astype(f32)
        np.testing.assert_array_equal(_np(_both("argmax", x, axis=1)[0]),
                                      x.argmax(1))
        (vals, _), _ = _both("topk", x, 2, axis=1)
        np.testing.assert_allclose(_np(vals), np.sort(x, 1)[:, ::-1][:, :2],
                                   rtol=1e-6)
        np.testing.assert_allclose(
            _np(_both("sort", x, descending=True)[0]),
            np.sort(x, -1)[:, ::-1])

    def test_where_masked(self, rng):
        x = rng.randn(3, 4).astype(f32)
        got, _ = _both("where", x > 0, x, np.zeros_like(x))
        np.testing.assert_allclose(_np(got), np.where(x > 0, x, 0))
        got, _ = _both("masked_select", x, x > 0)
        np.testing.assert_allclose(_np(got), x[x > 0])

    def test_logic(self):
        a = np.array([1.0, 2.0, np.nan], f32)
        assert _np(_both("isnan", a)[0]).tolist() == [False, False, True]
        assert bool(ptt.allclose(ptt.ones([2], place="cpu"),
                                 ptt.ones([2], place="cpu")))

    def test_searchsorted(self):
        got, _ = _both("searchsorted", np.array([1.0, 3.0, 5.0, 7.0], f32),
                       np.array([4.0], f32))
        np.testing.assert_array_equal(_np(got), [2])


class TestRandomOps:
    def test_shapes_ranges(self):
        ptt.seed(0)
        u = ptt.tensor.uniform([100], min=2.0, max=3.0, place="cpu")
        assert list(u.shape) == [100]
        assert float(u.min()) >= 2.0 and float(u.max()) <= 3.0
        r = ptt.tensor.randint(0, 5, [50], place="cpu")
        assert int(r.max()) < 5 and int(r.min()) >= 0
        p = ptt.tensor.randperm(10, place="cpu")
        assert sorted(p.tolist()) == list(range(10))

    def test_multinomial_no_replacement(self):
        ptt.seed(0)
        probs = torch.tensor([0.1, 0.2, 0.3, 0.4])
        s = ptt.tensor.multinomial(probs, 4, replacement=False)
        assert sorted(s.tolist()) == [0, 1, 2, 3]


def test_bitwise_dunders_math_op_patch_parity():
    """``&``, ``|``, ``^`` and ``~`` on the port's tensors (torch's own
    operators) agree with the reference's and with the ``bitwise_*``
    ops."""
    a = torch.tensor([True, False])
    b = torch.tensor([True, True])
    assert (a & b).tolist() == [True, False]
    assert (a | b).tolist() == [True, True]
    assert (a ^ b).tolist() == [False, True]
    assert (~a).tolist() == [False, True]
    x = torch.tensor([6, 3])
    assert (x & 2).tolist() == [2, 2] and (2 | x).tolist() == [6, 3]
    for name, want in (("bitwise_and", a & b), ("bitwise_or", a | b),
                       ("bitwise_xor", a ^ b)):
        got, _ = _both(name, a.numpy(), b.numpy())
        assert torch.equal(got, want)
    assert torch.equal(_both("bitwise_not", a.numpy())[0], ~a)


# -- every op, once in each package ------------------------------------------


def _inputs():
    r = np.random.RandomState(1)
    m = (r.randn(4, 4) + 4 * np.eye(4)).astype(f32)
    return dict(
        a=r.randn(3, 4).astype(f32), b=(r.rand(3, 4) + 1).astype(f32),
        p=(r.rand(3, 4) * 0.8 + 0.1).astype(f32),
        i=r.randint(1, 12, (3, 4)), j=r.randint(1, 12, (3, 4)),
        v=r.randn(4).astype(f32), m=m,
        spd=(m @ m.T + np.eye(4)).astype(f32),
        low=np.tril(m), k=r.randint(0, 3, (3, 6)),
        v3=r.randn(5, 3).astype(f32), w3=r.randn(5, 3).astype(f32),
        c=r.randn(2, 3, 4).astype(f32))


X = _inputs()
A, B, P, M = X["a"], X["b"], X["p"], X["m"]

# (op name, args, kwargs); several cases of one op get a suffix "#n"
SWEEP = [
    # math: elementwise binary
    ("add", (A, B), {}), ("subtract", (A, B), {}),
    ("multiply", (A, B), {}), ("divide", (A, B), {}),
    ("floor_divide", (X["i"], X["j"]), {}), ("mod", (A, B), {}),
    ("remainder", (X["i"], X["j"]), {}), ("floor_mod", (A, B), {}),
    ("pow", (B, A), {}), ("maximum", (A, B), {}), ("minimum", (A, B), {}),
    ("fmax", (A, B), {}), ("fmin", (A, B), {}),
    ("kron", (M[:2, :2], M[2:, 2:]), {}), ("outer", (X["v"], X["v"]), {}),
    ("lerp", (A, B, P), {}), ("atan2", (A, B), {}),
    ("heaviside", (A, B), {}), ("gcd", (X["i"], X["j"]), {}),
    ("lcm", (X["i"], X["j"]), {}),
    # math: elementwise unary
    *[(n, (A,), {}) for n in (
        "abs", "exp", "expm1", "sin", "cos", "tan", "sinh", "cosh", "tanh",
        "stanh", "atan", "asinh", "erf", "sigmoid", "ceil", "floor", "round",
        "trunc", "sign", "frac", "square", "neg", "deg2rad", "rad2deg",
        "nan_to_num", "conj")],
    *[(n, (B,), {}) for n in (
        "log", "log1p", "log2", "log10", "sqrt", "rsqrt", "reciprocal",
        "lgamma", "digamma", "acosh")],
    *[(n, (P,), {}) for n in ("asin", "acos", "atanh", "erfinv", "logit")],
    ("logit#eps", (P,), {"eps": 0.2}),
    ("clip", (A, -0.5, 0.5), {}), ("scale", (A, 2.0, 1.0), {}),
    ("increment", (A, 2.0), {}), ("diff", (A,), {"axis": 1}),
    ("diff#n2", (A,), {"n": 2, "axis": 0}),
    # math: reductions
    ("sum", (A,), {"axis": 1}), ("sum#all", (A,), {}),
    ("sum#keep", (A,), {"axis": [0, 1], "keepdim": True}),
    ("nansum", (A,), {"axis": 0}), ("mean", (A,), {"axis": 1}),
    ("nanmean", (A,), {}), ("prod", (B,), {"axis": 1}),
    ("prod#all", (B,), {}), ("max", (A,), {"axis": 1}),
    ("min", (A,), {"axis": 0, "keepdim": True}), ("amax", (A,), {}),
    ("amin", (A,), {"axis": [0, 1]}), ("all", (A > 0,), {"axis": 1}),
    ("any", (A > 1,), {}), ("logsumexp", (A,), {"axis": 1}),
    ("std", (A,), {"axis": 0}), ("var", (A,), {"unbiased": False}),
    ("cumsum", (A,), {"axis": 1}), ("cumprod", (B,), {"dim": 1}),
    ("add_n", ([A, B, A],), {}), ("trace", (M,), {}),
    ("diagonal", (M,), {"offset": 1}), ("mm", (A, A.T.copy()), {}),
    ("addmm", (M[:3, :3], A, A.T.copy()), {"beta": 0.5, "alpha": 2.0}),
    ("inverse", (M,), {}), ("multiplex", ([A, B], np.array([1, 0, 1])), {}),
    # manipulation
    ("cast", (A, "int32"), {}), ("reshape", (A, [2, 6]), {}),
    ("flatten", (X["c"],), {"start_axis": 1}),
    ("squeeze", (A[None],), {}), ("unsqueeze", (A, 1), {}),
    ("concat", ([A, B],), {"axis": 1}), ("stack", ([A, B],), {"axis": 2}),
    ("unstack", (A,), {"axis": 1}), ("unbind", (A,), {}),
    ("split", (A, 2), {"axis": 1}), ("chunk", (X["c"], 3), {"axis": 2}),
    ("tile", (A, [1, 2]), {}), ("expand", (A[:1], [3, -1]), {}),
    ("expand_as", (A[:1], B), {}), ("broadcast_to", (X["v"], [3, 4]), {}),
    ("transpose", (X["c"], [2, 0, 1]), {}), ("flip", (A, [0, 1]), {}),
    ("roll", (A, 2), {"axis": 1}), ("roll#flat", (A, 5), {}),
    ("gather", (A, np.array([2, 0])), {"axis": 0}),
    ("gather#2d", (A, np.array([[1, 3], [0, 0]])), {"axis": 1}),
    ("gather_nd", (X["c"], np.array([[1, 2], [0, 0]])), {}),
    ("take_along_axis", (A, X["k"][:, :2]), {"axis": 1}),
    ("put_along_axis", (A, X["k"][:, :2], 5.0, 1), {"reduce": "add"}),
    ("put_along_axis#mul", (B, X["k"][:, :1], 3.0, 1), {"reduce": "mul"}),
    ("scatter", (A, np.array([2, 0]), B[:2]), {}),
    ("scatter#add", (A, np.array([1, 1]), B[:2]), {"overwrite": False}),
    ("scatter_nd_add", (A, np.array([[0, 1], [2, 3], [0, 1]]),
                        np.array([1.0, 2.0, 3.0], f32)), {}),
    ("scatter_nd", (np.array([[1], [2], [1]]), B[:3], [4, 4]), {}),
    ("index_select", (A, np.array([3, 1])), {"axis": 1}),
    ("slice", (X["c"], [1, 2], [1, 0], [3, -1]), {}),
    ("strided_slice", (X["c"], [1, 2], [2, 3], [-4, 0], [-1, -2]), {}),
    ("unique", (X["k"],), {"return_counts": True}),
    ("unique#all", (X["k"],), {"return_index": True,
                              "return_inverse": True,
                              "return_counts": True}),
    ("unique#axis", (X["k"],), {"return_index": True,
                               "return_inverse": True, "axis": 1}),
    ("reverse", (A, 1), {}),
    ("broadcast_tensors", ([A[:1], B],), {}),
    ("broadcast_shape", ([3, 1], [1, 4]), {}),
    ("crop", (X["c"],), {"shape": [1, -1, 2], "offsets": [1, 1, 2]}),
    ("shard_index", (X["i"], 12, 3, 1), {}),
    # linalg
    ("bmm", (X["c"], X["c"].transpose(0, 2, 1).copy()), {}),
    ("mv", (A, X["v"]), {}), ("t", (A,), {}),
    ("norm#p1", (A,), {"p": 1, "axis": 1}),
    ("norm#inf", (A,), {"p": float("inf"), "axis": 0}),
    ("norm#p0", (A,), {"p": 0}), ("norm#p3", (A,), {"p": 3, "axis": 1}),
    ("dist", (A, B), {}), ("cross", (X["v3"], X["w3"]), {"axis": 1}),
    ("cholesky", (X["spd"],), {}),
    ("cholesky#upper", (X["spd"],), {"upper": True}),
    ("matrix_power", (M, 3), {}), ("inv", (M,), {}),
    ("pinv", (A,), {}), ("solve", (M, A.T.copy()), {}),
    ("triangular_solve", (X["low"], A.T.copy()), {"upper": False}),
    ("triangular_solve#t", (X["low"], A.T.copy()),
     {"upper": False, "transpose": True}),
    ("det", (M,), {}), ("slogdet", (M,), {}), ("eigvalsh", (X["spd"],), {}),
    ("matrix_rank", (A,), {}), ("cond", (M,), {}),
    ("multi_dot", ([A, A.T.copy(), A],), {}), ("lu", (M,), {}),
    ("histogram", (A,), {"bins": 5}),
    ("histogram#range", (A,), {"bins": 4, "min": -1.0, "max": 1.0}),
    # logic
    *[(n, (A, B), {}) for n in (
        "equal", "not_equal", "greater_than", "greater_equal", "less_than",
        "less_equal", "isclose", "allclose")],
    ("equal_all", (A, A), {}), ("equal_all#ne", (A, B), {}),
    *[(n, (A > 0, B > 1.5), {}) for n in (
        "logical_and", "logical_or", "logical_xor")],
    ("logical_not", (A > 0,), {}), ("isinf", (A,), {}),
    ("isfinite", (A,), {}), ("is_empty", (A,), {}),
    # search
    ("argmin", (A,), {"axis": 0}), ("argmax#all", (A,), {}),
    ("argsort", (A,), {"axis": 1}),
    ("argsort#desc", (A,), {"axis": 0, "descending": True}),
    ("sort", (A,), {"axis": 0}),
    ("topk", (A, 2), {"axis": 0, "largest": False}),
    ("kthvalue", (A, 2), {"axis": 1}),
    ("kthvalue#keep", (A, 3), {"axis": 0, "keepdim": True}),
    ("mode", (X["k"],), {"axis": 1}), ("nonzero", (A > 0,), {}),
    ("nonzero#tuple", (A > 0,), {"as_tuple": True}),
    ("where#one", (A > 0,), {}),
    ("index_sample", (A, X["k"][:, :3]), {}),
    # stat
    ("median", (A,), {}), ("median#axis", (A,), {"axis": 1}),
    ("nanmedian", (A,), {"axis": 0, "keepdim": True}),
    ("quantile", (A, 0.3), {"axis": 0}),
    ("quantile#list", (A, [0.2, 0.9]), {"axis": 1, "keepdim": True}),
    # attribute
    *[(n, (A,), {}) for n in ("shape", "rank", "is_floating_point",
                              "is_integer", "is_complex", "is_tensor",
                              "real", "imag")],
    # creation
    ("zeros", ([2, 3],), {}), ("ones", ([3],), {"dtype": "int32"}),
    ("empty", ([2],), {}), ("arange", (5,), {}),
    ("arange#float", (0.0, 1.0, 0.25), {}), ("eye", (3,), {}),
    ("zeros_like", (A,), {}), ("ones_like", (A,), {"dtype": "int32"}),
    ("full_like", (A, 2.5), {}), ("empty_like", (A,), {}),
    ("meshgrid", (X["v"], X["v"][:2]), {}),
    ("diag#pad", (X["v"],), {"offset": -1, "padding_value": 7.0}),
    ("diag#2d", (M,), {"offset": 1}), ("diagflat", (X["v"],), {"offset": 1}),
    ("assign", (A,), {}), ("clone", (A,), {}),
]

SIGN_FREE = {"svd": lambda o: o[1], "qr": lambda o: abs(_np(o[1])),
             "eigh": lambda o: o[0]}
SWEEP += [("svd", (A,), {}), ("qr", (A.T.copy(),), {}),
          ("eigh", (X["spd"],), {})]


@pytest.mark.parametrize("case", SWEEP, ids=[c[0] for c in SWEEP])
def test_op_matches_reference(case):
    label, args, kw = case
    name = label.split("#")[0]
    pkw = dict(kw, place="cpu") if name in PLACED else kw
    got = getattr(ptt, name)(*_to_port(args), **pkw)
    want = getattr(pt, name)(*_to_ref(args), **kw)
    tol = DECOMP if name in ("pinv", "cond", "inv", "inverse", "solve",
                             "lu", "matrix_power", "triangular_solve",
                             "eigh", "eigvalsh", "svd", "qr") else RTOL
    if name in SIGN_FREE:
        got, want = SIGN_FREE[name](got), SIGN_FREE[name](want)
    if isinstance(want, (bool, int)):
        assert bool(got) == want
        return
    _same(got, want, tol)


def test_sweep_covers_the_ported_surface():
    """Every op of the ported modules is in the sweep or in a test above
    (the random ops by their invariants)."""
    swept = {c[0].split("#")[0] for c in SWEEP} | {
        "to_tensor", "full", "linspace", "numel", "argmax", "where",
        "masked_select", "searchsorted", "einsum", "matmul", "dot", "norm",
        "transpose", "diag", "tril", "triu", "bitwise_and", "bitwise_or",
        "bitwise_xor", "bitwise_not", "isnan", "eig", "eigvals", "lstsq"}
    from paddle_tpu_torch.tensor import random as port_random

    ops = set(ptt.tensor.__all__) - set(port_random.__all__)
    ops = {n for n in ops if not n.endswith("_")}
    assert ops - swept == set()


def test_nonsymmetric_eig_and_lstsq(rng):
    """The non-symmetric eigenvalues (sorted, a conjugate-pair order aside)
    and the least-squares solution agree with the reference's."""
    m = (rng.randn(4, 4) + 4 * np.eye(4)).astype(f32)
    got = np.sort_complex(_np(ptt.eigvals(torch.from_numpy(m))))
    want = np.sort_complex(_np(pt.eigvals(pt.to_tensor(m))))
    np.testing.assert_allclose(got, want, rtol=DECOMP, atol=DECOMP)
    w, _ = ptt.eig(torch.from_numpy(m))
    np.testing.assert_allclose(np.sort_complex(_np(w)), want, rtol=DECOMP,
                               atol=DECOMP)
    a, y = rng.randn(6, 3).astype(f32), rng.randn(6, 2).astype(f32)
    got = ptt.lstsq(torch.from_numpy(a), torch.from_numpy(y))[0]
    want = pt.lstsq(pt.to_tensor(a), pt.to_tensor(y))[0]
    _same(got, want, DECOMP)


# -- the installs ------------------------------------------------------------

WHITE = sorted(n for n in amp.WHITE_LIST if n in ptt.tensor.__all__)
BLACK = sorted(n for n in amp.BLACK_LIST if n in ptt.tensor.__all__)


def _colour_args(name, dtype):
    r = np.random.RandomState(2)
    x = torch.from_numpy((r.rand(3, 3) + 0.5).astype(f32)).to(dtype)
    if name == "einsum":
        return ("ij,jk->ik", x, x)
    if name == "mv":
        return (x, x[0])
    if name == "addmm":
        return (x, x, x)
    if name == "bmm":
        return (x[None], x[None])
    if name in ("matmul", "mm", "pow"):
        return (x, x)
    return (x,)


@pytest.mark.parametrize("name", WHITE + BLACK)
def test_autocast_colour_by_name(name):
    """Under ``auto_cast(level="O1", dtype="bfloat16")`` a white op turns
    float32 inputs bf16 and a black op turns bf16 inputs float32."""
    white = name in WHITE
    args = _colour_args(name, torch.float32 if white else torch.bfloat16)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out = getattr(ptt, name)(*args)
    assert out.dtype == (torch.bfloat16 if white else torch.float32), name
    assert set(WHITE) == {"addmm", "bmm", "einsum", "matmul", "mm", "mv"}


def test_name_keyword_is_accepted_and_ignored():
    a = torch.ones(2)
    assert torch.equal(ptt.add(a, a, name="x"), a + a)
    assert torch.equal(ptt.tensor.sum(a, name="s"), torch.tensor(2.0))
    assert list(ptt.zeros([2], place="cpu", name="z").shape) == [2]


def test_inplace_variants_write_their_first_argument():
    x = torch.tensor([[1.0, 4.0], [9.0, 16.0]])
    assert ptt.sqrt_(x) is x
    assert x.tolist() == [[1.0, 2.0], [3.0, 4.0]]
    ptt.add_(x, torch.ones(2, 2))
    ptt.scale_(x, 2.0, 1.0)
    assert x.tolist() == [[5.0, 7.0], [9.0, 11.0]]
    assert ptt.reshape_(x, [4]) is x and list(x.shape) == [4]
    ptt.unsqueeze_(x, 0)
    assert list(x.shape) == [1, 4]
    ptt.squeeze_(x)
    ptt.clip_(x, 6.0, 10.0)
    assert x.tolist() == [6.0, 7.0, 9.0, 10.0]
    y = torch.zeros(3, 2)
    ptt.scatter_(y, torch.tensor([1]), torch.ones(1, 2))
    assert y[1].tolist() == [1.0, 1.0] and not y[0].any()
    names = {n for n in ptt.tensor.__all__ if n.endswith("_")}
    assert names == {"add_", "subtract_", "ceil_", "clip_", "exp_",
                     "flatten_", "floor_", "reciprocal_", "reshape_",
                     "round_", "rsqrt_", "scale_", "scatter_", "sqrt_",
                     "squeeze_", "tanh_", "unsqueeze_"}


def test_random_ops_reproduce_under_seed():
    draws = {}
    for run in range(2):
        ptt.seed(5)
        draws[run] = [
            ptt.rand([4], place="cpu"), ptt.randn([4], place="cpu"),
            ptt.standard_normal([2], place="cpu"),
            ptt.uniform([3], min=-2.0, max=0.0, place="cpu"),
            ptt.normal(1.0, 2.0, [3], place="cpu"),
            ptt.normal(torch.zeros(2), torch.ones(2)),
            ptt.randint(3, 9, [6], place="cpu"),
            ptt.randperm(7, place="cpu"),
            ptt.bernoulli(torch.full((8,), 0.5)),
            ptt.multinomial(torch.tensor([0.2, 0.8]), 3, replacement=True),
            ptt.poisson(torch.full((4,), 3.0))]
    for a, b in zip(draws[0], draws[1]):
        assert torch.equal(a, b)
    u, n, b = draws[0][3], draws[0][5], draws[0][8]
    assert float(u.min()) >= -2.0 and float(u.max()) <= 0.0
    assert list(n.shape) == [2]
    assert set(b.tolist()) <= {0.0, 1.0}
    r = draws[0][6]
    assert int(r.min()) >= 3 and int(r.max()) < 9
    # uniform(seed=n) draws from its own generator, whatever the global
    ptt.seed(1)
    s1 = ptt.uniform([4], seed=9, place="cpu")
    ptt.seed(2)
    assert torch.equal(s1, ptt.uniform([4], seed=9, place="cpu"))

"""The port's grad engine and ``PyLayer`` against the reference's: the
engine and PyLayer cases of ``tests/test_autograd.py``, each run on both
packages through a small adapter, with the values compared.

Paddle's ``stop_gradient`` is torch's ``not requires_grad`` and the port's
tensors are ``torch.Tensor``s, so each case is written once against the
adapter.  Values are fp32 elementwise math on both sides: 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.errors import InvalidArgumentError as RefInvalidArgument
from paddle_tpu.framework import engine as ref_engine

import paddle_tpu_torch as ptt
from paddle_tpu_torch import InvalidArgumentError
from paddle_tpu_torch import autograd as port_autograd


class Ref:
    pkg = pt
    grad = staticmethod(pt.grad)
    backward = staticmethod(ref_engine.backward)
    tanh = staticmethod(pt.tanh)
    PyLayer = pt.autograd.PyLayer
    Invalid = RefInvalidArgument

    @staticmethod
    def t(data, stop_gradient=True):
        return pt.to_tensor(np.asarray(data, np.float32),
                            stop_gradient=stop_gradient)

    @staticmethod
    def np(t):
        return None if t is None else np.asarray(t.value)

    @staticmethod
    def stop_gradient(t):
        return t.stop_gradient

    @staticmethod
    def clear_grad(t):
        t.clear_grad()


class Port:
    pkg = ptt
    grad = staticmethod(ptt.grad)
    backward = staticmethod(port_autograd.backward)
    tanh = staticmethod(torch.tanh)
    PyLayer = port_autograd.PyLayer
    Invalid = InvalidArgumentError

    @staticmethod
    def t(data, stop_gradient=True):
        return ptt.to_tensor(np.asarray(data, np.float32), place="cpu",
                             stop_gradient=stop_gradient)

    @staticmethod
    def np(t):
        return None if t is None else t.detach().numpy()

    @staticmethod
    def stop_gradient(t):
        return not t.requires_grad

    @staticmethod
    def clear_grad(t):
        t.grad = None


def _raises(fn, exc, match=None):
    """Whether ``fn()`` raises ``exc`` (with ``match`` in its message)."""
    with pytest.raises(exc, match=match):
        fn()
    return True


def case_scalar_chain(B):
    x = B.t([2.0, 3.0], stop_gradient=False)
    (x * x).sum().backward()
    return B.np(x.grad)


def case_grad_accumulation_two_backwards(B):
    x = B.t([2.0], stop_gradient=False)
    (x * x).sum().backward()
    (x * 3).sum().backward()
    g = B.np(x.grad)
    B.clear_grad(x)
    return g, x.grad is None


def case_diamond_graph(B):
    x = B.t([1.0, 2.0], stop_gradient=False)
    ((x * 2 + x * 3) * 1.0).sum().backward()
    return B.np(x.grad)


def case_multi_use_accumulation(B):
    x = B.t([2.0], stop_gradient=False)
    y = x * x
    (y + y).sum().backward()
    return B.np(x.grad)


def case_stop_gradient_blocks(B):
    x = B.t([2.0], stop_gradient=False)
    y = B.t([3.0])
    (x * y).sum().backward()
    return B.np(x.grad), y.grad is None


def case_detach_blocks(B):
    x = B.t([2.0], stop_gradient=False)
    y = (x * x).detach()
    return B.stop_gradient(y), _raises(lambda: B.backward(y), B.Invalid)


def case_retain_graph(B):
    x = B.t([2.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    return B.np(x.grad)


def case_double_backward_without_retain_raises(B):
    x = B.t([2.0], stop_gradient=False)
    y = (x * x).sum()
    B.backward(y)
    return _raises(lambda: B.backward(y), B.Invalid, "second time|retain")


def case_non_scalar_needs_grad_tensor(B):
    x = B.t([1.0, 2.0], stop_gradient=False)
    raised = _raises(lambda: B.backward(x * 2), B.Invalid, "scalar")
    B.backward(x * 2, B.t([1.0, 10.0]))
    return raised, B.np(x.grad)


def case_no_grad_context(B):
    x = B.t([2.0], stop_gradient=False)
    with B.pkg.no_grad():
        y = x * x
        off = B.pkg.is_grad_enabled()
    return B.stop_gradient(y), off, B.pkg.is_grad_enabled()


def case_no_grad_decorator(B):
    @B.pkg.no_grad()
    def f(a):
        return a * a

    return B.stop_gradient(f(B.t([2.0], stop_gradient=False)))


def case_set_grad_enabled(B):
    x = B.t([2.0], stop_gradient=False)
    B.pkg.set_grad_enabled(False)
    try:
        y = x * x
        with B.pkg.enable_grad():
            z = x * x
    finally:
        B.pkg.set_grad_enabled(True)
    return B.stop_gradient(y), B.stop_gradient(z)


def case_register_hook(B):
    x = B.t([2.0], stop_gradient=False)
    seen = []
    h = x.register_hook(lambda g: seen.append(B.np(g).copy()))
    (x * 3).sum().backward()
    h.remove()
    (x * 3).sum().backward()
    return seen, B.np(x.grad)


def case_hook_modifies_grad(B):
    x = B.t([2.0], stop_gradient=False)
    x.register_hook(lambda g: g * 10)
    (x * 3).sum().backward()
    return B.np(x.grad)


def case_matmul_backward(B):
    rng = np.random.RandomState(0)
    a = B.t(rng.randn(3, 4), stop_gradient=False)
    b = B.t(rng.randn(4, 2), stop_gradient=False)
    (a @ b).sum().backward()
    return B.np(a.grad), B.np(b.grad)


def case_paddle_grad(B):
    x = B.t([2.0], stop_gradient=False)
    y = B.t([3.0], stop_gradient=False)
    gx, gy = B.grad(x * x * y, [x, y])
    return B.np(gx), B.np(gy), x.grad is None


def case_grad_single_tensors(B):
    x = B.t([4.0], stop_gradient=False)
    g = B.grad(x * x, x)
    return B.np(g), type(g).__name__ != "list"


def case_grad_non_scalar_outputs(B):
    x = B.t([1.0, -2.0, 3.0], stop_gradient=False)
    (g,) = B.grad([x * x], [x])  # implicit ones, not refused
    (gw,) = B.grad([x * x], [x], grad_outputs=[B.t([1.0, 0.5, 2.0])])
    return B.np(g), B.np(gw)


def case_grad_unused_raises_and_allow_unused(B):
    x = B.t([2.0], stop_gradient=False)
    y = B.t([3.0], stop_gradient=False)
    raised = _raises(lambda: B.grad(x * 2, [y]), B.Invalid, "unused")
    res = B.grad(x * 2, [y], allow_unused=True)
    return raised, res[0] is None


def case_grad_intermediate_target(B):
    x = B.t([2.0], stop_gradient=False)
    y = x * 3
    return B.np(B.grad((y * y).sum(), [y])[0])


def case_pylayer_forward_backward(B):
    class Double(B.PyLayer):
        @staticmethod
        def forward(ctx, a):
            ctx.save_for_backward(a)
            return a * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    x = B.t([3.0], stop_gradient=False)
    y = Double.apply(x)
    y.sum().backward()
    return B.np(y), B.np(x.grad)


def case_pylayer_saved_tensors_two_inputs(B):
    class Mul(B.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensor()
            return g * b, g * a

    x = B.t([3.0, -1.0], stop_gradient=False)
    y = B.t([2.0, 5.0], stop_gradient=False)
    (Mul.apply(x, y) * B.t([1.0, 2.0])).sum().backward()
    return B.np(x.grad), B.np(y.grad)


def case_pylayer_wrong_grad_count_raises(B):
    class Bad(B.PyLayer):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            return g, g

    x = B.t([1.0], stop_gradient=False)
    return _raises(lambda: Bad.apply(x).sum().backward(), ValueError)


def case_third_order_polynomial(B):
    x = B.t([2.0, -1.0], stop_gradient=False)
    (g1,) = B.grad([(x * x * x).sum()], [x], create_graph=True)
    (g2,) = B.grad([g1.sum()], [x], create_graph=True)
    (g3,) = B.grad([g2.sum()], [x])
    return B.np(g1), B.np(g2), B.np(g3)


def case_gradient_penalty_reaches_params(B):
    rng = np.random.RandomState(0)
    w = B.t(rng.randn(3, 1), stop_gradient=False)
    b = B.t(rng.randn(1), stop_gradient=False)
    xx = B.t(rng.randn(4, 3), stop_gradient=False)
    (gx,) = B.grad([(xx @ w + b).sum()], [xx], create_graph=True)
    (gx * gx).sum().backward()
    return B.np(gx), B.np(w.grad)  # d||dx||^2/dW = 8 W


def case_hessian_vector_product(B):
    x = B.t([1.0, 2.0], stop_gradient=False)
    (g,) = B.grad([(x * x * x).sum()], [x], create_graph=True)
    (hvp,) = B.grad([(g * B.t([1.0, 0.5])).sum()], [x])
    return B.np(hvp)


def case_nonlinear_chain(B):
    x = B.t([0.3, -0.7, 1.2], stop_gradient=False)
    (g,) = B.grad([B.tanh(x * x).sum()], [x], create_graph=True)
    (gg,) = B.grad([g.sum()], [x])
    return B.np(g), B.np(gg)


def case_create_graph_frees_when_not_retained(B):
    x = B.t([2.0], stop_gradient=False)
    y = (x * x).sum()
    (g,) = B.grad([y], [x], create_graph=True, retain_graph=False)
    return B.np(g), _raises(lambda: B.grad([y], [x]), B.Invalid)


def case_create_graph_through_pylayer_raises(B):
    class Double(B.PyLayer):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, gy):
            return gy * 2

    x = B.t([1.0], stop_gradient=False)
    y = Double.apply(x).sum()
    return _raises(lambda: B.grad([y], [x], create_graph=True),
                   NotImplementedError)


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _assert_same(got, want, path="result"):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_case_matches_reference(name):
    _assert_same(CASES[name](Port), CASES[name](Ref))

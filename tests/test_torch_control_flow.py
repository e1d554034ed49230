"""The port's structured control flow (``paddle_tpu_torch.tensor
.control_flow``) held to the reference's (``tests/test_aux_subsystems.py``'s
control-flow cases): eagerly each call runs plain Python; inside a program
``torch.export`` traces they become ``torch.while_loop``/``torch.cond``.
The root's ``enable_static``/``disable_static``/``in_dynamic_mode``."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.jit import to_static
from paddle_tpu_torch.tensor import control_flow as cf


def test_while_loop_eager_and_traced():
    def run():
        i, s = ptt.tensor.while_loop(
            lambda i, s: i < 5, lambda i, s: (i + 1, s + 2.0),
            [torch.tensor(0, dtype=torch.int32), torch.tensor(0.0)])
        return s

    assert float(run()) == 10.0
    ri, rs = pt.tensor.while_loop(lambda i, s: i < 5,
                                  lambda i, s: (i + 1, s + 2.0),
                                  [pt.to_tensor(np.int32(0)),
                                   pt.to_tensor(np.float32(0))])
    assert float(rs.value) == float(run())

    def traced(x):
        i, acc = ptt.tensor.while_loop(lambda i, acc: i < 3,
                                       lambda i, acc: (i + 1, acc * 2.0),
                                       [0, x])
        return acc

    static = to_static(traced)
    assert float(static(torch.tensor(1.5))) == 12.0
    program = next(iter(static.concrete_program.values()))
    assert any("while_loop" in str(n.target) for n in program.graph.nodes)


def test_cond_case_switch():
    a = torch.tensor(2.0)
    out = ptt.static.nn.cond(a > 1.0, lambda: a * 10.0, lambda: a - 1.0)
    assert float(out) == 20.0
    got = ptt.tensor.case([(a > 5.0, lambda: a * 0.0),
                           (a > 1.0, lambda: a + 1.0)], default=lambda: a)
    assert float(got) == 3.0
    sw = ptt.tensor.switch_case(torch.tensor(1, dtype=torch.int32),
                                {0: lambda: a * 0.0, 1: lambda: a * 5.0},
                                default=lambda: a)
    assert float(sw) == 10.0
    # an index with no branch runs the default
    sw2 = ptt.tensor.switch_case(torch.tensor(7, dtype=torch.int32),
                                 {0: lambda: a * 0.0, 1: lambda: a * 5.0},
                                 default=lambda: a + 0.5)
    assert float(sw2) == 2.5
    assert ptt.static.nn.while_loop is ptt.tensor.while_loop


@pytest.mark.parametrize("v", [-3.0, 0.5, 2.0, 9.0])
def test_traced_cond_case_switch_match_the_reference(v):
    """The same three programs traced by both packages, on one input."""

    def prog(ns, x, idx):
        c = ns.static.nn.cond(x > 1.0, lambda: x * 10.0, lambda: x - 1.0)
        k = ns.tensor.case([(x > 5.0, lambda: x * 0.0),
                            (x > 0.0, lambda: x + 1.0)],
                           default=lambda: x * 3.0)
        s = ns.tensor.switch_case(idx, {0: lambda: x * 0.0,
                                        1: lambda: x * 5.0,
                                        4: lambda: x - 7.0},
                                  default=lambda: x + 0.5)
        return c, k, s

    idx = int(abs(v)) % 5
    static = to_static(lambda x, i: prog(ptt, x, i))
    got = static(torch.tensor(v), torch.tensor(idx))
    want = pt.jit.to_static(lambda x, i: prog(pt, x, i))(
        pt.to_tensor(np.float32(v)), pt.to_tensor(np.int32(idx)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.value),
                                   rtol=1e-6)
    program = next(iter(static.concrete_program.values()))
    assert any("cond" in str(n.target) for n in program.graph.nodes)


def test_gradient_through_eager_cond():
    x = torch.tensor([2.0, 1.0], requires_grad=True)
    y = cf.cond(x.sum() > 0, lambda: (x * 3.0).sum(), lambda: (x * 5.0).sum())
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])


def test_control_flow_errors():
    with pytest.raises(InvalidArgumentError):
        cf.cond(torch.tensor(True), None, None)
    with pytest.raises(InvalidArgumentError):
        cf.while_loop(lambda: True, lambda: (), [])
    with pytest.raises(InvalidArgumentError):
        cf.case([])
    with pytest.raises(InvalidArgumentError, match="returned 1 vars"):
        cf.while_loop(lambda a, b: a < 1, lambda a, b: a + 1,
                      [torch.tensor(0), torch.tensor(0)])
    with pytest.raises(InvalidArgumentError, match="scalar"):
        cf.cond(torch.ones(3) > 0, lambda: 1, lambda: 2)


def test_enable_disable_static():
    assert ptt.in_dynamic_mode()
    ptt.enable_static()
    try:
        assert not ptt.in_dynamic_mode()
    finally:
        ptt.disable_static()
    assert ptt.in_dynamic_mode()
    ptt.set_flags({"FLAGS_eager_mode": False})
    try:
        assert not ptt.in_dynamic_mode()
    finally:
        ptt.set_flags({"FLAGS_eager_mode": True})

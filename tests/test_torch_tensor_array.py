"""The port's tensor arrays (``paddle_tpu_torch.tensor.array``) held case
for case to the reference's ``tests/test_tensor_array.py``: the eager
list form, and the stacked ``TensorArray`` threaded through a
``while_loop`` -- eagerly and inside a program that ``torch.export``
traces, where the loop becomes ``torch.while_loop``.  Values are held
to the reference's on the same inputs."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.jit import to_static
from paddle_tpu_torch.tensor.array import TensorArray


def _np(t):
    return t.detach().numpy()


def test_eager_list_semantics():
    arr = ptt.create_array("float32")
    assert arr == []
    x = ptt.full([1, 3], 5.0, place="cpu")
    i = ptt.zeros([1], "int32", place="cpu")
    arr = ptt.array_write(x, i, array=arr)
    assert int(ptt.array_length(arr)) == 1
    item = ptt.array_read(arr, i)
    assert item is x
    # overwrite in place and append at the end
    arr = ptt.array_write(ptt.full([1, 3], 7.0, place="cpu"), 0, array=arr)
    arr = ptt.array_write(ptt.full([1, 3], 9.0, place="cpu"), 1, array=arr)
    assert len(arr) == 2
    np.testing.assert_allclose(_np(ptt.array_read(arr, 0)), 7.0)
    # array=None creates a fresh list (the reference's default)
    fresh = ptt.array_write(x, 0)
    assert len(fresh) == 1
    ref = pt.array_write(pt.full([1, 3], 5.0), pt.zeros([1], "int32"),
                         array=pt.create_array("float32"))
    assert int(np.asarray(pt.array_length(ref).value)) \
        == int(ptt.array_length(fresh))


def test_eager_list_errors():
    arr = ptt.create_array()
    with pytest.raises(InvalidArgumentError):
        ptt.array_write(ptt.ones([2], place="cpu"), 5, array=arr)  # a gap
    with pytest.raises(InvalidArgumentError):
        ptt.array_read(arr, 0)  # empty
    with pytest.raises(InvalidArgumentError):
        ptt.array_read("nope", 0)


def test_eager_autograd_flows_through_read():
    p = torch.tensor([2.0], requires_grad=True)
    arr = ptt.array_write(p * 3.0, 0)
    out = ptt.array_read(arr, 0).sum()
    out.backward()
    np.testing.assert_allclose(p.grad.numpy(), [3.0])


def test_create_array_initialized_list():
    arr = ptt.create_array("float32", [np.ones(2), np.zeros(2)])
    assert len(arr) == 2
    np.testing.assert_allclose(_np(ptt.array_read(arr, 1)), [0.0, 0.0])


def _collect(i0, ta, full, stack=None):
    """The reference's while_loop + array_write idiom: write ``i`` at
    position ``i`` for i < 5."""

    def cond(i, ta):
        return i < 5

    def body(i, ta):
        val = full([2], 1.0) * i.astype("float32") if stack is None \
            else full([2], 1.0) * i.to(torch.float32)
        ta = (pt if stack is None else ptt).array_write(val, i, array=ta)
        return i + 1, ta

    return (pt.tensor if stack is None else ptt.tensor).while_loop(
        cond, body, [i0, ta])


def test_stacked_array_in_while_loop():
    """The TensorArray threads through the loop state; the values and the
    length are the reference's."""
    ta = ptt.create_array("float32", capacity=8, element_shape=[2])
    i_out, ta_out = _collect(torch.zeros((), dtype=torch.int32), ta,
                             lambda s, v: torch.full(s, v), stack=True)
    assert int(ptt.array_length(ta_out)) == 5
    for k in range(5):
        np.testing.assert_allclose(_np(ptt.array_read(ta_out, k)), [k, k])
    stacked = _np(ta_out.stack())
    assert stacked.shape == (8, 2)
    np.testing.assert_allclose(stacked[5:], 0.0)  # padded slots
    ref = pt.create_array("float32", capacity=8, element_shape=[2])
    _, ref_out = _collect(pt.zeros([], "int32"), ref, pt.full)
    np.testing.assert_array_equal(stacked, np.asarray(ref_out.stack().value))


def test_stacked_array_under_a_traced_program():
    """The whole write/read flow inside a program ``torch.export`` traces
    (the reference's ``jax.jit`` case): the loop is ``torch.while_loop``
    and the array its carried buffer and length."""

    def run(n):
        ta = TensorArray.create(4, (3,), "float32")

        def body(k, ta):
            return k + 1, ta.write(k, torch.full((3,), 1.0) * k)

        k, ta = ptt.tensor.while_loop(lambda k, ta: k < n, body,
                                      [torch.zeros((), dtype=torch.int64),
                                       ta])
        return ta.buffer, ta.length

    static = to_static(run)
    buf, length = static(torch.tensor(3))
    assert int(length) == 3
    np.testing.assert_allclose(_np(buf)[2], 2.0)
    np.testing.assert_allclose(_np(buf)[3], 0.0)
    program = next(iter(static.concrete_program.values()))
    assert any("while_loop" in str(n.target) for n in program.graph.nodes)
    eager_buf, eager_len = run(torch.tensor(3))
    np.testing.assert_array_equal(_np(buf), _np(eager_buf))


def test_stacked_bounds_and_dtype_checks():
    ta = TensorArray.create(4, (2,), "float32")
    with pytest.raises(InvalidArgumentError):
        ta.write(10, np.ones(2, np.float32))  # beyond capacity
    with pytest.raises(InvalidArgumentError):
        ta.read(4)
    with pytest.raises(InvalidArgumentError):
        ptt.array_write(ptt.ones([2], place="cpu"), 1.5)  # fractional


def test_stacked_create_validates():
    with pytest.raises(InvalidArgumentError):
        ptt.create_array("float32", capacity=4)  # missing element_shape
    ta = ptt.create_array("float32", [np.ones(2)], capacity=4,
                          element_shape=[2])
    assert int(ptt.array_length(ta)) == 1


def test_tolist_and_install_methods():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert ptt.tolist(x) == pt.tolist(pt.to_tensor(x.numpy()))

    class Fake(torch.Tensor):
        pass

    before = {n for n in dir(torch.Tensor)}
    added = ptt.tensor.install_methods(Fake)
    # only names torch has no method of: torch's own are never replaced
    assert added and not set(added) & before
    assert "TensorArray" not in added  # a class, not an op
    assert "scale" in added
    got = Fake.scale(torch.ones(2), 3.0)
    np.testing.assert_allclose(got.numpy(), [3.0, 3.0])

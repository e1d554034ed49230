"""The port's ``tensor/segment.py`` against the reference's on the CPU:
``sequence_mask`` (and ``nn.functional``'s int64 alias),
``sequence_pad``/``sequence_unpad``, ``lengths_to_segment_ids``, the
segment reductions with dropped ids (< 0) and empty segments,
``segment_softmax``, ``masked_mean``, and the gradients of the sums and
means (held against ``jax.vjp`` of the reference).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: integer and boolean results exactly; float32 reductions and
gradients 1e-6 (relative to the largest magnitude, at least 1: sums of a
few terms in another order); ``segment_softmax`` 1e-6.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import common as rcommon
from paddle_tpu.tensor import segment as rseg

import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.tensor import segment as seg

TOL = 1e-6


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _ids(rng, shape, n):
    """Segment ids in [-1, n): -1 is dropped; segment n - 1 is left empty
    where it can be."""
    ids = rng.randint(-1, max(n - 1, 1), shape)
    return ids.astype(np.int32)


@pytest.mark.parametrize("maxlen", [None, 7])
@pytest.mark.parametrize("dtype", ["bool", "int64", "float32"])
def test_sequence_mask(maxlen, dtype):
    lengths = np.array([0, 3, 5, 1], np.int32)
    want = np.asarray(rseg.sequence_mask(lengths, maxlen, dtype="bool"))
    got = seg.sequence_mask(torch.from_numpy(lengths), maxlen, dtype=dtype)
    assert got.dtype == {"bool": torch.bool, "int64": torch.int64,
                         "float32": torch.float32}[dtype]
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    # the nn.functional alias defaults to int64, the tensor op to bool
    assert F.sequence_mask(torch.from_numpy(lengths), maxlen).dtype \
        == torch.int64
    assert ptt.sequence_mask(torch.from_numpy(lengths)).dtype == torch.bool
    np.testing.assert_array_equal(
        np.asarray(rcommon.sequence_mask(lengths, maxlen)).astype(bool),
        want)


def test_sequence_pad_unpad_roundtrip():
    rng = np.random.RandomState(0)
    rows = [rng.randn(n, 3).astype(np.float32) for n in (2, 5, 1)]
    want, want_len = rseg.sequence_pad(rows, pad_value=-1.0)
    got, got_len = seg.sequence_pad(rows, pad_value=-1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32
    back = seg.sequence_unpad(got, got_len)
    for r, b in zip(rows, back):
        np.testing.assert_array_equal(b.numpy(), r)
    # torch rows stay on their device and dtype; maxlen pads further
    got, _ = seg.sequence_pad([torch.from_numpy(r) for r in rows],
                              maxlen=6)
    assert tuple(got.shape) == (3, 6, 3) and got.dtype == torch.float32
    with pytest.raises(ptt.InvalidArgumentError):
        seg.sequence_pad(rows, maxlen=4)
    with pytest.raises(ptt.InvalidArgumentError):
        seg.sequence_pad([])


@pytest.mark.parametrize("maxlen", [None, 6])
def test_lengths_to_segment_ids(maxlen):
    lengths = np.array([2, 0, 4], np.int32)
    want = np.asarray(rseg.lengths_to_segment_ids(lengths, maxlen))
    got = seg.lengths_to_segment_ids(torch.from_numpy(lengths), maxlen)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("shape,tail", [((12,), ()), ((3, 4), ()),
                                        ((10,), (2, 3))])
@pytest.mark.parametrize("given_n", [True, False])
def test_segment_reductions(op, shape, tail, given_n):
    rng = np.random.RandomState(
        zlib.crc32(repr((op, shape, tail)).encode()))
    n = 5
    ids = _ids(rng, shape, n)
    data = rng.randn(*(shape + tail)).astype(np.float32)
    num = n if given_n else None
    want = np.asarray(getattr(rseg, "segment_" + op)(data, ids, num))
    got = getattr(seg, "segment_" + op)(torch.from_numpy(data),
                                        torch.from_numpy(ids), num)
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want)
    # the root and tensor namespaces export the same op
    root = getattr(ptt, "segment_" + op)(torch.from_numpy(data),
                                         torch.from_numpy(ids), num)
    _close(root.numpy(), want)


@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_extremes_int_dtype_empty_segment(op):
    data = np.array([5, 3, -2], np.int32)
    ids = np.array([0, 0, -1], np.int32)
    want = np.asarray(getattr(rseg, "segment_" + op)(data, ids, 3))
    got = getattr(seg, "segment_" + op)(torch.from_numpy(data),
                                        torch.from_numpy(ids), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [5 if op == "max" else 3, 0, 0])


@pytest.mark.parametrize("shape", [(9,), (2, 6)])
def test_segment_softmax(shape):
    rng = np.random.RandomState(3)
    ids = _ids(rng, shape, 4)
    data = (rng.randn(*shape) * 5).astype(np.float32)
    want = np.asarray(rseg.segment_softmax(data, ids, 4))
    got = seg.segment_softmax(torch.from_numpy(data), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert np.all(got.numpy()[ids < 0] == 0)


@pytest.mark.parametrize("axis", [None, 1])
def test_masked_mean(axis):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5).astype(np.float32)
    mask = rng.rand(3, 5) > 0.5
    mask[1] = False  # a row with nothing kept: its mean is 0
    want = np.asarray(rseg.masked_mean(x, mask, axis=axis))
    got = seg.masked_mean(torch.from_numpy(x), torch.from_numpy(mask),
                          axis=axis)
    _close(got.numpy(), want)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_segment_gradients(op):
    rng = np.random.RandomState(5)
    ids = _ids(rng, (8,), 4)
    data = rng.randn(8, 3).astype(np.float32)
    ref = getattr(rseg, "segment_" + op)
    want, vjp = jax.vjp(lambda d: ref(d, jnp.asarray(ids), 4),
                        jnp.asarray(data))
    cot = rng.randn(*want.shape).astype(np.float32)
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(data).requires_grad_()
    got = getattr(seg, "segment_" + op)(x, torch.from_numpy(ids), 4)
    got.backward(torch.from_numpy(cot))
    _close(got.detach().numpy(), np.asarray(want))
    _close(x.grad.numpy(), np.asarray(want_grad))

"""The port's flags, seeds and nan/inf check against the reference on the
CPU: ``tests/test_core.py``'s ``test_flags_roundtrip``,
``test_seed_reproducible`` and ``test_rng_state_roundtrip``, the ten
flags' names, defaults and help, ``FLAGS_log_level``'s call stack,
``FLAGS_seq_block_size`` changing no attention value, and the op shim's
``FLAGS_check_nan_inf`` scan.

``test_core.py::test_rng_guard_traced_key`` is JAX-only: it installs a
traced JAX key inside ``jax.jit``, which has no counterpart in the port
(torch's generators are stateful; a captured step draws from the CUDA
generator its capture registered).  Random draws are held by the
reference's clauses (the same seed gives the same draws, a restored state
replays them), not by equal streams: the two packages' generators
differ.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import flags as ref_flags

import paddle_tpu_torch as ptt
from paddle_tpu_torch import InvalidArgumentError
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.flash_attention import flash_attention


@pytest.fixture
def nan_check():
    ptt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        yield
    finally:
        ptt.set_flags({"FLAGS_check_nan_inf": False})


def test_flags_roundtrip():
    ptt.set_flags({"FLAGS_check_nan_inf": True})
    assert ptt.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"] \
        is True
    ptt.set_flags({"FLAGS_check_nan_inf": False})
    with pytest.raises(KeyError):
        ptt.set_flags({"FLAGS_nonexistent": 1})


def test_flags_are_the_references():
    """All ten of the reference's flags, with its defaults and help, and
    each round-trips."""
    want = {n: (f.default, f.help) for n, f in ref_flags._REGISTRY.items()}
    got = {n: (f.default, f.help) for n, f in flags._REGISTRY.items()}
    assert got == want and len(got) == 10
    assert ptt.get_flags() == {n: d for n, (d, _) in want.items()}
    for name, (default, _) in want.items():
        other = (not default if isinstance(default, bool)
                 else default + 1 if isinstance(default, int)
                 else default + "x")
        ptt.set_flags({name: other})
        assert ptt.get_flags(name) == {name: other}
        ptt.set_flags({name: default})


def test_seed_reproducible():
    ptt.seed(42)
    a = ptt.randn([4], place="cpu")
    ptt.seed(42)
    b = ptt.randn([4], place="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = ptt.randn([4], place="cpu")
    assert not np.allclose(b.numpy(), c.numpy())
    assert ptt.seed(42).initial_seed() == 42


def test_rng_state_roundtrip():
    ptt.seed(7)
    ptt.randn([2], place="cpu")
    state = ptt.get_rng_state()
    a = ptt.randn([3], place="cpu")
    ptt.set_rng_state(state)
    b = ptt.randn([3], place="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the generator facade carries every generator's state and the seed
    gen = ptt.seed(11)
    full = gen.get_state()
    a = ptt.rand([5], place="cpu")
    ptt.seed(3)
    gen.set_state(full)
    assert gen.initial_seed() == 11
    np.testing.assert_array_equal(ptt.rand([5], place="cpu").numpy(),
                                  a.numpy())
    # no card here: the CUDA states are an empty list, and restore is a no-op
    assert ptt.get_cuda_rng_state() == []
    ptt.set_cuda_rng_state([])


def test_log_level_appends_the_python_call_stack():
    try:
        ptt.set_flags({"FLAGS_log_level": 1})
        with pytest.raises(InvalidArgumentError) as e:
            raise InvalidArgumentError("bad arg")
        assert "[Python call stack]" in str(e.value)
        assert "test_log_level_appends_the_python_call_stack" in str(e.value)
    finally:
        ptt.set_flags({"FLAGS_log_level": 0})
    assert "[Python call stack]" not in str(InvalidArgumentError("x"))
    # the reference's messages carry the same marker
    try:
        pt.set_flags({"FLAGS_log_level": 1})
        assert "[Python call stack]" in str(
            pt.core.errors.InvalidArgumentError("x"))
    finally:
        pt.set_flags({"FLAGS_log_level": 0})


def test_nan_check_raises_naming_the_op(nan_check):
    x = torch.tensor([1.0, 0.0, 2.0])
    with pytest.raises(InvalidArgumentError) as e:
        ptt.log(x)  # log(0) = -inf
    assert "'log'" in str(e.value) and "FLAGS_check_nan_inf" in str(e.value)
    with pytest.raises(InvalidArgumentError, match="'divide'"):
        ptt.divide(x, torch.zeros(3))
    with pytest.raises(InvalidArgumentError, match="'mse_loss'"):
        F.mse_loss(torch.tensor([float("nan")]), torch.zeros(1))
    # the reference raises the same error for the same op
    with pytest.raises(pt.core.errors.InvalidArgumentError, match="'log'"):
        try:
            pt.set_flags({"FLAGS_check_nan_inf": True})
            pt.log(pt.to_tensor(np.array([1.0, 0.0], np.float32)))
        finally:
            pt.set_flags({"FLAGS_check_nan_inf": False})


def test_nan_check_passes_clean_ops(nan_check):
    x = torch.tensor([1.0, 2.0])
    np.testing.assert_allclose(ptt.log(x).numpy(), np.log([1.0, 2.0]),
                               rtol=1e-6)
    vals, idx = ptt.topk(x, 1)  # a tuple output is scanned leaf by leaf
    assert float(vals) == 2.0 and int(idx) == 1
    assert ptt.equal(x, x).all()  # boolean outputs are not scanned
    # torch's own operators are not installed ops: no scan
    assert torch.isinf(x / 0.0).all()


def test_nan_check_off_lets_inf_through():
    assert not ptt.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
    assert torch.isinf(ptt.log(torch.tensor([0.0]))).all()


def test_seq_block_size_changes_no_value():
    """The reference's flag bounds its kernel's tiles and changes no value;
    K3 keeps its compiled tiles, so the attention is the same at any
    setting."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 96, 16, generator=g) for _ in range(3))
    out = {}
    try:
        for blk in (32, 512):
            ptt.set_flags({"FLAGS_seq_block_size": blk})
            out[blk] = flash_attention(q, k, v, causal=True)
    finally:
        ptt.set_flags({"FLAGS_seq_block_size": 512})
    assert torch.equal(out[32], out[512])

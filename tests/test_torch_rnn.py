"""The port's recurrent layers (``nn/layer/rnn.py``) against the
reference's on the CPU: ``SimpleRNN``/``LSTM``/``GRU`` in both directions,
with and without ``sequence_length``, batch-first and time-major, their
outputs, final states and gradients (inputs and every parameter), on
every route a built-in cell takes (``"cudnn"`` without lengths,
``"packed"`` with them, and the ``"loop"`` a CUDA-graph capture takes,
forced here); the cells alone; ``RNN`` over a caller's own cell (the step
loop, with masked nested states); ``BiRNN``; and the reference's
parameter names, carried by ``load_reference_params`` with no renaming.

Inputs are made with numpy from a seed; weights cross from the reference.
Tolerances, fp32: outputs, states and gradients 1e-5 relative to each
array's largest magnitude (at least 1): recurrences of a few steps whose
sums run in another order.
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch.nn.layer import rnn as prnn

TOL = 1e-5
B, T, D, H = 3, 6, 5, 4
LENS = np.array([6, 2, 4], np.int64)


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _arrays(ref) -> dict:
    return {n: np.asarray(p.value) for n, p in ref.named_parameters()}


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.fixture
def route(monkeypatch, request):
    """Force a multi-step route: ``"auto"`` leaves the choice to
    ``rnn._route``; ``"loop"`` takes the capture's step loop."""
    if request.param == "loop":
        monkeypatch.setattr(prnn, "_route", lambda *a: "loop")
    return request.param


_CLASSES = {"simple": ("SimpleRNN", {}), "lstm": ("LSTM", {}),
            "gru": ("GRU", {})}


def _pair(mode, **kw):
    name, extra = _CLASSES[mode]
    pt.seed(1)
    ref = getattr(pt.nn, name)(D, H, **extra, **kw)
    port = getattr(ptt.nn, name)(D, H, **extra, **kw, device="cpu")
    load_reference_params(port, _arrays(ref))
    return ref, port


# the reference's results by case: the routes of one case share them
_REF_RUNS: dict = {}


def _ref_run(key, ref, x, lens, cots):
    if key not in _REF_RUNS:
        rx = pt.to_tensor(x, stop_gradient=False)
        kw = {} if lens is None else {"sequence_length": pt.to_tensor(lens)}
        out, st = ref(rx, **kw)
        leaves = [out] + _leaves(st)
        sum((t * pt.to_tensor(c)).sum()
            for t, c in zip(leaves, cots)).backward()
        _REF_RUNS[key] = (
            [np.asarray(t.value) for t in leaves], np.asarray(rx.grad.value),
            {n: np.asarray(p.grad.value) for n, p in ref.named_parameters()})
    return _REF_RUNS[key]


def _run_both(key, ref, port, x, lens):
    """Forward of both on ``x`` (and ``lens``), then the gradients of
    sum(out * cot) + sum(final states * cots): returns the reference's and
    the port's (outputs, states, input grad, {param: grad})."""
    px = torch.from_numpy(x).requires_grad_()
    kw = {} if lens is None else {"sequence_length": torch.from_numpy(lens)}
    p_out, p_st = port(px, **kw)
    p_leaves = [p_out] + _leaves(p_st)
    rng = _rng("cot", key)
    cots = [rng.randn(*t.shape).astype(np.float32) for t in p_leaves]
    want = _ref_run(key, ref, x, lens, cots)
    sum((t * torch.from_numpy(c)).sum()
        for t, c in zip(p_leaves, cots)).backward()
    got = ([t.detach().numpy() for t in p_leaves], px.grad.numpy(),
           {n: p.grad.numpy() for n, p in port.named_parameters()})
    return want, got


def _check(want, got):
    for w, g in zip(want[0], got[0]):
        assert w.shape == g.shape
        _close(g, w)
    _close(got[1], want[1])
    assert set(got[2]) == set(want[2])
    for name in want[2]:
        _close(got[2][name], want[2][name])


@pytest.mark.parametrize("route", ["auto", "loop"], indirect=True)
@pytest.mark.parametrize("lens", [None, LENS], ids=["full", "lengths"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("mode", ["simple", "lstm", "gru"])
def test_stack_matches_reference(mode, direction, lens, route):
    """Two layers: outputs (0 past each length), [L*D, B, H] final states
    and every gradient, on the route given."""
    ref, port = _pair(mode, num_layers=2, direction=direction)
    x = _rng(mode, direction).randn(B, T, D).astype(np.float32)
    want, got = _run_both(("stack", mode, direction, lens is None), ref,
                          port, x, lens)
    _check(want, got)
    if lens is not None:
        assert np.all(got[0][0][1, 2:] == 0)


@pytest.mark.parametrize("route", ["auto", "loop"], indirect=True)
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_time_major(mode, route):
    ref, port = _pair(mode, direction="bidirect", time_major=True)
    x = _rng("tm", mode).randn(T, B, D).astype(np.float32)
    want, got = _run_both(("time_major", mode), ref, port, x, LENS)
    _check(want, got)


def test_simple_rnn_relu_and_packed_zero_length():
    """A relu SimpleRNN; a zero-length row (which packing refuses) takes
    the step loop and keeps its initial state."""
    pt.seed(2)
    ref = pt.nn.SimpleRNN(D, H, activation="relu")
    port = ptt.nn.SimpleRNN(D, H, activation="relu", device="cpu")
    load_reference_params(port, _arrays(ref))
    x = _rng("relu").randn(B, T, D).astype(np.float32)
    lens = np.array([3, 0, 6], np.int64)
    want, got = _run_both(("relu",), ref, port, x, lens)
    _check(want, got)
    assert np.all(got[0][1][:, 1] == 0)


@pytest.mark.parametrize("mode", ["simple", "lstm", "gru"])
def test_cell_step_matches_reference(mode):
    name = {"simple": "SimpleRNNCell", "lstm": "LSTMCell",
            "gru": "GRUCell"}[mode]
    pt.seed(3)
    ref = getattr(pt.nn, name)(D, H)
    port = getattr(ptt.nn, name)(D, H, device="cpu")
    load_reference_params(port, _arrays(ref))
    rng = _rng("cell", mode)
    x = rng.randn(B, D).astype(np.float32)
    h = rng.randn(B, H).astype(np.float32)
    c = rng.randn(B, H).astype(np.float32)
    r_st = (pt.to_tensor(h), pt.to_tensor(c)) if mode == "lstm" \
        else pt.to_tensor(h)
    p_st = (torch.from_numpy(h), torch.from_numpy(c)) if mode == "lstm" \
        else torch.from_numpy(h)
    r_out, r_new = ref(pt.to_tensor(x), r_st)
    p_out, p_new = port(torch.from_numpy(x), p_st)
    _close(p_out.detach().numpy(), np.asarray(r_out.value))
    for g, w in zip(_leaves(p_new), _leaves(r_new)):
        _close(g.detach().numpy(), np.asarray(w.value))
    # no states: zeros of the cell's state shape
    r_out, _ = ref(pt.to_tensor(x))
    p_out, _ = port(torch.from_numpy(x))
    _close(p_out.detach().numpy(), np.asarray(r_out.value))
    init = port.get_initial_states(torch.zeros(B, D), init_value=0.5)
    assert all(tuple(t.shape) == (B, H) and bool((t == 0.5).all())
               for t in _leaves(init))


class _PortScaledCell(ptt.nn.RNNCellBase):
    """A caller's cell with nested states: a GRUCell and a running sum."""

    def __init__(self):
        super().__init__()
        self.gru = ptt.nn.GRUCell(D, H, device="cpu")

    def forward(self, x, states):
        h, extra = states
        out, h = self.gru(x, h)
        return out * 2.0, (h, {"sum": extra["sum"] + out})


class _RefScaledCell(pt.nn.RNNCellBase):
    def __init__(self):
        super().__init__()
        self.gru = pt.nn.GRUCell(D, H)

    def forward(self, x, states):
        h, extra = states
        out, h = self.gru(x, h)
        return out * 2.0, (h, {"sum": extra["sum"] + out})


@pytest.mark.parametrize("lens", [None, LENS], ids=["full", "lengths"])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_rnn_over_a_callers_cell(lens, is_reverse):
    """``RNN`` runs a cell of the caller's own step by step: nested states
    frozen past each length, outputs zeroed, reverse per row."""
    pt.seed(4)
    ref_cell = _RefScaledCell()
    port_cell = _PortScaledCell()
    load_reference_params(port_cell, _arrays(ref_cell))
    rng = _rng("generic", is_reverse)
    x = rng.randn(B, T, D).astype(np.float32)
    h0 = rng.randn(B, H).astype(np.float32)
    r_init = (pt.to_tensor(h0), {"sum": pt.to_tensor(np.zeros((B, H),
                                                             np.float32))})
    p_init = (torch.from_numpy(h0), {"sum": torch.zeros(B, H)})
    kw_r = {} if lens is None else {"sequence_length": pt.to_tensor(lens)}
    kw_p = {} if lens is None else {"sequence_length": torch.from_numpy(
        lens)}
    r_out, (r_h, r_x) = pt.nn.RNN(ref_cell, is_reverse=is_reverse)(
        pt.to_tensor(x), r_init, **kw_r)
    p_out, (p_h, p_x) = ptt.nn.RNN(port_cell, is_reverse=is_reverse)(
        torch.from_numpy(x), p_init, **kw_p)
    _close(p_out.detach().numpy(), np.asarray(r_out.value))
    _close(p_h.detach().numpy(), np.asarray(r_h.value))
    _close(p_x["sum"].detach().numpy(), np.asarray(r_x["sum"].value))


def test_birnn_matches_reference():
    pt.seed(5)
    ref = pt.nn.BiRNN(pt.nn.LSTMCell(D, H), pt.nn.LSTMCell(D, H))
    port = ptt.nn.BiRNN(ptt.nn.LSTMCell(D, H, device="cpu"),
                        ptt.nn.LSTMCell(D, H, device="cpu"))
    load_reference_params(port, _arrays(ref))
    x = _rng("birnn").randn(B, T, D).astype(np.float32)
    r_out, r_st = ref(pt.to_tensor(x), sequence_length=pt.to_tensor(LENS))
    p_out, p_st = port(torch.from_numpy(x),
                       sequence_length=torch.from_numpy(LENS))
    _close(p_out.detach().numpy(), np.asarray(r_out.value))
    for g, w in zip(p_st, r_st):
        for gg, ww in zip(g, w):
            _close(gg.detach().numpy(), np.asarray(ww.value))


def test_reference_names_carry_a_bidirectional_lstm():
    """``load_reference_params`` carries a 2-layer bidirectional LSTM by
    the reference's own names (``cell_l0.weight_ih``,
    ``cell_l1_reverse.bias_hh``, ...), and a wrong shape is refused."""
    pt.seed(6)
    ref = pt.nn.LSTM(D, H, num_layers=2, direction="bidirect")
    port = ptt.nn.LSTM(D, H, num_layers=2, direction="bidirect",
                       device="cpu")
    arrays = _arrays(ref)
    assert sorted(arrays) == sorted(n for n, _ in port.named_parameters())
    assert "cell_l1_reverse.bias_hh" in arrays
    load_reference_params(port, arrays)
    for n, p in port.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[n])
    assert tuple(port.cell_l1.weight_ih.shape) == (4 * H, 2 * H)
    arrays["cell_l0.weight_ih"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ptt.InvalidArgumentError):
        load_reference_params(port, arrays)


def test_direction_and_sizes_are_checked():
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.nn.LSTM(D, H, direction="sideways", device="cpu")
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.nn.GRUCell(D, 0, device="cpu")
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.nn.SimpleRNNCell(D, H, activation="gelu", device="cpu")
    cell = ptt.nn.GRUCell(D, H, device="cpu")
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.nn.RNN(cell)(torch.zeros(B, T, D), torch.zeros(B + 1, H))

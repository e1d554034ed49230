"""Recurrent layers (counterpart of the reference's ``nn/layer/rnn.py``):
the cells ``SimpleRNNCell``/``LSTMCell``/``GRUCell``, ``RNN`` (a cell run
over a sequence) and ``BiRNN``, and the stacks ``SimpleRNN``/``LSTM``/
``GRU``.

Gate layouts are the reference's (and torch's): LSTM [i, f, g, o]; GRU
[r, z, c] with the hidden-side bias inside the reset product.  Weights
are [gates * H, in] (``weight_ih``, ``weight_hh``) with their biases,
drawn from Uniform(-1/sqrt(H), 1/sqrt(H)); a stack names its cells
``cell_l{layer}`` and ``cell_l{layer}_reverse``, as the reference does.

With ``sequence_length``, a row's state stops changing after its length
and its outputs past it are 0; the reverse direction runs each row from
its own last valid step.  A built-in cell runs one layer-direction by one
of three routes (:func:`_route`), each giving the reference's values:

- ``"cudnn"``: no lengths, one ``torch._VF`` recurrence (cuDNN on the
  card, ATen's on the CPU) over the padded batch on the cell's own
  weights;
- ``"packed"``: lengths, eagerly: the rows packed by length (read back to
  the host once a call) and run by the same recurrence;
- ``"loop"``: while a CUDA graph captures (nothing may be read back
  there): one step at a time over masked states, plain torch ops.

A cell of the caller's own (any ``forward(x_t, states)``) always runs the
step loop, its states any nesting of tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)

from ...core.errors import InvalidArgumentError
from .. import functional as F
from .. import initializer as I
from .layers import Layer, create_parameter

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
]


# -- the raw step functions ---------------------------------------------


def _gates(x, h, w_ih, w_hh, b_ih, b_hh):
    """The input-side and hidden-side projections, their biases apart (a
    GRU needs the hidden bias inside the reset product)."""
    gi = torch.matmul(x, w_ih.t())
    if b_ih is not None:
        gi = gi + b_ih
    gh = torch.matmul(h, w_hh.t())
    if b_hh is not None:
        gh = gh + b_hh
    return gi, gh


def _step_simple(x, hc, w_ih, w_hh, b_ih, b_hh, activation="tanh"):
    (h,) = hc
    gi, gh = _gates(x, h, w_ih, w_hh, b_ih, b_hh)
    act = torch.tanh if activation == "tanh" else torch.relu
    return (act(gi + gh),)


def _step_lstm(x, hc, w_ih, w_hh, b_ih, b_hh, activation=None):
    h, c = hc
    gi, gh = _gates(x, h, w_ih, w_hh, b_ih, b_hh)
    i, f, g, o = torch.chunk(gi + gh, 4, dim=-1)
    nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return (torch.sigmoid(o) * torch.tanh(nc), nc)


def _step_gru(x, hc, w_ih, w_hh, b_ih, b_hh, activation=None):
    (h,) = hc
    gi, gh = _gates(x, h, w_ih, w_hh, b_ih, b_hh)
    ir, iz, ic = torch.chunk(gi, 3, dim=-1)
    hr, hz, hc_ = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    c = torch.tanh(ic + r * hc_)
    return (z * h + (1.0 - z) * c,)


_STEPS = {"simple": _step_simple, "lstm": _step_lstm, "gru": _step_gru}


def _reverse_sequence(x_tm, seq_len):
    """Each row of a time-major [T, B, ...] batch reversed within its own
    length (the padding stays at the tail); all of it without lengths."""
    if seq_len is None:
        return torch.flip(x_tm, (0,))
    t_len = x_tm.shape[0]
    t = torch.arange(t_len, device=x_tm.device)[:, None]
    sl = seq_len.to(torch.int64).clamp(max=t_len)[None, :]
    idx = torch.where(t < sl, sl - 1 - t, t)                    # [T, B]
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x_tm.ndim - 2))
    return x_tm.gather(0, idx.expand(x_tm.shape))


# -- cells ------------------------------------------------------------------


class RNNCellBase(Layer):
    """A single-step recurrence with the reference's initial states."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``shape`` (the cell's ``state_shape`` when None) for
        ``batch_ref``'s batch, filled with ``init_value``, on its device: a
        tuple for a nested shape (an LSTM's (h, c)), else one tensor."""
        batch = int(batch_ref.shape[batch_dim_idx])
        shapes = shape if shape is not None else self.state_shape
        dt = torch.float32 if dtype is None else dtype

        def make(s):
            return torch.full((batch,) + tuple(s), init_value, dtype=dt,
                              device=batch_ref.device)

        if isinstance(shapes, (list, tuple)) and shapes \
                and isinstance(shapes[0], (list, tuple)):
            made = tuple(make(s) for s in shapes)
            return made if len(made) > 1 else made[0]
        return make(tuple(shapes))

    @property
    def state_shape(self):
        raise NotImplementedError(
            "cell %s must define state_shape" % type(self).__name__)


class _BuiltinCell(RNNCellBase):
    _mode: str = ""
    _gate_mult: int = 1

    def __init__(self, input_size: int, hidden_size: int,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size <= 0 or input_size <= 0:
            raise InvalidArgumentError(
                "cell sizes must be positive, got input_size=%s "
                "hidden_size=%s" % (input_size, hidden_size))
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        rows = self._gate_mult * hidden_size
        kw = dict(default_initializer=I.Uniform(-std, std), device=device,
                  generator=generator)
        self.weight_ih = create_parameter([rows, input_size],
                                          weight_ih_attr, **kw)
        self.weight_hh = create_parameter([rows, hidden_size],
                                          weight_hh_attr, **kw)
        self.bias_ih = create_parameter([rows], bias_ih_attr, is_bias=True,
                                        **kw)
        self.bias_hh = create_parameter([rows], bias_hh_attr, is_bias=True,
                                        **kw)

    def _unpack_states(self, states, batch_ref):
        """(h, c) of ``states`` (c None but for an LSTM); zeros when
        None."""
        if states is None:
            states = self.get_initial_states(batch_ref)
        if self._mode == "lstm":
            h, c = states
            return h, c
        if isinstance(states, (tuple, list)):
            (states,) = states
        return states, None

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)

    def forward(self, inputs, states=None):
        h, c = self._unpack_states(states, inputs)
        hc = (h,) if c is None else (h, c)
        out = _STEPS[self._mode](inputs, hc, *self._weights(),
                                 getattr(self, "activation", "tanh"))
        return (out[0], out) if self._mode == "lstm" else (out[0], out[0])

    def extra_repr(self):
        return "input_size=%d, hidden_size=%d" % (self.input_size,
                                                  self.hidden_size)


class SimpleRNNCell(_BuiltinCell):
    """h' = act(W_ih x + b_ih + W_hh h + b_hh), act tanh or relu."""

    _mode = "simple"
    _gate_mult = 1

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None, generator=None):
        if activation not in ("tanh", "relu"):
            raise InvalidArgumentError(
                "SimpleRNNCell activation must be tanh or relu, got %r"
                % activation)
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, generator=generator)
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(_BuiltinCell):
    """Gates [i, f, g, o]; returns (h, (h, c))."""

    _mode = "lstm"
    _gate_mult = 4

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(_BuiltinCell):
    """Gates [r, z, c], h' = z h + (1 - z) c; returns (h, h)."""

    _mode = "gru"
    _gate_mult = 3

    @property
    def state_shape(self):
        return (self.hidden_size,)


# -- one layer-direction over a sequence --------------------------------


def _route(inputs, sequence_length) -> str:
    """How a built-in cell runs a sequence: ``"loop"`` while a CUDA graph
    captures, else ``"cudnn"`` without lengths and ``"packed"`` with
    them."""
    if inputs.is_cuda and torch.cuda.is_current_stream_capturing():
        return "loop"
    return "cudnn" if sequence_length is None else "packed"


def _loop(cell, x_tm, seq_len, h0, c0):
    """The step loop over masked states: past its length a row keeps its
    state and outputs 0.  Returns (outputs [T, B, H], h_T, c_T)."""
    step = _STEPS[cell._mode]
    weights = cell._weights()
    act = getattr(cell, "activation", "tanh")
    hc = (h0,) if c0 is None else (h0, c0)
    outs = []
    for t in range(x_tm.shape[0]):
        new = step(x_tm[t], hc, *weights, act)
        if seq_len is None:
            out = new[0]
        else:
            valid = (seq_len > t)[:, None]
            new = tuple(torch.where(valid, n, o) for n, o in zip(new, hc))
            out = torch.where(valid, new[0], torch.zeros_like(new[0]))
        hc = new
        outs.append(out)
    return torch.stack(outs), hc[0], (hc[1] if len(hc) > 1 else None)


def _vf_call(cell, data, batch_sizes, h0, c0):
    """One ``torch._VF`` recurrence of the cell's mode over ``data`` (a
    time-major batch, or packed rows with ``batch_sizes``)."""
    mode = "rnn_" + cell.activation if cell._mode == "simple" \
        else cell._mode
    w_ih, w_hh, b_ih, b_hh = cell._weights()
    if (b_ih is None) != (b_hh is None):
        zero = torch.zeros(w_ih.shape[0], dtype=w_ih.dtype,
                           device=w_ih.device)
        b_ih = zero if b_ih is None else b_ih
        b_hh = zero if b_hh is None else b_hh
    params = [w_ih, w_hh] + ([] if b_ih is None else [b_ih, b_hh])
    hx = h0[None] if c0 is None else (h0[None], c0[None])
    train = torch.is_grad_enabled()
    fn = getattr(torch._VF, mode)
    if batch_sizes is None:
        res = fn(data, hx, params, b_ih is not None, 1, 0.0, train, False,
                 False)
    else:
        res = fn(data, batch_sizes, hx, params, b_ih is not None, 1, 0.0,
                 train, False)
    return res[0], res[1][0], (res[2][0] if c0 is not None else None)


def _packed(cell, x_tm, seq_len, h0, c0):
    """The rows packed by length and run by one recurrence.  The lengths
    are read back once; a row of length 0 (which packing refuses) sends
    the call to the step loop."""
    t_len = x_tm.shape[0]
    lens = seq_len.detach().to("cpu", torch.int64).clamp(max=t_len)
    if int(lens.min()) < 1:
        return _loop(cell, x_tm, seq_len, h0, c0)
    packed = pack_padded_sequence(x_tm, lens, enforce_sorted=False)
    order, back = packed.sorted_indices, packed.unsorted_indices
    out, h, c = _vf_call(cell, packed.data, packed.batch_sizes,
                         h0.index_select(0, order),
                         None if c0 is None else c0.index_select(0, order))
    outs, _ = pad_packed_sequence(
        PackedSequence(out, packed.batch_sizes, order, back),
        total_length=t_len)
    return (outs, h.index_select(0, back),
            None if c is None else c.index_select(0, back))


def _run_builtin(cell, x_tm, seq_len, init_states, reverse):
    h0, c0 = cell._unpack_states(init_states, x_tm[0])
    if int(h0.shape[0]) != int(x_tm.shape[1]):
        raise InvalidArgumentError(
            "initial state batch %s != input batch %s"
            % (h0.shape[0], x_tm.shape[1]))
    if reverse:
        x_tm = _reverse_sequence(x_tm, seq_len)
    route = _route(x_tm, seq_len)
    if route == "loop":
        outs, h, c = _loop(cell, x_tm, seq_len, h0, c0)
    elif route == "cudnn":
        outs, h, c = _vf_call(cell, x_tm, None, h0, c0)
    else:
        outs, h, c = _packed(cell, x_tm, seq_len, h0, c0)
    if reverse:
        outs = _reverse_sequence(outs, seq_len)
    return outs, ((h, c) if cell._mode == "lstm" else h)


def _where_tree(valid, new, old):
    """``new`` where ``valid`` (per row), else ``old``, leaf by leaf."""
    if isinstance(new, torch.Tensor):
        v = valid.reshape((-1,) + (1,) * (new.ndim - 1))
        return torch.where(v, new, old)
    if isinstance(new, tuple):
        items = [_where_tree(valid, n, o) for n, o in zip(new, old)]
        return type(new)(*items) if hasattr(new, "_fields") \
            else tuple(items)
    if isinstance(new, list):
        return [_where_tree(valid, n, o) for n, o in zip(new, old)]
    if isinstance(new, dict):
        return {k: _where_tree(valid, v, old[k]) for k, v in new.items()}
    return new


def _run_cell_loop(cell, x_tm, seq_len, states, reverse):
    """A caller's cell, one step at a time, with the built-in routes'
    masking."""
    if reverse:
        x_tm = _reverse_sequence(x_tm, seq_len)
    outs = []
    for t in range(x_tm.shape[0]):
        out, new = cell(x_tm[t], states)
        if seq_len is None:
            states = new
        else:
            valid = seq_len > t
            states = _where_tree(valid, new, states)
            out = out * valid.reshape((-1,) + (1,) * (out.ndim - 1)).to(
                out.dtype)
        outs.append(out)
    outputs = torch.stack(outs)
    if reverse:
        outputs = _reverse_sequence(outputs, seq_len)
    return outputs, states


def _run_layer(cell, inputs, init_states, sequence_length, reverse,
               time_major):
    """One layer-direction over ``inputs`` ([B, T, ...], or [T, B, ...]
    when ``time_major``): (outputs in the same layout, final states)."""
    x_tm = inputs if time_major else inputs.transpose(0, 1)
    seq_len = None if sequence_length is None else torch.as_tensor(
        sequence_length, device=inputs.device)
    if init_states is None:
        init_states = cell.get_initial_states(
            inputs, batch_dim_idx=1 if time_major else 0)
    if isinstance(cell, _BuiltinCell):
        outs, final = _run_builtin(cell, x_tm, seq_len, init_states,
                                   reverse)
    else:
        outs, final = _run_cell_loop(cell, x_tm, seq_len, init_states,
                                     reverse)
    return (outs if time_major else outs.transpose(0, 1)), final


class RNN(Layer):
    """Runs ``cell`` over a sequence: (outputs, final states)."""

    def __init__(self, cell, is_reverse: bool = False,
                 time_major: bool = False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return _run_layer(self.cell, inputs, initial_states,
                          sequence_length, self.is_reverse, self.time_major)


class BiRNN(Layer):
    """A forward and a reverse cell over one sequence, their outputs
    concatenated; states (forward's, reverse's)."""

    def __init__(self, cell_fw, cell_bw, time_major: bool = False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        init_fw = init_bw = None
        if initial_states is not None:
            init_fw, init_bw = initial_states
        out_fw, st_fw = _run_layer(self.cell_fw, inputs, init_fw,
                                   sequence_length, False, self.time_major)
        out_bw, st_bw = _run_layer(self.cell_bw, inputs, init_bw,
                                   sequence_length, True, self.time_major)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(Layer):
    """A stack of built-in cells, one or two directions a layer; states
    [num_layers * directions, B, H] (an LSTM's as (h, c)); dropout between
    layers."""

    _mode = ""
    _cell_cls: type = None

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 direction: str = "forward", time_major: bool = False,
                 dropout: float = 0.0, activation: str = "tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise InvalidArgumentError(
                "direction must be 'forward' or 'bidirect', got %r"
                % direction)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self._cells = []
        for layer_i in range(num_layers):
            in_size = input_size if layer_i == 0 \
                else hidden_size * self.num_directions
            for d in range(self.num_directions):
                kw = dict(weight_ih_attr=weight_ih_attr,
                          weight_hh_attr=weight_hh_attr,
                          bias_ih_attr=bias_ih_attr,
                          bias_hh_attr=bias_hh_attr, device=device,
                          generator=generator)
                if self._mode == "simple":
                    kw["activation"] = activation
                cell = self._cell_cls(in_size, hidden_size, **kw)
                self.add_module("cell_l%d%s" % (layer_i,
                                                "_reverse" if d else ""),
                                cell)
                self._cells.append(cell)

    def _cell(self, layer_i, direction):
        return self._cells[layer_i * self.num_directions + direction]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        nd, lstm = self.num_directions, self._mode == "lstm"
        if initial_states is None:
            init_h = init_c = None
        elif lstm:
            init_h, init_c = initial_states
        else:
            init_h, init_c = initial_states, None
        x = inputs
        final_h, final_c = [], []
        for layer_i in range(self.num_layers):
            outs = []
            for d in range(nd):
                idx = layer_i * nd + d
                if init_h is None:
                    st = None
                elif lstm:
                    st = (init_h[idx], init_c[idx])
                else:
                    st = init_h[idx]
                o, st_t = _run_layer(self._cell(layer_i, d), x, st,
                                     sequence_length, bool(d),
                                     self.time_major)
                outs.append(o)
                if lstm:
                    final_h.append(st_t[0])
                    final_c.append(st_t[1])
                else:
                    final_h.append(st_t)
            x = outs[0] if nd == 1 else torch.cat(outs, dim=-1)
            if self.dropout > 0.0 and layer_i < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        h = torch.stack(final_h)
        return (x, (h, torch.stack(final_c))) if lstm else (x, h)

    def extra_repr(self):
        return ("input_size=%d, hidden_size=%d, num_layers=%d, "
                "num_directions=%d" % (self.input_size, self.hidden_size,
                                       self.num_layers, self.num_directions))


class SimpleRNN(_RNNBase):
    _mode = "simple"
    _cell_cls = SimpleRNNCell


class LSTM(_RNNBase):
    _mode = "lstm"
    _cell_cls = LSTMCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None, generator=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, generator=generator)


class GRU(_RNNBase):
    _mode = "gru"
    _cell_cls = GRUCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None,
                 device=None, generator=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr,
                         device=device, generator=generator)

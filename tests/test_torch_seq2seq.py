"""The sequence-to-sequence path of the port against the reference on the
CPU: ``nn.functional``'s ``one_hot``, ``label_smooth`` and
``gather_tree``; ``MultiHeadAttention``'s surface (``need_weights``,
``kdim``/``vdim``, ``Cache`` grown step by step against the full forward,
``StaticCache`` against the direct cross-attention, a fully masked row);
``Transformer`` post- and pre-norm, forward and gradients with padding and
subsequent masks, its decoder's incremental caches; beam search
(``BeamSearchDecoder``/``dynamic_decode``) over a ``GRUCell`` and over a
2 + 2-layer Transformer; and the two harness models of ``chip_smoke.py``
(the Transformer-base and LSTM seq2seq wrappers) end to end at small
width: a training step's loss and gradients, and a translation.

On the CPU every dropout-free attention runs K3's plain twin; the
reference runs its composition, as its own tests do.  Weights cross with
``load_reference_params``; inputs are made with numpy from a seed.
Tolerances, fp32, relative to each array's largest magnitude (at least
1): attention and layer outputs 1e-5; Transformer and harness gradients
1e-4 (sums over every position of 2 + 2 layers); losses 1e-5 relative.
Beam searches are held by ``chip_smoke.beam_agreement``: each sentence's
picks must agree up to its first step whose K-th and (K+1)-th best
candidates lie within ``BEAM_MARGIN_FLOOR`` (1e-4) of each other
(``torch.topk`` and ``lax.top_k`` need not order near-ties alike), and
each step's scores agree within 1e-3 + 1e-5 |score| wherever both took
the same path.
"""
import importlib.util
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn import functional as RF
from paddle_tpu.nn.functional import common as rcommon

import paddle_tpu_torch as ptt
from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch.nn import functional as F

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TOL = 1e-5
GRAD_TOL = 1e-4
# the small widths of the end-to-end checks
SMALL_TF = dict(vocab=50, d_model=32, nhead=2, layers=2, d_ff=64,
                dropout=0.0)
SMALL_LSTM = dict(src_vocab=40, trg_vocab=30, embed=16, hidden=16,
                  layers=2, dropout=0.0, init_scale=0.1)


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _arrays(ref) -> dict:
    return {n: np.asarray(p.value) for n, p in ref.named_parameters()}


def _v(t):
    return np.asarray(t.value if hasattr(t, "value") else t)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the sequence functions ------------------------------------------------


def test_one_hot_and_label_smooth():
    ids = np.array([[0, 3, 4], [2, -1, 5]], np.int64)
    want = _v(rcommon.one_hot(jnp.asarray(ids), 5))
    got = F.one_hot(_t(ids), 5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    prior = _rng("prior").dirichlet(np.ones(5)).astype(np.float32)
    for p in (None, prior):
        w = _v(rcommon.label_smooth(jnp.asarray(want), None if p is None
                                    else jnp.asarray(p), 0.1))
        g = F.label_smooth(got, None if p is None else _t(p), 0.1)
        _close(g.numpy(), w, 1e-7)


@pytest.mark.parametrize("t,b,k", [(1, 1, 1), (5, 2, 3), (7, 3, 4)])
def test_gather_tree(t, b, k):
    rng = _rng("tree", t, b, k)
    ids = rng.randint(0, 20, (t, b, k)).astype(np.int64)
    parents = rng.randint(0, k, (t, b, k)).astype(np.int64)
    want = _v(rcommon.gather_tree(jnp.asarray(ids), jnp.asarray(parents)))
    got = F.gather_tree(_t(ids), _t(parents))
    np.testing.assert_array_equal(got.numpy(), want)


# -- MultiHeadAttention ------------------------------------------------------


def _mha_pair(seed=0, **kw):
    pt.seed(seed)
    ref = pt.nn.MultiHeadAttention(16, 2, **kw)
    port = ptt.nn.MultiHeadAttention(16, 2, **kw, device="cpu")
    load_reference_params(port, _arrays(ref))
    ref.eval()
    port.eval()
    return ref, port


def test_mha_cache_decode_matches_full_forward():
    """A ``Cache`` grown a token at a time: every step's output equals the
    reference's step, and the last equals the full forward's last row."""
    ref, port = _mha_pair()
    x = _rng("cache").randn(2, 5, 16).astype(np.float32)
    full = port(_t(x)).detach().numpy()
    _close(full, _v(ref(pt.to_tensor(x))))
    r_cache = ref.gen_cache(pt.to_tensor(x[:, :0]))
    p_cache = port.gen_cache(_t(x[:, :0]))
    assert isinstance(p_cache, ptt.nn.MultiHeadAttention.Cache)
    assert tuple(p_cache.k.shape) == (2, 2, 0, 8)
    with torch.no_grad():
        for i in range(5):
            step = x[:, i:i + 1]
            r_out, r_cache = ref(pt.to_tensor(step), None, None, None,
                                 r_cache)
            p_out, p_cache = port(_t(step), None, None, None, p_cache)
            _close(p_out.numpy(), _v(r_out))
    assert tuple(p_cache.k.shape) == (2, 2, 5, 8)
    _close(p_out.numpy()[:, 0], full[:, -1])
    # a Cache given its own tensors is used as given
    given = port.gen_cache(p_cache.k, p_cache.v)
    assert given.k is p_cache.k


def test_mha_static_cache_and_need_weights():
    """``StaticCache`` is the memory's projections made once: attending it
    equals the direct cross-attention (with a padding mask); with
    ``need_weights`` the weights come back as None."""
    ref, port = _mha_pair(need_weights=True)
    rng = _rng("static")
    q = rng.randn(2, 3, 16).astype(np.float32)
    mem = rng.randn(2, 6, 16).astype(np.float32)
    mask = cs._pad_bias([6, 2], 6)
    r_out, r_w = ref(pt.to_tensor(q), pt.to_tensor(mem), pt.to_tensor(mem),
                     pt.to_tensor(mask))
    with torch.no_grad():
        p_out, p_w = port(_t(q), _t(mem), _t(mem), _t(mask))
        static = port.gen_cache(_t(mem), _t(mem),
                                type=ptt.nn.MultiHeadAttention.StaticCache)
        s_out, s_w = port(_t(q), None, None, _t(mask), static)
        c_out, c_w, cache = port(_t(q[:, :1]), None, None, None,
                                 port.gen_cache(_t(q[:, :0])))
    assert p_w is None and s_w is None and r_w is None and c_w is None
    assert isinstance(cache, ptt.nn.MultiHeadAttention.Cache)
    _close(p_out.numpy(), _v(r_out))
    _close(s_out.numpy(), p_out.numpy())


def test_mha_kdim_vdim_and_gradients():
    ref, port = _mha_pair(kdim=6, vdim=5)
    assert tuple(port.k_proj.weight.shape) == (6, 16)
    assert tuple(port.v_proj.weight.shape) == (5, 16)
    rng = _rng("kv")
    q = rng.randn(2, 3, 16).astype(np.float32)
    k = rng.randn(2, 4, 6).astype(np.float32)
    v = rng.randn(2, 4, 5).astype(np.float32)
    r_out = ref(pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v))
    r_out.sum().backward()
    p_out = port(_t(q), _t(k), _t(v))
    p_out.sum().backward()
    _close(p_out.detach().numpy(), _v(r_out))
    for n, p in ref.named_parameters():
        _close(dict(port.named_parameters())[n].grad.numpy(), _v(p.grad))


def test_mha_fully_masked_row():
    """A row whose every key carries the -1e9 padding bias: the scores
    round to the bias alone, so the row attends uniformly, in the port's
    twin as in the reference's composition."""
    ref, port = _mha_pair()
    x = _rng("fullpad").randn(3, 4, 16).astype(np.float32)
    mask = cs._pad_bias([4, 0, 2], 4)
    with torch.no_grad():
        got = port(_t(x), attn_mask=_t(mask)).numpy()
    _close(got, _v(ref(pt.to_tensor(x), attn_mask=pt.to_tensor(mask))))
    v = x[1] @ port.v_proj.weight.detach().numpy() \
        + port.v_proj.bias.detach().numpy()
    uniform = v.mean(axis=0) @ port.out_proj.weight.detach().numpy() \
        + port.out_proj.bias.detach().numpy()
    _close(got[1], np.broadcast_to(uniform, got[1].shape))


# -- Transformer -------------------------------------------------------------


def _transformer_pair(normalize_before, seed=0, **kw):
    pt.seed(seed)
    ref = pt.nn.Transformer(16, 2, 2, 2, 32, dropout=0.0,
                            normalize_before=normalize_before, **kw)
    port = ptt.nn.Transformer(16, 2, 2, 2, 32, dropout=0.0,
                              normalize_before=normalize_before, **kw,
                              device="cpu")
    load_reference_params(port, _arrays(ref))
    return ref, port


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_forward_and_gradients(normalize_before):
    ref, port = _transformer_pair(normalize_before)
    names = [n for n, _ in port.named_parameters()]
    assert ("decoder.norm.weight" in names) == normalize_before
    assert "decoder.layers.1.cross_attn.v_proj.bias" in names
    rng = _rng("tf", normalize_before)
    src = rng.randn(2, 5, 16).astype(np.float32)
    tgt = rng.randn(2, 4, 16).astype(np.float32)
    src_mask = cs._pad_bias([5, 3], 5)
    tgt_mask = _v(ref.generate_square_subsequent_mask(4))
    np.testing.assert_array_equal(
        port.generate_square_subsequent_mask(4).numpy(), tgt_mask)
    cot = rng.randn(2, 4, 16).astype(np.float32)
    r_src = pt.to_tensor(src, stop_gradient=False)
    r_out = ref(r_src, pt.to_tensor(tgt), pt.to_tensor(src_mask),
                pt.to_tensor(tgt_mask), pt.to_tensor(src_mask))
    (r_out * pt.to_tensor(cot)).sum().backward()
    p_src = _t(src).requires_grad_()
    p_out = port(p_src, _t(tgt), _t(src_mask), _t(tgt_mask), _t(src_mask))
    (p_out * _t(cot)).sum().backward()
    _close(p_out.detach().numpy(), _v(r_out))
    _close(p_src.grad.numpy(), _v(r_src.grad), GRAD_TOL)
    got = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        _close(got[n].grad.numpy(), _v(p.grad), GRAD_TOL)


def test_transformer_layers_surface():
    """``_clone_args`` builds the siblings as the reference does;
    ``attn_dropout``/``act_dropout`` default to ``dropout``; a custom
    encoder or decoder takes the default's place."""
    layer = ptt.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.2,
                                           act_dropout=0.3, device="cpu")
    assert layer.self_attn.dropout == 0.2 and layer.dropout.p == 0.3
    enc = ptt.nn.TransformerEncoder(layer, 3,
                                    ptt.nn.LayerNorm(16, device="cpu"))
    assert len(enc.layers) == 3
    for sib in enc.layers[1:]:
        assert sib.self_attn.dropout == 0.2 and sib.dropout.p == 0.3
        assert sib.linear1.out_features == 32
    dec = ptt.nn.TransformerDecoder(
        ptt.nn.TransformerDecoderLayer(16, 2, 32, attn_dropout=0.0,
                                       normalize_before=True,
                                       device="cpu"), 2)
    assert dec.layers[1].normalize_before and \
        dec.layers[1].cross_attn.dropout == 0.0
    model = ptt.nn.Transformer(16, 2, custom_encoder=enc,
                               custom_decoder=dec, device="cpu")
    assert model.encoder is enc and model.decoder is dec
    zipped = dec.gen_cache(torch.zeros(2, 3, 16), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert all(isinstance(c, ptt.nn.MultiHeadAttention.StaticCache)
               for c in zipped[1])


def test_decoder_incremental_caches_match_full_decode():
    """The decoder run a token at a time over ``gen_cache``'s caches
    equals the reference's run, and its last rows the full (masked)
    forward's."""
    ref, port = _transformer_pair(True, seed=1)
    ref.eval()
    port.eval()
    rng = _rng("incr")
    src = rng.randn(2, 5, 16).astype(np.float32)
    tgt = rng.randn(2, 4, 16).astype(np.float32)
    src_mask = cs._pad_bias([5, 2], 5)
    with torch.no_grad():
        memory = port.encoder(_t(src), _t(src_mask))
        full = port.decoder(_t(tgt), memory,
                            port.generate_square_subsequent_mask(4),
                            _t(src_mask)).numpy()
        caches = port.decoder.gen_cache(memory)
    r_memory = ref.encoder(pt.to_tensor(src), pt.to_tensor(src_mask))
    _close(memory.numpy(), _v(r_memory))
    r_caches = ref.decoder.gen_cache(r_memory)
    for i in range(4):
        step = tgt[:, i:i + 1]
        with torch.no_grad():
            p_out, caches = port.decoder(_t(step), memory, None,
                                         _t(src_mask), caches)
        r_out, r_caches = ref.decoder(pt.to_tensor(step), r_memory, None,
                                      pt.to_tensor(src_mask), r_caches)
        _close(p_out.numpy(), _v(r_out))
        _close(p_out.numpy()[:, 0], full[:, i])


# -- beam search -------------------------------------------------------------


def _ref_run_beam(cell, inits, beam, max_steps):
    """The reference's ``dynamic_decode`` of a ``BeamSearchDecoder`` over
    ``cell`` (which leaves its logits in ``cell.logits``), recorded as
    ``chip_smoke._run_beam`` records the port's search."""
    steps = []

    class Recording(pt.nn.BeamSearchDecoder):
        def step(self, time, inputs, states, **kw):
            out = super().step(time, inputs, states, **kw)
            steps.append((out[0], cs.beam_margins(
                torch.from_numpy(np.array(_v(cell.logits))),
                torch.from_numpy(np.array(states["log_probs"])),
                torch.from_numpy(np.array(states["finished"])), beam,
                cs.S2S_EOS)))
            return out

    dec = Recording(cell, cs.S2S_BOS, cs.S2S_EOS, beam)
    ids, final = pt.nn.dynamic_decode(dec, inits=inits,
                                      max_step_num=max_steps)
    record = {k: np.stack([np.asarray(o[k]) for o, _ in steps], axis=1)
              for k in ("predicted_ids", "parent_ids", "scores")}
    record["margins"] = np.stack([m.numpy() for _, m in steps], axis=1)
    return _v(ids), np.asarray(final["log_probs"]), record


def _gru_cells(seed):
    pt.seed(seed)
    r_emb, r_gru, r_out = (pt.nn.Embedding(12, 8), pt.nn.GRUCell(8, 16),
                           pt.nn.Linear(16, 12))
    p_emb = ptt.nn.Embedding(12, 8, device="cpu")
    p_gru = ptt.nn.GRUCell(8, 16, device="cpu")
    p_out = ptt.nn.Linear(16, 12, device="cpu")
    for r, p in ((r_emb, p_emb), (r_gru, p_gru), (r_out, p_out)):
        load_reference_params(p, _arrays(r))

    def ref_cell(ids, h):
        out, h = r_gru(r_emb(ids), h)
        ref_cell.logits = r_out(out)
        return ref_cell.logits, h

    def port_cell(ids, h):
        out, h = p_gru(p_emb(ids), h)
        port_cell.logits = p_out(out)
        return port_cell.logits, h

    return ref_cell, port_cell


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_gru(beam):
    """Beam search over a GRU cell (``test_functional_extras``' case):
    ids, scores and lengths against the reference's, margin-gated; the
    outputs are [B, T, K] (or time-major), the lengths count each beam's
    tokens up to its end token."""
    ref_cell, port_cell = _gru_cells(7)
    h0 = _rng("gru", beam).randn(2, 16).astype(np.float32)
    r_ids, r_scores, r_rec = _ref_run_beam(ref_cell, pt.to_tensor(h0),
                                           beam, 6)
    p_ids, p_scores, p_rec = cs._run_beam(port_cell, _t(h0), beam, 6, 2)
    agree = cs.beam_agreement(p_rec, r_rec)
    assert agree["sentences_gated_throughout"] >= 1, agree
    gated = r_rec["margins"].min(axis=1) > cs.BEAM_MARGIN_FLOOR
    np.testing.assert_array_equal(p_ids.numpy()[gated], r_ids[gated])
    _close(p_scores.numpy()[gated], r_scores[gated], 1e-5)
    dec = ptt.nn.BeamSearchDecoder(port_cell, 0, 1, beam)
    ids_tm, _, lens = ptt.nn.dynamic_decode(dec, inits=_t(h0),
                                            max_step_num=6,
                                            output_time_major=True,
                                            return_length=True)
    assert tuple(ids_tm.shape) == (p_ids.shape[1], 2, beam)
    np.testing.assert_array_equal(ids_tm.movedim(0, 1).numpy(),
                                  p_ids.numpy())
    ref_dec = pt.nn.BeamSearchDecoder(ref_cell, 0, 1, beam)
    _, _, r_lens = pt.nn.dynamic_decode(ref_dec, inits=pt.to_tensor(h0),
                                        max_step_num=6, return_length=True)
    np.testing.assert_array_equal(lens.numpy()[gated], _v(r_lens)[gated])


def test_beam_search_greedy_and_backstop():
    """Beam 1 is the greedy rollout (finished rows emit only the end
    token); a decoder that never finishes stops at the backstop."""
    _, port_cell = _gru_cells(8)
    h0 = _t(_rng("greedy").randn(2, 16).astype(np.float32))
    ids, _ = ptt.nn.dynamic_decode(ptt.nn.BeamSearchDecoder(
        port_cell, 0, 1, 1), inits=h0, max_step_num=6)
    tok, h, want, done = torch.zeros(2, dtype=torch.int64), h0, [], \
        torch.zeros(2, dtype=torch.bool)
    with torch.no_grad():
        for _ in range(ids.shape[1]):
            logits, h = port_cell(tok, h)
            tok = torch.where(done, 1, logits.argmax(-1))
            done = done | (tok == 1)
            want.append(tok)
    np.testing.assert_array_equal(ids[:, :, 0].numpy(),
                                  torch.stack(want, 1).numpy())

    class Forever(ptt.nn.Decoder):
        def initialize(self, inits):
            return None, None, torch.zeros(1, dtype=torch.bool)

        def step(self, time, inputs, states, **kw):
            return {}, None, None, torch.zeros(1, dtype=torch.bool)

    with pytest.raises(ptt.InvalidArgumentError):
        ptt.nn.dynamic_decode(Forever())
    with pytest.raises(ptt.InvalidArgumentError):
        ptt.nn.BeamSearchDecoder(port_cell, 0, 1, 0)


# -- the harness models ------------------------------------------------------


class _RefTransformerSeq2Seq(pt.nn.Layer):
    """The reference's counterpart of ``chip_smoke``'s
    ``TransformerSeq2Seq`` (same parameter names), fed numpy ids."""

    def __init__(self, vocab, d_model, nhead, layers, d_ff, dropout):
        super().__init__()
        self.d_model = d_model
        self.embedding = pt.nn.Embedding(vocab, d_model,
                                         padding_idx=cs.S2S_PAD)
        self.transformer = pt.nn.Transformer(
            d_model, nhead, layers, layers, d_ff, dropout,
            normalize_before=True)
        self._pos = cs.sinusoid_table(256, d_model)

    def embed(self, ids, positions=None):
        if positions is None:
            positions = (ids != cs.S2S_PAD) * np.arange(ids.shape[1])
        return self.embedding(pt.to_tensor(ids)) * self.d_model ** 0.5 \
            + pt.to_tensor(self._pos[positions])

    def encode(self, src):
        bias = np.where((src == cs.S2S_PAD)[:, None, None, :], -1e9, 0.0) \
            .astype(np.float32)
        return self.transformer.encoder(self.embed(src),
                                        pt.to_tensor(bias)), bias

    def forward(self, src, trg):
        memory, bias = self.encode(src)
        mask = self.transformer.generate_square_subsequent_mask(
            trg.shape[1])
        out = self.transformer.decoder(self.embed(trg), memory, mask,
                                       pt.to_tensor(bias))
        return pt.matmul(out, self.embedding.weight, transpose_y=True)

    def translate(self, src, beam, max_steps):
        """The reference's ``BeamSearchDecoder`` cannot tile an empty
        ``Cache`` (a zero-size reshape by -1), so the cell makes the
        self-attention's empty caches at its first step, at B*K rows."""
        memory, bias = self.encode(src)
        layers = self.transformer.decoder.layers
        static = [c[1] for c in self.transformer.decoder.gen_cache(memory)]
        tiled = pt.to_tensor(np.repeat(bias, beam, axis=0))

        def cell(ids, states):
            ids = np.asarray(ids.value)[:, None]
            incr = states["incr"]
            if incr is None:
                incr = [layer.self_attn.gen_cache(pt.to_tensor(
                    np.zeros(ids.shape + (self.d_model,), np.float32)))
                    for layer in layers]
            t = int(np.shape(_v(incr[0].k))[2])
            out, caches = self.transformer.decoder(
                self.embed(ids, np.full_like(ids, t)), None, None, tiled,
                list(zip(incr, states["static"])))
            cell.logits = pt.matmul(out[:, -1], self.embedding.weight,
                                    transpose_y=True)
            return cell.logits, {"incr": [c[0] for c in caches],
                                 "static": [c[1] for c in caches]}
        return _ref_run_beam(cell, {"incr": None, "static": static}, beam,
                             max_steps)


class _RefAttentionCell(pt.nn.RNNCellBase):
    def __init__(self, embed, hidden, layers):
        super().__init__()
        self.lstm_cells = pt.nn.LayerList(
            [pt.nn.LSTMCell(embed + hidden if i == 0 else hidden, hidden)
             for i in range(layers)])
        self.input_proj = pt.nn.Linear(hidden, hidden, bias_attr=False)
        self.output_proj = pt.nn.Linear(2 * hidden, hidden, bias_attr=False)
        self.memory = self.memory_bias = None

    def forward(self, step_input, states):
        lstm_states, input_feed = states
        x = pt.concat([step_input, input_feed], axis=-1)
        new_states = []
        for cell, st in zip(self.lstm_cells, lstm_states):
            x, st = cell(x, st)
            new_states.append(st)
        q = pt.unsqueeze(self.input_proj(x), 1)
        scores = pt.matmul(q, self.memory, transpose_y=True) \
            + self.memory_bias
        ctx = pt.squeeze(pt.matmul(RF.softmax(scores, axis=-1),
                                   self.memory), 1)
        out = pt.tanh(self.output_proj(pt.concat([ctx, x], axis=-1)))
        return out, [new_states, out]


class _RefLSTMSeq2Seq(pt.nn.Layer):
    """The reference's counterpart of ``chip_smoke``'s ``LSTMSeq2Seq``."""

    def __init__(self, src_vocab, trg_vocab, embed, hidden, layers, **_):
        super().__init__()
        self.hidden = hidden
        self.src_embedding = pt.nn.Embedding(src_vocab, embed)
        self.encoder = pt.nn.LSTM(embed, hidden, layers)
        self.trg_embedding = pt.nn.Embedding(trg_vocab, embed)
        self.decoder = pt.nn.RNN(_RefAttentionCell(embed, hidden, layers))
        self.output = pt.nn.Linear(hidden, trg_vocab, bias_attr=False)

    def encode(self, src, src_len):
        out, (h, c) = self.encoder(self.src_embedding(pt.to_tensor(src)),
                                   sequence_length=pt.to_tensor(src_len))
        bias = cs._pad_bias(src_len, src.shape[1])[:, 0]
        states = [[(h[i], c[i]) for i in range(np.shape(h.value)[0])],
                  pt.to_tensor(np.zeros((src.shape[0], self.hidden),
                                        np.float32))]
        return out, bias, states

    def forward(self, src, src_len, trg):
        memory, bias, states = self.encode(src, src_len)
        cell = self.decoder.cell
        cell.memory, cell.memory_bias = memory, pt.to_tensor(bias)
        out, _ = self.decoder(self.trg_embedding(pt.to_tensor(trg)), states)
        return self.output(out)

    def translate(self, src, src_len, beam, max_steps):
        memory, bias, states = self.encode(src, src_len)
        dec_cell = self.decoder.cell
        dec_cell.memory = pt.to_tensor(np.repeat(_v(memory), beam, axis=0))
        dec_cell.memory_bias = pt.to_tensor(np.repeat(bias, beam, axis=0))

        def cell(ids, st):
            out, st = dec_cell(self.trg_embedding(ids), st)
            cell.logits = self.output(out)
            return cell.logits, st
        return _ref_run_beam(cell, states, beam, max_steps)


def _ref_label_smoothed_ce(logits, label, epsilon):
    weights = (label != cs.S2S_PAD).astype(np.float32)
    soft = RF.label_smooth(RF.one_hot(pt.to_tensor(label),
                                      np.shape(logits.value)[-1]),
                           epsilon=epsilon)
    cost = RF.cross_entropy(logits, soft, soft_label=True, reduction="none")
    return (cost * pt.to_tensor(weights)).sum() / float(weights.sum())


def _ref_masked_token_ce(logits, label):
    cost = RF.cross_entropy(logits, pt.to_tensor(label), reduction="none")
    mask = pt.to_tensor((label != cs.S2S_PAD).astype(np.float32))
    return (cost * mask).mean(axis=0).sum()


def _harness_pair(kind):
    pt.seed(11)
    if kind == "transformer":
        ref = _RefTransformerSeq2Seq(**SMALL_TF)
        port = cs.s2s_models()["transformer"](**SMALL_TF, device="cpu")
    else:
        ref = _RefLSTMSeq2Seq(**SMALL_LSTM)
        port = cs.s2s_models()["lstm"](**SMALL_LSTM, device="cpu")
    load_reference_params(port, _arrays(ref))
    return ref, port


def _check_grads(ref, port):
    got = dict(port.named_parameters())
    assert set(got) == {n for n, _ in ref.named_parameters()}
    for n, p in ref.named_parameters():
        _close(got[n].grad.numpy(), _v(p.grad), GRAD_TOL)


def test_transformer_harness_train_step_and_translation():
    """The Transformer-base wrapper at small width: the label-smoothed
    loss (one-hot, ``label_smooth``, soft-label cross entropy over the
    non-pad tokens) and every gradient against the reference's; then a
    beam-4 translation against the reference's."""
    ref, port = _harness_pair("transformer")
    src, trg, label, _, _ = cs.s2s_batch(_rng("tfh"), 3, 50, 50, 3, 9, 12)
    r_loss = _ref_label_smoothed_ce(ref(src, trg), label, 0.1)
    r_loss.backward()
    p_loss = cs.label_smoothed_ce(port(_t(src), _t(trg)), _t(label), 0.1)
    p_loss.backward()
    np.testing.assert_allclose(float(p_loss.detach()), float(_v(r_loss)),
                               rtol=TOL)
    _check_grads(ref, port)
    port.eval()
    ref.eval()
    r_ids, r_scores, r_rec = ref.translate(src, 4, 5)
    p_ids, p_scores, p_rec = port.translate(_t(src), 4, 5)
    agree = cs.beam_agreement(p_rec, r_rec)
    assert agree["gated_steps"] > 0, agree


def test_lstm_harness_train_step_and_translation():
    """The LSTM seq2seq wrapper at small width: the encoder over the
    source lengths, the attention decoder with input feeding, the masked
    token loss and every gradient against the reference's, on the routes
    an eager step takes and on the step loop a capture takes; then a
    beam-3 translation against the reference's."""
    from paddle_tpu_torch.nn.layer import rnn as prnn

    ref, port = _harness_pair("lstm")
    src, trg, label, sl, _ = cs.s2s_batch(_rng("lstmh"), 3, 40, 30, 2, 5,
                                          6)
    sl = sl.astype(np.int64)
    r_loss = _ref_masked_token_ce(ref(src, sl, trg), label)
    r_loss.backward()
    for route in ("auto", "loop"):
        saved = prnn._route
        if route == "loop":
            prnn._route = lambda *a: "loop"
        try:
            port.zero_grad()
            p_loss = cs.masked_token_ce(port(_t(src), _t(sl), _t(trg)),
                                        _t(label))
            p_loss.backward()
        finally:
            prnn._route = saved
        np.testing.assert_allclose(float(p_loss.detach()),
                                   float(_v(r_loss)), rtol=TOL)
        _check_grads(ref, port)
    port.eval()
    ref.eval()
    r_ids, r_scores, r_rec = ref.translate(src, sl, 3, 5)
    p_ids, p_scores, p_rec = port.translate(_t(src), _t(sl), 3, 5)
    cs.beam_agreement(p_rec, r_rec)

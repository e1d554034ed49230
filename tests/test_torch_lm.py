"""The port's ``TransformerLM`` against the reference on the same weights.

Logits agree within atol 1e-4 / rtol 1e-4 in fp32: the two frameworks
take their matmul sums in different orders.  Cached prefill + decode is
held for the dense and paged layouts, with an aligned (scalar) and a
slot-batched ([B]) cache index.  ``load_reference_params`` refuses any
missing, extra or mis-shaped name.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import gpt_1p3b_config as ref_gpt_1p3b_config
from torch_parity import build_pair, port_logits, ref_logits

from paddle_tpu_torch import InvalidArgumentError, load_reference_params
from paddle_tpu_torch import TransformerLM, gpt_1p3b_config

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("normalize_before", [True, False],
                         ids=["pre-norm", "post-norm"])
def test_uncached_logits_match_reference(normalize_before):
    ref, port = build_pair(seed=1, normalize_before=normalize_before)
    ids = np.random.RandomState(0).randint(0, 512, (2, 12))
    np.testing.assert_allclose(port_logits(port, ids), ref_logits(ref, ids),
                               **TOL)


def _ref_cached(ref, ids, cache, split):
    logits, cache = ref(pt.to_tensor(ids[:, :split].astype(np.int32)),
                        cache=cache)
    parts = [np.asarray(logits.value)]
    for t in range(split, ids.shape[1]):
        logits, cache = ref(pt.to_tensor(ids[:, t:t + 1].astype(np.int32)),
                            cache=cache)
        parts.append(np.asarray(logits.value))
    return np.concatenate(parts, axis=1)


def _port_cached(port, ids, cache, split):
    with torch.no_grad():
        logits, cache = port(torch.from_numpy(ids[:, :split]), cache=cache)
        parts = [logits.numpy()]
        for t in range(split, ids.shape[1]):
            logits, cache = port(torch.from_numpy(ids[:, t:t + 1]),
                                 cache=cache)
            parts.append(logits.numpy())
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("per_slot", [False, True], ids=["aligned",
                                                         "slot-batched"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cached_prefill_decode_logits_match_reference(pair, layout,
                                                      per_slot):
    ref, port = pair
    ids = np.random.RandomState(1).randint(0, 512, (2, 12)).astype(np.int64)
    kw = dict(per_slot=per_slot, layout=layout, block_size=8)
    want = _ref_cached(ref, ids, ref.gen_decode_cache(2, 32, **kw), 8)
    got = _port_cached(port, ids, port.gen_decode_cache(2, 32, **kw), 8)
    np.testing.assert_allclose(got, want, **TOL)
    # and both equal the uncached forward
    np.testing.assert_allclose(got, ref_logits(ref, ids), **TOL)


def test_load_reference_params_refuses_mismatches(pair):
    ref, _ = pair
    arrays = {n: np.asarray(p.value) for n, p in ref.named_parameters()}
    port = TransformerLM(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, intermediate_size=128,
                         max_position=128, device="cpu", seed=3)
    before = port.final_norm.bias.detach().clone()
    missing = dict(arrays)
    del missing["final_norm.weight"]
    extra = dict(arrays, **{"encoder.layers.2.linear1.bias":
                            np.zeros(128, np.float32)})
    shaped = dict(arrays)
    shaped["encoder.layers.0.linear1.weight"] = np.zeros((128, 64),
                                                         np.float32)
    for bad, what in ((missing, "final_norm.weight"),
                      (extra, "encoder.layers.2.linear1.bias"),
                      (shaped, "encoder.layers.0.linear1.weight")):
        with pytest.raises(InvalidArgumentError, match=what):
            load_reference_params(port, bad)
    # a refused load copies nothing
    torch.testing.assert_close(port.final_norm.bias.detach(), before)
    load_reference_params(port, arrays)
    np.testing.assert_array_equal(
        port.encoder.layers[1].self_attn.q_proj.weight.detach().numpy(),
        arrays["encoder.layers.1.self_attn.q_proj.weight"])


def test_parameter_layout_and_config_match_reference(pair):
    ref, port = pair
    ref_shapes = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    port_shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert port_shapes == ref_shapes
    # Paddle's Linear layout [in, out], not torch's [out, in]
    assert port_shapes["encoder.layers.0.linear1.weight"] == (64, 128)
    assert gpt_1p3b_config() == ref_gpt_1p3b_config()


def test_weights_are_seeded():
    kw = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
              max_position=16, device="cpu")
    a, b, c = (TransformerLM(seed=s, **kw) for s in (0, 0, 1))
    wa, wb, wc = (m.word_embeddings.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    with pytest.raises(InvalidArgumentError):
        TransformerLM(causal=False, **kw).gen_decode_cache(1, 8)

"""The port's ``flash_attention`` (kernel K3; its plain twins on the CPU)
and ``scaled_dot_product_attention`` routing against the reference.

On the CPU the reference's ``flash_attention`` takes its composition
(``_reference_attention``); the port's goes through
``FlashAttentionFunction``, whose forward and backward are K3's twins --
the backward written out from the saved statistics, not autograd through
the forward.  Inputs are made with numpy and handed to both.

Tolerances: fp32 forward 1e-5 and gradients 1e-4, absolute (the two
frameworks sum in other orders); bf16 2e-2 absolute plus 2e-2 relative on
the forward and 6e-2 on the gradients: the reference computes scores,
softmax and every gradient product in bf16 (a few bf16 ulps of a value
near 1 are 2e-2), the twin in fp32 with one rounding at the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as ref_F
from paddle_tpu.ops.flash_attention import flash_attention as ref_flash

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_kernels as fk

FWD_TOL = {"float32": dict(rtol=0, atol=1e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = {"float32": dict(rtol=0, atol=1e-4),
            "bfloat16": dict(rtol=6e-2, atol=6e-2)}
B, H, D = 2, 3, 16

CASES = {
    "plain": dict(),
    "causal": dict(causal=True),
    "causal-lq-ne-lk": dict(causal=True, lq=7, lk=11),
    "bias-full": dict(bias=(B, H, 9, 9)),
    "bias-bcast": dict(bias=(1, 1, 9, 9), causal=True),
    "bias-2d-lq-ne-lk": dict(bias=(6, 10), lq=6, lk=10),
    "key-padding": dict(pad=True),
    "segments": dict(seg=True, causal=True),
}


def _inputs(rng, lq=9, lk=9, bias=None, pad=False, seg=False, **_):
    x = {"q": rng.randn(B, H, lq, D), "k": rng.randn(B, H, lk, D),
         "v": rng.randn(B, H, lk, D), "g": rng.randn(B, H, lq, D)}
    if bias is not None:
        x["bias"] = rng.randn(*bias)
    if pad:
        valid = np.ones((B, lk), bool)
        valid[0, lk - 3:] = False
        valid[1, 2:] = False
        x["pad"] = valid
    if seg:
        # row 0's keys are all of another segment than its queries: every
        # key masked, so those rows attend uniformly
        qs = rng.randint(0, 2, (B, lq))
        ks = rng.randint(0, 2, (B, lk))
        ks[0] = 7
        x["seg"] = (qs.astype(np.int32), ks.astype(np.int32))
    return x


def _ref_run(x, causal, dtype):
    jd = jnp.dtype(dtype)
    args = [jnp.asarray(x[n], jd) for n in "qkv"]
    bias = jnp.asarray(x["bias"], jd) if "bias" in x else None
    kw = dict(causal=causal)
    if "pad" in x:
        kw["key_padding_mask"] = jnp.asarray(x["pad"])
    if "seg" in x:
        kw["segment_ids"] = tuple(jnp.asarray(s) for s in x["seg"])

    def loss(q, k, v, b):
        out = ref_flash(q, k, v, bias=b, **kw)
        return jnp.sum(out.astype(jnp.float32) * x["g"]), out

    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    grads, out = jax.grad(loss, argnums=argnums, has_aux=True)(*args, bias)
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port_run(x, causal, dtype):
    td = getattr(torch, dtype)
    args = [torch.tensor(x[n], dtype=td, requires_grad=True) for n in "qkv"]
    if "bias" in x:
        args.append(torch.tensor(x["bias"], dtype=td, requires_grad=True))
    kw = dict(causal=causal)
    if "pad" in x:
        kw["key_padding_mask"] = torch.from_numpy(x["pad"])
    if "seg" in x:
        kw["segment_ids"] = tuple(torch.from_numpy(s) for s in x["seg"])
    out = fa.flash_attention(*args[:3], bias=args[3] if len(args) > 3
                             else None, **kw)
    (out.float() * torch.from_numpy(x["g"]).float()).sum().backward()
    return (out.detach().float().numpy(),
            [a.grad.float().numpy() for a in args])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_reference(name, dtype, monkeypatch):
    case = CASES[name]
    x = _inputs(np.random.RandomState(len(name)), **case)
    calls = []
    apply = fk.FlashAttentionFunction.apply
    monkeypatch.setattr(fk.FlashAttentionFunction, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    want_out, want_grads = _ref_run(x, case.get("causal", False), dtype)
    got_out, got_grads = _port_run(x, case.get("causal", False), dtype)
    assert calls, "the port did not go through FlashAttentionFunction"
    np.testing.assert_allclose(got_out, want_out, **FWD_TOL[dtype])
    assert len(got_grads) == len(want_grads)
    for got, want in zip(got_grads, want_grads):
        np.testing.assert_allclose(got, want, **GRAD_TOL[dtype])


def test_fully_masked_rows_attend_uniformly():
    """A row with no visible key gives the mean of V (not 0, not NaN), and
    its stats keep log l apart from m so the backward recovers 1/Lk."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 4, 8)).float()
               for _ in range(3))
    q_seg = torch.zeros(1, 4, dtype=torch.int32)
    kv_seg = torch.ones(1, 4, dtype=torch.int32)
    o, stats = fk.flash_attention_forward_plain(q, k, v, None, q_seg, kv_seg,
                                                False, 0.5)
    torch.testing.assert_close(o, v.mean(dim=2, keepdim=True).expand_as(o))
    torch.testing.assert_close(stats[..., 1], torch.full((1, 2, 4),
                                                         float(np.log(4))))
    do = torch.ones_like(o)
    dq, dk, dv, _ = fk.flash_attention_backward_plain(
        q, k, v, o, stats, do, None, q_seg, kv_seg, False, 0.5)
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0
    torch.testing.assert_close(dv, torch.ones_like(dv))  # 4 rows x 1/4


def test_backward_twin_is_the_flash_algorithm():
    """The backward twin (from saved stats) equals autograd through the
    forward twin, so the CPU route checks the algorithm (fp32: 1e-5 for
    the summation order)."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(2, 2, 6, 8), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    bias = torch.tensor(rng.randn(2, 1, 6, 6), dtype=torch.float32,
                        requires_grad=True)
    do = torch.from_numpy(rng.randn(2, 2, 6, 8)).float()
    o, stats = fk.flash_attention_forward_plain(q, k, v, bias, None, None,
                                                True, 0.3)
    o.backward(do)
    dq, dk, dv, ds = fk.flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), o.detach(), stats.detach(), do,
        bias.detach(), None, None, True, 0.3, bias_grad=True)
    for got, want in ((dq, q.grad), (dk, k.grad), (dv, v.grad),
                      (ds.sum_to_size(bias.shape), bias.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,dtype,drop,want", [
    ((2, 4, 16, 64), torch.float32, 0.0, True),
    ((2, 4, 16, 128), torch.bfloat16, 0.0, True),
    ((2, 4, 5, 256), torch.float32, 0.0, True),
    ((2, 4, 16, 24), torch.float32, 0.0, True),
    ((2, 4, 16, 12), torch.float32, 0.0, False),   # not a multiple of 8
    ((2, 4, 16, 264), torch.float32, 0.0, False),  # above 256
    ((2, 4, 16, 64), torch.float16, 0.0, False),
    ((2, 4, 16, 64), torch.float32, 0.1, False),   # dropout
    ((4, 16, 64), torch.float32, 0.0, False),      # not 4-D
])
def test_gate_is_the_kernels_structural_limits(shape, dtype, drop, want):
    assert fa.flash_attention_supported(shape, dtype, drop) is want


def _sdpa_pair(x, mask_np, is_causal=False):
    ref = ref_F.scaled_dot_product_attention(
        *[jnp.asarray(x[n], jnp.float32) for n in "qkv"],
        attn_mask=None if mask_np is None else jnp.asarray(mask_np),
        is_causal=is_causal)
    port = F.scaled_dot_product_attention(
        *[torch.from_numpy(x[n]).float() for n in "qkv"],
        attn_mask=None if mask_np is None else torch.from_numpy(mask_np),
        is_causal=is_causal)
    return np.asarray(ref), port.numpy()


def _neg_mask(allow):
    return np.where(allow, 0.0, np.finfo(np.float32).min).astype(np.float32)


@pytest.mark.parametrize("kind,flash", [
    ("causal-2d", True), ("padding-b11l", True), ("general-bias", True),
    ("is-causal", True), ("bool-mask", False), ("none", True)])
def test_sdpa_routes_and_matches_reference(kind, flash, monkeypatch):
    rng = np.random.RandomState(11)
    x = _inputs(rng)
    lq = lk = 9
    seen = []
    real = fa.flash_attention

    def spy(*a, **kw):
        seen.append((kw.get("causal"), kw.get("bias") is None,
                     kw.get("key_padding_mask") is not None))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    mask, is_causal, route = None, False, None
    if kind == "causal-2d":
        mask = _neg_mask(np.tril(np.ones((lq, lk), bool)))
        route = (True, True, False)  # causal, no bias, no padding lanes
    elif kind == "padding-b11l":
        valid = np.ones((B, 1, 1, lk), bool)
        valid[1, ..., 4:] = False
        mask = _neg_mask(valid)
        route = (False, True, True)
    elif kind == "general-bias":
        mask = rng.randn(B, 1, lq, lk).astype(np.float32)
        route = (False, False, False)
    elif kind == "is-causal":
        is_causal, route = True, (True, True, False)
    elif kind == "bool-mask":
        mask = np.tril(np.ones((lq, lk), bool))
    else:
        route = (False, True, False)
    want, got = _sdpa_pair(x, mask, is_causal)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert bool(seen) is flash
    if flash:
        assert seen == [route]


def test_detections_are_identity_cached_across_forwards(monkeypatch):
    from paddle_tpu_torch import TransformerLM

    model = TransformerLM(vocab_size=64, hidden_size=32, num_layers=3,
                          num_heads=2, max_position=32, dropout=0.0,
                          device="cpu")
    readbacks = []
    put = fa._cache_put
    monkeypatch.setattr(fa, "_cache_put",
                        lambda *a: readbacks.append(1) or put(*a))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 10)))
    with torch.no_grad():
        first = model(ids)
        n_first = len(readbacks)
        second = model(ids)
    # one readback for the model's one cached mask, none on the second
    # forward: every layer and call hits the cache
    assert n_first == 1 and len(readbacks) == 1
    assert model._causal_mask(10, torch.float32) is \
        model._causal_mask(10, torch.float32)
    torch.testing.assert_close(first, second, rtol=0, atol=0)


def test_learned_bias_is_not_claimed_as_a_mask():
    allow = torch.ones(6, 6, dtype=torch.bool).tril()
    mask = torch.where(allow, 0.0, torch.finfo(torch.float32).min)
    assert fa.detect_causal_additive_mask(mask, 6)
    learned = mask.clone().requires_grad_(True)
    assert not fa.detect_causal_additive_mask(learned, 6)
    pad = torch.zeros(2, 1, 1, 6)
    pad[0, ..., 3:] = torch.finfo(torch.float32).min
    valid = fa.detect_padding_additive_mask(pad)
    assert valid.tolist() == [[True] * 3 + [False] * 3, [True] * 6]
    assert fa.detect_padding_additive_mask(pad.clone().requires_grad_()) \
        is None
    assert fa.detect_padding_additive_mask(pad + 1.0) is None  # a bias


def test_key_padding_and_segment_ids_are_exclusive():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q,
                           key_padding_mask=torch.ones(1, 4, dtype=bool),
                           segment_ids=(torch.zeros(1, 4), torch.zeros(1, 4)))


@pytest.mark.parametrize("d,kv_heads", [(12, H), (16, 1)],
                         ids=["head-dim-12", "kv-broadcast-over-heads"])
def test_shapes_beyond_the_kernel_take_the_composition(d, kv_heads,
                                                       monkeypatch):
    """Outside K3's limits (a head_dim it does not take; k/v shared by
    every head, which the reference's einsum broadcasts) the call is the
    reference's composition, op for op (fp32, 1e-5)."""
    rng = np.random.RandomState(13)
    q = rng.randn(B, H, 9, d).astype(np.float32)
    k, v = (rng.randn(B, kv_heads, 9, d).astype(np.float32)
            for _ in range(2))
    calls = []
    monkeypatch.setattr(fk.FlashAttentionFunction, "apply",
                        lambda *a: calls.append(1))
    want = ref_flash(*map(jnp.asarray, (q, k, v)), causal=True)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert not calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _rewrite_case(rng):
    """B 2, H 2, L 8, D 16 fp32 q, k, v (the ROADMAP's reproduction)."""
    return [torch.from_numpy(rng.randn(2, 2, 8, 16).astype(np.float32))
            for _ in range(3)]


def _composition(q, k, v, mask):
    return fa._reference_attention(q, k, v, mask, False, 16 ** -0.5)


@pytest.mark.parametrize("rewrite", ["copy_", "slice"])
def test_padding_mask_rewritten_in_place_is_detected_again(rewrite):
    """F1: a [B, 1, 1, L] padding mask rewritten in place (keys 6-7 padded,
    then keys 3-7) must not keep its first verdict: the second call equals
    the composition on the rewritten mask, and the reference's SDPA."""
    q, k, v = _rewrite_case(np.random.RandomState(21))
    neg = torch.finfo(torch.float32).min
    mask = torch.zeros(2, 1, 1, 8)
    mask[..., 6:] = neg
    first = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    np.testing.assert_allclose(first.numpy(),
                               _composition(q, k, v, mask).numpy(),
                               rtol=0, atol=1e-5)
    if rewrite == "copy_":
        pad = torch.zeros(2, 1, 1, 8)
        pad[..., 3:] = neg
        mask.copy_(pad)
    else:
        mask[..., 3:] = neg
    second = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    np.testing.assert_allclose(second.numpy(),
                               _composition(q, k, v, mask).numpy(),
                               rtol=0, atol=1e-5)
    want, _ = _sdpa_pair({"q": q.numpy(), "k": k.numpy(), "v": v.numpy()},
                         mask.numpy())
    np.testing.assert_allclose(second.numpy(), want, rtol=0, atol=1e-5)
    assert fa.detect_padding_additive_mask(mask)[0].tolist() == \
        [True] * 3 + [False] * 5


def test_causal_mask_zeroed_in_place_is_detected_again():
    """F1: a causal [L, L] additive mask zeroed in place is no longer
    causal: the second call attends every key, as the composition and the
    reference's SDPA do."""
    q, k, v = _rewrite_case(np.random.RandomState(22))
    mask = torch.where(torch.ones(8, 8, dtype=torch.bool).tril(), 0.0,
                       torch.finfo(torch.float32).min)
    first = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    np.testing.assert_allclose(first.numpy(),
                               _composition(q, k, v, mask).numpy(),
                               rtol=0, atol=1e-5)
    mask.zero_()
    assert not fa.detect_causal_additive_mask(mask, 8)
    second = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    np.testing.assert_allclose(second.numpy(),
                               _composition(q, k, v, mask).numpy(),
                               rtol=0, atol=1e-5)
    want, _ = _sdpa_pair({"q": q.numpy(), "k": k.numpy(), "v": v.numpy()},
                         mask.numpy())
    np.testing.assert_allclose(second.numpy(), want, rtol=0, atol=1e-5)
    assert float((second - first).abs().max()) > 0.1  # the rewrite mattered

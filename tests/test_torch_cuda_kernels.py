"""The port's CUDA kernels against their plain twins, on the card: K1
(paged) and K2 (dense) decode attention, K3's flash-attention forward
and backward, and K4 (``scale_mul``, the custom-op door's kernel); a bf16 O2 training
step (K3 in bf16) against its CPU twin; then the captured
steps of ``jit/aot.py``: a graph captured once and replayed, launches
counted through replays, the pool's and the session's steps against
their private eager entry, the engine's background loop serving client
threads while it captures its first keys, and a failed capture raising.
Skipped without a CUDA card: the kernels have no CPU mode (the CPU runs
the twins, held against the reference by ``test_torch_decode_attention.py``,
``test_torch_flash_attention.py`` and ``test_torch_custom_op.py``).

This file imports neither JAX nor the reference package, so it also runs
on a machine that has only PyTorch; there, skip the JAX-based
``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from paddle_tpu_torch.ops import custom_kernels as ck
from paddle_tpu_torch.ops import decode_kernels as dk
from paddle_tpu_torch.ops import flash_kernels as fk
from paddle_tpu_torch.ops.flash_attention import quantize_kv

# fp32 (and int8, dequantized in fp32 by both) differ by summation order;
# a bf16 output is rounded to bf16 by both
ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, q_dtype, kv_dtype, lq, b=8, h=16, bs=32, d=128, mb=8):
    gen = torch.Generator(device=dev).manual_seed(lq)
    nb = 1 + b * mb
    q = torch.randn(b, h, lq, d, device=dev, generator=gen).to(q_dtype)
    k = torch.randn(nb, h, bs, d, device=dev, generator=gen)
    v = torch.randn(nb, h, bs, d, device=dev, generator=gen)
    k[0] = v[0] = 1e4  # poisoned scratch block
    ks = vs = None
    if kv_dtype == torch.int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    else:
        k, v = k.to(kv_dtype), v.to(kv_dtype)
    table = (torch.randperm(nb - 1, device=dev, generator=gen)[:b * mb]
             .reshape(b, mb) + 1).to(torch.int32)
    table[1, 2:] = 0  # row 1's unmapped tail: scratch
    qpos = torch.randint(0, mb * bs, (b, lq), device=dev, generator=gen)
    qpos[0] = -1  # a row that sees no key
    qpos[1] = qpos[1].clamp(max=2 * bs - 1)
    return q, k, v, table, qpos.to(torch.int32), ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [1, 4, 8])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.int8),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float16)],
    ids=["f32-f32", "f32-int8", "bf16-bf16", "f32-f16"])
def test_kernels_match_plain_twins(cuda_device, q_dtype, kv_dtype, lq):
    q, k, v, table, qpos, ks, vs = _inputs(cuda_device, q_dtype, kv_dtype,
                                           lq)
    bias = torch.randn(1, q.shape[1], lq, table.shape[1] * k.shape[2],
                       device=cuda_device) if lq == 4 else None
    before = dk.launch_counts()
    got = dk.paged_decode_attention_kernel(q, k, v, table, qpos, 0.125,
                                           ks, vs, bias)
    want = dk.paged_decode_attention_plain(q, k, v, table, qpos, 0.125,
                                           ks, vs, bias)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=ATOL[q_dtype])
    assert bool((got[0] == 0).all())
    # K2 on the same keys laid out densely
    tbl = table.long()
    b, mb = tbl.shape
    _, h, bs, d = k.shape

    def dense(x):
        return x[tbl].permute(0, 2, 1, 3, 4).reshape(b, h, mb * bs, d) \
            .contiguous()

    def dense_scale(x):
        return None if x is None else \
            x[tbl].permute(0, 2, 1, 3).reshape(b, h, mb * bs).contiguous()

    args = (q, dense(k), dense(v), qpos, 0.125, dense_scale(ks),
            dense_scale(vs), bias)
    torch.testing.assert_close(dk.decode_attention_kernel(*args).float(),
                               dk.decode_attention_plain(*args).float(),
                               rtol=0, atol=ATOL[q_dtype])
    after = dk.launch_counts()
    assert after["paged_decode_attention_kernel"] == \
        before["paged_decode_attention_kernel"] + 1
    assert after["decode_attention_kernel"] == \
        before["decode_attention_kernel"] + 1


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_they_cannot_take(cuda_device):
    q, k, v, table, qpos, _, _ = _inputs(cuda_device, torch.float32,
                                         torch.float32, 1)
    from paddle_tpu_torch import InvalidArgumentError

    with pytest.raises(InvalidArgumentError):  # int64 table
        dk.paged_decode_attention_kernel(q, k, v, table.long(), qpos, 0.1)
    with pytest.raises(InvalidArgumentError):  # fp16 queries
        dk.paged_decode_attention_kernel(q.half(), k, v, table, qpos, 0.1)
    with pytest.raises(InvalidArgumentError):  # a pool on the CPU
        dk.paged_decode_attention_kernel(q, k.cpu(), v, table, qpos, 0.1)


def _dense(x, table):
    """A pool (or its scales) gathered through ``table`` into the dense
    [B, H, S(, D)] layout K2 takes."""
    if x is None:
        return None
    tbl = table.long()
    b, mb = tbl.shape
    g = x[tbl]  # [B, MB, H, bs(, D)]
    g = g.permute(0, 2, 1, 3, 4) if g.ndim == 5 else g.permute(0, 2, 1, 3)
    return g.reshape(b, g.shape[1], -1, *g.shape[4:]).contiguous()


def _pools(dev, gen, nb, h, bs, d, kv_dtype):
    k = torch.randn(nb, h, bs, d, device=dev, generator=gen)
    v = torch.randn(nb, h, bs, d, device=dev, generator=gen)
    k[0] = v[0] = 1e4  # poisoned scratch block
    if kv_dtype == torch.int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, ks, vs
    return k.to(kv_dtype), v.to(kv_dtype), None, None


def _check_both(q, k, v, table, qpos, ks, vs, bias=None, scale=0.125):
    """K1 and K2 (on the same keys laid out densely) against their twins."""
    atol = ATOL[q.dtype]
    got = dk.paged_decode_attention_kernel(q, k, v, table, qpos, scale, ks,
                                           vs, bias)
    want = dk.paged_decode_attention_plain(q, k, v, table, qpos, scale, ks,
                                           vs, bias)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    args = (q, _dense(k, table), _dense(v, table), qpos, scale,
            _dense(ks, table), _dense(vs, table), bias)
    dgot = dk.decode_attention_kernel(*args)
    torch.testing.assert_close(dgot.float(),
                               dk.decode_attention_plain(*args).float(),
                               rtol=0, atol=atol)
    return got, dgot


# capacities that no split length divides: 600 positions at block 1 and 8,
# 19 blocks of 32 (608) at block 32
_EDGE_MB = {1: 600, 8: 75, 32: 19}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
@pytest.mark.parametrize("d", [8, 64, 128, 256])
@pytest.mark.parametrize("bs", [1, 8, 32])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_decode_split_edges(cuda_device, b, bs, d, kv_dtype):
    # every row at one context: at a split boundary (all spans full), one
    # either side, one key, and the whole capacity; row 0 sees no key when
    # B > 1, and table entries past the context point at the poisoned
    # scratch block, so splits past the context have no work
    h, mb = 16, _EDGE_MB[bs]
    s = mb * bs
    splits = dk.num_splits(b, h, s, bs)
    assert splits == dk.num_splits(b, h, s)  # paged and dense agree here
    edge = splits * 32 * max(1, s // (splits * 32 * 2))
    gen = torch.Generator(device=cuda_device).manual_seed(b * 1000 + bs + d)
    nb = 1 + b * mb
    k, v, ks, vs = _pools(cuda_device, gen, nb, h, bs, d, kv_dtype)
    q = torch.randn(b, h, 1, d, device=cuda_device, generator=gen)
    base = (torch.randperm(nb - 1, device=cuda_device, generator=gen)
            [:b * mb].reshape(b, mb) + 1).to(torch.int32)
    for ctx in sorted({edge - 1, edge, edge + 1, 1, s}):
        table = base.clone()
        table[:, -(-ctx // bs):] = 0
        qpos = torch.full((b, 1), ctx - 1, dtype=torch.int32,
                          device=cuda_device)
        if b > 1:
            qpos[0] = -1
        got, dgot = _check_both(q, k, v, table, qpos, ks, vs)
        if b > 1:
            assert bool((got[0] == 0).all()) and bool((dgot[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [1, 8])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.int8)], ids=["f32", "bf16", "int8"])
def test_decode_misaligned_bases(cuda_device, q_dtype, kv_dtype, lq):
    # pools, scales and q as contiguous views one element past a 16-byte
    # boundary: the kernels stage them by plain loads (no 16-byte copies)
    b, h, bs, d, mb = 8, 16, 32, 128, 8
    q, k, v, table, qpos, ks, vs = _inputs(cuda_device, q_dtype, kv_dtype,
                                           lq, b=b, h=h, bs=bs, d=d, mb=mb)

    def shifted(x):
        if x is None:
            return None
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 != 0 and y.is_contiguous()
        return y

    _check_both(shifted(q), shifted(k), shifted(v), table, qpos,
                shifted(ks), shifted(vs))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
@pytest.mark.parametrize("lq", [1, 8])
def test_decode_deterministic(cuda_device, kv_dtype, lq):
    # one request over a long context: 25 splits and the combine pass
    h, bs, d, mb = 16, 32, 128, 64
    gen = torch.Generator(device=cuda_device).manual_seed(lq)
    k, v, ks, vs = _pools(cuda_device, gen, 1 + mb, h, bs, d, kv_dtype)
    q = torch.randn(1, h, lq, d, device=cuda_device, generator=gen)
    table = torch.arange(1, 1 + mb, dtype=torch.int32,
                         device=cuda_device)[None]
    qpos = torch.arange(mb * bs - 100, mb * bs - 100 + lq, dtype=torch.int32,
                        device=cuda_device)[None]
    assert dk.num_splits(1, h, mb * bs, bs) == 25
    a1, d1 = _check_both(q, k, v, table, qpos, ks, vs)
    a2, d2 = _check_both(q, k, v, table, qpos, ks, vs)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)


# K3: fp32 differs from its twin by summation order (5e-5 on the gradients,
# which sum over every query or key); bf16 outputs and gradients are
# rounded to bf16 by both
FLASH_TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


def _flash_inputs(dev, dtype, b, h, lq, lk, d, bias, seg, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def heads(l):
        # as the attention layer makes them: transposed [B, L, H, D] views
        return rnd(b, l, h, d).to(dtype).transpose(1, 2)

    q, k, v, do = heads(lq), heads(lk), heads(lk), rnd(b, h, lq, d).to(dtype)
    bi = {None: None, "full": lambda: rnd(b, h, lq, lk),
          "bcast": lambda: rnd(1, 1, lq, lk),
          "pad": lambda: rnd(b, 1, 1, lk)}[bias]
    qs = ks = None
    if seg == "ids":
        qs = torch.randint(0, 2, (b, lq), device=dev, generator=gen).int()
        ks = torch.randint(0, 2, (b, lk), device=dev, generator=gen).int()
        ks[0] = 5  # batch row 0: every key masked
    elif seg == "pad":
        # the lanes flash_attention makes from a ragged key_padding_mask
        lens = torch.randint(lk // 4, lk + 1, (b,), device=dev, generator=gen)
        lens[0] = lk
        qs = torch.zeros(b, lq, dtype=torch.int32, device=dev)
        ks = (torch.arange(lk, device=dev)[None, :]
              >= lens[:, None]).to(torch.int32)
    return q, k, v, do, None if bi is None else bi(), qs, ks


def _check_flash(q, k, v, do, bi, qs, ks, causal, scale, dtype):
    """K3 forward and backward against the plain twins at FLASH_TOL (stats
    at 1e-5); returns the kernels' ``(o, stats, (dq, dk, dv, ds))``."""
    o, stats = fk.flash_attention_forward_kernel(q, k, v, bi, qs, ks, causal,
                                                 scale)
    got = fk.flash_attention_backward_kernel(q, k, v, o, stats, do, bi, qs,
                                             ks, causal, scale, bi is not None)
    torch.cuda.synchronize()
    want_o, want_stats = fk.flash_attention_forward_plain(q, k, v, bi, qs, ks,
                                                          causal, scale)
    want = fk.flash_attention_backward_plain(q, k, v, o, stats, do, bi, qs,
                                             ks, causal, scale,
                                             bi is not None)
    fwd_tol, grad_tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), rtol=0,
                               atol=fwd_tol)
    torch.testing.assert_close(stats, want_stats, rtol=0, atol=1e-5)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                       atol=grad_tol)
    return o, stats, got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,lq,lk,d,causal,bias,seg", [
    (2, 3, 100, 100, 64, True, None, None),
    (2, 3, 70, 130, 64, False, "full", None),
    (2, 3, 130, 70, 128, True, "bcast", None),
    (2, 3, 77, 77, 128, True, None, "ids"),
    (2, 2, 65, 90, 128, False, "pad", "ids"),
    (1, 2, 40, 50, 256, True, None, None),
    (1, 2, 40, 50, 24, False, None, "ids"),
    (8, 12, 512, 512, 64, False, None, "pad"),
], ids=["causal-d64", "bias-lq<lk", "bcast-lq>lk", "causal-seg",
        "pad-bias-seg", "d256", "d24-seg", "bert-key-padding"])
def test_flash_kernels_match_plain_twins(cuda_device, dtype, b, h, lq, lk,
                                         d, causal, bias, seg):
    q, k, v, do, bi, qs, ks = _flash_inputs(cuda_device, dtype, b, h, lq,
                                            lk, d, bias, seg, lq + lk)
    before = fk.launch_counts()
    o, _, _ = _check_flash(q, k, v, do, bi, qs, ks, causal, d ** -0.5, dtype)
    assert o.stride() == q.stride()  # written through q's layout
    after = fk.launch_counts()
    for name in after:
        assert after[name] == before[name] + 1


# the tile edges of every instantiation: 64-row tiles at D 64, 128-row
# owned tiles streaming 64 or 32 rows at D 128, 64/32-row tiles at D 256
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("lq,lk", [(1, 1), (63, 63), (64, 64), (65, 65),
                                   (127, 129), (128, 128), (129, 127),
                                   (1, 129), (129, 1)])
def test_flash_kernels_tile_edges(cuda_device, dtype, d, causal, lq, lk):
    q, k, v, do, _, _, _ = _flash_inputs(cuda_device, dtype, 1, 2, lq, lk, d,
                                         None, None, 1000 * lq + lk + d)
    _check_flash(q, k, v, do, None, None, None, causal, d ** -0.5, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["base+1", "row-stride"])
def test_flash_kernels_misaligned_operands(cuda_device, dtype, layout):
    """Operands whose rows do not start on 16 bytes take the kernels'
    plain-load staging: a base one element off, or a row stride of D + 1."""
    b, h, l, d = 2, 3, 80, 64
    gen = torch.Generator(device=cuda_device).manual_seed(9)

    def operand():
        if layout == "base+1":
            flat = torch.randn(b * h * l * d + 1, device=cuda_device,
                               generator=gen).to(dtype)
            t = flat[1:].view(b, h, l, d)
            assert t.data_ptr() % 16 != 0
        else:
            t = torch.randn(b, h, l, d + 1, device=cuda_device,
                            generator=gen).to(dtype)[..., :d]
            assert t.stride(2) * t.element_size() % 16 != 0
        return t

    q, k, v, do = operand(), operand(), operand(), operand()
    bias = torch.randn(b, h, l, l, device=cuda_device, generator=gen)
    for causal, bi in ((True, None), (False, bias)):
        _check_flash(q, k, v, do, bi, None, None, causal, d ** -0.5, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,bias", [(True, None), (False, "full")],
                         ids=["causal", "bias"])
def test_flash_kernels_deterministic(cuda_device, dtype, causal, bias):
    """No atomics: two calls give bit-identical outputs and gradients."""
    q, k, v, do, bi, qs, ks = _flash_inputs(cuda_device, dtype, 2, 4, 300,
                                            300, 128, bias, None, 5)
    runs = []
    for _ in range(2):
        o, stats = fk.flash_attention_forward_kernel(q, k, v, bi, qs, ks,
                                                     causal, 0.1)
        grads = fk.flash_attention_backward_kernel(
            q, k, v, o, stats, do, bi, qs, ks, causal, 0.1, bi is not None)
        runs.append((o, stats) + tuple(g for g in grads if g is not None))
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def _tf32_cut(x):
    """``x`` in fp32 with the low 13 of its 23 mantissa bits cleared: the
    10-bit mantissa of a single-pass TF32 product's operands."""
    return (x.float().view(torch.int32) & -8192).view(torch.float32)


@pytest.mark.cuda
def test_flash_fp32_is_not_single_pass_tf32(cuda_device):
    """Single-pass TF32, emulated by cutting q, k, v and P to TF32's
    mantissa, misses the fp32 tolerance on these inputs; the kernel (3xTF32)
    meets it."""
    b, h, l, d = 2, 4, 256, 128
    q, k, v, _, _, _, _ = _flash_inputs(cuda_device, torch.float32, b, h, l,
                                        l, d, None, None, 11)
    scale = d ** -0.5
    fwd_tol = FLASH_TOL[torch.float32][0]
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin in full fp32
    try:
        o, _ = fk.flash_attention_forward_kernel(q, k, v, None, None, None,
                                                 True, scale)
        want, _ = fk.flash_attention_forward_plain(q, k, v, None, None,
                                                   None, True, scale)
        s = torch.matmul(_tf32_cut(q), _tf32_cut(k).transpose(-1, -2)) * scale
        causal = torch.ones(l, l, dtype=torch.bool, device=cuda_device).tril()
        s = s.masked_fill(~causal, torch.finfo(torch.float32).min)
        tf32_o = torch.matmul(_tf32_cut(torch.softmax(s, dim=-1)),
                              _tf32_cut(v))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    assert (tf32_o - want).abs().max().item() > fwd_tol
    torch.testing.assert_close(o, want, rtol=0, atol=fwd_tol)


@pytest.mark.cuda
def test_flash_autograd_runs_the_kernels(cuda_device):
    from paddle_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, do, _, _, _ = _flash_inputs(cuda_device, torch.float32, 2, 2,
                                         64, 64, 64, None, None, 0)
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    bias = torch.randn(1, 2, 64, 64, device=cuda_device, requires_grad=True)
    before = fk.launch_counts()
    flash_attention(q, k, v, bias=bias, causal=True).backward(do)
    after = fk.launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    assert bias.grad is not None and bias.grad.shape == bias.shape


# O2 bf16 training, card against CPU: both sides round the same products
# to bf16 (cuBLAS and the CPU both accumulate in fp32; K3 and its twin
# both round P V once), so three AdamW steps part by summation order only
O2_LOSS_RTOL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "padded"])
def test_o2_bf16_train_step_matches_cpu_twin(cuda_device, causal):
    """A 2-layer model decorated O2 bf16, its loss under auto_cast(O1),
    3 TrainSteps of AdamW on the card and on the CPU from the same
    weights: the losses agree, and every K3 launch of the card run is
    bf16 (2 layers x 3 steps, forward and backward)."""
    import numpy as np

    from paddle_tpu_torch import (TrainStep, TransformerLM,
                                  TransformerLMCriterion, amp)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.RandomState(0)
    cfg = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
               intermediate_size=256, max_position=128, dropout=0.0,
               causal=causal)
    ids = torch.from_numpy(rng.randint(0, 512, (4, 128)))
    lens = torch.tensor([128, 100, 77, 64])
    valid = torch.arange(128)[None, :] < lens[:, None]
    mask = torch.where(valid, 0.0, torch.finfo(torch.float32).min)[
        :, None, None, :]
    labels = torch.where(valid, ids, -100)
    crit = TransformerLMCriterion(shift_labels=causal)

    def loss_fn(m, x, am, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(x, attn_mask=None if causal else am),
                        x if causal else y)

    losses = {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(**cfg, device=cuda_device, seed=0).to(dev)
        opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
        step = TrainStep(model, loss_fn, opt)
        fk.reset_launch_counts()
        batch = [t.to(dev) for t in (ids, mask, labels)]
        losses[dev] = [float(step(*batch)) for _ in range(3)]
        if dev == "cuda":
            counts = fk.launch_counts_by_dtype()
        assert model.word_embeddings.weight.dtype == torch.bfloat16
    torch.testing.assert_close(torch.tensor(losses["cuda"]),
                               torch.tensor(losses["cpu"]),
                               rtol=O2_LOSS_RTOL, atol=0)
    assert counts == {n: {"float32": 0, "bfloat16": 6} for n in counts}


# K4: (x * y) * 2 in fp32, rounded once to the input dtype, by both the
# kernel and its twin, so they agree bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(2,), (1,), (7,), (1_000_003,),
                                   (3, 5, 129), (2, 64, 256)])
def test_scale_mul_matches_plain_twin(cuda_device, dtype, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(len(shape))
    x = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    y = torch.randn(shape, device=cuda_device, generator=gen).to(dtype)
    before = ck.scale_mul.launches
    got = ck.scale_mul(x, y)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, ck.scale_mul_plain(x, y))
    assert ck.scale_mul.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scale_mul_misaligned_views_and_empty(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    base = torch.randn(4097, device=cuda_device, generator=gen).to(dtype)
    other = torch.randn(4097, device=cuda_device, generator=gen).to(dtype)
    x, y = base[1:], other[:-1]  # contiguous, x 2 or 4 bytes off 16
    assert x.data_ptr() % 16 != 0
    assert torch.equal(ck.scale_mul(x, y), ck.scale_mul_plain(x, y))
    strided = base[::2]  # made contiguous by the wrapper
    assert torch.equal(ck.scale_mul(strided, strided),
                       ck.scale_mul_plain(strided, strided))
    before = ck.scale_mul.launches
    empty = torch.empty(0, 3, device=cuda_device, dtype=dtype)
    got = ck.scale_mul(empty, empty)
    assert got.shape == (0, 3) and ck.scale_mul.launches == before


@pytest.mark.cuda
def test_scale_mul_refuses_what_it_cannot_take(cuda_device):
    from paddle_tpu_torch import InvalidArgumentError

    x = torch.ones(8, device=cuda_device)
    with pytest.raises(InvalidArgumentError):  # shapes differ
        ck.scale_mul(x, torch.ones(4, device=cuda_device))
    with pytest.raises(InvalidArgumentError):  # dtypes differ
        ck.scale_mul(x, x.half())
    with pytest.raises(InvalidArgumentError):  # devices differ
        ck.scale_mul(x, x.cpu())
    with pytest.raises(InvalidArgumentError):  # float64: no kernel
        ck.scale_mul(x.double(), x.double())


# -- captured steps (jit/aot.py) ------------------------------------------------
@pytest.mark.cuda
def test_aot_function_captures_once_and_replays(cuda_device):
    from paddle_tpu_torch.jit.aot import AotFunction, shape_key

    acc = torch.zeros(4, device=cuda_device)

    def step(x):
        acc.add_(x)  # a closed-over buffer, written by address
        return x * 2

    fn = AotFunction(step, shape_key, name="step", capture=True)
    x = torch.arange(4.0, device=cuda_device)
    outs = [fn(x).clone() for _ in range(3)]  # eager, capture+replay, replay
    torch.cuda.synchronize()
    assert torch.equal(acc, 3 * x), "a call ran its step twice (or never)"
    assert all(torch.equal(o, 2 * x) for o in outs)
    assert fn.compiles == 1 and fn.graphs() == 1
    x0 = x.clone()
    other = torch.full((4,), 5.0, device=cuda_device)
    assert torch.equal(fn(other), 2 * other)
    assert torch.equal(acc, 3 * x0 + other)
    assert torch.equal(x, other)  # copied into the held static input


@pytest.mark.cuda
def test_aot_function_counts_launches_through_replays(cuda_device):
    from paddle_tpu_torch.jit.aot import AotFunction

    q, k, v, table, qpos, _, _ = _inputs(cuda_device, torch.float32,
                                         torch.float32, 1)
    fn = AotFunction(lambda q_: dk.paged_decode_attention_kernel(
        q_, k, v, table, qpos, 0.125), lambda q_: "k1", name="k1",
        capture=True)
    want = dk.paged_decode_attention_plain(q, k, v, table, qpos, 0.125)
    dk.reset_launch_counts()
    for _ in range(4):
        got = fn(q)
    torch.cuda.synchronize()
    assert dk.launch_counts()["paged_decode_attention_kernel"] == 4
    torch.testing.assert_close(got, want, atol=ATOL[torch.float32], rtol=0)


def _tiny_lm(dev):
    from paddle_tpu_torch import TransformerLM

    return TransformerLM(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, intermediate_size=128, max_position=128,
                         dropout=0.0, device=dev, seed=0)


def _eager(pool, name):
    """Route one of the pool's steps through its private eager entry."""
    fn = getattr(pool, name)
    setattr(pool, name, fn._run_eager)
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kernel", [
    (dict(cache_layout="paged", block_size=8), "paged_decode_attention_kernel"),
    # 16-token chunks: past K1's 8 queries, so the chunk runs the
    # composition and every K1 launch is a decode step's
    (dict(cache_layout="paged", block_size=8, prefill_chunk_tokens=16,
          prefix_sharing=True), "paged_decode_attention_kernel"),
    ({}, "decode_attention_kernel")], ids=["paged", "chunked", "dense"])
def test_pool_steps_captured_match_eager(cuda_device, kw, kernel):
    import numpy as np

    from paddle_tpu_torch import GenerationPool

    model = _tiny_lm(cuda_device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7, 14)]

    def run(eager):
        pool = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                              device=cuda_device, **kw)
        if eager:
            _eager(pool, "_decode_fn")
            if pool._chunk_fn is not None:
                _eager(pool, "_chunk_fn")
        for i, p in enumerate(prompts):
            pool.submit(p, 6, request_id=i, temperature=0.8 * (i % 2),
                        top_k=20, seed=i)
        dk.reset_launch_counts()
        out = pool.run()
        return pool, out, dk.launch_counts()[kernel]

    pool, got, launches = run(eager=False)
    _, want, _ = run(eager=True)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert pool._decode_fn.graphs() == 1
    assert pool.compile_counts()["pool_decode"] == 1
    assert launches == 2 * pool.decode_steps_total
    if pool._chunk_fn is not None:
        assert pool._chunk_fn.graphs() == 1
        assert pool.compile_counts()["prefill_chunk"] == 1
    pool.reset()  # zeroed in place: the graphs still serve
    again = pool.generate(prompts[:2], 6)
    assert pool._decode_fn.graphs() == 1 and again[0].shape == (6,)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_session_decode_captured(cuda_device, layout):
    import numpy as np

    from paddle_tpu_torch import DecodeSession

    model = _tiny_lm(cuda_device)
    sess = DecodeSession(model, max_len=64, buckets=[16], device=cuda_device,
                         cache_layout=layout, block_size=8)
    ids = np.random.RandomState(1).randint(0, 512, (2, 9))
    dk.reset_launch_counts()
    got = sess.generate(ids, 8)
    counts = dk.launch_counts()
    assert sess.compile_counts() == {"prefill": 1, "decode": 1}
    assert sess._decode_fn.graphs() == 1
    kernel = ("paged_decode_attention_kernel" if layout == "paged"
              else "decode_attention_kernel")
    assert counts[kernel] == 2 * 7  # two layers x seven decode steps
    # the same tokens when every decode step runs eagerly
    eager = DecodeSession(model, max_len=64, buckets=[16],
                          device=cuda_device, cache_layout=layout,
                          block_size=8)
    eager._decode_fn = eager._decode_fn._run_eager
    np.testing.assert_array_equal(got, eager.generate(ids, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(cache_layout="paged", block_size=8),
    dict(cache_layout="paged", block_size=8, prefill_chunk_tokens=16)],
    ids=["paged", "chunked"])
def test_engine_loop_serves_threads_while_capturing(cuda_device, kw):
    """The background loop captures its first keys while four client
    threads submit, read their streams and poll the engine's host
    surfaces (stats, health, metrics): every device touch is under the
    engine lock, so no capture sees another thread's CUDA call, and the
    tokens equal ``pump()``'s."""
    import threading

    import numpy as np

    from paddle_tpu_torch import ServingEngine

    model = _tiny_lm(cuda_device)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7)]
    cfg = dict(max_len=64, slots=2, buckets=[32], device=cuda_device, **kw)
    pumped = ServingEngine(model, **cfg)
    streams = [pumped.submit(p, 6) for p in prompts]
    while pumped.pump(8):
        pass
    want = [s.result(timeout_s=0).tokens for s in streams]
    counts = pumped.compile_counts()

    eng = ServingEngine(model, **cfg).start()
    got = [None] * len(prompts)
    errors = []
    stop = threading.Event()

    def client(i):
        try:
            got[i] = eng.submit(prompts[i], 6).result(timeout_s=120.0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    def poller():
        while not stop.is_set():
            eng.cache_stats()
            eng.health()
            eng.metrics.render_prometheus()
            stop.wait(0.001)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    watcher = threading.Thread(target=poller)
    try:
        watcher.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
    finally:
        stop.set()
        watcher.join(timeout=30.0)
        eng.shutdown(drain=False)  # bounded: cancels what is left
    assert not any(t.is_alive() for t in threads + [watcher])
    assert not errors, errors
    for st, w in zip(got, want):
        assert st is not None and st.state == "DONE", st
        np.testing.assert_array_equal(st.tokens, w)
    assert eng.compile_counts() == counts
    assert eng.pool._decode_fn.graphs() == 1
    assert eng.health()["last_error"] is None


@pytest.mark.cuda
def test_aot_function_capture_failure_raises(cuda_device):
    # last in the file: a failed capture leaves nothing for later tests
    from paddle_tpu_torch.jit.aot import AotFunction, CaptureError

    fn = AotFunction(lambda x: x * float(x.sum().item()), lambda x: "f",
                     name="host_read", capture=True)
    x = torch.ones(3, device=cuda_device)
    fn(x)  # the eager warm-up reads the host freely
    with pytest.raises(CaptureError):
        fn(x)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kernel", [
    (dict(cache_layout="paged", block_size=8), "paged_decode_attention_kernel"),
    (dict(cache_layout="paged", block_size=8, cache_dtype="int8"),
     "paged_decode_attention_kernel"),
    (dict(cache_layout="dense"), "decode_attention_kernel"),
])
def test_speculative_pool_captured_round_matches_eager(cuda_device, kw,
                                                       kernel):
    """The speculative round's three captured steps (draft decode, verify
    at Lq = spec_k + 1, draft fixup) give the tokens of the same steps run
    eagerly and of the plain pool; one graph each, and the target's kernel
    launched once a layer a round (the draft, dense, on K2 at Lq 1)."""
    import numpy as np

    from paddle_tpu_torch import GenerationPool
    from paddle_tpu_torch.inference import SpeculativePool

    model = _tiny_lm(cuda_device)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7, 14)]

    def run(eager, draft):
        pool = SpeculativePool(model, draft, max_len=64, spec_k=3, slots=2,
                               buckets=[32], device=cuda_device, **kw)
        if eager:
            for name in ("_draft_decode_fn", "_verify_fn",
                         "_draft_fixup_fn"):
                _eager(pool, name)
        dk.reset_launch_counts()
        out = pool.generate(prompts, 9)
        return pool, out, dk.launch_counts()

    plain = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                           device=cuda_device, **kw).generate(prompts, 9)
    for draft in (model, _tiny_lm(cuda_device)):
        pool, got, counts = run(False, draft)
        _, want, _ = run(True, draft)
        for g, w, p in zip(got, want, plain):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
        rounds = pool.acceptance_stats()["rounds"]
        assert pool._verify_fn.graphs() == pool._draft_decode_fn.graphs() \
            == pool._draft_fixup_fn.graphs() == 1
        draft_k2 = 2 * 4 * rounds
        if kernel == "decode_attention_kernel":
            assert counts[kernel] == 2 * rounds + draft_k2, counts
        else:
            assert counts[kernel] == 2 * rounds, counts
            assert counts["decode_attention_kernel"] == draft_k2, counts

"""The port's CUDA kernels against their plain twins, on the card: K1
(paged) and K2 (dense) decode attention, K3's flash-attention forward
and backward, and K4 (``scale_mul``, the custom-op door's kernel); a bf16 O2 training
step (K3 in bf16) against its CPU twin; K3's forward at the sequence
models' shapes (Lq 1 included); then the captured
steps of ``jit/aot.py``: a graph captured once and replayed, launches
counted through replays, the pool's and the session's steps against
their private eager entry, the engine's background loop serving client
threads while it captures its first keys, a fleet capturing while other
threads submit and capture, a migration adopted under a warm graph
without dropping it, and a failed capture raising; a sparse embedding's
lazy Adam rows and the nan/inf check beside a captured train step; a
captured BatchNorm step advancing the running statistics once a call
(with and without recompute), and recompute's random draws under capture;
a captured LSTM step over ragged lengths (the step loop, nothing read
back), ``sequence_mask`` refusing to read its size back in a capture, a
captured step's dropout masks equal to the eager steps'; the vision
surface: ``nms`` captured into one graph, the detection ops and the
resampling functions against the CPU, and a captured MobileNetV2 step
advancing its running statistics once a call.
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
def test_fleet_captures_while_other_threads_submit_and_capture(
        cuda_device, tmp_path):
    """A fleet pumped on one thread warms up and captures its engines'
    steps while a second thread submits to the fleet and a started engine
    on the same card captures on its own loop thread: captures are
    serialized process-wide and run in thread-local capture mode, so no
    capture fails and every token equals one pumped engine's."""
    import threading

    import numpy as np

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.serving import ServingFleet

    model = _tiny_lm(cuda_device)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 512, n) for n in (5, 11, 20, 7, 9, 14)]
    cfg = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
               block_size=8, prefill_chunk_tokens=16, device=cuda_device)
    pumped = ServingEngine(model, **cfg)
    streams = [pumped.submit(p, 6) for p in prompts]
    while pumped.pump(8):
        pass
    want = [s.result(timeout_s=0).tokens for s in streams]

    fleet = ServingFleet(lambda eid, reg: ServingEngine(
        model, metrics=reg, spill_tier="disk",
        spill_dir=str(tmp_path / "s"), **cfg), engines=2)
    loop = ServingEngine(model, **cfg).start()
    errors, got, side = [], {}, {}
    first = [fleet.submit(p, 6, request_id="a%d" % i)
             for i, p in enumerate(prompts[:3])]

    def second_thread():
        try:
            later = [fleet.submit(p, 6, request_id="b%d" % i)
                     for i, p in enumerate(prompts[3:])]
            own = [loop.submit(p, 6) for p in prompts]
            for s in later:
                got[s.request_id] = s.result(timeout_s=120.0)
            for i, s in enumerate(own):
                side[i] = s.result(timeout_s=120.0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    t = threading.Thread(target=second_thread)
    try:
        t.start()
        while fleet.pump(1) or t.is_alive():
            pass
        t.join(timeout=180.0)
    finally:
        loop.shutdown(drain=False)
    assert not t.is_alive() and not errors, errors
    for i, s in enumerate(first):
        got["a%d" % i] = s.result(timeout_s=0)
    for i in range(len(prompts)):
        rid = ("a%d" % i) if i < 3 else ("b%d" % (i - 3))
        assert got[rid].state == "DONE", got[rid]
        np.testing.assert_array_equal(got[rid].tokens, want[i])
        np.testing.assert_array_equal(side[i].tokens, want[i])
    for eng in list(fleet.engines().values()) + [loop]:
        assert eng.health()["last_error"] is None
        assert eng.pool._decode_fn.graphs() == 1
    fleet.shutdown(drain=False)


@pytest.mark.cuda
def test_adopted_migration_drops_no_graph(cuda_device, tmp_path):
    """A request migrated into a warm engine is uploaded into its cache in
    place: the captured decode graph's watched tensors (weights and cache)
    have not moved (``drop_moved()`` drops nothing), no key is added, the
    K/V came from the transfer file, and the tokens are one engine's."""
    import numpy as np

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.jit.aot import cache_tensors

    model = _tiny_lm(cuda_device)
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, 512, 13)
    cfg = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
               block_size=8, prefill_chunk_tokens=16, spill_tier="disk",
               spill_dir=str(tmp_path / "s"), device=cuda_device)
    alone = ServingEngine(model, **cfg)
    want = alone.submit(prompt, 12, request_id="w")
    while alone.pump(8):
        pass
    donor, adopter = ServingEngine(model, **cfg), ServingEngine(model, **cfg)
    warm = adopter.submit(rng.randint(1, 512, 9), 4)  # capture its steps
    while adopter.pump(8):
        pass
    assert warm.result(timeout_s=0).state == "DONE"
    pool = adopter.pool
    assert pool._decode_fn.graphs() == 1
    counts = adopter.compile_counts()
    addresses = [t.data_ptr() for t in cache_tensors(pool._cache)]
    donor.submit(prompt, 12, request_id="m")
    donor.pump(5)  # decoding on the donor
    entry = donor.migrate_out("m")
    assert entry["spill_path"] is not None
    res = adopter.adopt_migration(
        entry["rid"], entry["prompt"], entry["tokens"], entry["max_new"],
        sampling=entry["sampling"])
    assert res["adopted_from_file"]
    while adopter.pump(8):
        pass
    st = res["stream"].result(timeout_s=0)
    assert st.state == "DONE"
    np.testing.assert_array_equal(
        np.concatenate([entry["tokens"], st.tokens[len(entry["tokens"]):]]),
        want.result(timeout_s=0).tokens)
    assert pool._decode_fn.drop_moved() == []
    assert pool._decode_fn.graphs() == 1
    assert [t.data_ptr() for t in cache_tensors(pool._cache)] == addresses
    assert adopter.compile_counts() == counts


@pytest.mark.cuda
def test_capture_on_a_thread_other_than_the_warm_up(cuda_device):
    """A key warmed up on one thread is captured on a fresh thread (a
    fleet's or HTTP handler's pumping thread that never ran cuBLAS): the
    capture makes the thread's cuBLAS handle before it begins, so the
    graph is captured and replays the eager result."""
    import threading

    from paddle_tpu_torch.jit.aot import AotFunction

    gen = torch.Generator(device="cpu").manual_seed(0)
    w1 = torch.randn(256, 256, generator=gen).to(cuda_device)
    b1 = torch.randn(256, generator=gen).to(cuda_device)
    w2 = torch.randn(256, 256, generator=gen).to(cuda_device)
    x = torch.randn(8, 256, generator=gen).to(cuda_device)

    def step(x):
        return (torch.addmm(b1, x, w1).relu() @ w2).softmax(-1)

    fn = AotFunction(step, lambda x: "k", name="other_thread", capture=True)
    want = fn(x).clone()  # the eager warm-up, on this thread
    out = {}

    def capture():
        try:
            out["got"] = fn(x).clone()
        except Exception as e:  # noqa: BLE001 - reported below
            out["err"] = repr(e)

    t = threading.Thread(target=capture)
    t.start()
    t.join(60.0)
    assert "err" not in out, out.get("err")
    assert fn.graphs() == 1
    assert torch.equal(out["got"], want)
    assert torch.equal(fn(x), want)  # a replay on this thread


@pytest.mark.cuda
def test_capture_temp_bytes_ignore_other_threads(cuda_device):
    """A key's ``temp_bytes`` is its graph's private pool: 256 MiB that a
    second thread allocates on the card during the capture (thread-local
    capture mode lets it) do not count."""
    import threading

    from paddle_tpu_torch.jit.aot import AotFunction

    go, done, held = threading.Event(), threading.Event(), []

    def step(x):
        if torch.cuda.is_current_stream_capturing():
            go.set()
            assert done.wait(30.0)
        return x * 2.0 + 1.0

    def other():
        assert go.wait(30.0)
        held.append(torch.empty(256 << 20, dtype=torch.uint8,
                                device=cuda_device))
        done.set()

    fn = AotFunction(step, lambda x: "f", name="pool", capture=True)
    x = torch.ones(1024, device=cuda_device)
    t = threading.Thread(target=other)
    t.start()
    fn(x)
    fn(x)  # captures
    t.join(30.0)
    assert held and fn.graphs() == 1
    entry = fn.cost_report()["f"]
    assert 0 < entry["temp_bytes"] < 256 << 20, entry
    assert entry["hbm_reserved_bytes"] == (
        entry["argument_bytes"] + entry["output_bytes"]
        - entry["alias_bytes"] + entry["temp_bytes"])


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


# -- F3: a weight swap that replaces the parameter tensors ---------------------
def _lm(dev, seed, layers=2):
    from paddle_tpu_torch import TransformerLM

    return TransformerLM(vocab_size=512, hidden_size=64, num_layers=layers,
                         num_heads=4, intermediate_size=128, max_position=128,
                         dropout=0.0, device=dev, seed=seed)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_refresh_weights_serves_replaced_weights(cuda_device, spec):
    """Serve, swap the model (and the draft) to other seeds' weights with
    ``load_state_dict(..., assign=True)`` -- new tensors, so every
    captured graph's parameter addresses are stale -- ``refresh_weights()``
    and serve again: the tokens (and a speculative pool's acceptance) are a
    fresh pool's on the new weights, and ``compile_counts()`` does not
    move."""
    import numpy as np

    from paddle_tpu_torch import GenerationPool
    from paddle_tpu_torch.inference import SpeculativePool

    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7, 14)]
    cfg = dict(max_len=64, slots=2, buckets=[32], device=cuda_device,
               cache_layout="paged", block_size=8)

    def make(model, draft):
        if spec:
            return SpeculativePool(model, draft, spec_k=3, **cfg)
        return GenerationPool(model, **cfg)

    model, draft = _lm(cuda_device, 0), _lm(cuda_device, 1, layers=1)
    pool = make(model, draft)
    pool.generate(prompts, 9)
    counts = pool.compile_counts()
    steps = pool._captured_steps()
    assert sum(fn.graphs() for fn in steps) >= 1
    model.load_state_dict(_lm(cuda_device, 2).state_dict(), assign=True)
    draft.load_state_dict(_lm(cuda_device, 3, layers=1).state_dict(),
                          assign=True)
    pool.refresh_weights()
    assert sum(fn.graphs() for fn in steps) == 0  # every graph dropped
    if spec:
        pool.reset_acceptance_stats()
    got = pool.generate(prompts, 9)
    fresh = make(_lm(cuda_device, 2), _lm(cuda_device, 3, layers=1))
    want = fresh.generate(prompts, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if spec:
        assert pool.acceptance_stats() == fresh.acceptance_stats()
    assert pool.compile_counts() == counts
    assert sum(fn.graphs() for fn in steps) >= 1  # captured again


# -- the captured train step (jit/train_step.py) --------------------------------
# Captured against eager, the same kernels in the same order on the same
# card: fp32 agrees to its rounding.  A padding mask passed to a captured
# step reaches K3 as a bias (a graph input is never claimed) where the eager
# step takes it as key-padding lanes; both add exact zeros to the kept
# scores, and in O2 bf16 the losses average bf16-rounded products over
# 2 x 4 x 96 positions: 1e-3 relative
CAPTURED_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _train_model(dev, causal, dropout=0.0):
    from paddle_tpu_torch import TransformerLM

    return TransformerLM(vocab_size=512, hidden_size=128, num_layers=2,
                         num_heads=2, intermediate_size=256,
                         max_position=128, dropout=dropout, causal=causal,
                         device=dev, seed=0)


def _train_batches(dev, n, seed=0, b=4, l=96):
    """``n`` (ids, [B,1,1,L] additive padding mask, labels) batches, each
    with its own ragged lengths (row 0 full)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = torch.from_numpy(rng.randint(0, 512, (b, l)))
        lens = torch.from_numpy(rng.randint(l // 4, l + 1, b))
        lens[0] = l
        valid = torch.arange(l)[None, :] < lens[:, None]
        mask = torch.where(valid, 0.0, torch.finfo(torch.float32).min)[
            :, None, None, :]
        out.append(tuple(t.to(dev) for t in (ids, mask,
                                             torch.where(valid, ids, -100))))
    return out


def _train_loss(causal, bf16):
    from paddle_tpu_torch import TransformerLMCriterion, amp

    crit = TransformerLMCriterion(shift_labels=causal)

    def loss_fn(m, x, am, y):
        with amp.auto_cast(enable=bf16[0], level="O1", dtype="bfloat16"):
            if causal:
                return crit(m(x), x)
            return crit(m(x, attn_mask=am), y)

    return loss_fn


def _adamw(model, lr=1e-3):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "o2_bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["gpt", "bert"])
def test_captured_train_step_matches_eager(cuda_device, causal, dtype):
    """Four AdamW steps (warm-up, capture, two replays) on a 2-layer GPT
    and a 2-layer BERT, each batch with its own padding, captured and
    eager from the same weights: the losses agree, one key and one graph,
    and K3 ran 2 layers x 4 steps forward and backward in the run's dtype
    under replay as eagerly."""
    from paddle_tpu_torch import TrainStep, amp

    bf16 = dtype == torch.bfloat16
    batches = _train_batches(cuda_device, 4)
    losses, counts = {}, {}
    for capture in (True, False):
        model = _train_model(cuda_device, causal)
        opt = _adamw(model)
        if bf16:
            model, opt = amp.decorate(model, opt, level="O2",
                                      dtype="bfloat16")
        step = TrainStep(model, _train_loss(causal, [bf16]), opt,
                         capture=capture)
        fk.reset_launch_counts()
        losses[capture] = [step(*b) for b in batches]
        torch.cuda.synchronize()
        counts[capture] = fk.launch_counts_by_dtype()
        assert step.compile_counts() == {"train_step": 1}
        assert step._fn.graphs() == int(capture)
    # every call returned its own loss tensor (none aliases the graph's)
    assert len({l.data_ptr() for l in losses[True]}) == 4
    torch.testing.assert_close(torch.stack(losses[True]),
                               torch.stack(losses[False]),
                               rtol=CAPTURED_RTOL[dtype], atol=0)
    name = "bfloat16" if bf16 else "float32"
    want = {n: {dt: 8 if dt == name else 0 for dt in c}
            for n, c in counts[False].items()}
    assert counts[True] == counts[False] == want


@pytest.mark.cuda
def test_captured_dropout_draws_a_fresh_mask_each_replay(cuda_device):
    """Dropout 0.1 and learning rate 0: the weights never change, so only
    the dropout masks can tell the steps apart, and every replay's loss
    differs from the one before."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    model = _train_model(cuda_device, True, dropout=0.1)
    step = TrainStep(model, _train_loss(True, [False]),
                     SGD(0.0, parameters=model.parameters()))
    batch = _train_batches(cuda_device, 1)[0]
    losses = [float(step(*batch)) for _ in range(4)]
    assert step._fn.graphs() == 1
    assert len(set(losses)) == 4, losses


@pytest.mark.cuda
def test_decorate_after_build_recaptures(cuda_device):
    """``amp.decorate`` after the step captured replaces every parameter's
    storage: the next call drops the graph (no stale read), warms up and
    captures again, and the losses still equal the eager twin's; the key
    is counted once."""
    from paddle_tpu_torch import TrainStep, amp

    batches = _train_batches(cuda_device, 6, seed=1)
    losses, counts = {}, {}
    for capture in (True, False):
        model = _train_model(cuda_device, True)
        opt = _adamw(model)
        bf16 = [False]
        step = TrainStep(model, _train_loss(True, bf16), opt,
                         capture=capture)
        got = [float(step(*b)) for b in batches[:3]]
        amp.decorate(model, opt, level="O2", dtype="bfloat16")
        bf16[0] = True
        fk.reset_launch_counts()
        got += [float(step(*b)) for b in batches[3:]]
        losses[capture] = got
        counts[capture] = fk.launch_counts_by_dtype()
        assert model.word_embeddings.weight.dtype == torch.bfloat16
        assert step.compile_counts() == {"train_step": 1}
        assert step._fn.graphs() == int(capture)
    torch.testing.assert_close(torch.tensor(losses[True]),
                               torch.tensor(losses[False]),
                               rtol=CAPTURED_RTOL[torch.bfloat16], atol=0)
    assert counts[True] == counts[False]
    assert all(c["bfloat16"] == 6 and c["float32"] == 0
               for c in counts[True].values())


@pytest.mark.cuda
def test_multi_step_train_step_is_one_replay_a_call(cuda_device,
                                                    monkeypatch):
    """``MultiStepTrainStep(K=4)``: the K steps are one graph and each call
    after the warm-up is one replay; the losses equal four eager
    ``TrainStep``s each."""
    from paddle_tpu_torch import MultiStepTrainStep, TrainStep

    batches = _train_batches(cuda_device, 12, seed=2)
    stacked = [tuple(torch.stack([b[i] for b in batches[c * 4:c * 4 + 4]])
                     for i in range(3)) for c in range(3)]
    replays = []
    replay = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda g: replays.append(1) or replay(g))
    model = _train_model(cuda_device, True)
    multi = MultiStepTrainStep(model, _train_loss(True, [False]),
                               _adamw(model), steps_per_call=4)
    fk.reset_launch_counts()
    got = torch.cat([multi(*s) for s in stacked])
    torch.cuda.synchronize()
    assert len(replays) == 2  # calls 2 and 3; call 1 is the warm-up
    assert multi._fn.graphs() == 1
    assert multi.compile_counts() == {"train_step": 1}
    assert fk.launch_counts()["flash_attention_forward_kernel"] == 2 * 12
    twin = _train_model(cuda_device, True)
    single = TrainStep(twin, _train_loss(True, [False]), _adamw(twin),
                       capture=False)
    want = torch.stack([single(*b) for b in batches])
    torch.testing.assert_close(got, want, rtol=CAPTURED_RTOL[torch.float32],
                               atol=0)


@pytest.mark.cuda
def test_host_op_loss_refuses_capture(cuda_device, tmp_path):
    """A loss through a ``utils.cpp_extension`` host op cannot be captured:
    the step's second call raises ``CaptureError`` naming ``capture=False``
    (nothing falls back to eager), and with ``capture=False`` it trains.
    Last in the file: a failed capture leaves nothing for later tests."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.jit.aot import CaptureError
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.utils import cpp_extension

    src = tmp_path / "ops.cc"
    src.write_text('#include "pt_extension.h"\n'
                   "PT_OP(capture_scale2) {\n"
                   "  long long n = 1;\n"
                   "  for (int d = 0; d < ndims[0]; ++d) n *= shapes[0][d];\n"
                   "  for (long long i = 0; i < n; ++i) out[i] = 2.0f * "
                   "ins[0][i];\n}\n")
    mod = cpp_extension.load(
        name="capture_refusal_ext", sources=[str(src)],
        build_directory=str(tmp_path),
        functions={"capture_scale2": {"out_shape": lambda s: s,
                                      "backward": lambda r, ct: (2.0 * ct,)}})
    x = torch.randn(8, 16, device=cuda_device)

    def loss_fn(m, x_):
        return mod.capture_scale2(m(x_)).square().mean()

    lin = torch.nn.Linear(16, 4, device=cuda_device)
    step = TrainStep(lin, loss_fn, SGD(0.1, parameters=lin.parameters()))
    step(x)  # the warm-up runs eagerly: the host op works there
    with pytest.raises(CaptureError, match="capture=False"):
        step(x)
    eager = TrainStep(lin, loss_fn, SGD(0.1, parameters=lin.parameters()),
                      capture=False)
    losses = [float(eager(x)) for _ in range(3)]
    assert losses[-1] < losses[0], losses


# -- multi-LoRA and the recurrent layout under captured steps ----------------
def _banked_lm(dev, rows=4):
    from paddle_tpu_torch.nn import lora

    model = _tiny_lm(dev)
    lora.attach_lora(model, n_adapters=rows, rank=4)
    for idx in range(1, rows):
        lora.load_adapter(model, idx, lora.random_adapter(model, seed=idx,
                                                          scale=0.5))
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(cache_layout="paged", block_size=8),
    dict(cache_layout="paged", block_size=8, prefill_chunk_tokens=16)],
    ids=["paged", "chunked"])
def test_lora_pool_captured_matches_eager(cuda_device, kw):
    """The adapter ids are the step's static buffer, read by address: a
    graph captured with one set of ids serves every later membership's
    ids, token for token as the eager step."""
    import numpy as np

    from paddle_tpu_torch import GenerationPool

    model = _banked_lm(cuda_device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7, 14, 9)]

    def run(eager):
        pool = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                              device=cuda_device, **kw)
        if eager:
            _eager(pool, "_decode_fn")
            if pool._chunk_fn is not None:
                _eager(pool, "_chunk_fn")
        for i, p in enumerate(prompts):
            pool.submit(p, 6, request_id=i, temperature=0.8 * (i % 2),
                        seed=i, adapter=i % 4)
        dk.reset_launch_counts()
        out = pool.run()
        return pool, out, dk.launch_counts()["paged_decode_attention_kernel"]

    pool, got, launches = run(eager=False)
    _, want, _ = run(eager=True)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert pool._decode_fn.graphs() == 1
    assert launches == 2 * pool.decode_steps_total
    assert pool._steps.adapter.is_cuda


@pytest.mark.cuda
def test_lora_hot_load_keeps_the_graph(cuda_device):
    """``load_adapter`` writes bank rows in place: the captured decode
    graph is kept (no drop, no new capture, no new key) and serves the new
    rows at its next replay."""
    import numpy as np

    from paddle_tpu_torch import GenerationPool
    from paddle_tpu_torch.nn import lora

    model = _banked_lm(cuda_device)
    pool = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                          cache_layout="paged", block_size=8,
                          device=cuda_device)
    ids = np.random.RandomState(3).randint(0, 512, 11)
    rid = pool.submit(ids, 8, adapter=1)
    before = pool.run()[rid]
    graph = pool._decode_fn._keys[next(iter(pool._decode_fn._keys))]
    counts, cost = pool.compile_counts(), pool.cost_version()
    weights = lora.random_adapter(model, seed=101, scale=1.0)
    pool.load_adapter(1, weights)
    rid = pool.submit(ids, 8, adapter=1)
    after = pool.run()[rid]
    assert pool._decode_fn._keys[next(iter(pool._decode_fn._keys))] is graph
    assert pool.compile_counts() == counts and pool.cost_version() == cost
    assert np.any(before != after)
    eager = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                           cache_layout="paged", block_size=8,
                           device=cuda_device)
    _eager(eager, "_decode_fn")
    rid = eager.submit(ids, 8, adapter=1)
    np.testing.assert_array_equal(after, eager.run()[rid])


@pytest.mark.cuda
def test_recurrent_graph_replay_matches_eager(cuda_device, tmp_path):
    """The recurrent layout's captured steps (the session's decode, the
    pool's decode with its carry freeze) against their eager entries, and
    a disk preempt and resume under the graph byte-identical to an
    uninterrupted run."""
    import numpy as np

    from paddle_tpu_torch import DecodeSession, GenerationPool
    from paddle_tpu_torch.nn import SSMLM

    model = SSMLM(vocab_size=512, hidden_size=64, num_layers=2, d_state=96,
                  device=cuda_device, seed=0)
    ids = np.random.RandomState(1).randint(0, 512, (2, 9))
    sess = DecodeSession(model, max_len=64, buckets=[16],
                         cache_layout="recurrent", device=cuda_device)
    got = sess.generate(ids, 8)
    assert sess.compile_counts() == {"prefill": 1, "decode": 1}
    assert sess._decode_fn.graphs() == 1
    eager = DecodeSession(model, max_len=64, buckets=[16],
                          cache_layout="recurrent", device=cuda_device)
    eager._decode_fn = eager._decode_fn._run_eager
    np.testing.assert_array_equal(got, eager.generate(ids, 8))

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7)]

    def run(eager, victim=None):
        pool = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                              cache_layout="recurrent", spill_tier="disk",
                              spill_dir=str(tmp_path), device=cuda_device)
        if eager:
            _eager(pool, "_decode_fn")
        for i, p in enumerate(prompts):
            pool.submit(p, 6, request_id=i, temperature=0.7 * (i % 2),
                        seed=i)
        if victim is not None:
            for _ in range(3):
                pool.step()
            pool.preempt(victim)
        return pool, pool.run()

    pool, got = run(eager=False)
    _, want = run(eager=True)
    _, resumed = run(eager=False, victim=0)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(resumed[rid], want[rid])
    assert pool._decode_fn.graphs() == 1
    assert not list(tmp_path.iterdir())


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("kw,kernel", [
    (dict(cache_layout="paged", block_size=8, cache_dtype="int8"),
     "paged_decode_attention_kernel"),
    (dict(cache_layout="paged", block_size=8, prefill_chunk_tokens=16,
          prefix_sharing=True), "paged_decode_attention_kernel"),
    (dict(cache_layout="dense"), "decode_attention_kernel")],
    ids=["paged-int8", "chunked", "dense"])
def test_mesh_pool_captured_matches_eager(cuda_device, dp, mp, kw, kernel):
    """A pool over a ``dp`` x ``mp`` mesh on one card: one captured decode
    graph whose tokens equal the eager step's and the unsharded pool's,
    the decode kernel launched ``layers x dp x mp`` times a step (each
    shard's own contiguous cache at 4/mp heads), the unsharded keys."""
    import numpy as np

    from paddle_tpu_torch import DecodeMesh, GenerationPool

    model = _tiny_lm(cuda_device)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7, 14, 9)]

    def run(mesh, eager=False):
        pool = GenerationPool(model, max_len=64, slots=4, buckets=[32],
                              device=cuda_device, mesh=mesh, **kw)
        if eager:
            _eager(pool, "_decode_fn")
        rids = [pool.submit(p, 6) for p in prompts]
        dk.reset_launch_counts()
        out = pool.run()
        return pool, [out[r] for r in rids], dk.launch_counts()[kernel]

    mesh = DecodeMesh(dp, mp, devices=["cuda:0"] * (dp * mp))
    pool, got, launches = run(mesh)
    _, eager, _ = run(mesh, eager=True)
    flat, want, _ = run(None)
    for p, g, e, w in zip(prompts, got, eager, want):
        np.testing.assert_array_equal(g, e)
        # mp sums its partials in shard order: the unsharded tokens bind
        # where the top-2 margin along their path clears 1e-3
        if _top2_margin(model, p, w) >= 1e-3:
            np.testing.assert_array_equal(g, w)
    assert pool._decode_fn.graphs() == 1
    assert launches == 2 * dp * mp * pool.decode_steps_total
    assert pool.compile_counts() == flat.compile_counts()


def _top2_margin(model, prompt, tokens):
    """Smallest top-2 logit margin along ``prompt`` + ``tokens`` (one
    uncached forward)."""
    import numpy as np

    seq = torch.as_tensor(np.concatenate([prompt, tokens[:-1]]),
                          dtype=torch.int64, device=model.device)
    with torch.no_grad():
        top2 = model(seq[None])[0, len(prompt) - 1:].topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.cuda
def test_mesh_int8_seam_captured(cuda_device):
    """The int8 seam inside the captured decode graph: tokens equal the
    eager step's, and the recorded wire bytes sit below the dense ring's;
    a grid over two cards is refused."""
    import numpy as np

    from paddle_tpu_torch import DecodeMesh, GenerationPool
    from paddle_tpu_torch.core.errors import UnimplementedError

    model = _tiny_lm(cuda_device)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 512, n) for n in (5, 11, 20, 7)]
    mesh = DecodeMesh(2, 2, devices=["cuda:0"] * 4, collective_quant="int8")

    def run(eager):
        pool = GenerationPool(model, max_len=64, slots=4, buckets=[32],
                              device=cuda_device, mesh=mesh,
                              cache_layout="paged", block_size=8)
        if eager:
            _eager(pool, "_decode_fn")
        return pool, pool.generate(prompts, 6)

    pool, got = run(False)
    _, want = run(True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pool._decode_fn.graphs() == 1
    stats = pool.cache_stats()
    assert stats["collective_bytes_per_token"] \
        < stats["collective_dense_bytes_per_token"]
    with pytest.raises(UnimplementedError):
        DecodeMesh(2, 1, devices=["cuda:0", "cuda:1"])


# -- the rest of training (sparse rows, the nan/inf check) ---------------------


@pytest.mark.cuda
def test_lazy_adam_rows_on_the_card(cuda_device):
    """A sparse embedding on the card: after two lazy Adam steps the rows
    the second step met equal dense Adam's, every other row of the weight
    and of both moments keeps its bytes from the first step, and the pad
    row none moved; under a captured ``TrainStep`` the same table trains
    on its dense gradient (the update sees no sparse one)."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.nn import Embedding
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam, param_name

    def table(sparse):
        return Embedding(500, 32, padding_idx=0, sparse=sparse,
                         device=cuda_device, generator=torch.Generator(
                             device=cuda_device).manual_seed(0))

    lazy, dense = table(True), table(False)
    w0 = lazy.weight.detach().clone()
    opts = (Adam(0.01, parameters=lazy.parameters(), lazy_mode=True),
            Adam(0.01, parameters=dense.parameters()))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ids = [torch.randint(0, 500, (4, 64), device=cuda_device, generator=gen)
           for _ in range(2)]
    st = opts[0]._state_for(lazy.weight)
    for i, x in enumerate(ids):
        for emb, opt in zip((lazy, dense), opts):
            emb(x).square().sum().backward()
            assert emb.weight.grad.is_sparse == (emb is lazy)
            opt.step()
            opt.clear_grad()
        if i == 0:
            before = [t.detach().clone() for t in
                      (lazy.weight, st["moment1"], st["moment2"])]
    met = torch.zeros(500, dtype=torch.bool, device=cuda_device)
    met[ids[1].reshape(-1)] = True
    met[0] = False
    torch.testing.assert_close(lazy.weight[met], dense.weight[met],
                               rtol=1e-6, atol=0)
    for now, was in zip((lazy.weight.detach(), st["moment1"],
                         st["moment2"]), before):
        assert torch.equal(now[~met], was[~met])
    assert torch.equal(lazy.weight[0], w0[0])
    assert opts[0]._states[param_name(lazy.weight)] is st

    model = torch.nn.Sequential(lazy, torch.nn.Flatten(),
                                torch.nn.Linear(64 * 32, 3)).to(cuda_device)
    opt = Adam(0.01, parameters=model.parameters(), lazy_mode=True)
    seen = []
    update = opt._functional_step

    def recording(params, grads, lr):
        seen.extend(g.is_sparse for g in grads)
        return update(params, grads, lr)

    opt._functional_step = recording
    step = TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y), opt)
    y = torch.tensor([0, 1, 2, 1], device=cuda_device)
    losses = [float(step(ids[1], y)) for _ in range(4)]
    assert step._fn.graphs() == 1 and seen and not any(seen)
    assert losses[-1] < losses[0], losses


@pytest.mark.cuda
def test_nan_check_raises_eagerly_and_skips_the_capture(cuda_device):
    """Under ``FLAGS_check_nan_inf`` an installed op with an inf output
    raises naming itself on the card; a captured train step with the flag
    on checks its eager warm-up, skips the check while capturing (a host
    read would void the capture) and replays."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import InvalidArgumentError, TrainStep
    from paddle_tpu_torch.framework import dispatch

    check = dispatch.check_nan_inf
    capturing = []

    def counting(out, op_name):
        capturing.append(torch.cuda.is_current_stream_capturing())
        return check(out, op_name)

    ptt.set_flags({"FLAGS_check_nan_inf": True})
    dispatch.check_nan_inf = counting
    try:
        with pytest.raises(InvalidArgumentError, match="'log'"):
            ptt.log(torch.zeros(4, device=cuda_device))
        model = _train_model(cuda_device, False)
        step = TrainStep(model, _train_loss(False, [False]), _adamw(model))
        losses = [float(step(*b)) for b in _train_batches(cuda_device, 3)]
    finally:
        dispatch.check_nan_inf = check
        ptt.set_flags({"FLAGS_check_nan_inf": False})
    assert step._fn.graphs() == 1
    assert all(torch.isfinite(torch.tensor(losses)))
    assert True in capturing and False in capturing


def _bn_net(dev, remat):
    """A small conv -> BatchNorm -> ReLU stack (ResNet18 at layers [1, 1,
    1, 1], 10 classes) on the card, its residual blocks under recompute
    with ``remat``."""
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    from paddle_tpu_torch.vision.models import resnet18

    model = resnet18(num_classes=10, layers=[1, 1, 1, 1], device=dev,
                     seed=0)
    if remat:
        for name, sub in model.named_modules():
            if name.startswith("layer") and name.count(".") == 1:
                sub.forward = (lambda *a, __o=sub.forward: recompute(__o,
                                                                     *a))
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_captured_batch_norm_advances_stats_once_a_replay(cuda_device,
                                                          remat):
    """At learning rate 0 the weights stay put and every call's batch
    statistics are the same, so after k calls of a captured step (the
    warm-up, the capture with its replay, replays) the running mean is
    (1 - 0.9^k) times the batch mean and the variance 0.9^k + (1 - 0.9^k)
    times the batch variance: each call advanced them once, the capture
    neither twice nor not at all, and recompute's second run not at
    all."""
    from paddle_tpu_torch import TrainStep, nn, optimizer

    model = _bn_net(cuda_device, remat)
    crit = nn.CrossEntropyLoss()
    opt = optimizer.Momentum(0.0, parameters=model.parameters())
    step = TrainStep(model, lambda m, x, y: crit(m(x), y), opt)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8, 3, 32, 32, device=cuda_device, generator=gen)
    y = torch.arange(8, device=cuda_device) % 10
    stats = []
    for _ in range(5):
        step(x, y)
        stats.append({n: b.double().clone() for n, b in model.named_buffers()})
    assert step._fn.graphs() == 1
    for k in range(1, 6):
        for n, got in stats[k - 1].items():
            first = stats[0][n]
            if n.endswith("_mean"):
                want = (1 - 0.9 ** k) * first / 0.1
            else:
                want = 0.9 ** k + (1 - 0.9 ** k) * (first - 0.9) / 0.1
            torch.testing.assert_close(got, want, rtol=1e-3,
                                       atol=1e-3 * want.abs().max().item(),
                                       msg="%s after %d calls" % (n, k))


@pytest.mark.cuda
def test_recompute_under_capture_replays_the_forward_draws(cuda_device):
    """A dropout region under recompute in a captured step: every replay
    draws a fresh mask, and the recompute in its backward draws the
    forward's (the generator pair registered before the capture).  With
    ``loss = w * sum(dropout(x))`` the gradient is ``loss / w`` exactly
    when the two masks agree, so SGD moves ``w`` by ``lr * loss / w``."""
    from paddle_tpu_torch import TrainStep, optimizer
    from paddle_tpu_torch.distributed.fleet.utils import recompute

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.full((1,), 2.0,
                                                   device=cuda_device))

        def forward(self, x):
            return recompute(lambda t: torch.nn.functional.dropout(
                t * self.w, 0.5, training=True), x)

    model = Net()
    opt = optimizer.SGD(1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda m, x: m(x).sum(), opt)
    x = torch.rand(4096, device=cuda_device) + 0.5
    losses = []
    for _ in range(5):
        w = model.w.detach().clone()
        loss = step(x)
        losses.append(float(loss))
        torch.testing.assert_close(model.w.detach(),
                                   w - 1e-3 * loss / w, rtol=1e-5, atol=0)
    assert step._fn.graphs() == 1
    assert len(set(losses)) == len(losses), losses  # a fresh mask each call


# -- the sequence models ------------------------------------------------------


def _s2s_flash_case(dev, name):
    """K3's inputs at a seq2seq shape (fp32, 8 heads x 64): q/k/v as
    transposed head views, and the bias the layer gives it (the -1e9
    padding bias, a row of it fully masked, the [L, L] subsequent mask,
    none for a beam step's self-attention)."""
    gen = torch.Generator(device=dev).manual_seed(len(name))
    rows, lq, lk = {"encoder": (128, 64, 64), "fully_padded": (128, 64, 64),
                    "decoder_self": (128, 64, 64), "step_cross": (64, 1, 64),
                    "step_self_1": (64, 1, 1), "step_self_17": (64, 1, 17),
                    "step_self_64": (64, 1, 64)}[name]

    def heads(l):
        return torch.randn(rows, l, 8, 64, device=dev,
                           generator=gen).transpose(1, 2)

    lens = torch.randint(min(8, lk), lk + 1, (rows,), device=dev,
                         generator=gen)
    pad = torch.where(torch.arange(lk, device=dev)[None, :] < lens[:, None],
                      0.0, -1e9)[:, None, None, :]
    if name == "fully_padded":
        pad[1] = -1e9
    bias = {"decoder_self": torch.full((lq, lk), -1e9, device=dev).triu(1),
            "encoder": pad, "fully_padded": pad,
            "step_cross": pad}.get(name)
    return dict(q=heads(lq), k=heads(lk), v=heads(lk), bias=bias,
                causal=False, sm_scale=0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["encoder", "fully_padded", "decoder_self",
                                  "step_cross", "step_self_1",
                                  "step_self_17", "step_self_64"])
def test_flash_forward_at_seq2seq_shapes(cuda_device, name):
    """K3's forward in its bias mode at the Transformer-base shapes,
    Lq 1 included, against its twin (fp32: summation order, 1e-5); a row
    whose every key is masked attends uniformly in both."""
    args = _s2s_flash_case(cuda_device, name)
    o, stats = fk.flash_attention_forward_kernel(**args)
    want_o, want_stats = fk.flash_attention_forward_plain(**args)
    torch.testing.assert_close(o, want_o, rtol=0, atol=1e-5)
    torch.testing.assert_close(stats, want_stats, rtol=0, atol=1e-5)
    if name == "fully_padded":
        torch.testing.assert_close(
            o[1], args["v"][1].mean(dim=1, keepdim=True).expand_as(o[1]),
            rtol=0, atol=1e-5)


def _lstm_batch(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(4, 12, 16, device=dev, generator=gen)
    lens = torch.randint(1, 13, (4,), device=dev, generator=gen)
    return x, lens


@pytest.mark.cuda
def test_captured_lstm_step_reads_nothing_back(cuda_device, monkeypatch):
    """A 2-layer bidirectional LSTM over ragged lengths under a captured
    ``TrainStep``: eagerly (and in the warm-up) the layer packs the rows by
    length, which reads the lengths back; the capture takes the step loop,
    which reads nothing back, and every replay runs on that call's
    lengths.  The losses equal the eager ones within 1e-4 (cuDNN's sums
    against the loop's)."""
    from paddle_tpu_torch import TrainStep, nn, optimizer
    from paddle_tpu_torch.nn.layer import rnn

    routes = []
    real = rnn._route
    monkeypatch.setattr(rnn, "_route",
                        lambda *a: routes.append(real(*a)) or routes[-1])
    losses = {}
    for capture in (False, True):
        model = nn.LSTM(16, 32, 2, direction="bidirect", device=cuda_device,
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(0))
        opt = optimizer.Adam(1e-3, parameters=model.parameters())
        step = TrainStep(model, lambda m, x, n: m(
            x, sequence_length=n)[0].square().mean(), opt, capture=capture)
        routes.clear()
        losses[capture] = [float(step(*_lstm_batch(cuda_device, s)))
                           for s in range(4)]
        assert step._fn.graphs() == int(capture)
        want = ["packed"] * 16 if not capture \
            else ["packed"] * 4 + ["loop"] * 4
        assert routes == want, routes
    torch.testing.assert_close(losses[True], losses[False], rtol=1e-4,
                               atol=0)


@pytest.mark.cuda
def test_sequence_ops_need_their_sizes_in_a_capture(cuda_device):
    """``sequence_mask`` without ``maxlen`` reads the largest length back,
    which a capture forbids: the capture fails naming the argument; with
    ``maxlen`` the step captures."""
    from paddle_tpu_torch import TrainStep, nn, optimizer, sequence_mask
    from paddle_tpu_torch.jit.aot import CaptureError

    for maxlen in (None, 12):
        model = nn.Linear(16, 1, device=cuda_device)
        step = TrainStep(model, lambda m, x, n: m(x).mean() * sequence_mask(
            n, maxlen, dtype="float32").sum(),
            optimizer.SGD(0.1, parameters=model.parameters()))
        x, lens = _lstm_batch(cuda_device, 0)
        step(x, lens)
        if maxlen is None:
            with pytest.raises(CaptureError, match="maxlen"):
                step(x, lens)
        else:
            step(x, lens)
            assert step._fn.graphs() == 1


@pytest.mark.cuda
def test_captured_dropout_replays_the_eager_masks(cuda_device):
    """From the same seed, a captured step's replays draw the dropout masks
    the eager steps drew (the generator's offset advances by the graph's
    draws at each replay), so the two runs' losses agree to rounding."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.optimizer import SGD

    losses = {}
    for capture in (False, True):
        torch.cuda.manual_seed(3)
        model = _train_model(cuda_device, True, dropout=0.1)
        step = TrainStep(model, _train_loss(True, [False]),
                         SGD(1e-2, parameters=model.parameters()),
                         capture=capture)
        batch = _train_batches(cuda_device, 1)[0]
        losses[capture] = [float(step(*batch)) for _ in range(4)]
    assert len(set(losses[False])) == 4, losses
    torch.testing.assert_close(losses[True], losses[False], rtol=1e-5,
                               atol=0)


# -- the vision surface ----------------------------------------------------------

def _vision_data(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)


@pytest.mark.cuda
def test_nms_runs_inside_a_capture(cuda_device):
    """``vision.ops.nms`` reads nothing back: its fixed trips capture into
    one CUDA graph, whose replay keeps the CPU's indices."""
    from paddle_tpu_torch.vision import ops

    gen = torch.Generator().manual_seed(0)
    xy = torch.rand(300, 2, generator=gen) * 50
    wh = torch.rand(300, 2, generator=gen) * 10 + 1
    boxes = torch.cat([xy, xy + wh], 1)
    scores = torch.rand(300, generator=gen)
    want = ops.nms(boxes, scores, 0.45, max_out=60)
    b, s = boxes.to(cuda_device), scores.to(cuda_device)
    ops.nms(b, s, 0.45, max_out=60)  # warm-up off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ops.nms(b, s, 0.45, max_out=60)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert int(got[1]) == int(want[1])


@pytest.mark.cuda
def test_detection_ops_on_the_card(cuda_device):
    """``roi_align``, ``deform_conv2d`` (v2) and ``yolo_loss`` with their
    gradients, and ``yolo_box``, on the card against the CPU."""
    from paddle_tpu_torch.vision import ops

    def both(fn, *arrays):
        outs = []
        for dev in ("cpu", cuda_device):
            ts = [a.to(dev).requires_grad_(a.is_floating_point())
                  for a in arrays]
            y = fn(*ts)
            y.sum().backward()
            outs.append([y.detach().cpu()] + [
                t.grad.cpu() for t in ts if t.grad is not None])
        for w, g in zip(*outs):
            torch.testing.assert_close(g, w, rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()))

    x = _vision_data(0, 2, 8, 20, 24)
    boxes = torch.tensor([[1., 2., 30., 40.], [-5., -3., 12., 9.],
                          [40., 50., 90., 85.], [3., 3., 3., 3.]])
    both(lambda a, b: ops.roi_align(
        a, b, torch.tensor([2, 2], device=a.device), 5, 0.25), x, boxes)
    off = _vision_data(1, 2, 18, 20, 24) * 2
    mask = torch.rand(2, 9, 20, 24, generator=torch.Generator().manual_seed(2))
    w = _vision_data(3, 6, 8, 3, 3) * 0.2
    both(lambda a, o, m, k: ops.deform_conv2d(a, o, k, None, m, padding=1),
         x, off, mask, w)
    head = _vision_data(4, 2, 3 * 9, 8, 8)
    gt = torch.tensor([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.2],
                        [0., 0., 0., 0.]]] * 2)
    label = torch.tensor([[1, 3, 0]] * 2)
    both(lambda h: ops.yolo_loss(h, gt.to(h.device), label.to(h.device),
                                 [10, 13, 16, 30, 33, 23], [0, 1, 2], 4, 0.7,
                                 32), head)
    got = ops.yolo_box(head.to(cuda_device),
                       torch.tensor([[256, 256]] * 2, device=cuda_device),
                       [10, 13, 16, 30, 33, 23], 4, 0.01, 32)
    want = ops.yolo_box(head, torch.tensor([[256, 256]] * 2),
                        [10, 13, 16, 30, 33, 23], 4, 0.01, 32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic", "area"])
def test_interpolate_and_grid_sample_on_the_card(cuda_device, mode):
    from paddle_tpu_torch.nn import functional as F

    x = _vision_data(5, 2, 3, 17, 13)
    for size in ((31, 29), (7, 5)):
        want = F.interpolate(x, size, mode=mode)
        got = F.interpolate(x.to(cuda_device), size, mode=mode).cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    theta = torch.tensor([[[0.9, 0.2, 0.1], [-0.1, 1.1, 0.0]]] * 2)
    grid = F.affine_grid(theta, [2, 3, 11, 9])
    for pad in ("zeros", "border", "reflection"):
        want = F.grid_sample(x, grid, padding_mode=pad)
        got = F.grid_sample(x.to(cuda_device), grid.to(cuda_device),
                            padding_mode=pad).cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_captured_mobilenet_v2_step(cuda_device):
    """A captured ``TrainStep`` of a narrow MobileNetV2 (scale 0.25) at 64
    px: at learning rate 0 each call -- the warm-up, the capture with its
    replay, a replay -- advances every running mean once, by the
    reference's rule; the captured losses equal the eager ones."""
    from paddle_tpu_torch import TrainStep, nn, optimizer
    from paddle_tpu_torch.vision.models import mobilenet_v2

    x = _vision_data(6, 8, 3, 64, 64).to(cuda_device)
    y = torch.randint(0, 10, (8,), generator=torch.Generator().manual_seed(
        7)).to(cuda_device)
    crit = nn.CrossEntropyLoss()
    losses = {}
    for capture in (False, True):
        torch.manual_seed(0)
        model = mobilenet_v2(scale=0.25, num_classes=10, device=cuda_device)
        opt = optimizer.Momentum(0.0, parameters=model.parameters())
        step = TrainStep(model, lambda m, a, b: crit(m(a), b), opt,
                         capture=capture)
        means = []
        losses[capture] = []
        for _ in range(3):
            losses[capture].append(float(step(x, y)))
            means.append(model.features[0][1]._mean.detach().clone())
        assert step._fn.graphs() == int(capture)
        first = means[0] / 0.1
        for k, m in enumerate(means, 1):
            torch.testing.assert_close(m, (1 - 0.9 ** k) * first, rtol=1e-4,
                                       atol=1e-6)
    torch.testing.assert_close(losses[True], losses[False], rtol=1e-5,
                               atol=0)

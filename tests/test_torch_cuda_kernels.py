"""The port's CUDA kernels K1 (paged) and K2 (dense) against their plain
twins, on the card.  Skipped without a CUDA card: the kernels have no CPU
mode (the CPU runs the twins, held against the reference by
``test_torch_decode_attention.py``).

This file imports neither JAX nor the reference package, so it also runs
on a machine that has only PyTorch; there, skip the JAX-based
``conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from paddle_tpu_torch.ops import decode_kernels as dk
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

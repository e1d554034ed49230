"""Distributed training on the card: captured steps over the one-card
meshes.  ZeRO-2 (and its pinned-host offload) replayed from a CUDA graph
bit-equal to the unsharded step; a pp 2 x mp 2 pipeline captured against
its eager run, K3 launched at the mp shard's heads; Ulysses attention on
K3 against the ring's composition; the DGC step captured; SyncBatchNorm
in a captured step.  Skipped without a CUDA card.  Imports neither JAX
nor the reference::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_distributed_cuda.py

Tolerances: bit-equality where the arithmetic is the same (ZeRO against
unsharded, captured against eager for the same program); bf16 Ulysses
(K3) against the float32 ring composition ``atol=2e-2``; the pipeline's
captured losses against its eager ones ``rtol=1e-5``.
"""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.meta_parallel import (
    PipelineLayer, PipelineTrainStep, ShardingOptimizerStage2,
    megatron_param_spec, partition_pipeline)
from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as sp
from paddle_tpu_torch.ops import flash_kernels as fk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()


def _mlp(seed):
    torch.manual_seed(seed)
    return ptt.nn.Sequential(ptt.nn.Linear(64, 256, device="cuda"),
                             ptt.nn.ReLU(),
                             ptt.nn.Linear(256, 10, device="cuda"))


def _loss(m, x, y):
    with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        return ptt.nn.functional.cross_entropy(m(x), y)


def _build(seed, offload=None, group=None):
    model = _mlp(seed)
    opt = ptt.optimizer.AdamW(1e-3, parameters=model.parameters(),
                              grad_clip=ptt.nn.ClipGradByGlobalNorm(1.0))
    model, opt = ptt.amp.decorate(model, opt, level="O2", dtype="bfloat16")
    if offload is not None:
        opt = ShardingOptimizerStage2(opt, group=group, offload=offload)
    return model, opt


@pytest.mark.cuda
@pytest.mark.parametrize("offload", [False, True])
def test_zero2_captured_is_bit_equal(cuda_device, offload):
    g = dist.init_parallel_env(world_size=4)
    x = torch.randn(32, 64, device="cuda")
    y = torch.randint(0, 10, (32,), device="cuda")
    model, opt = _build(0)
    step = ptt.TrainStep(model, _loss, opt)
    want = [step(x, y) for _ in range(4)]
    zmodel, zopt = _build(0, offload=offload, group=g)
    zstep = ptt.TrainStep(zmodel, _loss, zopt)
    got = [zstep(x, y) for _ in range(4)]
    assert zstep._fn.graphs() == 1
    assert [float(t) for t in got] == [float(t) for t in want]
    for p, q in zip(model.parameters(), zmodel.parameters()):
        assert torch.equal(p, q)
    states = zopt._states[zmodel[0].weight.param_name]
    assert states["moment1"].is_pinned() == offload
    assert states["moment1"].device.type == ("cpu" if offload else "cuda")


class _Block(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.l = ptt.nn.TransformerEncoderLayer(256, 4, 512, dropout=0.0,
                                                device="cuda")

    def forward(self, h):
        mask = torch.triu(torch.full((h.shape[1],) * 2, -1e9,
                                     device=h.device), 1).to(h.dtype)
        return self.l(h, mask)


class _Embed(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = ptt.nn.Embedding(512, 256, device="cuda")

    def forward(self, ids):
        return self.emb(ids)


class _Head(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.proj = ptt.nn.Linear(256, 512, device="cuda")

    def forward(self, h):
        return self.proj(h)


def _pipe_loss(logits, labels):
    return ptt.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), labels.reshape(-1))


@pytest.mark.cuda
def test_pp2_mp2_pipeline_captures(cuda_device):
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 2}
    dist.fleet.init(strategy=st)
    hcg = dist.fleet.get_hybrid_communicate_group()
    ids = torch.randint(0, 512, (4, 128), device="cuda")
    losses = {}
    for capture in (False, True):
        torch.manual_seed(0)
        pl = PipelineLayer([_Embed()] + [_Block() for _ in range(4)]
                           + [_Head()], num_stages=2, loss_fn=_pipe_loss)
        opt = ptt.optimizer.AdamW(1e-3, parameters=pl.parameters())
        spec = megatron_param_spec(partition_pipeline(pl)[1][0])
        step = PipelineTrainStep(pl, opt, hcg, microbatches=2,
                                 mp_param_spec=spec, capture=capture)
        fk.reset_launch_counts()
        losses[capture] = [float(step(ids, ids)) for _ in range(4)]
        counts = fk.launch_counts_by_dtype()
        assert step._fn.graphs() == int(capture)
        # 4 blocks x 2 mp ranks x 2 microbatches, and again in recompute
        fwd = counts["flash_attention_forward_kernel"]["float32"]
        assert fwd == 4 * 2 * 2 * 2 * 4, counts
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-5)
    assert losses[True][-1] < losses[True][0]


@pytest.mark.cuda
def test_ulysses_runs_k3_and_matches_the_ring(cuda_device):
    g = dist.init_parallel_env(world_size=4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 8, 1024, 64, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    fk.reset_launch_counts()
    out = sp.sep_attention(q, k, v, g, mode="ulysses", causal=True)
    assert fk.launch_counts()["flash_attention_forward_kernel"] == 4
    ring = sp.sep_attention(q.float(), k.float(), v.float(), g, mode="ring",
                            causal=True)
    assert (out.float() - ring).abs().max().item() < 2e-2


@pytest.mark.cuda
def test_dgc_step_and_sync_batch_norm_capture(cuda_device):
    dist.init_parallel_env(world_size=4)
    torch.manual_seed(1)
    model = ptt.nn.Sequential(ptt.nn.Conv2D(3, 8, 3, device="cuda"),
                              ptt.nn.BatchNorm2D(8, device="cuda"),
                              ptt.nn.ReLU(), ptt.nn.Flatten(),
                              ptt.nn.Linear(8 * 14 * 14, 10, device="cuda"))
    ptt.nn.SyncBatchNorm.convert_sync_batchnorm(model)
    opt = ptt.optimizer.SGD(0.01, parameters=model.parameters())
    step = dist.CompressedAllReduceStep(
        model, lambda m, x, y: ptt.nn.functional.cross_entropy(m(x), y),
        opt, compression="dgc", sparsity=0.99)
    x = torch.randn(16, 3, 16, 16, device="cuda")
    y = torch.randint(0, 10, (16,), device="cuda")
    losses = [float(step(x, y)) for _ in range(6)]
    assert step._fn.graphs() == 1 and all(np.isfinite(losses))
    assert float(model[1]._variance.sum()) != 8.0

"""The port's fleet training surface (``distributed.fleet``: strategies,
``distributed_model``/``distributed_optimizer``, the meta-optimizers;
``distributed.CompressedAllReduceStep``) against the reference's, the
reference's weights carried across, on the CPU (the reference on the
conftest's 8 host devices, the port over 8 ranks on the CPU).

Tolerances: the meta-optimizers' parameters after their steps,
``rtol=1e-5, atol=1e-6`` (two programs' float32 rounding); the
compressed steps' losses over dp 8, fp16 ``rtol=1e-4`` (the fp16 sums'
rounding order differs) and DGC ``rtol=1e-4`` (random data has no near-tie
at the k-th magnitude at this size), their parameters after 4 steps
``rtol=1e-4, atol=2e-5`` (the rank sums' order moves the last bits, which
the error-fed residuals carry from step to step).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed import CompressedAllReduceStep as RefStep
from paddle_tpu.distributed.fleet import meta_optimizers as rmo

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import CompressedAllReduceStep
from paddle_tpu_torch.distributed.comm_hooks import wire_bytes
from paddle_tpu_torch.distributed.fleet import meta_optimizers as mo
from paddle_tpu_torch.core.errors import InvalidArgumentError

N = 8
RTOL, ATOL = 1e-5, 1e-6


def _pair(seed=0, hid=64):
    pt.seed(seed)
    ref = pt.nn.Sequential(pt.nn.Linear(16, hid), pt.nn.ReLU(),
                           pt.nn.Linear(hid, 4))
    port = ptt.nn.Sequential(ptt.nn.Linear(16, hid, device="cpu"),
                             ptt.nn.ReLU(),
                             ptt.nn.Linear(hid, 4, device="cpu"))
    ptt.load_reference_params(port, {n: np.array(p.value) for n, p in
                                     ref.named_parameters()})
    return ref, port


def _data(steps=4, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(steps, batch, 16).astype(np.float32),
            rng.randint(0, 4, (steps, batch)).astype(np.int64))


def _eager(ref, ropt, port, popt, steps=3, micro=1):
    xs, ys = _data(steps * micro)
    for i in range(steps * micro):
        rl = pt.nn.functional.cross_entropy(ref(pt.to_tensor(xs[i])),
                                            pt.to_tensor(ys[i]))
        rl.backward()
        ropt.step()
        ropt.clear_grad()
        pl = torch.nn.functional.cross_entropy(port(torch.from_numpy(xs[i])),
                                               torch.from_numpy(ys[i]))
        pl.backward()
        popt.step()
        popt.clear_grad()
    for (n, rp), pp in zip(ref.named_parameters(), port.parameters()):
        np.testing.assert_allclose(pp.detach().numpy(), np.asarray(rp.value),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_strategy_knobs_are_the_reference_s():
    ref = vars(rdist.fleet.DistributedStrategy())
    got = vars(dist.fleet.DistributedStrategy())
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == ref[k], k


@pytest.mark.parametrize("kind", ["gradient_merge", "dgc", "fp16", "localsgd"])
def test_meta_optimizers_match_reference(kind):
    ref, port = _pair()
    rsgd = pt.optimizer.SGD(0.1, parameters=ref.parameters())
    psgd = ptt.optimizer.SGD(0.1, parameters=list(port.parameters()))
    micro = 1
    if kind == "gradient_merge":
        ropt = rmo.GradientMergeOptimizer(rsgd, k_steps=2)
        popt = mo.GradientMergeOptimizer(psgd, k_steps=2)
        micro = 2
    elif kind == "dgc":
        ropt = rmo.DGCOptimizer(rsgd, sparsity=0.9, rampup_begin_step=1)
        popt = mo.DGCOptimizer(psgd, sparsity=0.9, rampup_begin_step=1)
    elif kind == "fp16":
        ropt = rmo.FP16AllreduceOptimizer(rsgd)
        popt = mo.FP16AllreduceOptimizer(psgd)
    else:
        ropt = rmo.LocalSGDOptimizer(rsgd, k_steps=2)
        popt = mo.LocalSGDOptimizer(psgd, k_steps=2)
    _eager(ref, ropt, port, popt, micro=micro)
    if kind == "localsgd":
        assert popt.syncs == 1


def test_distributed_optimizer_stack_and_lamb_lars():
    st = dist.fleet.DistributedStrategy()
    st.lamb = True
    st.dgc = True
    st.fp16_allreduce = True
    st.localsgd = True
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 2, "avg": True}
    dist.fleet.init(strategy=st, device="cpu")
    _, port = _pair()
    opt = dist.fleet.distributed_optimizer(
        ptt.optimizer.AdamW(1e-3, parameters=list(port.parameters())))
    chain = []
    o = opt
    while hasattr(o, "_inner"):
        chain.append(type(o).__name__)
        o = o._inner
    assert chain == ["GradientMergeOptimizer", "LocalSGDOptimizer",
                     "FP16AllreduceOptimizer", "DGCOptimizer"]
    assert type(o).__name__ == "Lamb"
    st2 = dist.fleet.DistributedStrategy()
    st2.lars = True
    mom = ptt.optimizer.Momentum(0.1, parameters=list(port.parameters()))
    assert type(mo.apply_lamb_lars(mom, st2)).__name__ == "Lars"
    assert mo.apply_lamb_lars(mom, st) is mom


def test_recompute_and_amp_knobs():
    st = dist.fleet.DistributedStrategy()
    st.recompute = True
    st.recompute_configs = {"checkpoints": ["0"]}
    st.amp = True
    st.amp_configs = {"use_pure_bf16": True, "dtype": "bfloat16"}
    dist.fleet.init(strategy=st, device="cpu")
    _, port = _pair()
    wrapped = dist.fleet.distributed_model(port)
    assert isinstance(wrapped, dist.DataParallel)
    assert port[0]._fleet_recompute
    dist.fleet.distributed_optimizer(
        ptt.optimizer.AdamW(1e-3, parameters=list(port.parameters())))
    assert port[0].weight.dtype == torch.bfloat16
    st.recompute_configs = {"checkpoints": ["nope"]}
    _, other = _pair()
    with pytest.raises(InvalidArgumentError, match="match no sublayers"):
        dist.fleet.distributed_model(other)
    plain = dist.fleet.DistributedStrategy()
    plain.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                            "sep_degree": 2}
    dist.fleet.init(strategy=plain, device="cpu")
    with pytest.raises(InvalidArgumentError, match="enable_sequence"):
        dist.fleet.distributed_model(torch.nn.Linear(2, 2))


@pytest.mark.parametrize("compression", ["fp16", "dgc"])
def test_compressed_step_matches_reference(compression):
    rdist.init_parallel_env()
    dist.destroy_process_group()
    dist.init_parallel_env(world_size=N, device="cpu")
    ref, port = _pair(hid=32)
    kw = dict(compression=compression)
    if compression == "dgc":
        kw.update(sparsity=0.9, momentum=0.9, rampup_begin_step=1)
    rstep = RefStep(ref, lambda m, x, y: pt.nn.functional.cross_entropy(
        m(x), y), pt.optimizer.SGD(0.05, parameters=ref.parameters()), **kw)
    step = CompressedAllReduceStep(
        port, lambda m, x, y: torch.nn.functional.cross_entropy(m(x), y),
        ptt.optimizer.SGD(0.05, parameters=list(port.parameters())), **kw)
    xs, ys = _data(4)
    want = [float(rstep(pt.to_tensor(xs[i]), pt.to_tensor(ys[i])).value)
            for i in range(4)]
    got = [float(step(xs[i], ys[i])) for i in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for (n, rp), pp in zip(ref.named_parameters(), port.parameters()):
        np.testing.assert_allclose(pp.detach().numpy(), np.asarray(rp.value),
                                   rtol=1e-4, atol=2e-5, err_msg=n)
    if compression == "dgc":
        assert any(float(v.abs().sum()) > 0 for rank in step._uv
                   for _, v in rank)
        wire = step.wire_bytes_per_step()
        assert wire["compressed"] < wire["dense_fp32"]
    with pytest.raises(InvalidArgumentError, match="divide"):
        step(xs[0][:6], ys[0][:6])
    dist.destroy_process_group()


def test_wire_bytes_formulas_and_fleet_routing():
    n = 1000
    assert wire_bytes(n, 4, "none") == 2 * 3 * n  # 2(n-1)/n x 4 bytes
    assert wire_bytes(n, 4, "fp16") == 3 * n
    assert wire_bytes(n, 4, "dgc", sparsity=0.99) == 3 * 10 * 8
    assert wire_bytes(n, 1, "none") == 0
    st = dist.fleet.DistributedStrategy()
    st.dgc = True
    st.dgc_configs = {"sparsity": [0.95], "momentum": 0.8}
    dist.fleet.init(strategy=st, device="cpu")
    _, port = _pair()
    step = dist.fleet.fleet.compressed_train_step(
        port, lambda m, x, y: torch.nn.functional.cross_entropy(m(x), y),
        ptt.optimizer.SGD(0.01, parameters=list(port.parameters())))
    assert step.compression == "dgc" and step.sparsity == 0.95
    xs, ys = _data(1)
    assert np.isfinite(float(step(xs[0], ys[0])))
    with pytest.raises(InvalidArgumentError, match="compression"):
        CompressedAllReduceStep(port, None, None, compression="int4")
    st.dgc = False
    with pytest.raises(InvalidArgumentError, match="requires"):
        dist.fleet.fleet.compressed_train_step(port, None, None)

"""The port's ZeRO (``meta_parallel.sharding_parallel``): stage 2 and
stage 3 over a sharding group of 4 ranks on the CPU.

Held two ways:

- within the port, BIT-equal: an element-wise update on each rank's row
  views is the unsharded update's arithmetic, so the parameters after
  every step equal those of the same optimizer unwrapped (AdamW with a
  global-norm clip, O2-style master weights too, ``offload``, stage 3,
  and through ``TrainStep``);
- against the reference's ``ShardingOptimizerStage2`` on the conftest's
  host devices, with the reference's weights carried across: losses over
  4 Adam steps to ``rtol=1e-5`` (two programs' rounding; the reference
  test's own parity bound is 1e-4).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as rdist
import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.meta_parallel import (
    GroupShardedParallel, ShardingOptimizerStage2, group_sharded_parallel)
from paddle_tpu_torch.core.errors import InvalidArgumentError

N = 4


@pytest.fixture()
def group():
    dist.destroy_process_group()
    g = dist.init_parallel_env(world_size=N, device="cpu")
    yield g
    dist.destroy_process_group()


def _model(seed=0, bias_out=3):
    torch.manual_seed(seed)
    return torch.nn.Sequential(ptt.nn.Linear(16, 32, device="cpu"),
                               torch.nn.ReLU(),
                               ptt.nn.Linear(32, bias_out, device="cpu"))


def _data():
    rng = np.random.RandomState(7)
    return (torch.from_numpy(rng.randn(16, 16).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 3, (16,))))


def _adamw(model, **kw):
    return ptt.optimizer.AdamW(
        1e-2, parameters=list(model.parameters()),
        grad_clip=ptt.nn.ClipGradByGlobalNorm(0.5), **kw)


def _train(model, opt, steps=4):
    xs, ys = _data()
    losses = []
    for _ in range(steps):
        loss = torch.nn.functional.cross_entropy(model(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _same(a, b):
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("offload", [False, True])
def test_stage2_is_bit_equal_to_the_unsharded_update(group, offload):
    plain = _model()
    want = _train(plain, _adamw(plain))
    model = _model()
    opt = ShardingOptimizerStage2(_adamw(model), group=group,
                                  offload=offload)
    assert _train(model, opt) == want
    _same(model, plain)
    # each rank owns a quarter of the split states; the [3] bias's and the
    # scalars' replicate
    per_rank = opt.rank_state_bytes()
    whole = opt.state_bytes()
    assert len(per_rank) == N and per_rank[1] == per_rank[2] == per_rank[3]
    assert abs(per_rank[1] - whole / N) < 64
    w = model[0].weight.param_name
    assert opt.state_sharding_of(w)["moment1"] == ("dp",)
    assert opt.state_sharding_of(model[2].bias.param_name)["moment1"] == ()
    sd = opt.state_dict()
    assert sd[w + "__moment1"].shape == (16, 32)


def test_stage2_with_master_weights_and_train_step(group):
    def build():
        m = _model(seed=1)
        for p in m.parameters():
            p.data = p.data.to(torch.bfloat16)
        return m, _adamw(m, multi_precision=True)

    def loss_fn(m, x, y):
        return torch.nn.functional.cross_entropy(
            m(x.to(torch.bfloat16)).float(), y)

    xs, ys = _data()
    plain, popt = build()
    pstep = ptt.TrainStep(plain, loss_fn, popt)
    want = [float(pstep(xs, ys)) for _ in range(4)]
    model, inner = build()
    opt = ShardingOptimizerStage2(inner, group=group)
    step = ptt.TrainStep(model, loss_fn, opt)
    got = [float(step(xs, ys)) for _ in range(4)]
    assert got == want
    _same(model, plain)
    assert "master_weight" in opt._states[model[0].weight.param_name]


def test_stage2_rebuilds_its_states_after_a_later_decorate(group):
    """fleet.distributed_optimizer wraps before it decorates: the first
    step finds the parameters replaced and the states without masters,
    makes them again as a decorate-first optimizer has them, and trains
    bit-equal to it."""
    def loss_fn(m, x, y):
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            return torch.nn.functional.cross_entropy(m(x).float(), y)

    xs, ys = _data()
    plain = _model(seed=3)
    popt = _adamw(plain)
    plain, popt = ptt.amp.decorate(plain, popt, level="O2",
                                   dtype="bfloat16")
    pstep = ptt.TrainStep(plain, loss_fn, popt)
    want = [float(pstep(xs, ys)) for _ in range(3)]
    model = _model(seed=3)
    inner = _adamw(model)
    opt = ShardingOptimizerStage2(inner, group=group)
    model, inner = ptt.amp.decorate(model, inner, level="O2",
                                    dtype="bfloat16")
    step = ptt.TrainStep(model, loss_fn, opt)
    assert [float(step(xs, ys)) for _ in range(3)] == want
    _same(model, plain)


def test_stage3_and_group_sharded_levels(group):
    plain = _model(seed=2, bias_out=4)
    want = _train(plain, _adamw(plain))
    model = _model(seed=2, bias_out=4)
    wrapped, opt, scaler = group_sharded_parallel(model, _adamw(model),
                                                  level="p_g_os",
                                                  group=group)
    assert isinstance(wrapped, GroupShardedParallel) and scaler is None
    assert _train(wrapped, opt) == want
    _same(model, plain)
    assert all(p.is_distributed for p in model.parameters())
    total = sum(p.numel() * 4 for p in model.parameters())
    assert wrapped.rank_param_bytes() == [total // N] * N
    assert wrapped.parameters() == list(model.parameters())
    assert set(wrapped.state_dict()) == set(model.state_dict())
    m2 = _model()
    _, opt2, _ = group_sharded_parallel(m2, _adamw(m2), level="os_g",
                                        group=group)
    assert isinstance(opt2, ShardingOptimizerStage2)
    with pytest.raises(InvalidArgumentError, match="level"):
        group_sharded_parallel(m2, _adamw(m2), level="p")
    with pytest.raises(InvalidArgumentError, match="parameters="):
        ShardingOptimizerStage2(ptt.optimizer.SGD(0.1), group=group)


def test_stage2_matches_reference_losses():
    rdist.init_parallel_env()
    pt.seed(0)
    ref = pt.nn.Sequential(pt.nn.Linear(16, 32), pt.nn.ReLU(),
                           pt.nn.Linear(32, 4))
    port = torch.nn.Sequential(ptt.nn.Linear(16, 32, device="cpu"),
                               torch.nn.ReLU(),
                               ptt.nn.Linear(32, 4, device="cpu"))
    ptt.load_reference_params(port, {n: np.array(p.value) for n, p in
                                     ref.named_parameters()})
    rng = np.random.RandomState(7)
    xs = rng.randn(16, 16).astype(np.float32)
    ys = rng.randint(0, 4, (16,)).astype(np.int32)
    ropt = rdist.meta_parallel.ShardingOptimizerStage2(
        pt.optimizer.Adam(0.01, parameters=ref.parameters()))
    want = []
    for _ in range(4):
        loss = pt.nn.functional.cross_entropy(ref(pt.to_tensor(xs)),
                                              pt.to_tensor(ys))
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        want.append(float(loss.value))
    dist.destroy_process_group()
    g = dist.init_parallel_env(world_size=8, device="cpu")
    opt = ShardingOptimizerStage2(
        ptt.optimizer.Adam(0.01, parameters=list(port.parameters())),
        group=g)
    got = []
    for _ in range(4):
        loss = torch.nn.functional.cross_entropy(
            port(torch.from_numpy(xs)), torch.from_numpy(ys).long())
        loss.backward()
        opt.step()
        opt.clear_grad()
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    dist.destroy_process_group()


def test_fleet_sharding_knobs_wrap_stage2_and_stage3():
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                         "sharding_degree": N}
    st.sharding = True
    st.sharding_configs = {"stage": 3}
    dist.fleet.init(strategy=st, device="cpu")
    model = _model()
    wrapped = dist.fleet.distributed_model(model)
    opt = dist.fleet.distributed_optimizer(_adamw(model))
    assert isinstance(wrapped, GroupShardedParallel)
    assert isinstance(opt, ShardingOptimizerStage2) and opt.group.nranks == N

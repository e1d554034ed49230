"""The port's hybrid topology (``distributed.topology``, ``fleet.init``,
``DataParallel``) against the reference's: the rank maps are host
arithmetic and must be identical; the per-axis groups hold the same
ranks; a grid over several devices is refused.  The reference builds its
meshes on the conftest's 8 host devices.  No tolerance is needed: every
comparison here is exact (integers, or the same float program).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.distributed as rdist
import paddle_tpu_torch.distributed as dist
from paddle_tpu.distributed.fleet import fleet as rfleet
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          UnimplementedError)
from paddle_tpu_torch.distributed.fleet import fleet

GRIDS = [(("data", "pipe", "sharding", "model"), (2, 2, 1, 2)),
         (("data", "pipe", "sharding", "model", "sep"), (1, 2, 1, 2, 2)),
         (("data", "pipe", "sharding", "model", "expert"), (2, 1, 2, 1, 2))]


@pytest.mark.parametrize("names,dims", GRIDS)
def test_rank_maps_are_the_reference_s(names, dims):
    ref = rdist.CommunicateTopology(names, dims)
    got = dist.CommunicateTopology(names, dims)
    assert got.world_size() == ref.world_size()
    for r in range(got.world_size()):
        assert tuple(got.get_coord(r)) == tuple(ref.get_coord(r))
        assert got.get_rank(**got.get_coord(r)._asdict()) == r
    for axis in names:
        assert got.get_comm_list(axis) == ref.get_comm_list(axis)
        assert got.get_dim(axis) == ref.get_dim(axis)
        for i in range(got.get_dim(axis)):
            assert got.get_axis_list(axis, i) == ref.get_axis_list(axis, i)
    for r in range(got.world_size()):
        assert got.get_rank_from_stage(r, **{names[0]: 0}) == \
            ref.get_rank_from_stage(r, **{names[0]: 0})


@pytest.mark.parametrize("rank", [0, 5])
def test_hybrid_group_axes_match_reference(rank):
    names, dims = GRIDS[0]
    rh = rdist.HybridCommunicateGroup(rdist.CommunicateTopology(names, dims),
                                      rank=rank)
    ph = dist.HybridCommunicateGroup(dist.CommunicateTopology(names, dims),
                                     rank=rank, device="cpu")
    for getter in ("get_data_parallel_group", "get_model_parallel_group",
                   "get_pipe_parallel_group",
                   "get_sharding_parallel_group"):
        assert getattr(ph, getter)().ranks == getattr(rh, getter)().ranks
        assert getattr(ph, getter)().axis_name == \
            getattr(rh, getter)().axis_name
    for getter in ("get_data_parallel_rank", "get_model_parallel_rank",
                   "get_stage_id", "get_sharding_parallel_rank",
                   "get_p2p_next_rank", "get_p2p_prev_rank",
                   "get_parallel_mode", "get_model_parallel_world_size",
                   "get_pipe_parallel_world_size",
                   "get_data_parallel_world_size"):
        assert getattr(ph, getter)() == getattr(rh, getter)(), getter
    assert dict(ph.mesh.shape) == dict(rh.mesh.shape)
    assert ph.mesh.device == torch.device("cpu")


def test_fleet_init_builds_the_reference_grid():
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 1,
                         "sep_degree": 2}
    fleet.init(strategy=st, device="cpu")
    rst = rdist.fleet.DistributedStrategy()
    rst.hybrid_configs = dict(st.hybrid_configs)
    rfleet.init(strategy=rst)
    hcg = fleet.get_hybrid_communicate_group()
    rhcg = rfleet.get_hybrid_communicate_group()
    assert dict(hcg.mesh.shape) == dict(rhcg.mesh.shape)
    assert hcg.get_sep_parallel_group().ranks == \
        rhcg.get_sep_parallel_group().ranks
    assert hcg.get_sep_parallel_world_size() == 2
    assert dist.get_world_size() == 8
    assert (fleet.worker_index(), fleet.worker_num(),
            fleet.is_first_worker()) == (0, 1, True)
    assert dist.ParallelEnv().world_size == 1
    util = dist.fleet.util
    np.testing.assert_array_equal(util.all_reduce(np.arange(3)),
                                  np.arange(3))
    assert util.get_file_shard(["b", "a"]) == ["a", "b"]
    role = dist.fleet.UserDefinedRoleMaker(current_id=0, worker_num=4)
    assert role.is_first_worker() and role.worker_num() == 4


def test_grids_over_several_devices_are_refused():
    topo = dist.CommunicateTopology(("data", "model"), (2, 2))
    with pytest.raises(UnimplementedError, match="item 6"):
        dist.HybridCommunicateGroup(topo, devices=["cpu"] * 3 + ["cuda:0"])
    with pytest.raises(InvalidArgumentError, match="align"):
        dist.CommunicateTopology(("data",), (1, 2))


def test_data_parallel_is_the_global_batch_program():
    dist.destroy_process_group()
    g = dist.init_parallel_env(world_size=4, device="cpu")
    torch.manual_seed(0)
    net = torch.nn.Linear(6, 3)
    dp = dist.DataParallel(net, group=g)
    x = torch.randn(8, 6)
    np.testing.assert_array_equal(dp(x).detach().numpy(),
                                  net(x).detach().numpy())
    assert dp.parameters() == list(net.parameters())
    assert dp.scale_loss(3.0) == 3.0
    with dp.no_sync():
        pass
    with pytest.raises(InvalidArgumentError, match="divisible"):
        dp(torch.randn(6, 6))
    with pytest.raises(InvalidArgumentError, match="divisible"):
        dist.shard_batch(torch.randn(5, 2), g)
    dist.destroy_process_group()

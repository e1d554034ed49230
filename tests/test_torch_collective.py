"""The port's eager collectives (``paddle_tpu_torch.distributed``) held
against the reference's on the stacked ``[nranks, ...]`` view: the
reference runs its ``shard_map`` collectives on the conftest's 8 host
devices, the port writes them out over 8 ranks on the CPU.  Inputs are
numpy draws from a seed, handed to both.

Tolerances: the port sums in float32 in rank order, the reference in
XLA's order, so SUM/AVG/PROD agree to ``rtol=1e-6`` (a few ulps of 8
terms); MAX/MIN and the data movements (gather, broadcast, scatter,
all-to-all, shifts) are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.distributed as rdist
import paddle_tpu_torch.distributed as dist
from paddle_tpu.distributed.collective import shard_map as ref_shard_map
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          UnavailableError,
                                          UnimplementedError)

N = 8
SUM_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _world():
    rdist.init_parallel_env()
    dist.destroy_process_group()
    dist.init_parallel_env(world_size=N, device="cpu")
    yield
    dist.destroy_process_group()


def _draw(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


OPS = [("SUM", SUM_RTOL), ("AVG", SUM_RTOL), ("PROD", SUM_RTOL),
       ("MAX", 0.0), ("MIN", 0.0)]


@pytest.mark.parametrize("op,rtol", OPS)
def test_all_reduce_matches_reference(op, rtol):
    x = _draw((N, 4, 3))
    want = np.asarray(rdist.all_reduce(jnp.asarray(x),
                                       op=getattr(rdist.ReduceOp, op)))
    got = dist.all_reduce(_t(x), op=getattr(dist.ReduceOp, op))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)


@pytest.mark.parametrize("op,rtol", OPS)
def test_reduce_scatter_matches_reference(op, rtol):
    x = _draw((N, N * 2, 3), seed=1)
    want = np.asarray(rdist.reduce_scatter(
        jnp.asarray(x), op=getattr(rdist.ReduceOp, op)))
    got = dist.reduce_scatter(_t(x), op=getattr(dist.ReduceOp, op))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    # the list form is the same global view
    lst = dist.reduce_scatter([_t(r) for r in x],
                              op=getattr(dist.ReduceOp, op))
    np.testing.assert_array_equal(lst.numpy(), got.numpy())


def test_all_reduce_writes_in_place_and_keeps_dtype():
    x = _t(_draw((N, 5)))
    out = dist.all_reduce(x)
    assert out is x and x.dtype == torch.float32
    ints = torch.arange(N * 3, dtype=torch.int32).reshape(N, 3)
    dist.all_reduce(ints)
    want = np.asarray(rdist.all_reduce(
        jnp.arange(N * 3, dtype=jnp.int32).reshape(N, 3)))
    np.testing.assert_array_equal(ints.numpy(), want)


def test_reduce_lands_on_dst_only():
    x = _draw((N, 4, 3), seed=2)
    want = np.asarray(rdist.reduce(jnp.asarray(x), dst=3))
    got = dist.reduce(_t(x), dst=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL)
    np.testing.assert_array_equal(got.numpy()[0], x[0])


def test_movement_collectives_match_reference():
    x = _draw((N, N * 2, 3), seed=3)
    jx = jnp.asarray(x)
    np.testing.assert_array_equal(
        dist.broadcast(_t(x), src=5).numpy(),
        np.asarray(rdist.broadcast(jx, src=5)))
    np.testing.assert_array_equal(
        dist.alltoall(_t(x)).numpy(), np.asarray(rdist.alltoall(jx)))
    np.testing.assert_array_equal(
        dist.scatter(_t(x), src=2).numpy(),
        np.asarray(rdist.scatter(jx, src=2)))
    outs = dist.alltoall([_t(r) for r in x])
    want = rdist.alltoall([jnp.asarray(r) for r in x])
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))
    chunks = [_draw((3, 2), seed=10 + i) for i in range(N)]
    np.testing.assert_array_equal(
        dist.scatter(None, tensor_list=[_t(c) for c in chunks]).numpy(),
        np.asarray(rdist.scatter(None,
                                 tensor_list=[jnp.asarray(c)
                                              for c in chunks])))
    gathered = []
    dist.all_gather(gathered, _t(x))
    assert len(gathered) == N
    for i, g in enumerate(gathered):
        np.testing.assert_array_equal(g.numpy(), x[i])


def test_p2p_shifts_match_reference_ppermute():
    from jax.sharding import PartitionSpec as P

    g = rdist.init_parallel_env()
    x = _draw((N, 3), seed=4)
    for name in ("send_next", "send_prev"):
        fn = ref_shard_map(
            lambda v, f=getattr(rdist.p2p, name): f(v, g),
            mesh=g.mesh, in_specs=(P("dp"),), out_specs=P("dp"))
        want = np.asarray(fn(jnp.asarray(x)))
        got = getattr(dist.p2p, name)(_t(x))
        np.testing.assert_array_equal(got.numpy(), want)
        lst = getattr(dist.p2p, name)([_t(r) for r in x])
        np.testing.assert_array_equal(torch.stack(lst).numpy(), want)


def test_groups_subsets_and_roots():
    sub = dist.new_group([2, 4, 6])
    rsub = rdist.new_group([2, 4, 6])
    assert sub.nranks == rsub.nranks == 3
    assert [sub.get_group_rank(r) for r in (2, 4, 5)] == \
        [rsub.get_group_rank(r) for r in (2, 4, 5)]
    x = _draw((3, 4), seed=5)
    np.testing.assert_array_equal(
        dist.broadcast(_t(x), src=4, group=sub).numpy(),
        np.asarray(rdist.broadcast(jnp.asarray(x), src=4, group=rsub)))
    with pytest.raises(InvalidArgumentError, match="not a member"):
        dist.broadcast(_t(x), src=5, group=sub)
    assert dist.get_group(sub.id) is sub
    assert dist.get_world_size() == N and dist.get_rank() == 0
    assert dist.is_initialized()
    dist.barrier()
    dist.wait(_t(x))


def test_refusals():
    x = _t(_draw((N, 2)))
    for fn in (dist.send, dist.recv, dist.isend, dist.irecv):
        with pytest.raises(InvalidArgumentError, match="send_next"):
            fn(x)
    with pytest.raises(InvalidArgumentError, match="rank axis"):
        dist.all_reduce(_t(_draw((N + 1, 2))))
    with pytest.raises(InvalidArgumentError, match="must divide"):
        dist.alltoall(_t(_draw((N, N + 1))))
    with pytest.raises(InvalidArgumentError, match="out of range"):
        dist.new_group([0, N])
    dist.destroy_process_group()
    with pytest.raises(UnimplementedError, match="item 6"):
        dist.init_parallel_env(devices=["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError, match="device=\"cpu\""):
            dist.init_parallel_env(world_size=2)


def test_split_builds_parallel_layers_over_the_fleet_mp_group():
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 4,
                               "pp_degree": 1}
    dist.fleet.init(strategy=strategy, device="cpu")
    torch.manual_seed(0)
    x = torch.randn(3, 8)
    out = dist.split(x, (8, 12), "linear", axis=1, name="cpu_col")
    layer = dist.collective.get_split_layer("cpu_col")
    np.testing.assert_allclose(out.detach().numpy(),
                               (x @ layer.weight + layer.bias).detach()
                               .numpy(), rtol=1e-6)
    assert dist.split(x, (8, 12), "linear", axis=1, name="cpu_col") \
        .shape == (3, 12)
    row = dist.split(x, (8, 6), "linear", axis=0, name="cpu_row")
    lr = dist.collective.get_split_layer("cpu_row")
    np.testing.assert_allclose(row.detach().numpy(),
                               (x @ lr.weight + lr.bias).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    ids = torch.tensor([[0, 5, 11]])
    emb = dist.split(ids, (12, 4), "embedding", name="cpu_emb")
    ew = dist.collective.get_split_layer("cpu_emb").weight
    np.testing.assert_array_equal(emb.detach().numpy(),
                                  ew[ids].detach().numpy())
    with pytest.raises(InvalidArgumentError, match="num_partitions"):
        dist.split(x, (8, 12), "linear", axis=1, num_partitions=3,
                   name="cpu_bad")
    with pytest.warns(UserWarning, match="name="):
        dist.split(x, (8, 4), "linear", axis=1)

"""The port's ``SyncBatchNorm`` against the reference's (one BatchNorm
over the global batch under SPMD) and against the port's own
``BatchNorm2D`` over the global batch, at dp 4 on the CPU, with the
reference's weights and running statistics carried across.

Tolerances: the port reduces per-rank float32 sums in rank order (a
two-pass variance), the others reduce the whole batch at once: outputs
and running statistics ``rtol=1e-5, atol=1e-5``, input gradients
``rtol=1e-4, atol=1e-5``, parameter gradients ``rtol=1e-4`` and an
``atol`` of 1e-5 of the largest.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.nn.layer.norm import SyncBatchNorm as RefSyncBN

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.nn import BatchNorm2D, SyncBatchNorm

RTOL, ATOL = 1e-5, 1e-5
DP = 4


@pytest.fixture()
def dp_group():
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": DP, "mp_degree": 1, "pp_degree": 1}
    dist.fleet.init(strategy=st, device="cpu")
    return dist.fleet.get_hybrid_communicate_group().get_data_parallel_group()


def _x(seed=0, shape=(8, 3, 5, 5)):
    return (np.random.RandomState(seed).randn(*shape) * 2 + 1) \
        .astype(np.float32)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_matches_reference_sync_batch_norm(dp_group, data_format):
    x = _x(shape=(8, 3, 5, 5) if data_format == "NCHW" else (8, 5, 5, 3))
    pt.seed(0)
    ref = RefSyncBN(3, data_format=data_format)
    ref.weight.set_value(np.array([0.5, 1.5, -1.0], np.float32))
    ref.bias.set_value(np.array([0.1, 0.0, -0.2], np.float32))
    port = SyncBatchNorm(3, data_format=data_format, device="cpu")
    ptt.load_reference_params(port, {n: np.array(t.value) for n, t in
                                     list(ref.named_parameters())
                                     + list(ref.named_buffers())})
    want = np.asarray(ref(pt.to_tensor(x)).value)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(),
            np.asarray(dict(ref.named_buffers())[name].value), rtol=RTOL,
            atol=ATOL)
    port.eval()
    ref.eval()
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(ref(pt.to_tensor(x)).value), rtol=RTOL, atol=ATOL)


def test_equals_one_batch_norm_over_the_global_batch(dp_group):
    x = _x(seed=1)
    torch.manual_seed(0)
    bn = BatchNorm2D(3, device="cpu")
    net = ptt.nn.Sequential(ptt.nn.Conv2D(3, 3, 3, device="cpu"), bn)
    ref = ptt.nn.Sequential(ptt.nn.Conv2D(3, 3, 3, device="cpu"),
                            BatchNorm2D(3, device="cpu"))
    ref.load_state_dict(net.state_dict())
    synced = SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(synced[1], SyncBatchNorm) and synced[1].weight is \
        bn.weight and synced[1]._ranks() == DP
    for _ in range(2):
        xt = torch.from_numpy(x).requires_grad_()
        xr = torch.from_numpy(x).requires_grad_()
        out, want = synced(xt), ref(xr)
        np.testing.assert_allclose(out.detach().numpy(),
                                   want.detach().numpy(), rtol=RTOL,
                                   atol=ATOL)
        # a fixed random projection: the sum of squares of a normalized
        # batch is constant, so its gradient would be rounding alone
        proj = torch.from_numpy(_x(seed=2, shape=tuple(out.shape)))
        (out * proj).sum().backward()
        (want * proj).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(),
                                   rtol=1e-4, atol=ATOL)
    for a, b in zip(synced[1].buffers(), ref[1].buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)
    # the conv bias feeding a BatchNorm has gradient 0 up to rounding, so
    # the gradients are held at 1e-5 of the largest one
    scale = max(float(b.grad.abs().max()) for b in ref.parameters())
    for (n, a), b in zip(synced.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=n)
    with pytest.raises(InvalidArgumentError, match="divisible"):
        synced(torch.randn(6, 3, 5, 5))


def test_explicit_group_and_no_fleet():
    dist.destroy_process_group()
    g = dist.init_parallel_env(world_size=2, device="cpu")
    bn = SyncBatchNorm(4, device="cpu", group=g)
    assert bn._ranks() == 2
    x = torch.randn(6, 4)
    out = bn(x)
    np.testing.assert_allclose(out.mean(0).detach().numpy(), 0, atol=1e-6)
    dist.destroy_process_group()

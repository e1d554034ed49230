"""The port's tensor-parallel layers (``meta_parallel.mp_layers``) against
the reference's at mp 4: the reference's layers run their GSPMD
placement on the conftest's host devices, the port's run the 4 ranks in
order on the CPU, each on views of the one parameter.  The reference's
weights are carried across; inputs are numpy draws.

Tolerances: the row-parallel sums run in float32 in rank order in the
port and in XLA's order in the reference, so outputs agree to
``rtol=1e-5, atol=1e-6``; embedding lookups and column outputs are exact
up to the matmul's own rounding (the same ``1e-6``); losses after 4 SGD
steps to ``rtol=1e-5``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.distributed as rdist
import paddle_tpu_torch.distributed as dist
from paddle_tpu.distributed.meta_parallel import mp_layers as rmp
from paddle_tpu_torch.distributed.meta_parallel import mp_layers as pmp
from paddle_tpu_torch.core.errors import InvalidArgumentError

MP = 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture()
def groups():
    rst = rdist.fleet.DistributedStrategy()
    rst.hybrid_configs = {"dp_degree": 1, "mp_degree": MP, "pp_degree": 1}
    rdist.fleet.fleet.init(strategy=rst)
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = dict(rst.hybrid_configs)
    dist.fleet.init(strategy=st, device="cpu")
    return (rdist.fleet.fleet.get_hybrid_communicate_group()
            .get_model_parallel_group(),
            dist.fleet.get_hybrid_communicate_group()
            .get_model_parallel_group())


def _carry(ref_layer, port_layer):
    with torch.no_grad():
        for (rn, rp), (pn, pp_) in zip(ref_layer.named_parameters(),
                                       port_layer.named_parameters()):
            assert rn == pn and tuple(rp.value.shape) == tuple(pp_.shape)
            pp_.copy_(torch.from_numpy(np.array(rp.value)))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_column_row_pair_matches_reference(groups):
    rg, pg = groups
    pt.seed(0)
    rcol = rmp.ColumnParallelLinear(16, 32, gather_output=False,
                                    mp_group=rg)
    rrow = rmp.RowParallelLinear(32, 8, input_is_parallel=True, mp_group=rg)
    pcol = pmp.ColumnParallelLinear(16, 32, gather_output=False,
                                    mp_group=pg)
    prow = pmp.RowParallelLinear(32, 8, input_is_parallel=True, mp_group=pg)
    _carry(rcol, pcol)
    _carry(rrow, prow)
    x = _x((4, 16))
    want = np.asarray(rrow(rcol(pt.to_tensor(x))).value)
    parts = pcol(torch.from_numpy(x))
    assert isinstance(parts, list) and len(parts) == MP \
        and parts[0].shape == (4, 8)
    got = prow(parts)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert pcol.weight.is_distributed and prow.weight.is_distributed
    # the gradient lands in the one full-shape parameter
    got.sum().backward()
    assert pcol.weight.grad.shape == (16, 32)
    dense = torch.from_numpy(x).requires_grad_(False)
    w1 = pcol.weight.detach().clone().requires_grad_()
    ref_out = (dense @ w1 + pcol.bias.detach()) @ prow.weight.detach() \
        + prow.bias.detach()
    ref_out.sum().backward()
    np.testing.assert_allclose(pcol.weight.grad.numpy(), w1.grad.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_column_gather_and_row_global_input(groups):
    rg, pg = groups
    pt.seed(1)
    rcol = rmp.ColumnParallelLinear(8, 16, gather_output=True, mp_group=rg)
    rrow = rmp.RowParallelLinear(16, 4, input_is_parallel=False, mp_group=rg)
    pcol = pmp.ColumnParallelLinear(8, 16, gather_output=True, mp_group=pg)
    prow = pmp.RowParallelLinear(16, 4, mp_group=pg)
    _carry(rcol, pcol)
    _carry(rrow, prow)
    x = _x((3, 5, 8), seed=1)
    h = np.asarray(rcol(pt.to_tensor(x)).value)
    got = pcol(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), h, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        prow(got).detach().numpy(),
        np.asarray(rrow(pt.to_tensor(h)).value), rtol=RTOL, atol=ATOL)
    with pytest.raises(InvalidArgumentError, match="input_is_parallel"):
        prow(list(torch.chunk(got, MP, dim=-1)))
    with pytest.raises(InvalidArgumentError, match="divisible"):
        pmp.ColumnParallelLinear(8, 10, mp_group=pg)


def test_vocab_parallel_embedding_matches_reference(groups):
    rg, pg = groups
    pt.seed(2)
    remb = rmp.VocabParallelEmbedding(64, 16, mp_group=rg)
    pemb = pmp.VocabParallelEmbedding(64, 16, mp_group=pg)
    _carry(remb, pemb)
    ids = np.random.RandomState(2).randint(0, 64, (4, 7)).astype(np.int32)
    want = np.asarray(remb(pt.to_tensor(ids)).value)
    got = pemb(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    counts = np.bincount(ids.ravel(), minlength=64)[:, None]
    np.testing.assert_array_equal(pemb.weight.grad.numpy(),
                                  np.broadcast_to(counts, (64, 16)))


@pytest.mark.parametrize("ignore", [None, 3])
def test_parallel_cross_entropy_matches_reference(groups, ignore):
    rg, pg = groups
    logits = _x((2, 6, 64), seed=3) * 3
    labels = np.random.RandomState(3).randint(0, 64, (2, 6)).astype(np.int64)
    kw = {} if ignore is None else {"ignore_index": ignore}
    if ignore is not None:
        labels[0, :2] = ignore
    want = np.asarray(rmp.ParallelCrossEntropy(mp_group=rg, **kw)(
        pt.to_tensor(logits), pt.to_tensor(labels.astype(np.int32))).value)
    lt = torch.from_numpy(logits).requires_grad_()
    got = pmp.ParallelCrossEntropy(mp_group=pg, **kw)(lt,
                                                      torch.from_numpy(labels))
    assert got.shape == (2, 6, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    got.sum().backward()
    dense = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).reshape(-1, 64).requires_grad_(),
        torch.from_numpy(labels).reshape(-1), reduction="none",
        ignore_index=-100 if ignore is None else ignore)
    np.testing.assert_allclose(got.detach().numpy().ravel(),
                               dense.detach().numpy(), rtol=RTOL, atol=ATOL)


def test_megatron_encoder_layer_matches_unsharded():
    """A TransformerEncoderLayer with q/k/v and linear1 column-parallel,
    out_proj and linear2 row-parallel (shard_linear) gives the unsharded
    layer's output and gradients: the reference's unsharded layer holds
    the forward, the port's unsharded twin the gradients."""
    from paddle_tpu.nn.layer.transformer import \
        TransformerEncoderLayer as RefLayer
    from paddle_tpu_torch.nn.layer.transformer import TransformerEncoderLayer

    pt.seed(4)
    ref = RefLayer(32, 4, 64, dropout=0.0, activation="gelu")
    port = TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                   activation="gelu", device="cpu")
    twin = TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                   activation="gelu", device="cpu")
    _carry(ref, port)
    _carry(ref, twin)
    attn = port.self_attn
    for lin in (attn.q_proj, attn.k_proj, attn.v_proj, port.linear1):
        pmp.shard_linear(lin, "column", 2)
    for lin in (attn.out_proj, port.linear2):
        pmp.shard_linear(lin, "row", 2)
    x = _x((2, 6, 32), seed=4)
    mask = np.triu(np.full((6, 6), -1e9, np.float32), 1)
    want = np.asarray(ref(pt.to_tensor(x), pt.to_tensor(mask)).value)
    got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=1e-5)
    got.square().sum().backward()
    twin(torch.from_numpy(x), torch.from_numpy(mask)).square().sum() \
        .backward()
    for (n, a), b in zip(port.named_parameters(), twin.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    with pytest.raises(InvalidArgumentError, match="mp degree 3"):
        pmp.shard_linear(attn.q_proj, "column", 3)


def test_mp_training_matches_reference(groups):
    rg, pg = groups
    xs = _x((8, 16), seed=5)
    ys = np.random.RandomState(5).randint(0, 4, (8,))
    pt.seed(5)
    rcol = rmp.ColumnParallelLinear(16, 32, gather_output=False,
                                    mp_group=rg)
    rrow = rmp.RowParallelLinear(32, 4, input_is_parallel=True, mp_group=rg)
    ref = pt.nn.Sequential(rcol, pt.nn.ReLU(), rrow)
    pcol = pmp.ColumnParallelLinear(16, 32, gather_output=True, mp_group=pg)
    prow = pmp.RowParallelLinear(32, 4, mp_group=pg)
    _carry(rcol, pcol)
    _carry(rrow, prow)
    port = torch.nn.Sequential(pcol, torch.nn.ReLU(), prow)
    ropt = pt.optimizer.SGD(0.1, parameters=ref.parameters())
    popt = dist.fleet.distributed_optimizer(
        __import__("paddle_tpu_torch").optimizer.SGD(
            0.1, parameters=list(port.parameters())))
    want, got = [], []
    for _ in range(4):
        loss = pt.nn.functional.cross_entropy(
            ref(pt.to_tensor(xs)), pt.to_tensor(ys.astype(np.int32)))
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        want.append(float(loss.value))
        pl = torch.nn.functional.cross_entropy(port(torch.from_numpy(xs)),
                                               torch.from_numpy(ys))
        pl.backward()
        popt.step()
        popt.clear_grad()
        got.append(float(pl))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1] < got[0]

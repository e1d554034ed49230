"""The port's pipeline (``meta_parallel.pp_layers``, ``spmd_pipeline``,
``pipeline_parallel``) against the reference's.

The pipelines have an embedding prefix, transformer-block stages and a
norm + projection suffix (the reference's pipeline aborts inside XLA on
a homogeneous pipeline with no prefix when the host is busy, so none is
built here).  The reference's weights are carried across by name.

Tolerances: the reference's compiled pipeline (a scan over ticks on the
host devices) against the port's microbatch loop, AdamW, losses over 2
steps to ``rtol=1e-4, atol=1e-5`` (the reference test's own bound
against plain training); within the port, the pipelined step against
plain microbatch accumulation of the same layers is exact to float32
rounding of one summation order (``rtol=1e-6``); with the stages split
mp 2 (Megatron) the row-parallel rank-order sums move the last bits
(``rtol=1e-5``).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as pt
import paddle_tpu.nn.functional as RF
import paddle_tpu.tensor as RT
from jax.sharding import Mesh
from paddle_tpu.distributed.meta_parallel.pp_layers import \
    PipelineLayer as RefPipelineLayer
from paddle_tpu.distributed.meta_parallel.spmd_pipeline import \
    PipelineTrainStep as RefPipelineTrainStep
from paddle_tpu.nn.layer.common import Embedding as RefEmbedding
from paddle_tpu.nn.layer.common import Linear as RefLinear
from paddle_tpu.nn.layer.norm import LayerNorm as RefLayerNorm
from paddle_tpu.nn.layer.transformer import \
    TransformerEncoderLayer as RefEncoderLayer

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.distributed.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, PipelineTrainStep,
    SharedLayerDesc, megatron_param_spec, partition_pipeline)
from paddle_tpu_torch.distributed.topology import LogicalMesh

D, V, S, HEADS, FF = 16, 32, 8, 2, 32


class RefBlock(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.l = RefEncoderLayer(D, HEADS, FF, dropout=0.0)

    def forward(self, x):
        return self.l(x)


class RefEmbed(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = RefEmbedding(V, D)

    def forward(self, ids):
        return self.emb(ids)


class RefHead(pt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.norm = RefLayerNorm(D)
        self.proj = RefLinear(D, V)

    def forward(self, h):
        return self.proj(self.norm(h))


class Block(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.l = ptt.nn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0,
                                                device="cpu")

    def forward(self, x):
        return self.l(x)


class Embed(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = ptt.nn.Embedding(V, D, device="cpu")

    def forward(self, ids):
        return self.emb(ids)


class Head(ptt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.norm = ptt.nn.LayerNorm(D, device="cpu")
        self.proj = ptt.nn.Linear(D, V, device="cpu")

    def forward(self, h):
        return self.proj(self.norm(h))


def ref_loss(logits, labels):
    return RF.cross_entropy(RT.reshape(logits, [-1, V]),
                            RT.reshape(labels, [-1]), reduction="mean")


def port_loss(logits, labels):
    return torch.nn.functional.cross_entropy(logits.reshape(-1, V),
                                             labels.reshape(-1).long())


def _data(steps, b, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, V, (steps, b, S)).astype(np.int64),
            rng.randint(0, V, (steps, b, S)).astype(np.int64))


def _port_pipeline(n_blocks, stages, ref=None, seed=0):
    torch.manual_seed(seed)
    pl = PipelineLayer([Embed()] + [LayerDesc(Block)
                                    for _ in range(n_blocks)] + [Head()],
                       num_stages=stages, loss_fn=port_loss)
    if ref is not None:
        ptt.load_reference_params(pl, {n: np.array(p.value) for n, p in
                                       ref.named_parameters()})
    return pl


def _plain(pl, xs, ys, m, steps, lr=1e-3):
    """Plain microbatch accumulation over the same layers."""
    opt = ptt.optimizer.AdamW(lr, parameters=pl.parameters())
    losses = []
    for s in range(steps):
        x, y = torch.from_numpy(xs[s]), torch.from_numpy(ys[s])
        mb = x.shape[0] // m
        tot = 0.0
        for i in range(m):
            loss = port_loss(pl(x[i * mb:(i + 1) * mb]),
                             y[i * mb:(i + 1) * mb])
            (loss / m).backward()
            tot += float(loss)
        opt.step()
        opt.clear_grad()
        losses.append(tot / m)
    return losses


def test_pipeline_matches_the_reference_pipeline():
    steps, m, b = 2, 2, 8
    xs, ys = _data(steps, b)
    pt.seed(0)
    ref = RefPipelineLayer([RefEmbed()] + [RefBlock() for _ in range(4)]
                           + [RefHead()], num_stages=2, loss_fn=ref_loss)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "pp"))
    ropt = pt.optimizer.AdamW(1e-3, parameters=ref.parameters())
    reng = RefPipelineTrainStep(ref, ropt, mesh, microbatches=m)
    want = [float(reng(pt.to_tensor(xs[i].astype(np.int32)),
                       pt.to_tensor(ys[i])).value) for i in range(steps)]
    pl = _port_pipeline(4, 2, ref=None)
    pt.seed(0)
    fresh = RefPipelineLayer([RefEmbed()] + [RefBlock() for _ in range(4)]
                             + [RefHead()], num_stages=2, loss_fn=ref_loss)
    ptt.load_reference_params(pl, {n: np.array(p.value) for n, p in
                                   fresh.named_parameters()})
    opt = ptt.optimizer.AdamW(1e-3, parameters=pl.parameters())
    step = PipelineTrainStep(pl, opt, LogicalMesh(("dp", "pp"), (2, 2),
                                                  "cpu"), microbatches=m)
    got = [float(step(xs[i], ys[i])) for i in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("recompute", [True, False])
def test_pipelined_step_equals_microbatch_accumulation(recompute):
    steps, m, b = 3, 4, 8
    xs, ys = _data(steps, b, seed=1)
    plain = _port_pipeline(4, 2, seed=3)
    want = _plain(plain, xs, ys, m, steps)
    pl = _port_pipeline(4, 2, seed=3)
    opt = ptt.optimizer.AdamW(1e-3, parameters=pl.parameters())
    step = PipelineTrainStep(pl, opt, LogicalMesh(("pp",), (2,), "cpu"),
                             microbatches=m, recompute=recompute)
    got = [float(step(xs[i], ys[i])) for i in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert step.compile_counts() == {"train_step": 1}
    assert step.stage_devices(1) == {torch.device("cpu")}


def test_pp_by_mp_matches_the_unsharded_pipeline():
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 2, "pp_degree": 2}
    dist.fleet.init(strategy=st, device="cpu")
    hcg = dist.fleet.get_hybrid_communicate_group()
    steps, m, b = 3, 2, 4
    xs, ys = _data(steps, b, seed=2)
    plain = _port_pipeline(4, 2, seed=4)
    want = _plain(plain, xs, ys, m, steps)
    pl = _port_pipeline(4, 2, seed=4)
    _, core, _ = partition_pipeline(pl)
    spec = megatron_param_spec(core[0])
    opt = ptt.optimizer.AdamW(1e-3, parameters=pl.parameters())
    step = PipelineTrainStep(pl, opt, hcg, microbatches=m,
                             mp_param_spec=spec)
    assert step.mp == 2
    attn = core[1][0][0].l.self_attn
    assert attn._tp_degree() == 2
    got = [float(step(xs[i], ys[i])) for i in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the full logical parameters: the reference's names and shapes
    assert pl.state_dict()["1.l.self_attn.q_proj.weight"].shape == (D, D)


def test_segmentation_and_partition_are_the_reference_s():
    pt.seed(0)
    ref = RefPipelineLayer([RefEmbed()] + [RefBlock() for _ in range(5)]
                           + [RefHead()], num_stages=3,
                           seg_method="layer:Block", loss_fn=ref_loss)
    pl = PipelineLayer([Embed()] + [Block() for _ in range(5)] + [Head()],
                       num_stages=3, seg_method="layer:Block",
                       loss_fn=port_loss)
    assert pl._stage_bounds == ref._stage_bounds
    for s in range(3):
        assert [type(o).__name__ for o in pl.stage_layers(s)] == \
            [type(o).__name__[3:] for o in ref.stage_layers(s)]
    assert [pl.stage_of(i) for i in range(7)] == \
        [ref.stage_of(i) for i in range(7)]
    from paddle_tpu.distributed.meta_parallel.spmd_pipeline import \
        partition_pipeline as ref_partition

    for stages in (2, 4):
        pt.seed(0)
        ref_u = RefPipelineLayer([RefEmbed()] + [RefBlock()
                                                 for _ in range(6)]
                                 + [RefHead()], num_stages=stages,
                                 loss_fn=ref_loss)
        uniform = PipelineLayer([Embed()] + [Block() for _ in range(6)]
                                + [Head()], num_stages=stages,
                                loss_fn=port_loss)
        got = partition_pipeline(uniform)
        want = ref_partition(ref_u)
        assert [len(got[0]), [len(c) for c in got[1]], len(got[2])] == \
            [len(want[0]), [len(c) for c in want[1]], len(want[2])]
    hetero = PipelineLayer([Embed(), Head()], num_stages=2,
                           loss_fn=port_loss)
    assert partition_pipeline(hetero) is None
    with pytest.raises(InvalidArgumentError, match="homogeneous"):
        PipelineTrainStep(hetero, ptt.optimizer.SGD(0.1, parameters=
                                                    hetero.parameters()),
                          LogicalMesh(("pp",), (2,), "cpu"), 1)
    shared = PipelineLayer([SharedLayerDesc("e", Embed), Block(),
                            SharedLayerDesc("e", Embed,
                                            forward_func=lambda o, h:
                                            h @ o.emb.weight.t())],
                           num_stages=1, loss_fn=port_loss)
    assert shared._funcs[0][0] is shared._funcs[2][0]
    with pytest.raises(InvalidArgumentError, match="marks"):
        PipelineLayer([Embed(), Head()], num_stages=2,
                      seg_method="layer:Block")


def test_pipeline_parallel_train_batch_through_fleet():
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 2}
    st.pipeline_configs = {"accumulate_steps": 2}
    dist.fleet.init(strategy=st, device="cpu")
    xs, ys = _data(2, 4, seed=5)
    plain = _port_pipeline(2, 2, seed=6)
    want = _plain(plain, xs, ys, 2, 2)
    pl = _port_pipeline(2, 2, seed=6)
    engine = dist.fleet.distributed_model(pl)
    assert isinstance(engine, PipelineParallel)
    opt = ptt.optimizer.AdamW(1e-3, parameters=pl.parameters())
    got = [float(engine.train_batch((xs[i], ys[i]), opt)) for i in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert engine.stage_devices(0) == {torch.device("cpu")}
    # a scaler takes the accumulation path: the same arithmetic
    pl2 = _port_pipeline(2, 2, seed=6)
    eng2 = PipelineParallel(pl2, strategy=st)
    opt2 = ptt.optimizer.AdamW(1e-3, parameters=pl2.parameters())
    got2 = [float(eng2.train_batch((torch.from_numpy(xs[i]),
                                    torch.from_numpy(ys[i])), opt2))
            for i in range(2)]
    np.testing.assert_allclose(got2, want, rtol=1e-6)

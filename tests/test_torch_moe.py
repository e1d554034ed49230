"""The port's mixture-of-experts (``meta_parallel.moe_layer``) against the
reference's ``MoELayer`` (the reference's weights carried across), a
per-token routing loop, and its own one-rank form.

Ties: both packages pick experts by ``argmax``, and ``torch``'s need not
break near-ties as JAX's does, so the cross-package outputs are compared
only on tokens whose router probabilities separate the picks by at least
``PICK_MARGIN_FLOOR`` (the top-2 against the third, and the top-1
against the second); every other property is an invariant.

Tolerances: outputs against the reference and the loop ``rtol=2e-4,
atol=2e-5`` (the reference test's); ep 2 against one rank is exact (the
same einsums on expert slices: ``rtol=1e-6``); the aux loss ``1e-6``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed.meta_parallel import MoELayer as RefMoE
from paddle_tpu.distributed.meta_parallel import top2_gating as ref_gating

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.meta_parallel import MoELayer, top2_gating
from paddle_tpu_torch.core.errors import InvalidArgumentError

PICK_MARGIN_FLOOR = 1e-4
RTOL, ATOL = 2e-4, 2e-5


def _carry(ref, port):
    ptt.load_reference_params(port, {n: np.array(p.value) for n, p in
                                     ref.named_parameters()})


def _margins(x, wg):
    logits = x.reshape(-1, x.shape[-1]) @ wg
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    srt = np.sort(p, -1)[:, ::-1]
    return np.minimum(srt[:, 0] - srt[:, 1], srt[:, 1] - srt[:, 2])


def test_gating_matches_reference_and_invariants():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 16, 4).astype(np.float32)
    rd, rc, raux = (np.asarray(t) for t in ref_gating(
        __import__("jax").numpy.asarray(logits), capacity=5, top_k=2))
    d, c, aux = top2_gating(torch.from_numpy(logits), capacity=5, top_k=2)
    np.testing.assert_array_equal(d.numpy(), rd)
    np.testing.assert_allclose(c.numpy(), rc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    assert d.sum(dim=(2, 3)).max() <= 2 and d.sum(dim=1).max() <= 1
    assert ((c > 0) <= (d > 0)).all()


@pytest.mark.parametrize("ep", [1, 2])
def test_moe_matches_reference_where_picks_are_clear(ep):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 8).astype(np.float32)
    pt.seed(1)
    ref = RefMoE(8, 16, 4, top_k=2, capacity_factor=1.0)
    group = None
    if ep > 1:
        dist.destroy_process_group()
        group = dist.init_parallel_env(world_size=ep, device="cpu")
    port = MoELayer(8, 16, 4, top_k=2, capacity_factor=1.0, ep_group=group,
                    device="cpu")
    _carry(ref, port)
    want = np.asarray(ref(pt.to_tensor(x)).value)
    got = port(torch.from_numpy(x)).detach().numpy()
    clear = _margins(x, np.asarray(ref.gate_weight.value)) \
        >= PICK_MARGIN_FLOOR
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got.reshape(-1, 8)[clear],
                               want.reshape(-1, 8)[clear], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(port.aux_loss),
                               float(ref.aux_loss.value), rtol=1e-6)
    dist.destroy_process_group()


def test_moe_matches_per_token_loop():
    rng = np.random.RandomState(2)
    b, s, m, h, e = 2, 8, 6, 12, 4
    x = rng.randn(b, s, m).astype(np.float32)
    moe = MoELayer(m, h, e, top_k=2, capacity_factor=float(e),
                   activation="relu", renormalize=False, device="cpu")
    out = moe(torch.from_numpy(x)).detach().numpy()
    wg = moe.gate_weight.detach().numpy()
    w1, b1 = moe.w1.detach().numpy(), moe.b1.detach().numpy()
    w2, b2 = moe.w2.detach().numpy(), moe.b2.detach().numpy()
    want = np.zeros_like(x)
    for i in range(b):
        for t in range(s):
            logit = x[i, t] @ wg
            p = np.exp(logit - logit.max())
            p /= p.sum()
            for k in np.argsort(-p)[:2]:
                hid = np.maximum(x[i, t] @ w1[k] + b1[k], 0.0)
                want[i, t] += p[k] * (hid @ w2[k] + b2[k])
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_ep_ranks_equal_one_rank_and_train_through_fleet():
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                         "ep_degree": 2}
    dist.fleet.init(strategy=st, device="cpu")
    torch.manual_seed(3)
    moe = MoELayer(8, 16, 4, device="cpu")
    assert moe.ep_degree == 2 and moe.w1.is_distributed
    one = MoELayer(8, 16, 4, ep_group=None, device="cpu")
    one.ep_degree = 1
    one.load_state_dict(moe.state_dict())
    x = torch.randn(4, 8, 8)
    np.testing.assert_allclose(moe(x).detach().numpy(),
                               one(x).detach().numpy(), rtol=1e-6)
    opt = ptt.optimizer.Adam(1e-2, parameters=moe.parameters())
    step = ptt.TrainStep(
        moe, lambda m, v: m(v).square().mean() + 0.01 * m.aux_loss, opt)
    losses = [float(step(x)) for _ in range(4)]
    assert losses[-1] < losses[0]
    for p in (moe.gate_weight, moe.w1, moe.w2):
        assert p.requires_grad
    with pytest.raises(InvalidArgumentError, match="divisible"):
        MoELayer(8, 16, 3, device="cpu")
    with pytest.raises(InvalidArgumentError, match="top_k"):
        MoELayer(8, 16, 2, top_k=3, device="cpu")
    with pytest.raises(InvalidArgumentError, match="batch, seq"):
        moe(torch.randn(4, 8))

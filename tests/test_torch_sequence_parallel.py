"""The port's sequence parallelism (``meta_parallel.sequence_parallel``)
against the reference's ``shard_map`` runs on the conftest's host devices
and against dense attention, then wired into ``MultiHeadAttention`` and
``TransformerLM``.

Tolerances: ring and Ulysses in float32 against the reference's runs and
against dense attention, ``rtol=2e-4, atol=2e-5`` (the reference test's;
the online softmax and K3's twin sum in other orders); their gradients
against dense attention's ``rtol=5e-4, atol=5e-5`` (the reference
test's); sep-4 ``TransformerLM`` losses over 3 Adam steps against the
reference's sep-4 losses ``rtol=2e-4, atol=1e-5`` (the reference test's
bound against its unsharded model).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as pt
from paddle_tpu.distributed.collective import shard_map as ref_shard_map
from paddle_tpu.distributed.meta_parallel import sequence_parallel as rsp

import paddle_tpu_torch as ptt
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as sp

N = 4
B, H, L, D = 2, 8, 32, 16
RTOL, ATOL = 2e-4, 2e-5


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, L, D).astype(np.float32) for _ in range(3)]


def _dense(q, k, v, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((L, L), bool)), s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", w, v)


def _ref_run(fn_name, q, k, v, causal):
    mesh = Mesh(np.array(jax.devices()[:N]), ("sep",))
    inner = getattr(rsp, fn_name)
    fn = ref_shard_map(lambda a, b, c: inner(a, b, c, "sep", causal=causal),
                       mesh=mesh, in_specs=(P(None, None, "sep"),) * 3,
                       out_specs=P(None, None, "sep"))
    return np.asarray(jax.jit(fn)(q, k, v))


@pytest.fixture()
def group():
    dist.destroy_process_group()
    g = dist.init_parallel_env(world_size=N, device="cpu")
    yield g
    dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_reference_and_dense(group, mode, causal):
    q, k, v = _qkv()
    want = _ref_run(mode + "_attention", q, k, v, causal)
    got = sp.sep_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                           group, mode=mode, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), _dense(q, k, v, causal),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_gradients_match_dense(group, mode):
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in _qkv(1))
    sp.sep_attention(q, k, v, group, mode=mode, causal=True).sum() \
        .backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    s = q @ k.transpose(-1, -2) / np.sqrt(D)
    s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(), -1e30)
    (torch.softmax(s, -1) @ v).sum().backward()
    for a, t in zip(got, (q, k, v)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=5e-4,
                                   atol=5e-5)


def test_list_forms_and_refusals(group):
    x = torch.arange(2 * L * 3, dtype=torch.float32).reshape(2, L, 3)
    blocks = sp.split_sequence(x, group, seq_axis=1)
    assert len(blocks) == N and blocks[0].shape == (2, L // N, 3)
    assert torch.equal(sp.gather_sequence(blocks, group, seq_axis=1), x)
    with pytest.raises(InvalidArgumentError, match="divisible"):
        sp.split_sequence(torch.zeros(1, L + 1), group)
    q = [torch.zeros(1, 2, 4, D)] * N
    with pytest.raises(InvalidArgumentError, match="heads"):
        sp.ulysses_attention(q, q, q, group)
    with pytest.raises(InvalidArgumentError, match="blocks"):
        sp.ring_attention(q[:2], q, q, group)


def _ref_lm():
    from paddle_tpu.models import TransformerLM

    pt.seed(0)
    return TransformerLM(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64, max_position=32,
                         dropout=0.0, causal=True)


def _ref_losses(mode):
    from paddle_tpu.distributed import fleet as rfleet
    from paddle_tpu.jit import TrainStep
    from paddle_tpu.models import TransformerLMCriterion

    st = rfleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                         "sharding_degree": 1, "sep_degree": N}
    rfleet.init(is_collective=True, strategy=st)
    group = rfleet.get_hybrid_communicate_group().get_sep_parallel_group()
    model = _ref_lm().enable_sequence_parallel(group, mode)
    crit = TransformerLMCriterion(shift_labels=False)
    opt = pt.optimizer.Adam(1e-3, parameters=model.parameters())
    step = TrainStep(model, lambda m, x, y: crit(m(x), y), opt, donate=False)
    ids = np.random.RandomState(3).randint(0, 64, (2, 16)).astype("int32")
    return [float(step(pt.to_tensor(ids), pt.to_tensor(ids)))
            for _ in range(3)]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_transformer_lm_sep4_matches_reference(mode):
    want = _ref_losses(mode)
    st = dist.fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                         "sep_degree": N}
    st.sep_configs = {"mode": mode}
    dist.fleet.init(strategy=st, device="cpu")
    model = ptt.TransformerLM(vocab_size=64, hidden_size=32, num_layers=2,
                              num_heads=4, intermediate_size=64,
                              max_position=32, dropout=0.0, causal=True,
                              device="cpu")
    ptt.load_reference_params(model, {n: np.array(p.value) for n, p in
                                      _ref_lm().named_parameters()})
    wrapped = dist.fleet.distributed_model(model)
    assert model._sequence_parallel
    assert model.encoder.layers[0].self_attn._sep[1] == mode
    crit = ptt.TransformerLMCriterion(shift_labels=False)
    opt = ptt.optimizer.Adam(1e-3, parameters=model.parameters())
    step = ptt.TrainStep(wrapped, lambda m, x, y: crit(m(x), y), opt)
    ids = np.random.RandomState(3).randint(0, 64, (2, 16))
    got = [float(step(ids, ids)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    assert got[-1] < got[0]


def test_mha_sequence_parallel_refusals(group):
    mha = ptt.nn.MultiHeadAttention(32, 4, dropout=0.1, device="cpu")
    with pytest.raises(InvalidArgumentError, match="dropout"):
        mha.enable_sequence_parallel(group)
    mha = ptt.nn.MultiHeadAttention(32, 2, dropout=0.0, device="cpu")
    with pytest.raises(InvalidArgumentError, match="ulysses"):
        mha.enable_sequence_parallel(group, mode="ulysses")
    mha.enable_sequence_parallel(group, mode="ring", causal=True)
    x = torch.randn(2, 16, 32)
    with pytest.raises(InvalidArgumentError, match="mask"):
        mha(x, attn_mask=torch.zeros(16, 16))
    out = mha(x)
    out.sum().backward()
    assert mha.q_proj.weight.grad.abs().sum() > 0
    with pytest.raises(InvalidArgumentError, match="'ring' or 'ulysses'"):
        mha.enable_sequence_parallel(group, mode="tree")

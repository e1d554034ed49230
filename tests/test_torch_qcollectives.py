"""The port's quantized model-parallel collectives
(``paddle_tpu_torch.distributed.qcollectives``): the reference's
``tests/test_qcollectives.py`` re-pointed at the port on the CPU (every
shard of a mesh on ``"cpu"``), plus the same inputs through both packages.

Pinned here, as in the reference:

1. PRIMITIVES: ``qpsum`` over a list of shard partials matches their fp32
   sum within the reference's two-hop bound, every shard holding the same
   result; ``qall_gather`` within half a step; quantize/dequantize round
   trips (padded blocks, all-zero blocks); the wire-byte helpers' exact
   ring figures.
2. THE SEAM: ``collective_quant="int8"`` on 1x2 and 2x2 meshes, paged x
   {fp32, int8 KV}, keeps the unquantized mesh's ``compile_counts()`` and
   stamps quantized bytes strictly below the dense ring's.  Greedy token
   identity through int8 reductions is a margin property, and the
   reference's own identity case is a known caveat at this size, so the
   counterparts hold every seam's reduction within the primitive bound and
   the decode steps' logits within ``INT8_LOGIT_TOL`` of their largest
   magnitude (tokens compared while they agree).
3. "none" is the fp32 reduction: a mesh pool decodes the unsharded pool's
   tokens.
4. ACCOUNTING: "none" stamps the quantized and dense columns equal, int8
   strictly below; ``cost_report``'s derived block carries them.
5. TYPED ERRORS at construction.

Across the packages: ``quantize_int8``/``dequantize_int8`` bit for bit on
the same numpy inputs (both round half to even), the wire-byte helpers the
same integers, and the collective columns of a 2x2 int8 pool equal to the
reference pool's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import qcollectives as ref_qc
from paddle_tpu.inference.generation import GenerationPool as RefPool
from paddle_tpu.jit.mesh import DecodeMesh as RefMesh
from paddle_tpu.models import TransformerLM as RefLM
from torch_parity import reference_arrays

from paddle_tpu_torch import TransformerLM, load_reference_params
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.distributed import qcollectives as qc
from paddle_tpu_torch.inference.generation import GenerationPool
from paddle_tpu_torch.jit.mesh import DecodeMesh
from paddle_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position=64, causal=True,
           dropout=0.0)

# the reference's greedy-identity model seed (its seeds 0-1 hold top-1
# gaps below the int8 error floor)
SEED = 2

# the int8 seams' perturbation of a decode step's logits, as a share of
# the step's largest logit magnitude: at most 1.4% measured over seeds
# 0-3 on this configuration (4 seams of 2 layers), held at 3%
INT8_LOGIT_TOL = 0.03


def mesh(dp, mp, **kw):
    return DecodeMesh(dp, mp, devices=["cpu"] * (dp * mp), **kw)


def _fresh_model(seed=SEED):
    return TransformerLM(**CFG, device="cpu", seed=seed)


def _prompts(n=4, seed=0):
    rng = np.random.RandomState(seed)
    lens = [5, 9, 3, 12, 7, 10, 4, 8][:n]
    return [rng.randint(1, CFG["vocab_size"], (l,)).astype("int32")
            for l in lens]


def _pool(mesh=None, dtype="float32", model=None, **kw):
    return GenerationPool(model or _fresh_model(), max_len=32, slots=4,
                          buckets=[16], cache_layout="paged", block_size=4,
                          cache_dtype=dtype, mesh=mesh, device="cpu", **kw)


def _qpsum_bound(parts, want):
    """The reference's two-hop bound: each of the ``n`` incoming chunks
    carries at most half a step of its scale, the re-quantized reduced
    chunk at most half a step of its own."""
    n = len(parts)
    amax_in = max(float(p.abs().max()) for p in parts)
    return n * (amax_in / 254.0) + float(want.abs().max()) / 254.0


# -- contract 1: primitives --------------------------------------------------

@pytest.mark.parametrize("scale_mode", ["block", "channel"])
def test_quantize_roundtrip_within_bound(scale_mode):
    """|x - deq(q)| <= scale/2 per element, padded blocks stripped, the
    original shape restored."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 20).astype(np.float32)  # 20 % block(8) != 0: pads
    q, s = qc.quantize_int8(torch.from_numpy(x), scale_mode, block=8)
    out = qc.dequantize_int8(q, s, x.shape[-1], scale_mode).numpy()
    assert out.shape == x.shape
    if scale_mode == "channel":
        step = s.numpy()[None, :]
    else:
        step = np.repeat(s.numpy(), 8, axis=-1)[:, :20]
    assert (np.abs(out - x) < step / 2 + 1e-7).all()


@pytest.mark.parametrize("shape,block", [((3, 20), 8), ((2, 5, 64), 32),
                                         ((4, 96), 32), ((7,), 4)])
@pytest.mark.parametrize("scale_mode", ["block", "channel"])
def test_quantize_bit_identical_to_reference(scale_mode, shape, block):
    """The same numpy input through both packages' quantize and
    dequantize: payload, scales and reconstruction equal bit for bit
    (ties included: both round half to even)."""
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    # a block whose amax is 127 has scale 1: 0.5, 1.5 and -2.5 are ties
    x.reshape(-1)[:4] = [127.0, 0.5, 1.5, -2.5]
    q, s = qc.quantize_int8(torch.from_numpy(x), scale_mode, block)
    rq, rs = ref_qc.quantize_int8(x, scale_mode, block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    out = qc.dequantize_int8(q, s, shape[-1], scale_mode).numpy()
    ref = np.asarray(ref_qc.dequantize_int8(rq, rs, shape[-1], scale_mode))
    np.testing.assert_array_equal(out, ref)


def test_round_half_to_even():
    """``torch.round`` is ``jnp.round``: halves go to the even integer."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  [0.0, 2.0, 2.0, -0.0, -2.0, -2.0])


def test_quantize_zero_block_roundtrips_exactly():
    # a zero amax maps to scale 1, not a divide-by-zero
    x = torch.zeros((2, 16))
    for mode in qc.COLLECTIVE_QUANT_SCALES:
        q, s = qc.quantize_int8(x, mode, block=8)
        out = qc.dequantize_int8(q, s, 16, mode)
        np.testing.assert_array_equal(out.numpy(), x.numpy())


@pytest.mark.parametrize("scale_mode", ["block", "channel"])
def test_qpsum_matches_psum_within_bound(scale_mode):
    """qpsum over two shards' partials == their fp32 sum within the
    two-hop bound, and every shard holds the SAME reduction."""
    n = 2
    rng = np.random.RandomState(1)
    parts = [torch.from_numpy(p) for p in
             rng.randn(n, 4, 32).astype(np.float32)]
    want = parts[0] + parts[1]
    got = qc.qpsum(parts, scale_mode, qc.QUANT_BLOCK)
    assert len(got) == n
    np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())
    bound = _qpsum_bound(parts, want)
    assert float((got[0] - want).abs().max()) <= bound + 1e-6


def test_qpsum_identity_on_size_one_axis():
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    (got,) = qc.qpsum([x])
    np.testing.assert_array_equal(got.numpy(), x.numpy())


def test_qpsum_rejects_indivisible_last_axis():
    with pytest.raises(InvalidArgumentError, match="divisible"):
        qc.qpsum([torch.ones(3, 5), torch.ones(3, 5)])


def test_qall_gather_matches_all_gather():
    rng = np.random.RandomState(2)
    x = [torch.from_numpy(p) for p in rng.randn(2, 4, 32).astype(np.float32)]
    got = qc.qall_gather(x)
    # every shard stacks the shard payloads in shard order
    for shard in range(2):
        assert tuple(got[shard].shape) == (2, 4, 32)
        for j in range(2):
            assert ((got[shard][j] - x[j]).abs()
                    < float(x[j].abs().max()) / 254.0 + 1e-7).all()


def test_wire_byte_helpers_exact():
    # dense ring all-reduce: 2*(n-1)/n of the fp32 payload per device
    assert qc.psum_wire_bytes((4, 32), 2) == 512
    assert qc.psum_wire_bytes((4, 32), 4) == 768
    assert qc.psum_wire_bytes((4, 32), 1) == 0
    # two-stage quantized: 2*(n-1) chunk payloads, int8 body + scales
    assert qc.qpsum_wire_bytes((4, 32), 2) == 288
    assert qc.qpsum_wire_bytes((4, 32), 2, "channel") == 256
    assert qc.qpsum_wire_bytes((4, 32), 1) == 0
    with pytest.raises(InvalidArgumentError, match="divisible"):
        qc.qpsum_wire_bytes((4, 30), 4)


@pytest.mark.parametrize("shape", [(4, 32), (2, 1, 2048), (8, 5, 2048),
                                   (3, 96), (1, 64)])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_wire_bytes_equal_reference(shape, n):
    """The same integers as the reference's helpers, every mode."""
    assert qc.psum_wire_bytes(shape, n) == ref_qc.psum_wire_bytes(shape, n)
    for mode in qc.COLLECTIVE_QUANT_SCALES:
        for block in (8, 32):
            assert qc.qpsum_wire_bytes(shape, n, mode, block) \
                == ref_qc.qpsum_wire_bytes(shape, n, mode, block)


def test_normalize_typed_errors():
    with pytest.raises(InvalidArgumentError, match="collective_quant"):
        qc.normalize_collective_quant("int4")
    with pytest.raises(InvalidArgumentError,
                       match="collective_quant_scale"):
        qc.normalize_collective_scale("tensor")


def test_row_parallel_linear_checks_and_bias_once():
    """The seam's own refusals (batch over dp, contraction over mp) and
    the bias added once after the reduce."""
    m = mesh(2, 2)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 1, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    b = torch.from_numpy(rng.randn(6).astype(np.float32))
    xs = [[x[d * 2:(d + 1) * 2, :, m_ * 4:(m_ + 1) * 4] for m_ in range(2)]
          for d in range(2)]
    ws = [w[:4], w[4:]]
    want = x @ w + b
    with qc.collective_quant("none", m, sink={}):
        got = qc.row_parallel_linear(xs, ws, b, qc.active())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    # one dp group of 3 rows cannot split over dp=2
    odd = [[x[:3, :, :4], x[:3, :, 4:]]]
    with qc.collective_quant("int8", m):
        with pytest.raises(InvalidArgumentError, match="divisible by dp"):
            qc.row_parallel_linear(odd, ws, b, qc.active())
    three = [[x[:2, :, :3], x[:2, :, 3:6], x[:2, :, 6:]]] * 2
    with qc.collective_quant("int8", m):
        with pytest.raises(InvalidArgumentError, match="divisible by mp"):
            qc.row_parallel_linear(three, [w[:3], w[3:6], w[6:]], b,
                                   qc.active())


# -- contracts 2-4: the serving seam ----------------------------------------

QMESHES = [(1, 2), (2, 2)]


def _checked_qpsum(monkeypatch, seen):
    """Wrap the seam's qpsum so every reduction is held against the fp32
    sum of the same partials within the two-hop bound."""
    real = qc.qpsum

    def checked(parts, scale_mode="block", block=qc.QUANT_BLOCK,
                devices=None):
        out = real(parts, scale_mode, block, devices)
        want = parts[0].float()
        for p in parts[1:]:
            want = want + p.float()
        err = float((out[0] - want).abs().max())
        assert err <= _qpsum_bound(parts, want) + 1e-6
        seen.append(err)
        return out

    monkeypatch.setattr(qc, "qpsum", checked)


def _logged(pool):
    """Record every decode step's [slots, V] logits."""
    logs = []
    fn = pool._decode_fn

    def step(tok):
        out = fn(tok)
        logs.append(out[1].clone())
        return out

    pool._decode_fn = step
    return fn, logs


def _hold_int8_logits(want_toks, got_toks, want_logs, got_logs):
    """Decode-step logits within INT8_LOGIT_TOL of the step's largest
    magnitude while every request's tokens still agree (a step whose
    inputs already differ is not a perturbation of the same step)."""
    steps = min(len(want_logs), len(got_logs))
    compared = 0
    for t in range(steps):
        # step t reads tokens[t]: its inputs agree while tokens[:t + 1] do
        if not all(np.array_equal(w[:t + 1], g[:t + 1])
                   for w, g in zip(want_toks, got_toks)):
            break
        scale = float(want_logs[t].abs().max())
        assert float((want_logs[t] - got_logs[t]).abs().max()) \
            <= INT8_LOGIT_TOL * scale
        compared += 1
    assert compared >= 1


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("dp,mp", QMESHES)
def test_int8_token_identity_and_compile_counts(dp, mp, dtype,
                                                monkeypatch):
    """The quantized mesh compiles the unquantized mesh's keys, every
    seam reduction is within the primitive bound, the decode logits
    within the stated share, and quantized bytes stamp strictly below the
    dense ring's (the reference's token-identity case is a known caveat:
    held by logits here)."""
    prompts = _prompts()
    ref = _pool(mesh=mesh(dp, mp), dtype=dtype)
    ref_fn, want_logs = _logged(ref)
    want = ref.generate(prompts, 8)

    seen = []
    _checked_qpsum(monkeypatch, seen)
    pool = _pool(mesh=mesh(dp, mp, collective_quant="int8"), dtype=dtype)
    fn, got_logs = _logged(pool)
    got = pool.generate(prompts, 8)
    assert seen, "the int8 seam never ran"
    _hold_int8_logits(want, got, want_logs, got_logs)
    assert fn._cache_size() == ref_fn._cache_size() == 1
    pool._decode_fn, ref._decode_fn = fn, ref_fn
    assert pool.compile_counts() == ref.compile_counts()

    stats = pool.cache_stats()
    assert stats["collective_quant"] == "int8"
    assert stats["collective_bytes_per_token"] \
        < stats["collective_dense_bytes_per_token"]
    # 2 layers x 2 row-parallel seams (out_proj, linear2) per step
    assert stats["collective_calls_per_step"] == 4
    ref_stats = ref.cache_stats()
    assert ref_stats["collective_quant"] == "none"
    assert ref_stats["collective_bytes_per_token"] \
        == ref_stats["collective_dense_bytes_per_token"] \
        == stats["collective_dense_bytes_per_token"]


def test_none_mode_byte_identical_to_unsharded():
    """The default mode's mesh pool decodes the unsharded pool's tokens
    (the seam only records; the reduction is fp32)."""
    prompts = _prompts()
    want = _pool().generate(prompts, 8)
    for dp, mp in QMESHES:
        pool = _pool(mesh=mesh(dp, mp), collective_quant="none")
        got = pool.generate(prompts, 8)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)


def test_per_channel_scale_identity(monkeypatch):
    """One fp32 scale per output channel: every reduction within the
    bound, the logits within the stated share, and still below the dense
    ring's bytes."""
    prompts = _prompts()
    ref = _pool(mesh=mesh(2, 2))
    _, want_logs = _logged(ref)
    want = ref.generate(prompts, 8)
    seen = []
    _checked_qpsum(monkeypatch, seen)
    pool = _pool(mesh=mesh(2, 2, collective_quant="int8",
                           collective_quant_scale="channel"))
    _, got_logs = _logged(pool)
    got = pool.generate(prompts, 8)
    assert seen
    _hold_int8_logits(want, got, want_logs, got_logs)
    stats = pool.cache_stats()
    assert stats["collective_quant_scale"] == "channel"
    assert stats["collective_bytes_per_token"] \
        < stats["collective_dense_bytes_per_token"]


def test_mode_rides_mesh_session_kwarg_overrides():
    """DecodeMesh carries the mode, describe() exports it, the pool kwarg
    overrides it."""
    m = mesh(2, 2, collective_quant="int8")
    assert m.describe()["collective_quant"] == "int8"
    pool = _pool(mesh=m)
    pool.generate(_prompts(), 4)
    assert pool.cache_stats()["collective_quant"] == "int8"

    ovr = _pool(mesh=mesh(2, 2, collective_quant="int8"),
                collective_quant="none")
    ovr.generate(_prompts(), 4)
    assert ovr.cache_stats()["collective_quant"] == "none"


def test_mp1_mesh_is_documented_noop():
    """int8 on a pure-dp mesh: no mp reductions exist, the seam is not
    installed and no byte columns appear."""
    prompts = _prompts()
    want = _pool().generate(prompts, 8)
    pool = _pool(mesh=mesh(2, 1, collective_quant="int8"))
    got = pool.generate(prompts, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    stats = pool.cache_stats()
    assert stats["collective_quant"] == "int8"
    assert "collective_bytes_per_token" not in stats


def test_cost_report_carries_collective_columns():
    """cost_report's derived block carries the mesh and the same byte
    columns cache_stats does."""
    pool = _pool(mesh=mesh(1, 2, collective_quant="int8"))
    pool.generate(_prompts(), 4)
    derived = pool.cost_report()["derived"]
    assert derived["mesh"]["collective_quant"] == "int8"
    assert derived["collective_bytes_per_token"] \
        < derived["collective_dense_bytes_per_token"]
    assert "collective_basis" in derived
    (entry,) = pool.cost_report()["pool_decode"].values()
    assert entry["mesh"] == pool.mesh.describe()
    # a mesh adds no step key: the unsharded pool's one decode key
    plain = _pool()
    plain.generate(_prompts(), 4)
    assert set(pool.cost_report()["pool_decode"]) \
        == set(plain.cost_report()["pool_decode"])


def test_engine_threads_collective_quant(monkeypatch):
    """ServingEngine passes the mode through and serves the quantized pool
    with the unquantized engine's keys; its reductions are held by the
    bound (the reference's token-identity case is a known caveat)."""
    prompts = _prompts()

    def engine(**kw):
        return ServingEngine(_fresh_model(), max_len=32, slots=4,
                             buckets=[16], cache_layout="paged",
                             block_size=4, mesh=mesh(1, 2), device="cpu",
                             **kw)

    ref = engine()
    ref_streams = [ref.submit(p, 8) for p in prompts]
    while ref.pump(4):
        pass
    seen = []
    _checked_qpsum(monkeypatch, seen)
    eng = engine(collective_quant="int8")
    streams = [eng.submit(p, 8) for p in prompts]
    while eng.pump(4):
        pass
    assert seen
    for s, r in zip(streams, ref_streams):
        st = s.result(timeout_s=0)
        assert st.state == "DONE"
        assert len(st.tokens) == len(r.result(timeout_s=0).tokens) == 8
    assert eng.cache_stats()["collective_quant"] == "int8"
    assert eng.compile_counts() == ref.compile_counts()


# -- contract 5: typed construction errors ----------------------------------

def test_construction_typed_errors():
    with pytest.raises(InvalidArgumentError, match="collective_quant"):
        mesh(1, 2, collective_quant="fp8")
    with pytest.raises(InvalidArgumentError,
                       match="collective_quant_scale"):
        mesh(1, 2, collective_quant_scale="row")
    with pytest.raises(InvalidArgumentError, match="collective_quant"):
        _pool(mesh=mesh(1, 2), collective_quant="int4")
    # int8 without a mesh has no mp reductions to replace
    with pytest.raises(InvalidArgumentError, match="DecodeMesh"):
        GenerationPool(_fresh_model(), max_len=32, slots=4, buckets=[16],
                       collective_quant="int8", device="cpu")


# -- across the packages -----------------------------------------------------

def test_collective_columns_match_reference():
    """A 2x2 int8 pool's collective columns equal the reference pool's on
    the same weights and traffic: the same seams, shapes and formulas."""
    pt.seed(SEED)
    ref_model = RefLM(**CFG)
    ref_pool = RefPool(ref_model, max_len=32, slots=4, buckets=[16],
                       cache_layout="paged", block_size=4,
                       mesh=RefMesh(2, 2, collective_quant="int8"))
    ref_pool.generate(_prompts(), 4)
    port = TransformerLM(**CFG, device="cpu")
    load_reference_params(port, reference_arrays(ref_model))
    pool = _pool(mesh=mesh(2, 2, collective_quant="int8"), model=port)
    pool.generate(_prompts(), 4)
    keys = ("collective_quant", "collective_quant_scale",
            "collective_bytes_per_token", "collective_dense_bytes_per_token",
            "collective_calls_per_step")
    want, got = ref_pool.cache_stats(), pool.cache_stats()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["mesh"] == want["mesh"]

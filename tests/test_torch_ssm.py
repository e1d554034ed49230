"""The port's O(1)-cache model class (``paddle_tpu_torch.nn.ssm.SSMLM`` on
the ``"recurrent"`` cache layout): the reference's
``tests/test_ssm_serving.py`` re-pointed at the port on the CPU, plus the
same weights and inputs through both packages.

Pinned here, as in the reference:

1. a served ``SSMLM`` (bucketed prefill + per-token decode through
   ``DecodeSession``/``GenerationPool``) emits greedy tokens byte-identical
   to the eager cached loop and to the full re-forward from a zero carry
   (the sequential scan's one fp32 operation order);
2. one step key per step shape: {prefill: 1, decode: 1} per bucket, and
   preemption, spill and resume add none;
3. preempt -> spill -> resume is byte-identical through the host and disk
   tiers, and a detached disk spill adopts byte-identically on a second
   pool, with the carry (layers x d_state fp32) as the PTKV payload;
4. the fingerprint carries the model class: a transformer pool never
   adopts a recurrent pool's file or the other way round (an
   ``xfer.reject`` with ``reason="fingerprint"``);
5. the positional-only features (prefix sharing, chunked prefill, paged
   knobs, speculative decoding, the prefill tier) and a layout the model
   class does not serve raise typed errors naming the layout;
6. the serving engine's chaos invariants and the SIGKILL journal restore
   hold for the recurrent pool.

The reference's dp=2 mesh test waits for the mesh's port (not here).

Across the packages: the reference's weights carried by name; logits
within 1e-4 (fp32 through the same products in another summation order,
24 scan steps); pool greedy tokens equal under the reference's margin
gate; the fingerprint dicts equal; a recurrent PTKV file written by
either package adopted by the other.
"""
import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import GenerationPool as RefPool
from paddle_tpu.nn import SSMLM as RefSSM
from torch_parity import SMALL, MARGIN_FLOOR, reference_arrays

from paddle_tpu_torch import (DecodeSession, GenerationPool, ServingEngine,
                              TransformerLM, load_reference_params)
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.inference import SpeculativePool
from paddle_tpu_torch.jit import SpeculativeDecodeSession
from paddle_tpu_torch.jit.cache import CACHE_LAYOUTS, get_layout
from paddle_tpu_torch.jit.mesh import DecodeMesh
from paddle_tpu_torch.nn import SSMLM
from paddle_tpu_torch.serving import RequestState, faults
from paddle_tpu_torch.serving import log as slog
from paddle_tpu_torch.serving.faults import FaultPlane

SSM_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, d_state=48,
               dropout=0.0)
STATE_BYTES = 2 * 48 * 4  # layers x d_state x fp32


def _ssm(seed=0, **over):
    return SSMLM(**dict(SSM_CFG, **over), device="cpu", seed=seed)


def _transformer(seed=0):
    return TransformerLM(**SMALL, dropout=0.0, causal=True, device="cpu",
                         seed=seed)


@pytest.fixture(scope="module")
def model():
    return _ssm()


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype("int32") for n in lens]


def _eager_cached(model, ids, n):
    """Greedy through the eager per-token cache loop: the exact
    (unpadded) prompt, then one forward per token."""
    cache = model.gen_decode_cache(1, len(ids) + n)
    with torch.no_grad():
        logits, cache = model(torch.from_numpy(ids[None].astype(np.int64)),
                              cache=cache)
        out = [int(logits[0, -1].argmax())]
        while len(out) < n:
            logits, cache = model(torch.tensor([[out[-1]]]), cache=cache)
            out.append(int(logits[0, -1].argmax()))
    return np.asarray(out, np.int32)


def _eager_reforward(model, ids, n):
    """Greedy with NO cache: the whole growing sequence re-run from a
    zero carry each step."""
    seq = list(ids)
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([seq]))
            out.append(int(logits[0, -1].argmax()))
            seq.append(out[-1])
    return np.asarray(out, np.int32)


def _pool(model, **over):
    kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="recurrent",
              device="cpu")
    kw.update(over)
    return GenerationPool(model, **kw)


# -- byte identity with the eager references (fp32) -----------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_served_matches_eager_reference(seed):
    model = _ssm(seed)
    sess = DecodeSession(model, max_len=64, buckets=[16, 32],
                         cache_layout="recurrent", device="cpu")
    for ids in _prompts(seed, (5, 11, 20, 7)):
        got = sess.generate(ids[None], 8)
        want = _eager_cached(model, ids, 8)
        np.testing.assert_array_equal(np.ravel(got), want)
        np.testing.assert_array_equal(want, _eager_reforward(model, ids, 8))


def test_exactly_two_compiles(model):
    sess = DecodeSession(model, max_len=64, buckets=[32],
                         cache_layout="recurrent", device="cpu")
    for ids in _prompts(9, (4, 9, 17, 26)):
        sess.generate(ids[None], 6)
    assert sess.compile_counts() == {"prefill": 1, "decode": 1}


def test_pool_matches_session_and_compile_pin(model):
    p = _prompts(3, (5, 9, 7))
    sess = DecodeSession(model, max_len=64, buckets=[32],
                         cache_layout="recurrent", device="cpu")
    want = [np.ravel(sess.generate(ids[None], 8)) for ids in p]
    pool = _pool(model)
    got = pool.generate(p, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pool.compile_counts() == {"prefill": 1, "decode": 0,
                                     "pool_decode": 1, "slot_insert": 1}


# -- preempt / spill / resume ------------------------------------------------

@pytest.mark.parametrize("tier", ["host", "disk"])
def test_preempt_spill_resume_byte_identity(model, tier, tmp_path):
    p = _prompts(3, (5, 9, 7))
    kw = {} if tier == "host" else dict(spill_tier="disk",
                                        spill_dir=str(tmp_path))
    ref = _pool(model, **kw)
    for i, ids in enumerate(p):
        ref.submit(ids, 8, request_id=i)
    want = ref.run()
    counts = ref.compile_counts()

    pool = _pool(model, **kw)
    for i, ids in enumerate(p):
        pool.submit(ids, 8, request_id=i)
    pool.step()
    pool.step()
    assert pool.can_preempt(0)
    info = pool.preempt(0)
    # the spill is the O(1) carry, not blocks
    assert info["state_bytes"] == STATE_BYTES
    assert info["spill_bytes"] == info["state_bytes"]
    assert info["blocks_spilled"] == 0
    if tier == "disk":
        assert os.listdir(str(tmp_path)), "no transfer file written"
    got = pool.run()
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    assert pool.compile_counts() == counts
    if tier == "disk":
        assert not os.listdir(str(tmp_path)), "resume must consume file"
    ss = pool.spill_stats()
    assert ss["enabled"] and ss["preempts_total"] == 1 \
        and ss["resumes_total"] == 1 and ss["spilled_requests"] == 0
    assert ss["spill_bytes_total"] == ss["upload_bytes_total"] \
        == info["state_bytes"]


def test_detach_and_adopt_cross_engine(model, tmp_path):
    p = _prompts(3, (5, 9, 7))

    def mk():
        return _pool(model, spill_tier="disk", spill_dir=str(tmp_path))

    ref = mk()
    for i, ids in enumerate(p):
        ref.submit(ids, 8, request_id="r%d" % i)
    want = ref.run()

    a = mk()
    for i, ids in enumerate(p):
        a.submit(ids, 8, request_id="r%d" % i)
    a.step()
    a.step()
    a.preempt("r0")
    committed = list(a._spilled["r0"].tokens)
    handoff = a.detach_spilled("r0")
    assert handoff["spill_bytes"] == STATE_BYTES

    b = mk()
    assert b.adopt_spill("r0", p[0], committed, 8)
    for i, ids in enumerate(p[1:], 1):
        b.submit(ids, 8, request_id="r%d" % i)
    got = b.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    # the adopted victim resumed through the carry upload, no re-prefill
    assert b.spill_stats()["upload_bytes_total"] == STATE_BYTES
    assert b.compile_counts()["prefill"] == 1  # only the two submits'


def test_cross_model_class_spill_rejected(model, tmp_path):
    """A transformer pool never adopts a recurrent pool's spill file (and
    the other way round): the fingerprint carries ``cache_layout`` and
    ``d_state``, so the triage is an ``xfer.reject`` with
    ``reason="fingerprint"``, and the file stays on disk."""
    spill = str(tmp_path)
    tf = _transformer()
    p = _prompts(4, (9,))[0]
    rec_pool = _pool(model, spill_tier="disk", spill_dir=spill)
    rec_pool.submit(p, 8, request_id="v")
    for _ in range(3):
        rec_pool.step()
    rec_pool.preempt("v")
    committed = list(rec_pool._spilled["v"].tokens)
    path = rec_pool._spilled["v"].host_path
    assert path is not None and os.path.exists(path)

    def try_adopt(pool):
        buf = io.StringIO()
        with slog.logging_to(buf):
            ok = pool.adopt_spill("v", p, committed, 8)
        rej = [json.loads(line) for line in buf.getvalue().splitlines()
               if json.loads(line)["event"] == "xfer.reject"]
        return ok, rej

    paged = GenerationPool(tf, max_len=64, slots=2, buckets=[32],
                           cache_layout="paged", block_size=8,
                           spill_tier="disk", spill_dir=spill, device="cpu")
    ok, rej = try_adopt(paged)
    assert not ok
    assert len(rej) == 1 and rej[0]["reason"] == "fingerprint"
    assert "cache_layout" in rej[0]["keys"]
    assert os.path.exists(path)
    ref = _pool(model, slots=1)
    ref.submit(p, 8, request_id="v")
    want = ref.run()["v"]
    fresh = _pool(model, spill_tier="disk", spill_dir=spill)
    assert fresh.adopt_spill("v", p, committed, 8)
    np.testing.assert_array_equal(fresh.run()["v"], want)

    # the mirror direction: a paged spill rejected by a recurrent pool
    paged.submit(p, 8, request_id="v")
    for _ in range(3):
        paged.step()
    paged.preempt("v")
    committed = list(paged._spilled["v"].tokens)
    assert paged.detach_spilled("v")["path"]
    ok, rej = try_adopt(_pool(model, spill_tier="disk", spill_dir=spill))
    assert not ok
    assert len(rej) == 1 and rej[0]["reason"] == "fingerprint"
    assert "cache_layout" in rej[0]["keys"]


# -- typed construction errors --------------------------------------------

def test_layout_registry_typed_errors():
    assert set(CACHE_LAYOUTS) == {"dense", "paged", "recurrent"}
    layout = get_layout("recurrent")
    assert not layout.positional and layout.spillable
    assert layout.field_axes("state") == ("dp", None)
    with pytest.raises(InvalidArgumentError, match="recurrent"):
        get_layout("block-sparse")


def test_positional_features_raise_typed_errors(model, tmp_path):
    with pytest.raises(InvalidArgumentError,
                       match="prefix_sharing.*recurrent"):
        _pool(model, prefix_sharing=True)
    with pytest.raises(InvalidArgumentError,
                       match="prefill_chunk_tokens.*recurrent"):
        _pool(model, prefill_chunk_tokens=8)
    with pytest.raises(InvalidArgumentError, match="num_blocks"):
        _pool(model, num_blocks=16)
    with pytest.raises(InvalidArgumentError,
                       match="prefill_only.*recurrent"):
        _pool(model, prefill_only=True, spill_tier="disk",
              spill_dir=str(tmp_path))
    with pytest.raises(InvalidArgumentError, match="speculative.*recurrent"):
        SpeculativePool(_transformer(), _transformer(1), max_len=64,
                        cache_layout="recurrent", device="cpu")
    with pytest.raises(InvalidArgumentError, match="speculative.*recurrent"):
        SpeculativeDecodeSession(_transformer(), _transformer(1),
                                 max_len=64, cache_layout="recurrent",
                                 device="cpu")
    with pytest.raises(InvalidArgumentError, match="recurrent"):
        ServingEngine(model, max_len=64, slots=2, buckets=[32],
                      cache_layout="recurrent", prefill_chunk_tokens=8,
                      device="cpu")


def test_model_layout_compatibility_is_checked(model):
    with pytest.raises(InvalidArgumentError,
                       match="TransformerLM.*recurrent"):
        DecodeSession(_transformer(), max_len=64, cache_layout="recurrent",
                      device="cpu")
    for layout in ("dense", "paged"):
        with pytest.raises(InvalidArgumentError, match="SSMLM"):
            DecodeSession(model, max_len=64, cache_layout=layout,
                          device="cpu")
    with pytest.raises(InvalidArgumentError, match="float32"):
        DecodeSession(model, max_len=64, cache_layout="recurrent",
                      cache_dtype="int8", device="cpu")
    with pytest.raises(InvalidArgumentError, match="SSMLM"):
        model.gen_decode_cache(1, 8, layout="paged")
    with pytest.raises(InvalidArgumentError, match="float32"):
        model.gen_decode_cache(1, 8, dtype="bfloat16")


# -- accounting stamps -----------------------------------------------------

def test_cache_stats_and_fingerprint_stamps(model):
    pool = _pool(model, slots=4)
    stats = pool.cache_stats()
    assert stats["cache_layout"] == "recurrent"
    assert stats["cache_dtype"] == "float32"
    assert stats["d_state"] == 48
    # one slot's decode state is layers x d_state x 4 bytes, whatever
    # max_len is
    assert stats["state_bytes_per_slot"] == STATE_BYTES
    assert stats["reachable_bytes"] == stats["pool_bytes"] \
        == 4 * stats["state_bytes_per_slot"]
    assert _pool(model, slots=4, max_len=256).cache_stats()[
        "state_bytes_per_slot"] == STATE_BYTES
    fp = pool.config_fingerprint()
    assert fp["cache_layout"] == "recurrent" and fp["d_state"] == 48
    assert "block_size" not in fp
    paged = GenerationPool(_transformer(), max_len=64, slots=4,
                           buckets=[32], cache_layout="paged",
                           block_size=8, device="cpu")
    assert paged.cache_stats()["state_bytes_per_slot"] \
        > stats["state_bytes_per_slot"]
    assert model.flops_per_token(64) == 6.0 * (
        2 * (3 * 32 * 48 + 48 * 32) + 128 * 32)


def test_dp2_mesh_identity(model):
    """The reference's case: a dp=2 mesh shards the recurrent carry over
    slots (each shard its own state tensor) and decodes the unsharded
    pool's tokens; ``per_shard`` has one entry per shard.  Under mp the
    SSM's weights replicate (no structural mp rule), so a 2x2 mesh decodes
    the same tokens too, and preemption moves a shard's carry rows."""
    p = _prompts(6, (5, 9, 7, 4))
    plain = _pool(model)
    want = plain.generate(p, 6)
    sharded = _pool(model, mesh=DecodeMesh(2, 1, devices=["cpu"] * 2))
    got = sharded.generate(p, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    per_shard = sharded.cache_stats()["per_shard"]
    assert len(per_shard) == 2
    assert sum(e["pool_bytes"] for e in per_shard) \
        == sharded.cache_stats()["pool_bytes"]
    states = {id(row[0].state) for row in sharded._cache[0].shards}
    assert len(states) == 2

    both = _pool(model, slots=4, mesh=DecodeMesh(2, 2, devices=["cpu"] * 4))
    rids = [both.submit(x, 6) for x in p]
    for _ in range(2):
        both.step()
    both.preempt(rids[1])
    while both.step():
        pass
    for r, w in zip(rids, want):
        np.testing.assert_array_equal(both.collect(r)[0], w)


# -- serving-engine invariants under chaos ---------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_invariants_hold_for_recurrent(model, seed):
    rng = np.random.RandomState(seed)
    lens, budgets = (5, 9, 7, 4), (6, 5, 7, 4)
    prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in lens]

    def mk():
        return ServingEngine(model, max_len=64, slots=2, buckets=[32],
                             cache_layout="recurrent", max_retries=8,
                             device="cpu")

    def drive(eng):
        streams = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        iters = 0
        while eng.pump(1):
            iters += 1
            assert iters < 500, "chaos run failed to drain: wedged"
        return streams

    clean = mk()
    want = [s.result(timeout_s=0).tokens for s in drive(clean)]
    clean_counts = clean.compile_counts()

    eng = mk()
    plane = FaultPlane(chaos_seed=seed, chaos_p=0.08,
                       chaos_points=("pool.step", "stream.deliver"),
                       max_faults=6)
    with faults.injected(plane):
        streams = drive(eng)
    statuses = [s.result(timeout_s=0) for s in streams]
    assert all(st is not None for st in statuses)
    for st, w in zip(statuses, want):
        assert st.state == RequestState.DONE, (seed, st.state, st.error)
        np.testing.assert_array_equal(st.tokens, w)
    assert eng.live_requests == 0 and eng.queue_depth == 0
    assert eng.cache_stats()["cache_layout"] == "recurrent"
    snap = eng.metrics.snapshot()
    assert snap["serving_requests_submitted_total"] == len(prompts)
    assert snap["serving_requests_completed_total"] == len(prompts)
    assert snap["serving_requests_failed_total"] == 0
    assert snap["serving_tokens_emitted_total"] == \
        sum(st.new_tokens for st in statuses) == sum(len(w) for w in want)
    assert eng.compile_counts() == clean_counts


# -- the SIGKILL journal-restore capstone --------------------------------

_CHILD = r"""
import os, signal, sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from paddle_tpu_torch.nn import SSMLM
from paddle_tpu_torch.serving import ServingEngine

workdir = sys.argv[1]
model = SSMLM(vocab_size=128, hidden_size=32, num_layers=2, d_state=48,
              dropout=0.0, device="cpu", seed=0)
rng = np.random.RandomState(11)
lens = (5, 9, 7, 4, 6)
prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in lens]
eng = ServingEngine(model, max_len=64, slots=2, buckets=[32, 64],
                    cache_layout="recurrent", spill_tier="disk",
                    spill_dir=os.path.join(workdir, "spill"),
                    journal_path=os.path.join(workdir, "wal.journal"),
                    device="cpu")
for i, p in enumerate(prompts[:2]):
    eng.submit(p, 8, request_id="low%d" % i, priority="low")
eng.pump(2)
for i, p in enumerate(prompts[2:]):
    eng.submit(p, 12, request_id="high%d" % i, priority="high")
eng.preempt()   # park a low victim's carry in the disk tier
eng.pump(2)
parked = sum(1 for r in eng._live.values() if r.state == "PREEMPTED")
sys.stdout.write("LIVE %d PARKED %d\n" % (eng.live_requests, parked))
sys.stdout.flush()
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_subprocess_crash_restore_byte_identical(tmp_path):
    """An engine in a child PROCESS (recurrent pool, disk tier, journal)
    is SIGKILLed mid-decode with a disk-spilled victim; a fresh engine
    restores the journal and the spill directory and finishes every
    greedy survivor byte-identically, the victim through its carry."""
    workdir = str(tmp_path)
    child = os.path.join(workdir, "crash_child.py")
    with open(child, "w") as f:
        f.write(_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, child, workdir, repo],
                          capture_output=True, text=True, timeout=600,
                          cwd=repo)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-1500:])
    assert "PARKED 1" in proc.stdout, proc.stdout

    model = _ssm()
    rng = np.random.RandomState(11)
    lens = (5, 9, 7, 4, 6)
    prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in lens]

    def mk(journal=None):
        return ServingEngine(model, max_len=64, slots=2, buckets=[32, 64],
                             cache_layout="recurrent", spill_tier="disk",
                             spill_dir=os.path.join(workdir, "spill"),
                             journal_path=journal, device="cpu")

    def drain(engine, bound=400):
        n = 0
        while engine.pump(1):
            n += 1
            assert n < bound, "engine failed to drain: wedged"

    ref = mk()
    for warm_len in (20, 50):
        ref.submit(rng.randint(0, 128, (warm_len,)).astype("int32"), 2)
        drain(ref)
    streams = [ref.submit(p, 8, request_id="low%d" % i, priority="low")
               for i, p in enumerate(prompts[:2])]
    ref.pump(2)
    streams += [ref.submit(p, 12, request_id="high%d" % i, priority="high")
                for i, p in enumerate(prompts[2:])]
    drain(ref)
    want = {s.request_id: s.result(timeout_s=0).tokens for s in streams}
    clean_counts = ref.compile_counts()

    jpath = os.path.join(workdir, "wal.journal")
    eng_b = mk(journal=jpath)
    for warm_len in (20, 50):
        eng_b.submit(rng.randint(0, 128, (warm_len,)).astype("int32"), 2)
        drain(eng_b)
    counts_before = eng_b.compile_counts()
    summary = eng_b.restore(jpath)
    assert summary["requests_replayed"] == 5
    assert summary["adopted_from_spill"] == 1
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    drain(eng_b)
    for rid, s in restored.items():
        st = s.result(timeout_s=0)
        assert st.state == "DONE"
        np.testing.assert_array_equal(np.asarray(st.tokens), want[rid])
    assert eng_b.compile_counts() == counts_before == clean_counts
    assert eng_b.spill_stats()["upload_bytes_total"] == STATE_BYTES


# -- across the packages ---------------------------------------------------

@pytest.fixture(scope="module")
def xpair():
    """(reference SSMLM, port SSMLM carrying its weights by name)."""
    pt.seed(0)
    ref = RefSSM(**SSM_CFG)
    ref.eval()
    port = SSMLM(**SSM_CFG, device="cpu")
    load_reference_params(port, reference_arrays(ref))
    port.eval()
    return ref, port


def test_logits_match_reference(xpair):
    ref, port = xpair
    ids = np.random.RandomState(2).randint(0, 128, (3, 24)).astype(np.int32)
    want = np.asarray(ref(pt.to_tensor(ids)).value)
    with torch.no_grad():
        got = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _margin(port, prompt, tokens) -> float:
    """Smallest top-2 logit margin along the greedy path (the port's
    uncached forward; causality makes its logits each step's)."""
    seq = np.concatenate([prompt, tokens])[None].astype(np.int64)
    with torch.no_grad():
        steps = port(torch.from_numpy(seq)).numpy()[0, len(prompt) - 1:-1]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def _assert_greedy(port, prompt, got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if not np.array_equal(got, want):
        m = min(_margin(port, prompt, want), _margin(port, prompt, got))
        assert m < MARGIN_FLOOR, (what, got, want, m)


def test_pool_greedy_and_fingerprint_match_reference(xpair):
    ref, port = xpair
    prompts = _prompts(5, (5, 9, 7))
    kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="recurrent")
    rp = RefPool(ref, **kw)
    pp = GenerationPool(port, device="cpu", **kw)
    assert pp.config_fingerprint() == rp.config_fingerprint()
    assert pp.config_fingerprint()["d_state"] == 48
    want = rp.generate(prompts, 8)
    got = pp.generate(prompts, 8)
    for p, g, w in zip(prompts, got, want):
        _assert_greedy(port, p, g, w, "recurrent pool")
    assert pp.cache_stats() == rp.cache_stats()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_recurrent_ptkv_crosses_packages(xpair, tmp_path, writer):
    """A recurrent victim's carry file written by one package's pool is
    adopted by the other's and finishes with the greedy tokens of an
    uninterrupted run."""
    ref, port = xpair
    kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="recurrent",
              spill_tier="disk", spill_dir=str(tmp_path))
    ids = _prompts(4, (13,))[0]
    plain = _pool(port)
    plain.submit(ids, 10, request_id="u")
    want = plain.run()["u"]
    port_pool = GenerationPool(port, device="cpu", **kw)
    donor, adopter = ((RefPool(ref, **kw), port_pool)
                      if writer == "reference"
                      else (port_pool, RefPool(ref, **kw)))
    committed = []
    donor.on_token = lambda rid, tok: committed.append(int(tok))
    donor.submit(ids, 10, request_id="mig")
    donor.step()
    donor.step()
    donor.preempt("mig")
    assert donor.detach_spilled("mig")["spill_bytes"] == STATE_BYTES
    assert adopter.adopt_spill("mig", ids, committed, 10)
    got = np.asarray(adopter.run()["mig"])
    assert list(got[:len(committed)]) == committed
    _assert_greedy(port, ids, got, want, "adopted from " + writer)

"""The port's disaggregated prefill/decode serving, re-pointed from the
reference's ``tests/test_disagg_serving.py`` case for case and held
against the reference's engine on the same weights (CPU).

Pinned here:

1. the disaggregated pair gives the fused engine's greedy tokens exactly
   (paged, fp32 and int8: the transfer carries the int8 K/V and scales),
   the fused engine gives the reference's (margin-gated), and the per-role
   step keys hold: the decode tier never runs a prefill-chunk step, the
   prefill tier never the batched decode step;
2. deadline, priority and tenant cross the hand-off (the remaining
   deadline, never a fresh grant);
3. a cancel in the hand-off window deletes the transfer file and leaves
   neither tier holding a slot or a block;
4. seeded chaos at the ``xfer.write`` seam: no hang, no token lost, and
   the injections reconcile with the ``xfer.error`` trace events;
5. the decode tier crashing mid-adopt restores from its own journal and
   the shared transfer directory, survivors identical;
6. PTKV version/magic hardening at adoption;
7. capacity keys are outside the transfer fingerprint check;
8. roles are validated as the reference validates them, and the front's
   deadline estimate adds the observed mean hand-off wait;
9. across the packages: the reference's prefill tier writes a hand-off,
   the port's decode tier adopts it, and the tokens equal the reference's
   fused engine's.

Tolerances: tokens are compared exactly within the port; against the
reference, greedy equality is margin-gated (``torch_parity``).
"""
import io
import json
import os

import numpy as np
import pytest

from torch_parity import SMALL, RefEngines, assert_greedy_equal, build_pair

from paddle_tpu_torch import GenerationPool, ServingEngine
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.serving import (DisaggregatedServing, RequestState,
                                      faults, transfer)
from paddle_tpu_torch.serving import log as slog
from paddle_tpu_torch.serving.faults import FaultPlane


@pytest.fixture(scope="module")
def pair():
    return build_pair(**SMALL)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def ref_engines(pair):
    return RefEngines(pair[0])


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype("int32") for n in lens]


def _drain(target, bound=400):
    n = 0
    while target.pump(8):
        n += 1
        assert n < bound, "failed to drain: wedged"


def _mk_front(model, tmp_path, tag="x", **over):
    kw = dict(transfer_dir=str(tmp_path / ("xfer-" + tag)),
              prefill_chunk_tokens=16, prefill_slots=2, decode_slots=2,
              buckets=[32, 64], block_size=8, device="cpu")
    kw.update(over)
    return DisaggregatedServing(model, 64, **kw)


_FUSED = dict(max_len=64, slots=2, buckets=[32, 64], cache_layout="paged",
              block_size=8, prefill_chunk_tokens=16)


def _fused_want(model, prompts, budgets, **over):
    kw = dict(_FUSED, **over)
    eng = ServingEngine(model, device="cpu", **kw)
    streams = [eng.submit(p, n, request_id="r%d" % i)
               for i, (p, n) in enumerate(zip(prompts, budgets))]
    _drain(eng)
    want = {s.request_id: np.asarray(s.result(timeout_s=0).tokens)
            for s in streams}
    eng.shutdown()
    return want


# -- 1. identity + per-role step keys -------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_disagg_byte_identity_and_role_pins(model, ref_engines, tmp_path,
                                            cache_dtype):
    prompts = _prompts(3, (5, 19, 9, 33))
    budgets = (8, 6, 7, 5)
    want = _fused_want(model, prompts, budgets, cache_dtype=cache_dtype)
    if cache_dtype == "float32":
        # the port's fused engine against the reference's, margin-gated
        ref = ref_engines.run(prompts, budgets, cache_dtype=cache_dtype,
                              ids=["r%d" % i for i in range(4)], **_FUSED)
        for p, st in zip(prompts, ref):
            assert_greedy_equal(model, p, want[st.request_id], st.tokens,
                                st.request_id)

    front = _mk_front(model, tmp_path, tag="ident-" + cache_dtype,
                      cache_dtype=cache_dtype)
    streams = [front.submit(p, n, request_id="r%d" % i)
               for i, (p, n) in enumerate(zip(prompts, budgets))]
    _drain(front)
    for s in streams:
        st = s.result(timeout_s=0)
        # the front never surfaces the tier-terminal HANDED_OFF
        assert st.state == RequestState.DONE
        np.testing.assert_array_equal(np.asarray(st.tokens),
                                      want[s.request_id])
    # every request crossed as a real file adoption
    assert front._c_transfers.value == len(prompts)
    assert front._c_transfer_bytes.value > 0
    assert front._c_degraded.value == 0
    assert front._h_handoff.count == len(prompts)
    cc = front.compile_counts()
    assert "prefill_chunk" not in cc["decode"], cc["decode"]
    assert cc["prefill"]["prefill_chunk"] >= 1
    assert cc["prefill"].get("pool_decode", 0) == 0, cc["prefill"]
    assert cc["decode"].get("pool_decode", 0) >= 1
    # the transfer files are consumed at adoption/resume
    assert os.listdir(str(tmp_path / ("xfer-ident-" + cache_dtype))) == []
    assert front.prefill.health()["role"] == "prefill"
    assert front.decode.health()["role"] == "decode"
    front.shutdown()


# -- 2. metadata across the hand-off --------------------------------------

def test_handoff_carries_scheduling_metadata(model, tmp_path):
    front = _mk_front(model, tmp_path, tag="meta")
    p = _prompts(5, (21,))[0]
    s = front.submit(p, 8, request_id="m", deadline_s=60.0,
                     priority="high", tenant="acme")
    fr = front._records["m"]
    ticks = 0
    while "m" not in front._handoffs:
        front.prefill.pump(1)
        ticks += 1
        assert ticks < 100, "hand-off never fired"
    info = front._handoffs["m"]
    assert info["priority"] is not None
    assert info["tenant"] == "acme"
    assert info["deadline_abs"] is not None
    front._bridge()  # adopt into the decode tier
    drec = front.decode._live["m"]
    assert drec.tenant == "acme"
    assert drec.priority == info["priority"]
    # the remaining deadline crossed, not a fresh 60 s grant
    assert drec.deadline_abs == info["deadline_abs"]
    assert abs(drec.deadline_abs - fr.deadline_abs) < 1.0
    _drain(front)
    assert s.result(timeout_s=0).state == RequestState.DONE
    front.shutdown()


# -- 3. cancel during the hand-off window ---------------------------------

def test_cancel_during_handoff_reclaims_both_tiers(model, tmp_path):
    front = _mk_front(model, tmp_path, tag="cancel")
    p = _prompts(6, (21,))[0]
    s = front.submit(p, 8, request_id="c")
    ticks = 0
    while "c" not in front._handoffs:
        front.prefill.pump(1)
        ticks += 1
        assert ticks < 100, "hand-off never fired"
    path = front._handoffs["c"]["path"]
    assert path and os.path.exists(path)
    assert front.cancel("c")
    assert not os.path.exists(path)
    assert front.prefill.live_requests == 0
    assert front.decode.live_requests == 0
    assert front.prefill.cache_stats()["mapped_blocks"] == 0
    assert s.result(timeout_s=0).state == RequestState.CANCELLED
    assert not front.cancel("c")  # idempotent
    # a cancel on the decode tier (after adoption) reclaims it too
    s2 = front.submit(p, 8, request_id="c2")
    ticks = 0
    while front.decode.live_requests == 0:
        front.pump(1)
        ticks += 1
        assert ticks < 100
    assert front.cancel("c2")
    assert front.decode.live_requests == 0
    assert front.decode.cache_stats()["mapped_blocks"] == 0
    assert s2.result(timeout_s=0).state == RequestState.CANCELLED
    front.shutdown()


# -- 4. chaos at the xfer.write seam --------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_chaos_xfer_write_seam(model, tmp_path, seed):
    """Seeded faults at the transfer-file write: no hang, survivors
    identical (a dead export degrades to a resubmit on the decode tier),
    injections == recorded ``xfer.error`` events exactly."""
    prompts = _prompts(seed, (5, 19, 9, 4))
    budgets = (6, 5, 7, 4)
    want = _fused_want(model, prompts, budgets)

    front = _mk_front(model, tmp_path, tag="chaos-%d" % seed)
    plane = FaultPlane(chaos_seed=seed, chaos_p=0.35,
                       chaos_points=("xfer.write",), max_faults=8)
    tracer = front.prefill.start_trace(capacity=4096)
    with faults.injected(plane):
        streams = [front.submit(p, n, request_id="r%d" % i)
                   for i, (p, n) in enumerate(zip(prompts, budgets))]
        ticks = 0
        while front.pump(1):
            ticks += 1
            assert ticks < 400, "chaos run failed to drain: wedged"
    front.prefill.stop_trace()
    for s in streams:
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE
        np.testing.assert_array_equal(np.asarray(st.tokens),
                                      want[s.request_id])
    events = tracer.recorder.snapshot()
    xfer_errors = sum(1 for e in events if e.name == "xfer.error")
    injected = sum(1 for pt_, _, name in plane.injected
                   if pt_ == "xfer.write" and name != "delay")
    assert xfer_errors == injected
    degraded = sum(1 for e in events
                   if e.name == "xfer.export"
                   and (e.meta or {}).get("degraded"))
    assert front._c_degraded.value == degraded
    front.shutdown()


# -- 5. decode tier crash mid-adopt + journal restore ---------------------

def test_decode_crash_mid_adopt_restores_from_journal(model, tmp_path):
    prompts = _prompts(11, (9, 17))
    budgets = (8, 7)
    want = _fused_want(model, prompts, budgets)
    jpath = str(tmp_path / "decode.journal")
    xdir = str(tmp_path / "xfer-crash")

    front = _mk_front(model, tmp_path, tag="crash",
                      decode_overrides={"journal_path": jpath})
    streams = [front.submit(p, n, request_id="r%d" % i)
               for i, (p, n) in enumerate(zip(prompts, budgets))]
    # both requests adopted into the decode tier, which never ticks: the
    # crash lands mid-adopt, the files still parked in its spill tier
    ticks = 0
    while front.decode.live_requests < len(prompts):
        front.prefill.pump(1)
        front._bridge()
        ticks += 1
        assert ticks < 200, "adoption never completed"
    del front, streams  # the in-process SIGKILL stand-in

    eng = ServingEngine(model, max_len=64, slots=2, buckets=[32, 64],
                        cache_layout="paged", block_size=8, role="decode",
                        spill_tier="disk", spill_dir=xdir,
                        journal_path=str(tmp_path / "decode2.journal"),
                        device="cpu")
    summary = eng.restore(jpath)
    restored = {rid: rec.stream for rid, rec in eng._live.items()}
    assert set(restored) == {"r0", "r1"}
    assert summary["adopted_from_spill"] >= 1
    _drain(eng)
    for rid, s in restored.items():
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE
        np.testing.assert_array_equal(np.asarray(st.tokens), want[rid])
    assert "prefill_chunk" not in eng.compile_counts()
    eng.shutdown()


# -- 6. version/magic hardening -------------------------------------------

def test_transfer_version_and_magic_hardening(model, tmp_path):
    spill = str(tmp_path / "pool-spill")

    def mk(**over):
        kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
                  block_size=8, spill_tier="disk", spill_dir=spill,
                  device="cpu")
        kw.update(over)
        return GenerationPool(model, **kw)

    p = _prompts(4, (9,))[0]
    pool = mk()
    pool.submit(p, 8, request_id="v")
    for _ in range(3):
        pool.step()
    pool.preempt("v")
    path = pool._spilled["v"].host_path
    committed = list(pool._spilled["v"].tokens)
    with open(path, "rb") as f:
        raw = f.read()
    magic, _ver, hlen = transfer._HEADER_STRUCT.unpack(
        raw[:transfer._HEADER_STRUCT.size])

    def rejects(body, reason, deleted):
        with open(path, "wb") as f:
            f.write(body)
        buf = io.StringIO()
        with slog.logging_to(buf):
            assert not mk().adopt_spill("v", p, committed, 8)
        assert os.path.exists(path) == (not deleted)
        rej = [json.loads(ln) for ln in buf.getvalue().splitlines()
               if json.loads(ln)["event"] == "xfer.reject"]
        assert len(rej) == 1, "exactly one reject line per attempt"
        assert rej[0]["reason"] == reason
        return rej[0]

    line = rejects(transfer._HEADER_STRUCT.pack(magic, 0, hlen) + raw[16:],
                   "version", deleted=True)
    assert line["found"] == 0
    line = rejects(
        transfer._HEADER_STRUCT.pack(magic, transfer.VERSION + 41, hlen)
        + raw[16:], "version", deleted=False)
    assert line["found"] == transfer.VERSION + 41
    buf = io.BytesIO()
    np.savez(buf, l0_f0=np.zeros((1, 8, 2, 16), np.float32))
    rejects(buf.getvalue(), "legacy_npz", deleted=False)
    rejects(b"\x00" * 64, "format", deleted=False)
    with open(path, "wb") as f:
        f.write(raw)
    buf = io.StringIO()
    with slog.logging_to(buf):
        assert not mk(cache_dtype="int8").adopt_spill("v", p, committed, 8)
    assert os.path.exists(path)
    rej = [json.loads(ln) for ln in buf.getvalue().splitlines()
           if json.loads(ln)["event"] == "xfer.reject"]
    assert len(rej) == 1 and rej[0]["reason"] == "fingerprint"
    assert "cache_dtype" in rej[0]["keys"]
    # after every rejection the intact file still adopts, identically
    ref = mk()
    ref.submit(p, 8, request_id="v")
    want = ref.run()
    good = mk()
    assert good.adopt_spill("v", p, committed, 8)
    got = good.run()
    np.testing.assert_array_equal(got["v"], want["v"])


def test_capacity_keys_tolerated_across_tiers():
    """Tier sizing (slots / num_blocks) is outside the transfer
    fingerprint check; sampling and cache keys still refuse."""
    fp_a = {"slots": 2, "num_blocks": 16, "temperature": 0.0,
            "cache_dtype": "float32"}
    fp_b = {"slots": 8, "num_blocks": 64, "temperature": 0.0,
            "cache_dtype": "float32"}
    transfer.check_fingerprint(fp_a, fp_b)
    with pytest.raises(transfer.TransferFingerprintError) as ei:
        transfer.check_fingerprint(dict(fp_a, temperature=1.0), fp_b)
    assert "temperature" in str(ei.value)


# -- 7. roles + the front's deadline estimate -----------------------------

def test_role_validation(model, tmp_path):
    spill = str(tmp_path / "rv")
    with pytest.raises(InvalidArgumentError, match="role"):
        ServingEngine(model, max_len=64, role="hybrid", device="cpu")
    with pytest.raises(InvalidArgumentError, match="prefill_chunk"):
        ServingEngine(model, max_len=64, role="prefill",
                      cache_layout="paged", block_size=8,
                      spill_tier="disk", spill_dir=spill, device="cpu")
    with pytest.raises(InvalidArgumentError, match="prefill_chunk"):
        ServingEngine(model, max_len=64, role="decode",
                      cache_layout="paged", block_size=8,
                      prefill_chunk_tokens=16, spill_tier="disk",
                      spill_dir=spill, device="cpu")
    with pytest.raises(InvalidArgumentError, match="disk"):
        ServingEngine(model, max_len=64, role="decode",
                      cache_layout="paged", block_size=8, device="cpu")
    with pytest.raises(InvalidArgumentError, match="draft"):
        ServingEngine(model, max_len=64, role="decode", draft_model=model,
                      cache_layout="paged", block_size=8,
                      spill_tier="disk", spill_dir=spill, device="cpu")
    eng = ServingEngine(model, max_len=64, slots=2, buckets=[32],
                        cache_layout="paged", block_size=8, role="decode",
                        spill_tier="disk", spill_dir=spill, device="cpu")
    assert eng.health()["role"] == "decode"
    fused = ServingEngine(model, max_len=64, slots=2, buckets=[32],
                          device="cpu")
    with pytest.raises(PreconditionNotMetError):
        # adoption of a hand-off is the decode tier's door
        fused.adopt_transfer("x", [1, 2], [3], 8)
    eng.shutdown()
    fused.shutdown()


def test_front_deadline_estimate_includes_handoff_wait(model, tmp_path):
    front = _mk_front(model, tmp_path, tag="ddl")
    prompts = _prompts(8, (9, 17))
    streams = [front.submit(p, 6, request_id="d%d" % i)
               for i, p in enumerate(prompts)]
    _drain(front)
    for s in streams:
        assert s.result(timeout_s=0).state == RequestState.DONE
    h = front._h_handoff
    assert h.count > 0
    est = front._deadline_estimate_s(4, prompt_len=8)
    assert est is not None
    pe = front.prefill._deadline_estimate_s(1, 8)
    de = front.decode._deadline_estimate_s(3)
    assert est == pytest.approx(pe + h.sum / h.count + de)
    h.observe(100.0)
    assert front._deadline_estimate_s(4, prompt_len=8) > est + 1.0
    front.shutdown()


# -- 8. across the packages -----------------------------------------------

def test_reference_prefill_tier_hands_off_to_port_decode_tier(pair,
                                                              tmp_path):
    """The reference's prefill tier exports a PTKV hand-off; the port's
    decode tier adopts the file (no re-prefill) and finishes the request
    with the reference's fused engine's tokens (margin-gated)."""
    from paddle_tpu.serving import ServingEngine as RefEngine

    ref, port = pair
    xdir = str(tmp_path / "xfer-cross")
    prompts = _prompts(13, (19, 9))
    budgets = (8, 6)
    fused = RefEngine(ref, max_len=64, slots=2, buckets=[32, 64],
                      cache_layout="paged", block_size=8,
                      prefill_chunk_tokens=16)
    fs = [fused.submit(p, n, request_id="x%d" % i)
          for i, (p, n) in enumerate(zip(prompts, budgets))]
    while fused.pump(4):
        pass
    want = {s.request_id: np.asarray(s.result(timeout_s=0).tokens)
            for s in fs}

    handoffs = {}
    pre = RefEngine(ref, max_len=64, slots=2, buckets=[32, 64],
                    cache_layout="paged", block_size=8, role="prefill",
                    prefill_chunk_tokens=16, spill_tier="disk",
                    spill_dir=xdir)
    pre.on_handoff = lambda rid, info: handoffs.__setitem__(rid, info)
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        pre.submit(p, n, request_id="x%d" % i)
    ticks = 0
    while len(handoffs) < len(prompts):
        pre.pump(1)
        ticks += 1
        assert ticks < 100, "the reference's hand-off never fired"

    dec = ServingEngine(port, max_len=64, slots=2, buckets=[32, 64],
                        cache_layout="paged", block_size=8, role="decode",
                        spill_tier="disk", spill_dir=xdir, device="cpu")
    streams = {}
    for rid, info in handoffs.items():
        assert info["path"] and os.path.exists(info["path"])
        res = dec.adopt_transfer(rid, info["prompt"], info["tokens"],
                                 info["max_new_tokens"])
        assert res["adopted_from_file"], rid
        streams[rid] = (info["tokens"], res["stream"])
    _drain(dec)
    assert "prefill_chunk" not in dec.compile_counts()
    for i, p in enumerate(prompts):
        rid = "x%d" % i
        first, s = streams[rid]
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE
        got = np.asarray(st.tokens)
        assert list(got[:len(first)]) == list(first)
        assert_greedy_equal(port, p, got, want[rid], rid)
    assert os.listdir(xdir) == []
    dec.shutdown()
    pre.shutdown()
    fused.shutdown()

"""The port's crash-durable serving: the request journal, the disk
spill tier and byte-identical cross-engine restore, re-pointed from the
reference's ``tests/test_durable_serving.py`` and held against the
reference's engine on the same weights (CPU).

Pinned here:

1. a fresh engine (same weights) that restores a crashed engine's journal
   and disk spill directory finishes every greedy survivor
   byte-identically to an uninterrupted run, with a clean engine's step
   keys -- also when the crashed engine was a child process killed with
   SIGKILL mid-decode;
2. ``serving_journal_replayed_total`` equals the journal's
   admitted-minus-terminal record count;
3. the disk spill tier behaves as the host tier (the allocator partition
   every tick, byte-identical resume, int8 scales with their blocks) plus
   file hygiene: the file exists while parked and goes at resume, cancel
   and reset;
4. RESTORING: ``health()`` unhealthy with a Retry-After hint, submits
   deferred with a live stream, admitted when the replay ends;
5. a fingerprint-mismatched journal is refused naming both sides, a torn
   tail truncates with a ``journal.truncated`` log line;
6. chaos at the ``journal.append``/``spill.write`` seams: no hang, no
   token lost, and the injections reconcile with the recorded events;
7. across the packages: a journal (with a disk-spilled victim) written by
   the reference's engine is restored by the port's engine to the same
   greedy tokens, and the other way round.
"""
import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.serving import ServingEngine as RefEngine
from torch_parity import SMALL, assert_greedy_equal, build_pair

from paddle_tpu_torch import GenerationPool, ServingEngine
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.serving import faults
from paddle_tpu_torch.serving import log as slog
from paddle_tpu_torch.serving.faults import FaultPlane, FaultSpec
from paddle_tpu_torch.serving.journal import (FingerprintMismatchError,
                                              JournalWriteError,
                                              JournalWriter, read_journal,
                                              replay)


@pytest.fixture(scope="module")
def pair():
    return build_pair(**SMALL)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _port_model(seed=0):
    return build_pair(seed=seed, **SMALL)[1]


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype("int32") for n in lens]


def _partition_ok(stats):
    return stats["free_blocks"] + stats["mapped_blocks"] \
        + stats["spilled_blocks"] + 1 == stats["num_blocks"]


def _mk_engine(model, tmp_path, journal=None, **over):
    kw = dict(max_len=64, slots=2, buckets=[32, 64],
              cache_layout="paged", block_size=8,
              spill_tier="disk", spill_dir=str(tmp_path / "spill"))
    kw.update(over)
    return ServingEngine(model, journal_path=journal, device="cpu", **kw)


def _mixed_traffic(engine, prompts, budget=8):
    """Lows first (already decoding), then highs: a preempted low
    victim stays PARKED behind the high queue — the shape every
    adoption test needs."""
    streams = [engine.submit(p, budget, request_id="low%d" % i,
                             priority="low")
               for i, p in enumerate(prompts[:2])]
    engine.pump(2)
    streams += [engine.submit(p, budget + 4, request_id="high%d" % i,
                              priority="high")
                for i, p in enumerate(prompts[2:])]
    return streams


def _drain(engine, bound=400):
    n = 0
    while engine.pump(1):
        n += 1
        assert n < bound, "engine failed to drain: wedged"


# -- checkpoint / restore byte-identity ----------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_restore_byte_identity_and_reconciliation(model, tmp_path,
                                                  cache_dtype):
    prompts = _prompts(3, (5, 9, 7, 4, 6))
    jpath = str(tmp_path / "wal.journal")

    ref = _mk_engine(model, tmp_path, cache_dtype=cache_dtype)
    # the clean engine serves the same warm traffic engine B will (both
    # prefill buckets), so "compile counts equal to a clean engine's"
    # compares like with like
    for warm_len in (20, 50):
        ref.submit(_prompts(99, (warm_len,))[0], 2)
        _drain(ref)
    streams = _mixed_traffic(ref, prompts)
    _drain(ref)
    want = {s.request_id: s.result(timeout_s=0).tokens for s in streams}
    clean_counts = ref.compile_counts()

    # engine A: journaled, one victim parked in the disk tier, then
    # hard-abandoned (no drain, no shutdown — the crash stand-in)
    eng_a = _mk_engine(model, tmp_path, journal=jpath,
                       cache_dtype=cache_dtype)
    _mixed_traffic(eng_a, prompts)
    victim = eng_a.preempt()
    eng_a.pump(2)
    assert any(r.state == "PREEMPTED" for r in eng_a._live.values()), \
        "the victim must still be parked at crash time"
    del eng_a

    # engine B: fresh, same weights; warm BOTH buckets outside the
    # restore (zero-new-compiles is a warmed-executable contract)
    eng_b = _mk_engine(model, tmp_path, journal=jpath,
                       cache_dtype=cache_dtype)
    for warm_len in (20, 50):
        eng_b.submit(_prompts(99, (warm_len,))[0], 2)
        _drain(eng_b)
    counts_before = eng_b.compile_counts()
    summary = eng_b.restore(jpath)
    assert summary["adopted_from_spill"] == 1
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    assert victim in restored
    _drain(eng_b)
    for rid, s in restored.items():
        st = s.result(timeout_s=0)
        assert st.state == "DONE"
        np.testing.assert_array_equal(np.asarray(st.tokens), want[rid])
    # zero new compiles on the adopting engine
    assert eng_b.compile_counts() == counts_before == clean_counts
    # the acceptance reconciliation: replayed == admitted - terminal
    snap = eng_b.metrics.snapshot()
    jc = summary["journal_counts"]
    assert snap["serving_journal_replayed_total"] \
        == jc["admitted"] - jc["terminals"] == summary["requests_replayed"]
    assert snap["serving_restores_total"] == 1
    # the adopted victim resumed via the page-in path, not a re-prefill
    assert eng_b.spill_stats()["upload_bytes_total"] > 0
    # restore compacted B's journal: a SECOND restore of it from yet
    # another fresh engine replays to an all-terminal (empty) live set
    eng_b.shutdown()
    _, records, _ = read_journal(jpath)
    live, _ = replay(records)
    assert live == []


def test_checkpoint_compacts_and_survives_crash(model, tmp_path):
    prompts = _prompts(5, (5, 9, 7, 4))
    jpath = str(tmp_path / "wal.journal")
    ref = _mk_engine(model, tmp_path)
    streams = [ref.submit(p, 8, request_id=i)
               for i, p in enumerate(prompts)]
    _drain(ref)
    want = {s.request_id: s.result(timeout_s=0).tokens for s in streams}

    eng_a = _mk_engine(model, tmp_path, journal=jpath)
    for i, p in enumerate(prompts):
        eng_a.submit(p, 8, request_id=i)
    eng_a.pump(3)
    size_before = os.path.getsize(jpath)
    info = eng_a.checkpoint()
    assert info["live_requests"] == eng_a.live_requests
    # compaction rewrote the journal as header + ONE checkpoint record
    _, records, _ = read_journal(jpath)
    assert [r["t"] for r in records] == ["checkpoint"]
    assert os.path.getsize(jpath) < size_before or size_before == 0
    eng_a.pump(2)  # post-checkpoint commits append AFTER the snapshot
    del eng_a

    eng_b = _mk_engine(model, tmp_path, journal=jpath)
    eng_b.submit(_prompts(98, (20,))[0], 2)
    _drain(eng_b)
    eng_b.restore(jpath)
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    _drain(eng_b)
    for rid, s in restored.items():
        np.testing.assert_array_equal(
            np.asarray(s.result(timeout_s=0).tokens), want[rid])
    assert int(eng_b.metrics.snapshot()["serving_checkpoints_total"]) \
        >= 1


def test_checkpoint_to_explicit_path_leaves_journal_alone(model,
                                                          tmp_path):
    jpath = str(tmp_path / "wal.journal")
    snap_path = str(tmp_path / "handoff.journal")
    eng = _mk_engine(model, tmp_path, journal=jpath)
    eng.submit(_prompts(1, (6,))[0], 6, request_id="r")
    eng.pump(2)
    n_records = read_journal(jpath)[2]["records"]
    eng.checkpoint(path=snap_path)
    # the live journal is NOT compacted by a hand-off snapshot
    assert read_journal(jpath)[2]["records"] == n_records
    _, records, _ = read_journal(snap_path)
    assert [r["t"] for r in records] == ["checkpoint"]
    live, _ = replay(records)
    assert [e["rid"] for e in live] == ["r"]


def test_checkpoint_without_journal_needs_a_path(model, tmp_path):
    eng = _mk_engine(model, tmp_path)
    with pytest.raises(PreconditionNotMetError, match="journal"):
        eng.checkpoint()
    # an unjournaled engine can still write a hand-off snapshot
    eng.submit(_prompts(1, (6,))[0], 4, request_id="r")
    eng.pump(1)
    snap = str(tmp_path / "snap.journal")
    eng.checkpoint(path=snap)
    live, _ = replay(read_journal(snap)[1])
    assert [e["rid"] for e in live] == ["r"]


# -- fingerprint / precondition typed errors ------------------------------

def test_restore_fingerprint_mismatch_names_both_sides(model, tmp_path):
    jpath = str(tmp_path / "wal.journal")
    eng_a = _mk_engine(model, tmp_path, journal=jpath)
    eng_a.submit(_prompts(1, (6,))[0], 4)
    eng_a.pump(1)
    del eng_a
    eng_b = _mk_engine(model, tmp_path, block_size=16,
                       spill_dir=str(tmp_path / "spill-b"))
    with pytest.raises(FingerprintMismatchError) as ei:
        eng_b.restore(jpath)
    msg = str(ei.value)
    assert "block_size" in msg and "8" in msg and "16" in msg
    # the failed restore left the engine serviceable, not RESTORING
    assert eng_b.health()["state"] == "idle"
    s = eng_b.submit(_prompts(2, (5,))[0], 3)
    _drain(eng_b)
    assert s.result(timeout_s=0).state == "DONE"


def test_journal_writer_rejects_mismatched_existing_file(model,
                                                         tmp_path):
    jpath = str(tmp_path / "wal.journal")
    eng_a = _mk_engine(model, tmp_path, journal=jpath)
    del eng_a
    with pytest.raises(FingerprintMismatchError, match="block_size"):
        _mk_engine(model, tmp_path, journal=jpath, block_size=16,
                   spill_dir=str(tmp_path / "spill-b"))


def test_restore_requires_fresh_engine(model, tmp_path):
    jpath = str(tmp_path / "wal.journal")
    eng_a = _mk_engine(model, tmp_path, journal=jpath)
    eng_a.submit(_prompts(1, (6,))[0], 4)
    eng_a.pump(1)
    with pytest.raises(PreconditionNotMetError, match="fresh"):
        eng_a.restore(jpath)


def test_journaled_engine_rejects_unjournalable_rid(model, tmp_path):
    eng = _mk_engine(model, tmp_path,
                     journal=str(tmp_path / "wal.journal"))
    with pytest.raises(InvalidArgumentError, match="JSON-safe"):
        eng.submit(_prompts(1, (5,))[0], 3, request_id=("tup", 1))
    # int and str rids admit fine
    eng.submit(_prompts(1, (5,))[0], 3, request_id=7)
    eng.submit(_prompts(2, (5,))[0], 3, request_id="seven")
    _drain(eng)


# -- replay edge cases ----------------------------------------------------

def test_restore_finalizes_exhausted_and_eos_requests(model, tmp_path):
    """A torn tail can eat the terminal record of a request whose
    committed history already ended (budget exhausted, or EOS
    committed): restore must finalize it, never resubmit work the
    decode contract forbids."""
    eng = _mk_engine(model, tmp_path, eos_id=99)
    fp = eng._pool.config_fingerprint()
    jpath = str(tmp_path / "crafted.journal")
    w = JournalWriter(jpath, fp)
    w.append({"t": "admit", "rid": "full", "ids": [1, 2, 3],
              "max_new": 3, "priority": 0, "tenant": None,
              "deadline_s": None})
    w.append({"t": "commit", "toks": [["full", [5, 6, 7]]]})
    w.append({"t": "admit", "rid": "eos", "ids": [4, 5], "max_new": 6,
              "priority": 0, "tenant": None, "deadline_s": None})
    w.append({"t": "commit", "toks": [["eos", [8, 99]]]})
    w.sync()
    w.close()
    summary = eng.restore(jpath)
    assert summary["finished_at_restore"] == 2
    assert summary["requests_replayed"] == 2
    assert eng.live_requests == 0 and eng._pool.queue_depth == 0


def test_restore_rearms_remaining_deadline_not_full(model, tmp_path):
    """A crash must not silently re-grant a deadline request its full
    budget: restore deducts the wall-clock time burned since the
    journaled admission (checkpoint snapshots already store the
    remaining budget), so a long-exhausted deadline expires at the
    first post-restore tick."""
    import time as _time
    eng = _mk_engine(model, tmp_path)
    fp = eng._pool.config_fingerprint()
    jpath = str(tmp_path / "late.journal")
    w = JournalWriter(jpath, fp)
    w.append({"t": "admit", "rid": "late", "ids": [1, 2, 3],
              "max_new": 5, "priority": 0, "tenant": None,
              "deadline_s": 5.0, "ts": _time.time() - 100.0})
    w.append({"t": "commit", "toks": [["late", [7]]]})
    w.sync()
    w.close()
    before = eng._clock()
    eng.restore(jpath)
    rec = eng._live["late"]
    stream = rec.stream
    # remaining, not the full 5s re-grant: the 100s already burned
    # exhausted it, so the re-armed deadline is epsilon from now
    assert rec.deadline_abs is not None
    assert rec.deadline_abs - before < 1.0
    _drain(eng)
    assert stream.result(timeout_s=0).state == "EXPIRED"


def test_torn_tail_restore_truncates_and_logs(model, tmp_path):
    prompts = _prompts(7, (5, 9))
    jpath = str(tmp_path / "wal.journal")
    eng_a = _mk_engine(model, tmp_path, journal=jpath)
    for i, p in enumerate(prompts):
        eng_a.submit(p, 8, request_id="r%d" % i)
    eng_a.pump(3)
    del eng_a
    with open(jpath, "ab") as f:
        f.write(b"\x07half-written-frame")  # the torn tail
    eng_b = _mk_engine(model, tmp_path)
    buf = io.StringIO()
    with slog.logging_to(buf):
        summary = eng_b.restore(jpath)
    assert summary["truncated"] is True
    assert summary["records_dropped"] >= 1
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    trunc = [l for l in lines if l["event"] == "journal.truncated"]
    assert trunc and trunc[0]["dropped_records"] \
        == summary["records_dropped"]
    assert int(eng_b.metrics.snapshot()[
        "serving_journal_truncated_records_total"]) \
        == summary["records_dropped"]
    # the valid prefix still replays and finishes
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    assert len(restored) == 2
    _drain(eng_b)
    for s in restored.values():
        assert s.result(timeout_s=0).state == "DONE"


# -- RESTORING state / deferred admission ---------------------------------

def test_restoring_defers_admission_not_drops(model, tmp_path):
    eng = _mk_engine(model, tmp_path,
                     journal=str(tmp_path / "wal.journal"))
    eng._begin_restore(retry_after_s=2.5)
    h = eng.health()
    assert h["state"] == "restoring" and h["healthy"] is False
    assert h["retry_after_s"] == 2.5
    # deferred, not dropped: the submit returns a LIVE stream, but
    # nothing reaches the pool yet — and an AUTO request's identity is
    # honestly None until the post-restore admission assigns it (a
    # provisional id could collide with a journaled request's)
    s_auto = eng.submit(_prompts(1, (5,))[0], 3)
    s_named = eng.submit(_prompts(2, (6,))[0], 3, request_id="named")
    assert eng.live_requests == 0 and eng.queue_depth == 0
    assert s_auto.request_id is None
    assert s_named.request_id == "named"
    eng._end_restore()
    assert eng.health()["state"] == "serving"
    assert eng.live_requests == 2
    assert s_auto.request_id is not None  # assigned at admission
    _drain(eng)
    assert s_auto.result(timeout_s=0).state == "DONE"
    assert s_named.result(timeout_s=0).state == "DONE"
    # the assigned auto rid never collides with later auto submits
    s_later = eng.submit(_prompts(3, (5,))[0], 2)
    assert s_later.request_id != s_auto.request_id
    _drain(eng)


def test_deferred_submits_are_cancellable_and_duplicate_checked(
        model, tmp_path):
    """The deferral is a full citizen: an explicit-rid deferred submit
    can be CANCELLED during the restore window (the HTTP disconnect
    path must not leave an orphan decoding for nobody afterwards), and
    a duplicate explicit rid is rejected with the typed 409-mapped
    error at the door, same as the normal path."""
    from paddle_tpu_torch.inference.generation import DuplicateRequestError
    eng = _mk_engine(model, tmp_path)
    eng._begin_restore()
    s = eng.submit(_prompts(1, (5,))[0], 4, request_id="park")
    with pytest.raises(DuplicateRequestError, match="park"):
        eng.submit(_prompts(2, (5,))[0], 4, request_id="park")
    assert eng.cancel("park") is True
    assert s.result(timeout_s=0).state == "CANCELLED"
    assert eng.cancel("park") is False  # idempotent
    eng._end_restore()
    # the cancelled deferral was NOT admitted
    assert eng.live_requests == 0
    # ...and its rid is reusable afterwards
    s2 = eng.submit(_prompts(3, (5,))[0], 3, request_id="park")
    _drain(eng)
    assert s2.result(timeout_s=0).state == "DONE"


# -- disk spill tier ------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_disk_spill_byte_identity_and_file_lifecycle(model, tmp_path,
                                                     cache_dtype):
    p = _prompts(3, (5, 9, 7))
    spill = str(tmp_path / "pool-spill")

    def mk():
        return GenerationPool(model, max_len=64, slots=2, buckets=[32],
                              cache_layout="paged", block_size=8,
                              cache_dtype=cache_dtype, device="cpu",
                              spill_tier="disk", spill_dir=spill)

    ref = mk()
    for i, ids in enumerate(p):
        ref.submit(ids, 8, request_id=i)
    want = ref.run()
    counts = ref.compile_counts()

    pool = mk()
    for i, ids in enumerate(p):
        pool.submit(ids, 8, request_id=i)
    pool.step()
    pool.step()
    info = pool.preempt(0)
    assert info["spill_bytes"] > 0
    path = pool._spilled[0].host_path
    assert path is not None and os.path.exists(path)
    assert pool._spilled[0].host is None  # the FILE is the survivor
    assert _partition_ok(pool.cache_stats())
    assert pool.spill_stats()["spill_tier"] == "disk"
    got = pool.run()
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    assert not os.path.exists(path)  # consumed at resume
    assert pool.compile_counts() == counts
    assert _partition_ok(pool.cache_stats())

    # cancel drops the file too
    pool.submit(p[1], 8, request_id="c")
    pool.step()
    pool.step()
    pool.preempt("c")
    path = pool._spilled["c"].host_path
    assert os.path.exists(path)
    pool.cancel("c")
    assert not os.path.exists(path)

    # reset() (the recovery primitive) drops parked files — stale K/V
    # under a recurring rid would be worse than no file
    pool.submit(p[2], 8, request_id="z")
    pool.step()
    pool.step()
    pool.preempt("z")
    path = pool._spilled["z"].host_path
    pool.reset()
    assert not os.path.exists(path)


def test_vanished_spill_file_falls_back_per_victim(model, tmp_path):
    """A disk-tier file deleted between park and resume (operator
    cleanup, shared-dir consumer) must cost ONE victim a re-prefill —
    prompt+committed resubmit under its own identity — never a
    whole-pool recovery, and stay byte-identical."""
    spill = str(tmp_path / "pool-spill")

    def mk():
        return GenerationPool(model, max_len=64, slots=2, buckets=[32],
                              cache_layout="paged", block_size=8,
                              spill_tier="disk", spill_dir=spill,
                              device="cpu")

    p = _prompts(8, (5, 9, 7))
    ref = mk()
    for i, ids in enumerate(p):
        ref.submit(ids, 8, request_id=i)
    want = ref.run()

    pool = mk()
    for i, ids in enumerate(p):
        pool.submit(ids, 8, request_id=i)
    pool.step()
    pool.step()
    pool.preempt(0)
    committed = list(pool._spilled[0].tokens)
    # force the upload path (drop the device copies), then delete the
    # file out from under the parked victim
    while any(b is not None for b in pool._spilled[0].dev_blocks):
        pool._reclaim_one_spilled()
    os.remove(pool._spilled[0].host_path)
    pool._spilled[0].host_path = pool._spill_path(0)  # stale pointer
    got = pool.run()  # never raises; the victim re-prefilled
    # the victim's POOL result is the post-resubmit tail (same as the
    # engine recovery semantics); committed + tail == uninterrupted
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(committed, np.int32), got[0]]),
        want[0])
    for i in (1, 2):
        np.testing.assert_array_equal(got[i], want[i])
    assert _partition_ok(pool.cache_stats())


def test_deferred_deadline_anchors_at_submit_time(model, tmp_path):
    """The restore wait counts against a deferred request's deadline
    ("a wall-clock budget from NOW" is submit's contract): a budget
    the replay consumed expires at the first post-restore tick instead
    of being served past its SLA."""
    class FakeClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    clock = FakeClock()
    eng = _mk_engine(model, tmp_path, clock=clock)
    eng._begin_restore()
    s = eng.submit(_prompts(1, (5,))[0], 4, request_id="late",
                   deadline_s=5.0)
    clock.t += 60.0  # a long replay eats the whole budget
    eng._end_restore()
    _drain(eng)
    assert s.result(timeout_s=0).state == "EXPIRED"


def test_checkpoint_deadline_deducts_downtime(model, tmp_path):
    """Checkpoint entries stamp wall-clock time like admits: an outage
    after the checkpoint is not granted back to a request whose SLA it
    consumed."""
    import time as _time
    eng = _mk_engine(model, tmp_path)
    fp = eng._pool.config_fingerprint()
    jpath = str(tmp_path / "ckpt.journal")
    w = JournalWriter(jpath, fp)
    w.append({"t": "checkpoint", "live": [
        {"rid": "late", "ids": [1, 2, 3], "tokens": [7], "max_new": 5,
         "priority": 0, "tenant": None, "deadline_s": 5.0,
         "ts": _time.time() - 100.0, "retries": 0}]})
    w.sync()
    w.close()
    before = eng._clock()
    eng.restore(jpath)
    rec = eng._live["late"]
    assert rec.deadline_abs is not None
    assert rec.deadline_abs - before < 1.0  # remaining, not a re-grant
    _drain(eng)
    assert rec.stream.result(timeout_s=0).state == "EXPIRED"


def test_spill_tier_validation(model, tmp_path):
    kw = dict(max_len=64, device="cpu")
    with pytest.raises(InvalidArgumentError, match="spill_tier"):
        GenerationPool(model, spill_tier="cloud", **kw)
    with pytest.raises(InvalidArgumentError, match="spill_dir"):
        GenerationPool(model, cache_layout="paged", spill_tier="disk", **kw)
    with pytest.raises(InvalidArgumentError, match="paged"):
        GenerationPool(model, spill_tier="disk",
                       spill_dir=str(tmp_path / "s"), **kw)
    with pytest.raises(InvalidArgumentError, match="spill_dir"):
        GenerationPool(model, spill_dir=str(tmp_path / "s"), **kw)


def test_adopt_spill_rejects_stale_or_alien_files(model, tmp_path):
    spill = str(tmp_path / "pool-spill")

    def mk(**over):
        kw = dict(max_len=64, slots=2, buckets=[32],
                  cache_layout="paged", block_size=8,
                  spill_tier="disk", spill_dir=spill, device="cpu")
        kw.update(over)
        return GenerationPool(model, **kw)

    p = _prompts(4, (9,))[0]
    pool = mk()
    pool.submit(p, 8, request_id="v")
    pool.step()
    pool.step()
    pool.step()
    pool.preempt("v")
    committed = list(pool._spilled["v"].tokens)

    path = pool._spilled["v"].host_path
    # structural mismatch (an int8 pool must not upload fp32 bytes):
    # falls back WITHOUT deleting — the file may belong to another
    # config's pool sharing the directory
    other = mk(cache_dtype="int8")
    assert not other.adopt_spill("v", p, committed, 8)
    assert os.path.exists(path)
    # no file at all
    fresh = mk()
    assert not fresh.adopt_spill("ghost", p, committed, 8)
    # exact metadata adopts, resumes byte-identically
    ref = mk()
    ref.submit(p, 8, request_id="v")
    want = ref.run()
    assert fresh.adopt_spill("v", p, committed, 8)
    got = fresh.run()
    np.testing.assert_array_equal(got["v"], want["v"])
    assert not os.path.exists(path)  # consumed at resume

    # STALE: the journal says one more token committed than the file
    # holds — adopting would replay the wrong resume point, and the
    # file can NEVER become adoptable again, so the reject DELETES it
    pool2 = mk()
    pool2.submit(p, 8, request_id="v")
    pool2.step()
    pool2.step()
    pool2.step()
    pool2.preempt("v")
    path2 = pool2._spilled["v"].host_path
    committed2 = list(pool2._spilled["v"].tokens)
    stale_pool = mk()
    assert not stale_pool.adopt_spill("v", p, committed2 + [1], 8)
    assert not os.path.exists(path2)
    # ...after which even the exact metadata falls back to resubmit
    assert not stale_pool.adopt_spill("v", p, committed2, 8)


def test_speculative_engine_restore_byte_identity(tmp_path):
    """The journal/restore machinery is pool-variant-agnostic: a
    speculative engine's journal replays on a speculative engine with
    the same spec_k (the fingerprint carries it), survivors
    byte-identical — acceptance is a throughput matter, never a
    token-identity one."""
    model = _port_model()
    draft = _port_model(seed=1)
    prompts = _prompts(9, (5, 9, 7))
    jpath = str(tmp_path / "spec.journal")

    def mk(journal=None, spill="spill"):
        return ServingEngine(model, draft_model=draft, spec_k=3,
                             max_len=64, slots=2, buckets=[32, 64],
                             cache_layout="paged", block_size=8,
                             spill_tier="disk",
                             spill_dir=str(tmp_path / spill),
                             journal_path=journal, device="cpu")

    ref = mk()
    ref.submit(_prompts(98, (20,))[0], 2)
    _drain(ref)
    streams = [ref.submit(p, 8, request_id="r%d" % i)
               for i, p in enumerate(prompts)]
    _drain(ref)
    want = {s.request_id: s.result(timeout_s=0).tokens for s in streams}

    eng_a = mk(journal=jpath)
    for i, p in enumerate(prompts):
        eng_a.submit(p, 8, request_id="r%d" % i)
    eng_a.pump(2)
    del eng_a

    # a PLAIN engine refuses the speculative journal (spec_k +
    # pool_type differ) — typed, naming both sides
    plain = _mk_engine(model, tmp_path,
                       spill_dir=str(tmp_path / "plain-spill"))
    with pytest.raises(FingerprintMismatchError, match="pool_type"):
        plain.restore(jpath)

    eng_b = mk(journal=jpath, spill="spill-b")
    eng_b.submit(_prompts(98, (20,))[0], 2)
    _drain(eng_b)
    counts_before = eng_b.compile_counts()
    eng_b.restore(jpath)
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    _drain(eng_b)
    for rid, s in restored.items():
        np.testing.assert_array_equal(
            np.asarray(s.result(timeout_s=0).tokens), want[rid])
    assert eng_b.compile_counts() == counts_before


# -- fault seams ----------------------------------------------------------

def test_journal_append_fault_is_retried_then_typed(model, tmp_path):
    eng = _mk_engine(model, tmp_path,
                     journal=str(tmp_path / "wal.journal"))
    p = _prompts(1, (5,))[0]
    # ONE transient fault: absorbed by the internal retry, admission
    # succeeds, the error is counted
    with faults.injected(FaultPlane([FaultSpec(
            "journal.append", error=faults.TransientInjectedFault,
            times=1)])):
        s = eng.submit(p, 3, request_id="ok")
    assert int(eng.metrics.snapshot()["serving_journal_errors_total"]) \
        == 1
    # TWO consecutive faults beat the single retry: the admission is
    # REJECTED with the typed retryable error and nothing leaks
    with faults.injected(FaultPlane([FaultSpec(
            "journal.append", error=faults.TransientInjectedFault,
            times=2)])):
        with pytest.raises(JournalWriteError):
            eng.submit(_prompts(2, (5,))[0], 3, request_id="nope")
    assert eng.live_requests == 1  # only "ok"
    _drain(eng)
    assert s.result(timeout_s=0).state == "DONE"
    # the rejected rid is reusable (nothing leaked into the pool)
    s2 = eng.submit(_prompts(2, (5,))[0], 3, request_id="nope")
    _drain(eng)
    assert s2.result(timeout_s=0).state == "DONE"
    # the journal replays to exactly the terminal set (no phantom)
    eng.shutdown()
    live, counts = replay(read_journal(
        str(tmp_path / "wal.journal"))[1])
    assert live == [] and counts["admitted"] == 2


def test_journal_backlog_flushes_before_new_admits(model, tmp_path):
    """Journal ORDER is replay correctness: records stranded by a
    failed flush must land before any new admit record — a collected-
    and-reused rid would otherwise see the old request's commits
    replayed onto the new admission."""
    jpath = str(tmp_path / "wal.journal")
    eng = _mk_engine(model, tmp_path, journal=jpath)
    s = eng.submit(_prompts(1, (5,))[0], 3, request_id="r")
    # strand the tick's commit/terminal records: every append fails
    with faults.injected(FaultPlane([FaultSpec(
            "journal.append", error=faults.TransientInjectedFault,
            times=50)])):
        _drain(eng)
    assert s.result(timeout_s=0).state == "DONE"
    assert eng._jl_pending, "flush failures must leave records pending"
    # the reused rid's admit drains the backlog FIRST, so on-disk
    # order is commit(old) < terminal(old) < admit(new)
    s2 = eng.submit(_prompts(2, (5,))[0], 3, request_id="r")
    _drain(eng)
    assert s2.result(timeout_s=0).state == "DONE"
    eng.shutdown()
    _, records, _ = read_journal(jpath)
    kinds = [(r["t"], r.get("rid")) for r in records]
    first_terminal = kinds.index(("terminal", "r"))
    second_admit = kinds.index(("admit", "r"), 1)
    assert first_terminal < second_admit
    live, counts = replay(records)
    assert live == [] and counts["admitted"] == 2


def test_checkpoint_discards_superseded_backlog(model, tmp_path):
    """Records stranded by failed flushes are folded into the
    checkpoint snapshot's own token history: appending them AFTER the
    compaction would double-apply tokens at replay — the in-place
    checkpoint must discard them with the history they belong to."""
    jpath = str(tmp_path / "wal.journal")
    ref = _mk_engine(model, tmp_path,
                     spill_dir=str(tmp_path / "spill-ref"))
    p = _prompts(13, (6,))[0]
    s = ref.submit(p, 8, request_id="r")
    _drain(ref)
    want = s.result(timeout_s=0).tokens

    eng = _mk_engine(model, tmp_path, journal=jpath)
    eng.submit(p, 8, request_id="r")
    # strand this tick's commit records: every append fails
    with faults.injected(FaultPlane([FaultSpec(
            "journal.append", error=faults.TransientInjectedFault,
            times=50)])):
        eng.pump(3)
    assert eng._jl_pending, "flush failures must leave records pending"
    eng.checkpoint()  # the snapshot already CONTAINS those tokens
    assert eng._jl_pending == [] and eng._jl_tick_toks == {}
    eng.pump(1)  # one post-checkpoint commit appends cleanly
    del eng      # crash

    eng_b = _mk_engine(model, tmp_path, journal=jpath,
                       spill_dir=str(tmp_path / "spill-b"))
    eng_b.submit(_prompts(98, (20,))[0], 2)
    _drain(eng_b)
    eng_b.restore(jpath)
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    _drain(eng_b)
    # a double-applied backlog would corrupt prompt+committed and the
    # continuation would diverge — byte-identity proves it did not
    np.testing.assert_array_equal(
        np.asarray(restored["r"].result(timeout_s=0).tokens), want)


def test_deferred_auto_rid_cannot_collide_with_journaled(model,
                                                         tmp_path):
    """Both engines allocate auto int rids from 0, so a deferred
    submit must NOT take a provisional id a journaled request may own:
    ``stream.request_id`` stays None until the post-restore admission
    assigns it, and the journaled auto rid 0 replays under its own
    identity untouched."""
    # engine A journals AUTO rid 0
    jpath = str(tmp_path / "wal.journal")
    eng_a = _mk_engine(model, tmp_path, journal=jpath)
    s_a = eng_a.submit(_prompts(4, (6,))[0], 8)
    assert s_a.request_id == 0
    eng_a.pump(2)
    del eng_a

    eng_b = _mk_engine(model, tmp_path, journal=jpath)
    eng_b.submit(_prompts(98, (20,))[0], 2)
    _drain(eng_b)
    # a submit arriving MID-restore (hooked at the journal read, which
    # runs on the restoring thread under the reentrant lock — exactly
    # where a real concurrent submit queues): it defers with NO id
    import paddle_tpu_torch.serving.engine as engine_mod
    real_read = engine_mod.read_journal
    holder = {}

    def hooked_read(path):
        holder["s"] = eng_b.submit(_prompts(1, (5,))[0], 3)
        assert holder["s"].request_id is None  # deferred, identity TBD
        return real_read(path)

    engine_mod.read_journal = hooked_read
    try:
        summary = eng_b.restore(jpath)
    finally:
        engine_mod.read_journal = real_read
    s = holder["s"]
    assert summary["requests_replayed"] == 1
    # replay happened FIRST, so the journaled request owns rid 0 and
    # the deferred request was assigned a fresh id at admission
    assert 0 in eng_b._live
    assert s.request_id is not None and s.request_id != 0
    restored_0 = eng_b._live[0].stream
    _drain(eng_b)
    assert s.result(timeout_s=0).state == "DONE"
    assert restored_0.result(timeout_s=0).state == "DONE"


def test_orphan_admit_is_closed_when_submit_rejects(model, tmp_path):
    """If the admit record lands but the fsync fails, the rejected
    admission must not be resurrected at restore: a closing terminal
    rides the pending queue."""
    jpath = str(tmp_path / "wal.journal")
    eng = _mk_engine(model, tmp_path, journal=jpath)
    # first fire = append (succeeds... the fault hits the SECOND fire,
    # which is the retry-free sync-side failure path approximated by
    # failing both append attempts after a landed first frame is not
    # reachable from the seam — so fail both appends and verify the
    # ghost-terminal closure is harmless, plus the landed-admit case
    # via a crafted sequence below)
    with faults.injected(FaultPlane([FaultSpec(
            "journal.append", error=faults.TransientInjectedFault,
            times=2)])):
        with pytest.raises(JournalWriteError):
            eng.submit(_prompts(1, (5,))[0], 3, request_id="gone")
    # the closing terminal is pending; once flushed, replay tracks
    # nothing for the rejected rid
    eng.submit(_prompts(2, (5,))[0], 3, request_id="kept")
    _drain(eng)
    eng.shutdown()
    live, counts = replay(read_journal(jpath)[1])
    assert live == []
    # the ghost terminal (admit never landed) is not counted; had the
    # admit landed, the terminal would close it — either way nothing
    # is resurrected
    assert counts["admitted"] == 1


def test_journal_truncation_surfaced_at_reopen(model, tmp_path):
    """The same-path restart flow: the WRITER truncates the torn tail
    at open (it must — appending after garbage would strand every new
    record), and the engine surfaces the dropped count it found, so
    the §5m post-mortem never reads 0 for damage that happened."""
    jpath = str(tmp_path / "wal.journal")
    eng_a = _mk_engine(model, tmp_path, journal=jpath)
    eng_a.submit(_prompts(1, (5,))[0], 4, request_id="r")
    eng_a.pump(2)
    del eng_a
    with open(jpath, "ab") as f:
        f.write(b"\x99torn-frame")
    buf = io.StringIO()
    with slog.logging_to(buf):
        eng_b = _mk_engine(model, tmp_path, journal=jpath)
    assert int(eng_b.metrics.snapshot()[
        "serving_journal_truncated_records_total"]) >= 1
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    trunc = [l for l in lines if l["event"] == "journal.truncated"]
    assert trunc and trunc[0]["at"] == "open"
    # and the truncated journal still restores its valid prefix
    eng_b.restore(jpath)
    _drain(eng_b)


def test_spill_write_fault_leaves_pool_untouched(model, tmp_path):
    spill = str(tmp_path / "pool-spill")
    pool = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                          cache_layout="paged", block_size=8,
                          spill_tier="disk", spill_dir=spill, device="cpu")
    p = _prompts(6, (9, 7))
    for i, ids in enumerate(p):
        pool.submit(ids, 8, request_id=i)
    pool.step()
    pool.step()
    stats_before = pool.cache_stats()
    # two faults beat the single retry: preempt fails, pool unchanged
    with faults.injected(FaultPlane([FaultSpec(
            "spill.write", error=faults.TransientInjectedFault,
            times=2)])):
        with pytest.raises(faults.TransientInjectedFault):
            pool.preempt(0)
    assert pool.preempted_count == 0
    assert pool.cache_stats()["mapped_blocks"] \
        == stats_before["mapped_blocks"]
    assert _partition_ok(pool.cache_stats())
    # ONE fault: absorbed by the retry, the preemption lands
    with faults.injected(FaultPlane([FaultSpec(
            "spill.write", error=faults.TransientInjectedFault,
            times=1)])):
        info = pool.preempt(0)
    assert info["spill_bytes"] > 0
    got = pool.run()
    assert set(got) == {0, 1}


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_journal_and_spill_seams(model, tmp_path, seed):
    """The §5m chaos acceptance: seeded faults at the durability seams
    — no hang, no token loss after retry, partition invariant every
    tick, and the plane's injection count reconciles exactly with the
    recorded ``journal.error``/``spill.error`` trace events."""
    prompts = _prompts(seed, (5, 9, 7, 4))
    budgets = (6, 5, 7, 4)

    ref = _mk_engine(model, tmp_path,
                     spill_dir=str(tmp_path / ("spill-ref-%d" % seed)))
    streams = [ref.submit(p, n, request_id="r%d" % i)
               for i, (p, n) in enumerate(zip(prompts, budgets))]
    _drain(ref)
    want = {s.request_id: s.result(timeout_s=0).tokens for s in streams}

    eng = _mk_engine(model, tmp_path,
                     journal=str(tmp_path / ("chaos-%d.journal" % seed)),
                     spill_dir=str(tmp_path / ("spill-%d" % seed)))
    plane = FaultPlane(chaos_seed=seed, chaos_p=0.35,
                       chaos_points=("journal.append", "spill.write"),
                       max_faults=8)
    tracer = eng.start_trace(capacity=4096)
    streams = []
    with faults.injected(plane):
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            for _attempt in range(12):
                try:
                    streams.append(
                        eng.submit(p, n, request_id="r%d" % i))
                    break
                except JournalWriteError:
                    continue  # typed + retryable: the caller's move
            else:
                raise AssertionError("submit retry budget exhausted")
        eng.pump(2)
        try:
            eng.preempt()  # exercise spill.write under chaos
        except Exception:  # noqa: BLE001 - an injected spill fault
            pass
        ticks = 0
        while eng.pump(1):
            ticks += 1
            assert ticks < 400, "chaos run failed to drain: wedged"
            assert _partition_ok(eng.cache_stats())
    eng.stop_trace()
    # no token loss: every request DONE, byte-identical to clean
    for s in streams:
        st = s.result(timeout_s=0)
        assert st.state == "DONE"
        np.testing.assert_array_equal(np.asarray(st.tokens),
                                      want[s.request_id])
    # reconciliation: injected raises at each seam == recorded events
    events = tracer.recorder.snapshot()
    journal_errors = sum(1 for e in events if e.name == "journal.error")
    spill_errors = sum(1 for e in events if e.name == "spill.error")
    injected_journal = sum(1 for pt_, _, name in plane.injected
                           if pt_ == "journal.append"
                           and name != "delay")
    injected_spill = sum(1 for pt_, _, name in plane.injected
                         if pt_ == "spill.write" and name != "delay")
    assert journal_errors == injected_journal
    assert spill_errors == injected_spill
    assert int(eng.metrics.snapshot()["serving_journal_errors_total"]) \
        == injected_journal


# -- across the packages ------------------------------------------------------
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_and_spill_cross_packages(pair, tmp_path, writer):
    """A journal and a disk-spilled victim written by one package's
    engine are restored by the other's: the victim is adopted from the
    PTKV file (no re-prefill), every survivor finishes with the greedy
    tokens of an uninterrupted run (margin-gated, as the packages may
    round a near-tie differently)."""
    ref_model, port_model = pair
    prompts = _prompts(3, (5, 9, 7, 4, 6))
    jpath = str(tmp_path / "wal.journal")
    kw = dict(max_len=64, slots=2, buckets=[32, 64], cache_layout="paged",
              block_size=8, spill_tier="disk",
              spill_dir=str(tmp_path / "spill"))

    def port_engine(journal=None):
        return ServingEngine(port_model, journal_path=journal,
                             device="cpu", **kw)

    def ref_engine(journal=None):
        return RefEngine(ref_model, journal_path=journal, **kw)

    first, second = ((ref_engine, port_engine) if writer == "reference"
                     else (port_engine, ref_engine))
    clean = second()
    streams = _mixed_traffic(clean, prompts)
    _drain(clean)
    want = {s.request_id: s.result(timeout_s=0).tokens for s in streams}

    eng_a = first(journal=jpath)
    _mixed_traffic(eng_a, prompts)
    victim = eng_a.preempt()
    eng_a.pump(2)
    assert any(r.state == "PREEMPTED" for r in eng_a._live.values())
    del eng_a

    eng_b = second(journal=jpath)
    summary = eng_b.restore(jpath)
    assert summary["adopted_from_spill"] == 1
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    assert victim in restored
    _drain(eng_b)
    prompt_of = {"low%d" % i: p for i, p in enumerate(prompts[:2])}
    prompt_of.update({"high%d" % i: p for i, p in enumerate(prompts[2:])})
    equal = 0
    for rid, s in restored.items():
        st = s.result(timeout_s=0)
        assert st.state == "DONE"
        equal += assert_greedy_equal(port_model, prompt_of[rid],
                                     np.asarray(st.tokens), want[rid],
                                     what=str(rid))
    assert equal >= len(restored) - 1
    jc = summary["journal_counts"]
    assert eng_b.metrics.snapshot()["serving_journal_replayed_total"] \
        == jc["admitted"] - jc["terminals"]


def test_cross_package_fingerprint_mismatch_names_both_sides(pair,
                                                             tmp_path):
    ref_model, port_model = pair
    jpath = str(tmp_path / "wal.journal")
    eng_a = RefEngine(ref_model, max_len=64, slots=2, buckets=[32],
                      cache_layout="paged", block_size=8,
                      journal_path=jpath)
    eng_a.submit(_prompts(1, (6,))[0], 4)
    eng_a.pump(1)
    del eng_a
    eng_b = ServingEngine(port_model, max_len=64, slots=2, buckets=[32],
                          cache_layout="paged", block_size=16, device="cpu")
    with pytest.raises(FingerprintMismatchError) as ei:
        eng_b.restore(jpath)
    msg = str(ei.value)
    assert "block_size" in msg and "8" in msg and "16" in msg
    assert ei.value.journal_fingerprint["block_size"] == 8
    assert ei.value.engine_fingerprint["block_size"] == 16
    # at a matching configuration the fingerprints are the same dict
    eng_c = ServingEngine(port_model, max_len=64, slots=2, buckets=[32],
                          cache_layout="paged", block_size=8, device="cpu")
    assert eng_c._pool.config_fingerprint() == read_journal(jpath)[0]


# -- the subprocess crash-restore capstone -------------------------------------
_CHILD = r"""
import os, signal, sys
import numpy as np
from paddle_tpu_torch import ServingEngine, TransformerLM

workdir = sys.argv[1]
model = TransformerLM(vocab_size=128, hidden_size=32, num_layers=1,
                      num_heads=2, intermediate_size=64, max_position=256,
                      dropout=0.0, device="cpu", seed=0)
rng = np.random.RandomState(11)
lens = (5, 9, 7, 4, 6)
prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in lens]
eng = ServingEngine(model, max_len=64, slots=2, buckets=[32, 64],
                    cache_layout="paged", block_size=8, spill_tier="disk",
                    spill_dir=os.path.join(workdir, "spill"),
                    journal_path=os.path.join(workdir, "wal.journal"),
                    device="cpu")
for i, p in enumerate(prompts[:2]):
    eng.submit(p, 8, request_id="low%d" % i, priority="low")
eng.pump(2)
for i, p in enumerate(prompts[2:]):
    eng.submit(p, 12, request_id="high%d" % i, priority="high")
eng.preempt()   # park a low victim in the disk tier
eng.pump(2)
parked = sum(1 for r in eng._live.values() if r.state == "PREEMPTED")
sys.stdout.write("LIVE %d PARKED %d\n" % (eng.live_requests, parked))
sys.stdout.flush()
# the crash: SIGKILL mid-decode, no drain, no flush, no exit handlers
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_subprocess_crash_restore_byte_identical(tmp_path):
    """Engine A (a separate process, the port with no reference module
    loaded) admits mixed-priority traffic with a disk-spilled victim and
    is killed with SIGKILL mid-decode; engine B, in this process with
    identical weights built from the same seed, restores from the journal
    and the spill directory and finishes every greedy survivor
    byte-identically with a clean engine's step keys."""
    from paddle_tpu_torch import TransformerLM

    workdir = str(tmp_path)
    child = os.path.join(workdir, "crash_child.py")
    with open(child, "w") as f:
        f.write(_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, child, workdir],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=repo)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-1500:])
    assert "PARKED 1" in proc.stdout, proc.stdout

    model = TransformerLM(vocab_size=128, hidden_size=32, num_layers=1,
                          num_heads=2, intermediate_size=64,
                          max_position=256, dropout=0.0, device="cpu",
                          seed=0)
    rng = np.random.RandomState(11)
    lens = (5, 9, 7, 4, 6)
    prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in lens]

    def mk(journal=None):
        return ServingEngine(model, max_len=64, slots=2, buckets=[32, 64],
                             cache_layout="paged", block_size=8,
                             spill_tier="disk",
                             spill_dir=os.path.join(workdir, "spill"),
                             journal_path=journal, device="cpu")

    ref = mk()
    for warm_len in (20, 50):
        ref.submit(rng.randint(0, 128, (warm_len,)).astype("int32"), 2)
        _drain(ref)
    streams = [ref.submit(p, 8, request_id="low%d" % i, priority="low")
               for i, p in enumerate(prompts[:2])]
    ref.pump(2)
    streams += [ref.submit(p, 12, request_id="high%d" % i,
                           priority="high")
                for i, p in enumerate(prompts[2:])]
    _drain(ref)
    want = {s.request_id: s.result(timeout_s=0).tokens for s in streams}
    clean_counts = ref.compile_counts()

    jpath = os.path.join(workdir, "wal.journal")
    eng_b = mk(journal=jpath)
    for warm_len in (20, 50):
        eng_b.submit(rng.randint(0, 128, (warm_len,)).astype("int32"), 2)
        _drain(eng_b)
    counts_before = eng_b.compile_counts()
    summary = eng_b.restore(jpath)
    assert summary["requests_replayed"] == 5
    assert summary["adopted_from_spill"] == 1
    restored = {rid: rec.stream for rid, rec in eng_b._live.items()}
    _drain(eng_b)
    for rid, s in restored.items():
        st = s.result(timeout_s=0)
        assert st.state == "DONE"
        np.testing.assert_array_equal(np.asarray(st.tokens), want[rid])
    assert eng_b.compile_counts() == counts_before == clean_counts
    snap = eng_b.metrics.snapshot()
    jc = summary["journal_counts"]
    assert snap["serving_journal_replayed_total"] \
        == jc["admitted"] - jc["terminals"]


# -- the fingerprint and the pre-per-request-sampling journal ----------------
def test_fingerprint_drops_global_sampling(model):
    """Two pools differing only in sampling defaults have the same
    fingerprint (sampling is per-request data), with the reference's
    keys (re-pointed from ``tests/test_lora_sampling.py``; LoRA is not
    ported, so ``lora`` is None)."""
    from paddle_tpu.inference import GenerationPool as RefPool

    kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
              block_size=8)
    a = GenerationPool(model, temperature=0.0, device="cpu", **kw)
    b = GenerationPool(model, temperature=0.9, top_k=7, seed=5,
                       device="cpu", **kw)
    fa = a.config_fingerprint()
    assert fa == b.config_fingerprint()
    assert fa["sampling"] == "per-request" and fa["lora"] is None
    assert "temperature" not in fa and "sampling_seed" not in fa
    ref_model = build_pair(**SMALL)[0]
    assert fa == RefPool(ref_model, **kw).config_fingerprint()


def test_journal_v1_upgrade_triage_replays_via_resubmit(model, tmp_path):
    """A journal whose header carries pool-global sampling scalars (the
    format before per-request sampling) replays through the resubmit
    path with the old config applied per request, logged as
    ``journal.upgrade``; a second fresh engine restoring it produces the
    same stream (deterministic going forward)."""
    from paddle_tpu_torch.serving.journal import MAGIC, frame_record

    probe = _mk_engine(model, tmp_path)
    fp2 = probe._pool.config_fingerprint()
    probe.shutdown(drain=False)
    ids = _prompts(5, (9,))[0]
    v1 = {k: v for k, v in fp2.items() if k not in ("sampling", "lora")}
    v1.update(temperature=0.7, top_k=5, top_p=0.9, sampling_seed=123)
    jpath = str(tmp_path / "v1.journal")
    with open(jpath, "wb") as f:
        f.write(MAGIC + frame_record({"t": "header", "v": 1,
                                      "fingerprint": v1})
                + frame_record({"t": "admit", "rid": "old",
                                "ids": [int(t) for t in ids], "max_new": 8,
                                "priority": 0, "tenant": None,
                                "deadline_s": None, "ts": None})
                + frame_record({"t": "commit", "toks": [["old", [3, 7]]]}))

    def restore_once(name):
        eng = _mk_engine(model, tmp_path,
                         journal=str(tmp_path / (name + ".journal")))
        buf = io.StringIO()
        with slog.logging_to(buf):
            summary = eng.restore(jpath)
        streams = {rid: rec.stream for rid, rec in eng._live.items()}
        _drain(eng)
        ups = [json.loads(line) for line in buf.getvalue().splitlines()
               if json.loads(line)["event"] == "journal.upgrade"]
        st = streams["old"].result(timeout_s=0)
        eng.shutdown(drain=False)
        return summary, ups, st

    summary, ups, st = restore_once("a")
    assert summary["requests_replayed"] == 1
    assert ups and ups[0]["temperature"] == 0.7 and ups[0]["seed"] == 123
    assert st.state == "DONE"
    assert list(map(int, st.tokens))[:2] == [3, 7]
    _, _, st2 = restore_once("b")
    assert list(map(int, st2.tokens)) == list(map(int, st.tokens))

"""The port's crash-durability journal and PTKV transfer format
(``serving/journal.py``, ``serving/transfer.py``), re-pointed from the
reference's ``tests/test_journal.py`` and held byte for byte against the
reference's modules (CPU).

Pinned here:

1. replay of a damaged journal recovers the LONGEST VALID PREFIX --
   truncation at every byte offset, CRC corruption of every record --
   and never raises for tail damage (only a destroyed head is an error);
2. record semantics fold deterministically (``admitted - terminals ==
   len(live)``), integer and string rids survive distinctly, a checkpoint
   record replaces the folded state;
3. the writer re-opens an existing journal only under the same
   fingerprint and truncates a torn tail before appending;
4. across the packages: ``frame_record`` gives the reference's bytes, a
   journal written by either package's writer is the same file and reads
   in the other, and a PTKV file written by either package reads in the
   other with bit-identical arrays and header; a mismatched fingerprint
   is refused naming both sides.
"""
import os

import numpy as np
import pytest

from paddle_tpu.serving import journal as ref_journal
from paddle_tpu.serving import transfer as ref_transfer

from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.serving import transfer
from paddle_tpu_torch.serving.journal import (MAGIC, FingerprintMismatchError,
                                              JournalCorruptError,
                                              JournalWriter, frame_record,
                                              read_journal, replay)

FP = {"temperature": 0.0, "cache_layout": "paged", "block_size": 8}

RECORDS = [
    {"t": "admit", "rid": "a", "ids": [1, 2, 3], "max_new": 4,
     "priority": 1, "tenant": None, "deadline_s": None},
    {"t": "commit", "toks": [["a", [7, 8]]]},
    {"t": "admit", "rid": 2, "ids": [4], "max_new": 2, "priority": 0,
     "tenant": "acme", "deadline_s": 5.0},
    {"t": "commit", "toks": [["a", [9]], [2, [5]]]},
    {"t": "terminal", "rid": "a", "state": "DONE", "reason": "length"},
]


def _write(tmp_path, records, name="j.journal", fp=FP):
    path = str(tmp_path / name)
    w = JournalWriter(path, fp)
    for r in records:
        w.append(r)
    w.sync()
    w.close()
    return path


def test_roundtrip_and_replay(tmp_path):
    path = _write(tmp_path, RECORDS)
    fp, records, stats = read_journal(path)
    assert fp == FP
    assert records == RECORDS
    assert stats["truncated"] is False
    assert stats["records_dropped"] == 0 and stats["bytes_dropped"] == 0
    live, counts = replay(records)
    # "a" terminated; 2 survives with its committed token
    assert [e["rid"] for e in live] == [2]
    assert live[0]["tokens"] == [5]
    assert live[0]["ids"] == [4] and live[0]["max_new"] == 2
    assert live[0]["tenant"] == "acme" and live[0]["deadline_s"] == 5.0
    assert counts == {"admitted": 2, "terminals": 1,
                      "committed_tokens": 4, "checkpoints": 0}
    # the acceptance reconciliation: admitted - terminals == live
    assert counts["admitted"] - counts["terminals"] == len(live)


def test_int_and_str_rids_survive_distinctly(tmp_path):
    # int 2 must come back as int 2 (commit records are rid/token
    # PAIRS, not a JSON object, exactly so keys keep their type)
    path = _write(tmp_path, RECORDS)
    _, records, _ = read_journal(path)
    live, _ = replay(records)
    assert live[0]["rid"] == 2 and not isinstance(live[0]["rid"], str)


def test_checkpoint_record_replaces_state(tmp_path):
    ckpt = {"t": "checkpoint", "live": [
        {"rid": "z", "ids": [9, 9], "tokens": [1], "max_new": 6,
         "priority": 2, "tenant": None, "deadline_s": None,
         "retries": 1}]}
    extra = {"t": "commit", "toks": [["z", [3]], ["ghost", [4]]]}
    path = _write(tmp_path, RECORDS + [ckpt, extra])
    _, records, _ = read_journal(path)
    live, counts = replay(records)
    # the snapshot REPLACED everything folded before it; the later
    # commit lands on top of it (the ghost rid is ignored)
    assert [e["rid"] for e in live] == ["z"]
    assert live[0]["tokens"] == [1, 3] and live[0]["retries"] == 1
    assert counts["checkpoints"] == 1


def test_unknown_record_types_are_skipped(tmp_path):
    path = _write(tmp_path, [RECORDS[0], {"t": "future", "x": 1},
                             RECORDS[1]])
    _, records, _ = read_journal(path)
    live, _ = replay(records)
    assert live[0]["tokens"] == [7, 8]


def test_truncation_at_every_byte_offset(tmp_path):
    """The torn-tail property: cut a valid journal at EVERY byte
    offset — replay never crashes, always recovers the longest valid
    prefix, and says exactly how much it dropped."""
    path = _write(tmp_path, RECORDS)
    with open(path, "rb") as f:
        full = f.read()
    # frame boundaries: magic + header + each record
    header_frame = frame_record({"t": "header", "v": 1,
                                 "fingerprint": FP})
    bounds = [len(MAGIC) + len(header_frame)]
    for rec in RECORDS:
        bounds.append(bounds[-1] + len(frame_record(rec)))
    assert bounds[-1] == len(full)
    cut_path = str(tmp_path / "cut.journal")
    for cut in range(len(full) + 1):
        with open(cut_path, "wb") as f:
            f.write(full[:cut])
        if cut < bounds[0]:
            # the HEAD (magic + fingerprint header) is destroyed:
            # that is the one unrecoverable damage class
            with pytest.raises(JournalCorruptError):
                read_journal(cut_path)
            continue
        fp, records, stats = read_journal(cut_path)
        assert fp == FP
        # longest valid prefix: every complete frame before the cut
        n_complete = sum(1 for b in bounds[1:] if b <= cut)
        assert records == RECORDS[:n_complete]
        assert stats["truncated"] == (cut not in bounds)
        assert stats["bytes_dropped"] == cut - bounds[n_complete]
        if cut in bounds:
            assert stats["records_dropped"] == 0
        else:
            assert stats["records_dropped"] >= 1
        # replay of the prefix never raises
        replay(records)


def test_crc_corruption_drops_exact_suffix(tmp_path):
    """Corrupt one byte inside each record's payload in turn: replay
    recovers the records before it, and the dropped-record count is
    exact (the corrupt record plus every intact one behind it —
    framing survives, content does not, and prefix-only is the
    correctness rule)."""
    path = _write(tmp_path, RECORDS)
    with open(path, "rb") as f:
        full = bytearray(f.read())
    header_frame = frame_record({"t": "header", "v": 1,
                                 "fingerprint": FP})
    start = len(MAGIC) + len(header_frame)
    offs = [start]
    for rec in RECORDS:
        offs.append(offs[-1] + len(frame_record(rec)))
    bad_path = str(tmp_path / "bad.journal")
    for i in range(len(RECORDS)):
        corrupt = bytearray(full)
        payload_byte = offs[i] + 8  # first payload byte of record i
        corrupt[payload_byte] ^= 0xFF
        with open(bad_path, "wb") as f:
            f.write(corrupt)
        fp, records, stats = read_journal(bad_path)
        assert records == RECORDS[:i]
        assert stats["truncated"] is True
        assert stats["records_dropped"] == len(RECORDS) - i
        replay(records)  # never raises


def test_head_damage_is_typed(tmp_path):
    missing = str(tmp_path / "nope.journal")
    with pytest.raises(JournalCorruptError, match="unreadable"):
        read_journal(missing)
    empty = str(tmp_path / "empty.journal")
    open(empty, "wb").close()
    with pytest.raises(JournalCorruptError, match="magic"):
        read_journal(empty)
    garbled = str(tmp_path / "garbled.journal")
    with open(garbled, "wb") as f:
        f.write(b"not a journal at all")
    with pytest.raises(JournalCorruptError, match="magic"):
        read_journal(garbled)


def test_reopen_appends_under_same_fingerprint(tmp_path):
    path = _write(tmp_path, RECORDS[:2])
    w = JournalWriter(path, FP)
    w.append(RECORDS[2])
    w.sync()
    w.close()
    _, records, _ = read_journal(path)
    assert records == RECORDS[:3]


def test_reopen_rejects_fingerprint_mismatch(tmp_path):
    path = _write(tmp_path, RECORDS[:1])
    other = dict(FP, temperature=0.7)
    with pytest.raises(FingerprintMismatchError) as ei:
        JournalWriter(path, other)
    msg = str(ei.value)
    # names the differing key AND both sides' values
    assert "temperature" in msg and "0.0" in msg and "0.7" in msg


def test_reopen_truncates_torn_tail_before_appending(tmp_path):
    path = _write(tmp_path, RECORDS[:2])
    size = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"\x13\x37torn")  # a crash mid-write
    w = JournalWriter(path, FP)
    w.append(RECORDS[2])
    w.sync()
    w.close()
    _, records, stats = read_journal(path)
    # the garbage is GONE (not sitting between old and new records)
    assert records == RECORDS[:3]
    assert stats["truncated"] is False
    assert os.path.getsize(path) == size + len(frame_record(RECORDS[2]))


def test_append_rewinds_over_torn_bytes(tmp_path):
    """Exactly-once framing: an append whose write died mid-frame (or
    landed but failed its fsync) must be REPLACED by the next append,
    never stacked behind — a duplicate commit record would
    double-apply tokens at replay, and a torn frame would strand every
    later record past the reader's stop point."""
    path = _write(tmp_path, RECORDS[:1])
    w = JournalWriter(path, FP)
    w.append(RECORDS[1])
    # simulate a torn append: partial frame bytes land at the tail
    # without the writer's known-good offset advancing
    with open(path, "ab") as f:
        f.write(b"\x55torn-partial-frame")
    w.append(RECORDS[2])  # rewinds over the garbage
    w.sync()
    w.close()
    _, records, stats = read_journal(path)
    assert records == RECORDS[:3]
    assert stats["truncated"] is False and stats["bytes_dropped"] == 0


def test_compact_in_place_and_to_path(tmp_path):
    path = _write(tmp_path, RECORDS, name="live.journal")
    w = JournalWriter(path, FP)
    ckpt = {"t": "checkpoint", "live": []}
    # standalone snapshot: the live journal is untouched
    other = str(tmp_path / "snapshot.journal")
    info = w.compact([ckpt], path=other)
    assert info["path"] == other and info["records"] == 1
    _, records, _ = read_journal(other)
    assert records == [ckpt]
    _, records, _ = read_journal(path)
    assert records == RECORDS
    # in-place: the journal shrinks to header + checkpoint and the
    # handle keeps appending onto the COMPACTED file
    w.compact([ckpt])
    w.append(RECORDS[0])
    w.sync()
    w.close()
    _, records, _ = read_journal(path)
    assert records == [ckpt, RECORDS[0]]


def test_fsync_policy_validation(tmp_path):
    with pytest.raises(InvalidArgumentError, match="fsync"):
        JournalWriter(str(tmp_path / "x.journal"), FP, fsync="sometimes")
    for mode in ("always", "tick", "never"):
        p = str(tmp_path / ("m-%s.journal" % mode))
        w = JournalWriter(p, FP, fsync=mode)
        w.append(RECORDS[0])
        w.sync()
        w.close()
        assert read_journal(p)[1] == RECORDS[:1]


def test_commit_for_unknown_rid_is_ignored(tmp_path):
    path = _write(tmp_path, [
        {"t": "commit", "toks": [["ghost", [1, 2]]]}, RECORDS[0]])
    _, records, _ = read_journal(path)
    live, counts = replay(records)
    assert [e["rid"] for e in live] == ["a"]
    assert counts["committed_tokens"] == 0


def test_terminal_for_unknown_rid_not_counted(tmp_path):
    path = _write(tmp_path, [
        {"t": "terminal", "rid": "ghost", "state": "DONE",
         "reason": "length"}] + RECORDS)
    _, records, _ = read_journal(path)
    live, counts = replay(records)
    # the ghost terminal neither crashes nor skews the reconciliation
    assert counts["terminals"] == 1
    assert counts["admitted"] - counts["terminals"] == len(live)


# -- across the packages ------------------------------------------------------
def test_frame_record_bytes_equal_the_reference():
    recs = RECORDS + [{"t": "header", "v": 2, "fingerprint": FP},
                      {"t": "checkpoint", "live": []},
                      {"t": "admit", "rid": "\u00e9", "ids": [1],
                       "max_new": 1, "sampling": [0.0, 0, 1.0, 7, 0]}]
    for rec in recs:
        assert frame_record(rec) == ref_journal.frame_record(rec)
    assert MAGIC == ref_journal.MAGIC
    assert ref_journal.JOURNAL_VERSION == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_file_crosses_between_packages(tmp_path, writer):
    """Both writers produce the same file for the same records, and
    each package's reader folds the other's file to the same state."""
    mine = _write(tmp_path, RECORDS, name="port.journal")
    theirs = str(tmp_path / "ref.journal")
    w = ref_journal.JournalWriter(theirs, FP)
    for r in RECORDS:
        w.append(r)
    w.sync()
    w.close()
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    path = mine if writer == "port" else theirs
    read_port, read_ref = read_journal(path), ref_journal.read_journal(path)
    assert read_port[0] == read_ref[0] and read_port[1] == read_ref[1]
    assert replay(read_port[1]) == ref_journal.replay(read_ref[1])


def _ptkv_arrays(rng):
    return {"l0_f0": rng.standard_normal((3, 2, 8, 4)).astype(np.float32),
            "l0_f1": rng.integers(-127, 128, (3, 2, 8, 4)).astype(np.int8),
            "l0_f2": rng.random((3, 2, 8)).astype(np.float32)}


PTKV_META = {"rid": "r1", "prompt_len": 9, "committed": 4, "written": 2,
             "cache_layout": "paged", "layers": 1, "fields": 3,
             "cache_dtype": "int8", "sampling": [0.0, 0, 1.0, 5, 0],
             "adapter": 0, "block_size": 8}


def _same_view(got, arr):
    # a helper, so no view outlives the reader's close
    assert got.dtype == arr.dtype and got.shape == arr.shape
    assert got.tobytes() == arr.tobytes()
    assert not got.flags.writeable  # mmap views


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ptkv_crosses_between_packages_bit_identical(tmp_path, writer):
    rng = np.random.default_rng(0)
    arrays = _ptkv_arrays(rng)
    path = str(tmp_path / "x.ptkv")
    write = transfer.write_transfer if writer == "port" \
        else ref_transfer.write_transfer
    assert write(path, FP, PTKV_META, arrays, seam="spill.write",
                 rid="r1") == path
    assert not os.path.exists(path + ".tmp")
    for reader in (transfer.TransferReader, ref_transfer.TransferReader):
        r = reader(path)
        try:
            assert r.fingerprint == FP and r.meta == PTKV_META
            assert set(r.arrays) == set(arrays)
            for name, arr in arrays.items():
                _same_view(r.arrays[name], arr)
            assert r.nbytes == sum(a.nbytes for a in arrays.values())
        finally:
            r.close()
    # the two writers produce the same bytes
    other = str(tmp_path / "y.ptkv")
    (ref_transfer.write_transfer if writer == "port"
     else transfer.write_transfer)(other, FP, PTKV_META, arrays)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_ptkv_reader_errors_and_close(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "x.ptkv")
    transfer.write_transfer(path, FP, PTKV_META, _ptkv_arrays(rng))
    r = transfer.TransferReader(path)
    keep = r.arrays["l0_f0"].copy()
    r.close()
    # closing keeps copies (the mapping is gone); keep=False drops them
    assert np.array_equal(r.arrays["l0_f0"], keep)
    r2 = transfer.TransferReader(path)
    r2.close(keep=False)
    assert r2.arrays == {}
    os.remove(path)  # the mapping is closed: the file can go
    legacy = str(tmp_path / "old.npz")
    np.savez(legacy, a=np.zeros(3))
    with pytest.raises(transfer.TransferFormatError) as ei:
        transfer.TransferReader(legacy)
    assert ei.value.legacy_npz
    newer = str(tmp_path / "newer.ptkv")
    transfer.write_transfer(newer, FP, PTKV_META, {})
    with open(newer, "r+b") as f:
        f.seek(4)
        f.write((transfer.VERSION + 1).to_bytes(4, "little"))
    with pytest.raises(transfer.TransferVersionError) as ei:
        transfer.TransferReader(newer)
    assert ei.value.found == transfer.VERSION + 1
    cut = str(tmp_path / "cut.ptkv")
    transfer.write_transfer(cut, FP, PTKV_META, _ptkv_arrays(rng))
    with open(cut, "r+b") as f:
        f.truncate(os.path.getsize(cut) - 8)
    with pytest.raises(transfer.TransferFormatError, match="truncated"):
        transfer.TransferReader(cut)


def test_fingerprint_mismatch_refused_naming_both_sides():
    """The capacity keys may differ between a writer and a reader;
    anything else refuses, naming the keys and both sides' values, in
    both packages alike."""
    pool = dict(FP, slots=4, num_blocks=33)
    transfer.check_fingerprint(dict(pool, slots=8, num_blocks=65), pool)
    other = dict(pool, block_size=16)
    for mod in (transfer, ref_transfer):
        with pytest.raises(mod.TransferFingerprintError) as ei:
            mod.check_fingerprint(other, pool)
        assert ei.value.keys == ("block_size",)
        assert "16" in str(ei.value) and "8" in str(ei.value)
    assert transfer.CAPACITY_KEYS == ref_transfer.CAPACITY_KEYS

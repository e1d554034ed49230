"""Crash durability: the append-only, CRC-framed request journal
(counterpart of the reference's ``serving/journal.py``; the bytes are
the reference's, so a journal written by one package restores in the
other at a matching configuration).

The engine's request-level recovery and the host spill tier live in the
engine's own memory and die with its process.  The journal is their
durable half: prompt + committed tokens fully determine greedy decode
state, so if admissions and committed-token batches are on disk, a FRESH
process -- or a second engine with the same weights -- can adopt the file
and finish every greedy survivor byte-identically.  This module is that
file format plus its replay semantics; the engine-side wiring (what gets
recorded when, checkpoint/restore) lives in ``serving/engine.py``.

Format -- one magic prefix, then length+CRC framed JSON records:

- file = ``MAGIC`` (``b"PTWJ1\\n"``) + frame*
- frame = ``<u32 payload_len><u32 crc32(payload)>`` + payload
- payload = compact JSON object with a ``"t"`` record type:

  ========== ==========================================================
  ``header``     first record of every journal; carries the engine's
                 config fingerprint (sampling config, cache
                 layout/dtype/mesh shape) -- ``restore()`` refuses a
                 journal whose fingerprint does not match the adopting
                 engine, naming both sides
  ``admit``      one admission: rid, prompt ids, token budget,
                 priority/tenant/deadline metadata
  ``commit``     one tick's committed-token deltas:
                 ``[[rid, [tok, ...]], ...]`` (a list of pairs, not an
                 object, so integer rids survive the JSON round trip)
  ``terminal``   a request left the live set (done/cancelled/expired/
                 failed) -- replay stops tracking it
  ``checkpoint`` a full snapshot of the live set; replay REPLACES its
                 state with it (compaction writes a fresh journal that
                 is just header + checkpoint)
  ========== ==========================================================

Torn-tail truncation: a crash mid-``write`` leaves a partial or
CRC-broken frame at the tail.  :func:`read_journal` recovers the
LONGEST VALID PREFIX -- it stops at the first bad frame and never
raises for tail damage (only a missing/garbled file head is an error),
reporting how many bytes and (best-effort) records were dropped so the
restore path can log ``journal.truncated`` with the count.  Records
AFTER a corrupt frame are never trusted even when they parse: a gap
means lost commits, and applying later deltas over a hole would
corrupt token streams -- prefix-only is the correctness rule.

Durability policy: ``fsync="tick"`` (default) syncs once per engine
tick (the flush that carries the tick's commit batch), ``"always"``
syncs every record, ``"never"`` leaves it to the OS.  The window of
loss is bounded either way -- a lost tail only costs REPLAYED decode
work at restore (greedy regeneration is byte-identical), never wrong
tokens.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from ..core.errors import (InvalidArgumentError, PreconditionNotMetError,
                           UnavailableError)
from . import faults

__all__ = ["MAGIC", "JOURNAL_VERSION", "JournalWriter",
           "JournalCorruptError", "JournalWriteError",
           "FingerprintMismatchError", "read_journal", "replay",
           "frame_record"]

MAGIC = b"PTWJ1\n"
# Header schema version.  v1 fingerprints carried pool-GLOBAL sampling
# scalars (temperature/top_k/top_p/sampling_seed); v2 moved sampling to
# per-request data -- the fingerprint carries the
# "sampling": "per-request" marker plus the LoRA bank geometry, and
# admit/checkpoint records carry each request's own resolved
# ``sampling`` 5-list ([temperature, top_k, top_p, seed, draws]) and
# ``adapter`` id.  The engine's restore path triages a v1 header
# (engine._fingerprint_upgrade): equal-modulo-sampling journals replay
# through the resubmit fallback with the old global config applied
# per-request.
JOURNAL_VERSION = 2
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)
# a frame length past this is framing garbage, not a record -- the
# reader treats it as the torn tail (prompts are token-id arrays; even
# a max_position-scale checkpoint is far below this)
MAX_RECORD_BYTES = 64 << 20

_FSYNC_MODES = ("always", "tick", "never")


class JournalCorruptError(PreconditionNotMetError):
    """The journal's HEAD is unreadable (missing/short file, bad magic,
    or no valid header record).  Tail damage is NOT this error -- torn
    tails are truncated silently-but-counted by :func:`read_journal`."""


class JournalWriteError(UnavailableError):
    """An append could not be made durable (typed and RETRYABLE -- the
    engine retries once internally; a submit that still fails is
    rejected so the caller can back off and resubmit, which is strictly
    better than admitting a request the journal cannot replay)."""


class FingerprintMismatchError(PreconditionNotMetError):
    """The journal was written by an engine whose config fingerprint
    (sampling config, cache layout/dtype/mesh shape) differs from the
    adopting engine's -- replaying it could not be byte-identical, so
    restore refuses, naming both sides."""

    def __init__(self, journal_fp: dict, engine_fp: dict):
        self.journal_fingerprint = dict(journal_fp)
        self.engine_fingerprint = dict(engine_fp)
        diff = sorted(k for k in set(journal_fp) | set(engine_fp)
                      if journal_fp.get(k) != engine_fp.get(k))
        super().__init__(
            "journal fingerprint does not match this engine (differing "
            "keys: %s); the byte-identity contract needs identical "
            "sampling config and cache layout/dtype/mesh shape -- "
            "journal side: %r, engine side: %r"
            % (diff, journal_fp, engine_fp))


def frame_record(rec: dict) -> bytes:
    """One record as its on-disk frame (length + crc32 + compact
    JSON).  Shared by the writer and the tests' torn-journal
    corruptors.  Refuses a payload the READER would reject as a torn
    tail -- writing an oversized frame "successfully" and silently
    losing the whole live set at replay is the one failure mode worse
    than failing the write."""
    payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_RECORD_BYTES:
        raise InvalidArgumentError(
            "journal record of %d bytes exceeds MAX_RECORD_BYTES=%d "
            "(the reader treats larger frames as torn-tail garbage): "
            "an unreplayable record must fail at the WRITE, not at "
            "the restore" % (len(payload), MAX_RECORD_BYTES))
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _parse_frame(data: bytes, off: int) -> Optional[Tuple[dict, int]]:
    """``(record, next_offset)`` for the frame at ``off``, or None when
    the bytes there are not one complete, CRC-valid, JSON-parseable
    frame -- the reader's stop condition."""
    if off + _FRAME.size > len(data):
        return None
    length, crc = _FRAME.unpack_from(data, off)
    if length > MAX_RECORD_BYTES or off + _FRAME.size + length > len(data):
        return None
    payload = data[off + _FRAME.size:off + _FRAME.size + length]
    if zlib.crc32(payload) != crc:
        return None
    try:
        rec = json.loads(payload.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(rec, dict):
        return None
    return rec, off + _FRAME.size + length


def read_journal(path: str) -> Tuple[dict, List[dict], dict]:
    """Read ``path`` → ``(fingerprint, records, stats)``.

    Recovers the longest valid prefix: scanning stops at the first
    incomplete/CRC-broken/unparseable frame and everything after it is
    DROPPED (never applied, even if later bytes happen to parse -- a gap
    would corrupt replay).  ``stats`` carries ``bytes_valid`` /
    ``bytes_dropped`` / ``records`` / ``records_dropped`` (best-effort:
    the torn frame plus any well-formed frames the walk can still count
    behind it) / ``truncated``.  Only an unreadable HEAD -- missing
    file, bad magic, no valid header record -- raises
    :class:`JournalCorruptError`."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise JournalCorruptError(
            "journal %r is unreadable: %s" % (path, e))
    if not data.startswith(MAGIC):
        raise JournalCorruptError(
            "journal %r does not start with the %r magic (not a "
            "journal, or its head was destroyed -- tail damage is "
            "recoverable, head damage is not)" % (path, MAGIC))
    off = len(MAGIC)
    parsed = _parse_frame(data, off)
    if parsed is None or parsed[0].get("t") != "header":
        raise JournalCorruptError(
            "journal %r has no valid header record at its head; "
            "a journal always begins with the fingerprint header "
            "(written+fsynced at creation, before any admission)"
            % (path,))
    header, off = parsed
    records: List[dict] = []
    while True:
        parsed = _parse_frame(data, off)
        if parsed is None:
            break
        rec, off = parsed
        records.append(rec)
    dropped_bytes = len(data) - off
    dropped_records = 0
    if dropped_bytes:
        # best-effort count of what the torn tail held: the broken
        # frame itself, plus any well-formed frames its (untrusted)
        # length field still lets the walk reach.  A garbled length
        # desyncs the walk -- then the count is a floor, and
        # bytes_dropped is the honest remainder either way.
        dropped_records = 1
        if off + _FRAME.size <= len(data):
            length, _ = _FRAME.unpack_from(data, off)
            scan = off + _FRAME.size + length
            while 0 < scan <= len(data):
                parsed = _parse_frame(data, scan)
                if parsed is None:
                    break
                dropped_records += 1
                scan = parsed[1]
    stats = {"bytes_total": len(data), "bytes_valid": off,
             "bytes_dropped": dropped_bytes, "records": len(records),
             "records_dropped": dropped_records,
             "truncated": bool(dropped_bytes),
             # header schema version (v1 journals predate per-request
             # sampling; a missing field means v1) -- the restore path
             # keys its upgrade triage off the FINGERPRINT shape, but
             # operators and tests read the declared version here
             "version": int(header.get("v") or 1)}
    return header.get("fingerprint") or {}, records, stats


def replay(records: List[dict]) -> Tuple[List[dict], dict]:
    """Fold ``records`` into the live-request state at the journal's
    (valid) tail: ``(live, counts)``.

    ``live`` is the ordered list of still-live requests, each
    ``{"rid", "ids", "tokens", "max_new", "priority", "tenant",
    "deadline_s", "sampling", "adapter", "retries"}`` -- exactly what
    the engine resubmits (prompt + committed + the per-request
    sampling/adapter data determine decode state).  ``counts`` reconciles
    the replay: ``admitted`` / ``terminals`` / ``committed_tokens`` /
    ``checkpoints`` -- with no checkpoint record,
    ``admitted - terminals == len(live)`` exactly (test-pinned)."""
    live: Dict[object, dict] = {}
    admitted = terminals = tokens = checkpoints = 0
    for rec in records:
        t = rec.get("t")
        if t == "admit":
            admitted += 1
            live[rec["rid"]] = {
                "rid": rec["rid"], "ids": list(rec["ids"]),
                "tokens": [], "max_new": int(rec["max_new"]),
                "priority": int(rec.get("priority") or 0),
                "tenant": rec.get("tenant"),
                "deadline_s": rec.get("deadline_s"),
                # admission wall-clock stamp: restore deducts the
                # elapsed time from deadline_s so a crash does not
                # silently GRANT a request its full budget again
                "ts": rec.get("ts"),
                # v2 per-request fields; None/0 on a v1 admit record --
                # the engine's upgrade triage supplies the old global
                # config in that case
                "sampling": rec.get("sampling"),
                "adapter": int(rec.get("adapter") or 0),
                "retries": 0}
        elif t == "commit":
            for rid, toks in rec.get("toks", ()):
                entry = live.get(rid)
                if entry is not None:
                    entry["tokens"].extend(int(x) for x in toks)
                    tokens += len(toks)
        elif t == "terminal":
            if live.pop(rec.get("rid"), None) is not None:
                terminals += 1
        elif t == "checkpoint":
            # a snapshot REPLACES the folded state: compaction writes
            # header + checkpoint, and replay of the compacted file
            # starts exactly where the live engine was
            checkpoints += 1
            live = {}
            for entry in rec.get("live", ()):
                live[entry["rid"]] = {
                    "rid": entry["rid"], "ids": list(entry["ids"]),
                    "tokens": [int(x) for x in entry.get("tokens", ())],
                    "max_new": int(entry["max_new"]),
                    "priority": int(entry.get("priority") or 0),
                    "tenant": entry.get("tenant"),
                    # checkpoint deadline_s is the REMAINING budget at
                    # snapshot time; the wall-clock stamp lets restore
                    # deduct the downtime since then, same as admits
                    "deadline_s": entry.get("deadline_s"),
                    "ts": entry.get("ts"),
                    "sampling": entry.get("sampling"),
                    "adapter": int(entry.get("adapter") or 0),
                    "retries": int(entry.get("retries") or 0)}
        # unknown record types are skipped, not fatal: a NEWER writer's
        # extra record must not brick an older reader's replay
    counts = {"admitted": admitted, "terminals": terminals,
              "committed_tokens": tokens, "checkpoints": checkpoints}
    return list(live.values()), counts


def _write_all(f, data: bytes) -> None:
    """Write EVERY byte or raise: raw (unbuffered) FileIO.write may
    accept a short count without raising (POSIX write(2) semantics,
    e.g. partway into ENOSPC) -- and a silently-short frame is exactly
    the torn-tail corruption the known-good-offset discipline exists
    to repair, so it must surface as a failure the caller can retry."""
    view = memoryview(data)
    while view:
        n = f.write(view)
        if not n:
            raise OSError(
                "short write: 0 of %d remaining bytes accepted"
                % (len(view),))
        view = view[n:]


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path`` so a rename/creation is
    itself durable (best-effort: not every OS/filesystem allows it)."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class JournalWriter:
    """The engine's append handle on one journal file.

    Creation writes+fsyncs ``MAGIC`` + the header record (the
    fingerprint is durable before the first admission can be).
    Re-opening an EXISTING journal validates its fingerprint against
    ``fingerprint`` (:class:`FingerprintMismatchError` naming both
    sides) and truncates any torn tail first -- appending after garbage
    would put every new record behind the reader's stop point.

    ``append`` fires the ``journal.append`` fault seam before touching
    the file, so the chaos harness can fail exactly the write a real
    full-disk/EIO would.  Failures surface as the caller's exception --
    retry/buffering policy is the engine's."""

    def __init__(self, path: str, fingerprint: dict,
                 fsync: str = "tick"):
        if fsync not in _FSYNC_MODES:
            raise InvalidArgumentError(
                "journal fsync policy must be one of %s (per-record / "
                "per-tick-flush / OS-buffered), got %r"
                % (_FSYNC_MODES, fsync))
        self.path = str(path)
        self.fsync = fsync
        self.fingerprint = dict(fingerprint)
        self.records_written = 0
        self.bytes_written = 0
        # torn-tail damage found (and truncated) at open: recorded so
        # the OWNING engine can surface it -- this constructor runs
        # before any metric/log plane exists, and silently eating the
        # count would blind the same-path restart flow's post-mortem
        self.truncated_bytes = 0
        self.truncated_records = 0
        # the largest integer rid any record in a pre-existing file
        # names: an engine adopting the file advances its auto-rid
        # floor past it, so its OWN pre-restore traffic (warm-up,
        # canaries) can never reuse a crashed engine's auto id and
        # stomp that id's live entry with an admit/terminal of its own
        self.max_int_rid: Optional[int] = None
        exists = os.path.exists(self.path) \
            and os.path.getsize(self.path) > 0
        if exists:
            existing_fp, _records, stats = read_journal(self.path)
            if existing_fp != self.fingerprint:
                raise FingerprintMismatchError(existing_fp,
                                               self.fingerprint)
            self.truncated_bytes = stats["bytes_dropped"]
            self.truncated_records = stats["records_dropped"]
            ints = []
            for r in _records:
                rid = r.get("rid")
                if r.get("t") == "admit" and isinstance(rid, int) \
                        and not isinstance(rid, bool):
                    ints.append(rid)
                elif r.get("t") == "checkpoint":
                    ints.extend(
                        e["rid"] for e in r.get("live", ())
                        if isinstance(e.get("rid"), int)
                        and not isinstance(e.get("rid"), bool))
            self.max_int_rid = max(ints) if ints else None
            # torn tail from a previous crash: truncate BEFORE
            # appending, or everything we write lands past the
            # reader's stop point and replay silently loses it.
            # Unbuffered: every write() reaches the OS, so the
            # known-good offset below is always the literal file state
            self._f = open(self.path, "r+b", buffering=0)
            self._f.truncate(stats["bytes_valid"])
            self._f.seek(stats["bytes_valid"])
            self._good = stats["bytes_valid"]
        else:
            self._f = open(self.path, "wb", buffering=0)
            head = MAGIC + frame_record(
                {"t": "header", "v": JOURNAL_VERSION,
                 "fingerprint": self.fingerprint})
            _write_all(self._f, head)
            os.fsync(self._f.fileno())
            _fsync_dir(self.path)
            self.bytes_written += len(head)
            self._good = len(head)

    def append(self, rec: dict) -> int:
        """Append one record; returns its framed byte size.  Fires the
        ``journal.append`` seam first (an injected fault leaves the
        file untouched, exactly like a failed write).

        EXACTLY-ONCE framing under retries: a previous append may have
        died mid-write (a partial frame at the tail) or AFTER its
        write but before its fsync (a naive retry would then duplicate
        the record -- and a duplicated commit record double-applies
        tokens at replay).  Every append therefore rewinds to the last
        KNOWN-GOOD frame boundary first, so a retried append REPLACES
        its own failed attempt instead of stacking behind it, and a
        torn frame can never strand later records past the reader's
        stop point."""
        faults.fire("journal.append")
        frame = frame_record(rec)
        if self._good != self._f.tell():
            self._f.seek(self._good)
        self._f.truncate(self._good)
        _write_all(self._f, frame)
        if self.fsync == "always":
            os.fsync(self._f.fileno())
        self._good += len(frame)
        self.records_written += 1
        self.bytes_written += len(frame)
        return len(frame)

    def sync(self) -> None:
        """fsync (per policy) -- the engine calls this once per tick
        flush, so ``fsync="tick"`` bounds the loss window at one
        tick's commits (which replay regenerates byte-identically
        anyway).  Writes are unbuffered, so the only deferred step is
        the fsync itself."""
        if self.fsync != "never":
            os.fsync(self._f.fileno())

    def compact(self, records: List[dict],
                path: Optional[str] = None) -> dict:
        """Rewrite the journal as header + ``records`` (normally one
        checkpoint record), atomically: tmp file, fsync, ``os.replace``
        onto ``path`` (default: this journal), fsync the directory.
        Compacting ONTO this journal re-opens the append handle on the
        fresh file; compacting to another ``path`` writes a standalone
        snapshot journal (cross-engine hand-off) and leaves this handle
        alone.  Returns ``{"path", "bytes", "records"}``."""
        target = self.path if path is None else str(path)
        body = MAGIC + frame_record(
            {"t": "header", "v": JOURNAL_VERSION,
             "fingerprint": self.fingerprint})
        for rec in records:
            body += frame_record(rec)
        tmp = target + ".compact.tmp"
        with open(tmp, "wb") as f:
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        if os.path.abspath(target) == os.path.abspath(self.path):
            # close BEFORE the swap so no straggler write can land on
            # the replaced (unlinked) file after the rename
            self._f.close()
            os.replace(tmp, target)
            _fsync_dir(target)
            self._f = open(target, "ab", buffering=0)
            self._good = os.path.getsize(target)
        else:
            os.replace(tmp, target)
            _fsync_dir(target)
        return {"path": target, "bytes": len(body),
                "records": len(records)}

    def close(self) -> None:
        if not self._f.closed:
            if self.fsync != "never":
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass
            self._f.close()

"""The versioned K/V hand-off format, PTKV (counterpart of the
reference's ``serving/transfer.py``; the bytes are the reference's, so a
file written by one package is read by the other).

One wire format for every boundary a request's paged K/V crosses a
process or engine edge on: the disk spill tier (preempt to disk, crash
restore), and the hand-off of a finished prefill (``export_kv``):

====================  =================================================
bytes                 field
====================  =================================================
``[0, 4)``            magic ``b"PTKV"``
``[4, 8)``            format version, u32 little-endian (currently 1)
``[8, 16)``           JSON header length, u64 little-endian
``[16, 16+hlen)``     UTF-8 JSON header: ``{"fingerprint": <the
                      writing pool's full config_fingerprint()>,
                      "meta": <spill meta -- rid, prompt_len,
                      committed, written, block_size, layers, fields,
                      cache_dtype>, "arrays": [{name, dtype, shape,
                      offset, nbytes}, ...]}``
``[data_start, ...)`` raw C-order array blobs; ``data_start`` is
                      ``16+hlen`` rounded up to 64, each array's
                      ``offset`` is relative to ``data_start`` and
                      64-aligned
====================  =================================================

The header is self-describing, the version check is a 16-byte read, and
the 64-byte alignment lets :class:`TransferReader` hand out zero-copy
``np.frombuffer`` views over one ``mmap``.  Such views are read-only:
the pool copies the rows it uploads out of them (a writable host copy
the upload reads), and closes the mapping before the file is deleted.
A bfloat16 cache (no numpy dtype without an extension) is stored under
the dtype name ``"bfloat16"`` and read back as its raw 16-bit words,
which the pool views as ``torch.bfloat16``.

The writer's durability discipline: tmp file + flush + fsync + atomic
``os.replace``, one transient retry at the fault seam (``spill.write``
for preemption spills, ``xfer.write`` for exports), a ``<seam>.error``
trace event per caught fault so chaos harnesses reconcile injections
against the recorder, and tmp-file cleanup on the persistent failure
path.

The typed errors subclass ``InvalidArgumentError`` so
``faults.classify_error`` calls them PERMANENT: a stale-version or
alien-fingerprint file is never retried, the adopting engine falls back
to prompt+committed resubmit (always available, and byte-identical under
greedy decoding).
"""
from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import numpy as np

from ..core.errors import InvalidArgumentError
from . import faults, trace

__all__ = ["MAGIC", "VERSION", "CAPACITY_KEYS",
           "TransferFormatError", "TransferVersionError",
           "TransferFingerprintError",
           "write_transfer", "TransferReader", "check_fingerprint"]

MAGIC = b"PTKV"
VERSION = 1

# fingerprint keys a hand-off is allowed to differ on: tier capacity is
# a per-engine deployment choice (a prefill tier sized for admission
# and a decode tier sized for residency SHOULD differ here), while
# everything else -- sampling config, cache layout/dtype/geometry --
# changes bytes and must match exactly
CAPACITY_KEYS = frozenset({"slots", "num_blocks", "mesh"})

_HEADER_STRUCT = struct.Struct("<4sIQ")  # magic, version, header length
_ALIGN = 64


class TransferFormatError(InvalidArgumentError):
    """The file is not a PTKV transfer at all -- wrong magic, truncated
    prefix, or unparsable header.  ``legacy_npz`` is True when the
    magic is a zip local-file header (``PK\\x03\\x04``): a pre-upgrade
    engine's unversioned ``np.savez`` spill, which adopters reject with
    a one-line log instead of a crash (and leave on disk -- it is the
    old engine's to clean up)."""

    def __init__(self, msg: str, legacy_npz: bool = False):
        super().__init__(msg)
        self.legacy_npz = legacy_npz


class TransferVersionError(InvalidArgumentError):
    """The file IS a PTKV transfer, but written under a different
    format version than this reader speaks.  Carries ``found`` so the
    adopter can apply the staleness rule: ``found < VERSION`` is a
    pre-upgrade leftover under OUR naming scheme -- delete it (a file
    that can never be adopted again is litter);
    ``found > VERSION`` is a NEWER engine's file -- leave it alone."""

    def __init__(self, msg: str, found: int):
        super().__init__(msg)
        self.found = int(found)


class TransferFingerprintError(InvalidArgumentError):
    """The writer's config fingerprint disagrees with the reader's on a
    byte-identity-relevant key (anything outside :data:`CAPACITY_KEYS`).
    Adopting would replay under different sampling/cache semantics —
    the file is another deployment's, so the adopter falls back WITHOUT
    deleting what is not its to judge.  ``keys`` names the differing
    fingerprint keys, both values in the message."""

    def __init__(self, msg: str, keys):
        super().__init__(msg)
        self.keys = tuple(keys)


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a stored array is read as: its own, except
    ``"bfloat16"``, whose raw 16-bit words are read as ``uint16``."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def write_transfer(path: str, fingerprint: dict, meta: dict,
                   arrays: Dict[str, np.ndarray],
                   seam: str = "xfer.write", rid=None,
                   dtype_names: Optional[Dict[str, str]] = None) -> str:
    """Serialize ``arrays`` under the PTKV contract to ``path``.

    Durability and fault semantics are the spill writer's, verbatim:
    the whole image is built in memory first, the ``seam`` fault point
    fires before any I/O, the bytes go to ``path + ".tmp"`` and are
    fsynced before the atomic ``os.replace`` -- a crash mid-write can
    never leave a half file an adopting engine would read.  A transient
    failure (``faults.classify_error``) is retried ONCE; each
    caught fault emits a ``<seam-group>.error`` trace event
    (``spill.error`` / ``xfer.error``) naming the rid, error type, and
    whether a retry follows; a persistent failure removes the tmp file
    and propagates to the caller, which leaves the pool untouched.
    ``dtype_names`` overrides the stored dtype name of some arrays (a
    bfloat16 cache passes its raw words with ``"bfloat16"``)."""
    dtype_names = dtype_names or {}
    table = []
    blobs = []
    offset = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        table.append({"name": str(name),
                      "dtype": dtype_names.get(name, str(arr.dtype)),
                      "shape": list(arr.shape), "offset": offset,
                      "nbytes": int(arr.nbytes)})
        blobs.append(arr)
        offset = _align(offset + arr.nbytes)
    header = json.dumps({"fingerprint": fingerprint, "meta": meta,
                         "arrays": table},
                        sort_keys=True).encode("utf-8")
    prefix = _HEADER_STRUCT.pack(MAGIC, VERSION, len(header))
    data_start = _align(len(prefix) + len(header))
    image = bytearray(data_start + (_align(offset) if blobs else 0))
    image[:len(prefix)] = prefix
    image[len(prefix):len(prefix) + len(header)] = header
    for entry, arr in zip(table, blobs):
        lo = data_start + entry["offset"]
        image[lo:lo + entry["nbytes"]] = arr.tobytes()
    event = seam.split(".", 1)[0] + ".error"
    tmp = path + ".tmp"
    for attempt in (0, 1):
        try:
            faults.fire(seam)
            with open(tmp, "wb") as f:
                f.write(image)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except BaseException as e:  # noqa: BLE001 - classify + retry
            retry = attempt == 0 \
                and faults.classify_error(e) == "transient"
            tr = trace.active()
            if tr is not None:
                tr.instant(event, rid=rid, error=type(e).__name__,
                           retried=retry)
            if not retry:
                # a persistently failed write must not leave its
                # half-written .tmp littering the transfer dir
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
    raise AssertionError("unreachable")  # pragma: no cover


class TransferReader:
    """mmap-backed zero-copy reader for one PTKV transfer file.

    ``arrays`` are read-only ``np.frombuffer`` views over the mapping
    (the kernel pages K/V in on first touch); ``dtypes`` maps each name
    to its stored dtype name.  Keep the reader open while the views are
    live.  :meth:`close` (or the context manager exit) replaces them
    with copies, or drops them with ``keep=False``.

    Raises :class:`TransferFormatError` (bad/legacy magic, truncated or
    corrupt header) or :class:`TransferVersionError` (right magic,
    wrong version) -- both permanent by classification."""

    def __init__(self, path: str):
        self.path = path
        f = open(path, "rb")
        try:
            head = f.read(_HEADER_STRUCT.size)
            if len(head) < _HEADER_STRUCT.size \
                    or head[:4] != MAGIC:
                legacy = head[:4] == b"PK\x03\x04"
                raise TransferFormatError(
                    "%s is not a PTKV transfer file (magic %r)%s"
                    % (path, bytes(head[:4]),
                       " -- pre-upgrade unversioned .npz spill"
                       if legacy else ""),
                    legacy_npz=legacy)
            _, version, hlen = _HEADER_STRUCT.unpack(head)
            if version != VERSION:
                raise TransferVersionError(
                    "%s is PTKV format version %d; this engine speaks "
                    "version %d" % (path, version, VERSION), version)
            size = os.fstat(f.fileno()).st_size
            data_start = _align(_HEADER_STRUCT.size + hlen)
            if size < data_start:
                raise TransferFormatError(
                    "%s truncated: %d bytes < header end %d"
                    % (path, size, data_start))
            try:
                header = json.loads(
                    f.read(hlen).decode("utf-8"))
            except (UnicodeDecodeError, ValueError) as e:
                raise TransferFormatError(
                    "%s header is not valid JSON: %s" % (path, e))
            self._mm = mmap.mmap(f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        finally:
            f.close()
        self.fingerprint = header.get("fingerprint") or {}
        self.meta = header.get("meta") or {}
        self.arrays: Dict[str, np.ndarray] = {}
        self.dtypes: Dict[str, str] = {}
        self.nbytes = 0
        for entry in header.get("arrays") or ():
            lo = data_start + int(entry["offset"])
            hi = lo + int(entry["nbytes"])
            if hi > size:
                raise TransferFormatError(
                    "%s truncated: array %r wants bytes [%d, %d) of a "
                    "%d-byte file" % (path, entry["name"], lo, hi,
                                      size))
            view = np.frombuffer(
                self._mm, dtype=_np_dtype(entry["dtype"]),
                count=int(np.prod(entry["shape"], dtype=np.int64)),
                offset=lo).reshape(entry["shape"])
            self.arrays[entry["name"]] = view
            self.dtypes[entry["name"]] = str(entry["dtype"])
            self.nbytes += int(entry["nbytes"])

    def close(self, keep: bool = True) -> None:
        """Unmap the file.  The views go first (closing a mapping with
        exported buffers raises on CPython): copied when ``keep``, else
        dropped."""
        if getattr(self, "_mm", None) is not None:
            self.arrays = ({k: np.array(v) for k, v in self.arrays.items()}
                           if keep else {})
            self._mm.close()
            self._mm = None

    def __enter__(self) -> "TransferReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def check_fingerprint(header_fp: dict, pool_fp: dict) -> None:
    """Raise :class:`TransferFingerprintError` when the writer's and
    reader's fingerprints differ on any key OUTSIDE
    :data:`CAPACITY_KEYS` -- the disaggregation rule: a prefill tier
    and a decode tier legitimately differ in slots/blocks/mesh (tier
    sizing is the point), but sampling and cache semantics must match
    or the adopted K/V replays under different numerics."""
    keys = (set(header_fp) | set(pool_fp)) - CAPACITY_KEYS
    bad = sorted(k for k in keys
                 if header_fp.get(k) != pool_fp.get(k))
    if bad:
        raise TransferFingerprintError(
            "transfer fingerprint disagrees on %s: file has %s, pool "
            "has %s" % (bad,
                        {k: header_fp.get(k) for k in bad},
                        {k: pool_fp.get(k) for k in bad}), bad)

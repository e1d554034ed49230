"""``save``/``load`` (counterpart of the reference's ``framework/io.py``),
in the reference's on-disk format:

- ``<path>``: the object pickled with every array replaced by an
  ``_ArrayRef(key, kind, dtype)`` placeholder;
- ``<path>.npz``: the arrays; a dtype numpy cannot store (bfloat16, the
  fp8 types) as its unsigned view of the same width, its name in the
  placeholder's ``dtype``.

A file the reference's ``save`` wrote loads here: the unpickler maps the
reference's module paths onto the port's (``paddle_tpu.framework.io.
_ArrayRef`` is this module's ``_ArrayRef``) by name, importing nothing
of the reference, and ``"bfloat16"`` comes back as ``torch.bfloat16``.
Tensors load as CPU tensors (a parameter as an ``nn.Parameter``, kind
``"parameter"``); ``Layer.set_state_dict`` copies them onto the layer's
device.  ``return_numpy=True`` gives numpy arrays (a bfloat16 one needs
``ml_dtypes``).

One process writes the plain pair.  The reader keeps the reference's
sharded layout (``<path>.index<K>.json`` fragments naming chunks of
``<path>.shard<K>.npz``): it merges the fragments and refuses a
checkpoint whose chunks do not cover every array, so a fragment file
loads too.
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.errors import InvalidArgumentError

__all__ = ["save", "load"]

_ARRAYS_SUFFIX = ".npz"
_SHARD_SUFFIX = ".shard%d.npz"
_INDEX_SUFFIX = ".index.json"          # legacy single-process index
_INDEX_FRAG_SUFFIX = ".index%d.json"   # per-process index fragment

_BITS_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_BITS_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
# dtypes numpy stores only as their bits: name -> torch dtype
_VIEW_DTYPES = {"bfloat16": torch.bfloat16}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _VIEW_DTYPES[_name] = getattr(torch, _name)
_VIEW_NAMES = {v: k for k, v in _VIEW_DTYPES.items()}


class _ArrayRef:
    """Pickled placeholder for an array hoisted to the npz sidecar."""

    __slots__ = ("key", "kind", "dtype")

    def __init__(self, key: str, kind: str, dtype: str = ""):
        self.key = key
        self.kind = kind  # "tensor" | "parameter" | "ndarray"
        self.dtype = dtype  # real dtype name when npz stores a uint view


def _savable_tensor(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    name = _VIEW_NAMES.get(t.dtype)
    if name is not None:
        bits = t.view(_BITS_INT[t.element_size()]).numpy()
        return bits.view(_BITS_UINT[t.element_size()]), name
    return t.numpy(), ""


def _savable_array(a: np.ndarray) -> Tuple[np.ndarray, str]:
    # ml_dtypes arrays (bfloat16, fp8) are void-kind scalars of fixed width
    if a.dtype.kind == "V" and a.dtype.names is None \
            and a.dtype.itemsize in _BITS_UINT:
        return a.view(_BITS_UINT[a.dtype.itemsize]), a.dtype.name
    return a, ""


def _hoist(obj, arrays: Dict[str, np.ndarray]):
    """Replace the arrays of a nested structure with placeholders."""
    if torch.is_tensor(obj):
        key = "a%d" % len(arrays)
        arrays[key], dt = _savable_tensor(obj)
        kind = "parameter" if isinstance(obj, nn.Parameter) else "tensor"
        return _ArrayRef(key, kind, dt)
    if isinstance(obj, np.ndarray):
        key = "a%d" % len(arrays)
        arrays[key], dt = _savable_array(obj)
        return _ArrayRef(key, "ndarray", dt)
    if isinstance(obj, dict):
        return {k: _hoist(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_hoist(v, arrays) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


def _numpy_of(bits: np.ndarray, real: str) -> np.ndarray:
    try:
        import ml_dtypes
    except ImportError:
        raise InvalidArgumentError(
            "load(return_numpy=True) of a %s array needs ml_dtypes; load "
            "it as a tensor instead" % real) from None
    return bits.view(np.dtype(getattr(ml_dtypes, real)))


def _restore(obj, arrays, real_dtypes, return_numpy: bool):
    if isinstance(obj, _ArrayRef):
        v = arrays[obj.key]
        real = getattr(obj, "dtype", "") or real_dtypes.get(obj.key, "")
        if return_numpy:
            return _numpy_of(v, real) if real else v
        if real:
            dt = _VIEW_DTYPES.get(real)
            if dt is None:
                raise InvalidArgumentError(
                    "load: dtype %r has no torch counterpart" % real)
            t = torch.from_numpy(np.ascontiguousarray(v)).view(
                _BITS_INT[v.dtype.itemsize]).view(dt)
        else:
            t = torch.from_numpy(np.array(v))
        if obj.kind == "parameter":
            return nn.Parameter(t)
        return t
    if isinstance(obj, dict):
        return {k: _restore(v, arrays, real_dtypes, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_restore(v, arrays, real_dtypes, return_numpy) for v in obj]
        return seq if isinstance(obj, list) else tuple(seq)
    return obj


class _Unpickler(pickle.Unpickler):
    """Maps the reference's module paths onto the port's by name."""

    def find_class(self, module, name):
        top, _, rest = module.partition(".")
        if top == "paddle_tpu":
            port = "paddle_tpu_torch" + ("." + rest if rest else "")
            try:
                return getattr(importlib.import_module(port), name)
            except (ImportError, AttributeError):
                raise InvalidArgumentError(
                    "load: the checkpoint holds %s.%s, which has no "
                    "counterpart %s.%s in the port"
                    % (module, name, port, name)) from None
        return super().find_class(module, name)


def _boxes_cover(boxes, shape) -> bool:
    """True when the union of axis-aligned boxes covers the full shape
    (the reference's check: disjoint boxes by their summed sizes, others
    by a boolean mask)."""
    total = int(np.prod(shape)) if shape else 1
    uniq = sorted(set(boxes))
    sizes = [int(np.prod([b - a for a, b in bx])) if bx else 1 for bx in uniq]
    disjoint = all(
        not all(a1 < b2 and a2 < b1 for (a1, b1), (a2, b2)
                in zip(uniq[i], uniq[j]))
        for i in range(len(uniq)) for j in range(i + 1, len(uniq)))
    if disjoint:
        return sum(sizes) == total
    covered = np.zeros(shape, dtype=bool)
    for bx in uniq:
        covered[tuple(slice(a, b) for a, b in bx)] = True
    return bool(covered.all())


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    """paddle.save: ``obj`` (a state dict, nested containers of tensors
    and arrays, any picklable object) to ``path`` and ``path + ".npz"``."""
    if not isinstance(path, (str, os.PathLike)):
        raise InvalidArgumentError(
            "save path must be a string, got %r" % (path,))
    path = os.fspath(path)
    if path.endswith("/"):
        raise InvalidArgumentError("save path %r is a directory" % path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    skeleton = _hoist(obj, arrays)
    # stale sidecars of an earlier save at this path would be merged in
    stale = [path + _INDEX_SUFFIX]
    k = 0
    while os.path.exists(path + _INDEX_FRAG_SUFFIX % k) \
            or os.path.exists(path + _SHARD_SUFFIX % k):
        stale += [path + _INDEX_FRAG_SUFFIX % k, path + _SHARD_SUFFIX % k]
        k += 1
    for p in stale:
        if os.path.exists(p):
            os.remove(p)
    np.savez(path + _ARRAYS_SUFFIX, **arrays)
    with open(path, "wb") as f:
        pickle.dump(skeleton, f, protocol=protocol)


def _merge_fragments(path: str, arrays: dict, real_dtypes: dict) -> None:
    merged: Dict[str, dict] = {}
    frags = []
    if os.path.exists(path + _INDEX_SUFFIX):
        frags.append(path + _INDEX_SUFFIX)
    k = 0
    while os.path.exists(path + _INDEX_FRAG_SUFFIX % k):
        frags.append(path + _INDEX_FRAG_SUFFIX % k)
        k += 1
    expect_nproc: Optional[int] = None
    n_frag_files = 0
    for fp in frags:
        with open(fp) as f:
            index = json.load(f)
        if "process" in index:  # fragment format (legacy index lacks it)
            n_frag_files += 1
            if expect_nproc is None:
                expect_nproc = index.get("nprocesses")
        for key, meta in index["arrays"].items():
            ent = merged.setdefault(
                key, {"shape": meta["shape"], "dtype": meta["dtype"],
                      "chunks": []})
            if ent["shape"] != meta["shape"] or ent["dtype"] != meta["dtype"]:
                raise InvalidArgumentError(
                    "checkpoint index fragments disagree on %r: shape/dtype "
                    "%r/%r vs %r/%r" % (key, ent["shape"], ent["dtype"],
                                        meta["shape"], meta["dtype"]))
            ent["chunks"].extend(meta["chunks"])
    if expect_nproc is not None and n_frag_files < expect_nproc:
        missing = [i for i in range(expect_nproc)
                   if not os.path.exists(path + _INDEX_FRAG_SUFFIX % i)]
        raise InvalidArgumentError(
            "checkpoint %r was written by %d processes but only %d index "
            "fragment(s) are present (missing: %r)"
            % (path, expect_nproc, n_frag_files, missing))
    if not merged:
        return
    shard_data: Dict[str, np.ndarray] = {}
    k = 0
    while os.path.exists(path + _SHARD_SUFFIX % k):
        with np.load(path + _SHARD_SUFFIX % k, allow_pickle=False) as z:
            shard_data.update({n: z[n] for n in z.files})
        k += 1
    for key, meta in merged.items():
        if meta["dtype"] in _VIEW_DTYPES:
            size = torch.empty((), dtype=_VIEW_DTYPES[meta["dtype"]]
                               ).element_size()
            dt = np.dtype(_BITS_UINT[size])
            real_dtypes[key] = meta["dtype"]
        else:
            dt = np.dtype(meta["dtype"])
        full = np.zeros(meta["shape"], dtype=dt)
        boxes = []
        for chunk in meta["chunks"]:
            if chunk["key"] not in shard_data:
                raise InvalidArgumentError(
                    "checkpoint shard chunk %r missing (found %d shard "
                    "files)" % (chunk["key"], k))
            sl = tuple(slice(a, b) for a, b in chunk["index"])
            full[sl] = shard_data[chunk["key"]].view(dt).reshape(
                full[sl].shape)
            boxes.append(tuple((a, b) for a, b in chunk["index"]))
        if not _boxes_cover(boxes, meta["shape"]):
            raise InvalidArgumentError(
                "checkpoint %r: shard chunks do not cover all of %r "
                "(shape %r) — missing per-process shard files?"
                % (path, key, meta["shape"]))
        arrays[key] = full


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """paddle.load: the object :func:`save` (or the reference's) wrote at
    ``path``, its arrays as CPU tensors (or numpy arrays)."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise InvalidArgumentError("checkpoint %r not found" % path)
    with open(path, "rb") as f:
        skeleton = _Unpickler(f).load()
    arrays: Dict[str, np.ndarray] = {}
    if os.path.exists(path + _ARRAYS_SUFFIX):
        with np.load(path + _ARRAYS_SUFFIX, allow_pickle=False) as z:
            arrays.update({k: z[k] for k in z.files})
    real_dtypes: Dict[str, str] = {}
    _merge_fragments(path, arrays, real_dtypes)
    return _restore(skeleton, arrays, real_dtypes, return_numpy)

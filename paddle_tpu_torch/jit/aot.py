"""One executable per step shape (counterpart of the reference's
``jit/aot.py``).

The reference compiles each serving step once per shape key
(``jax.jit(f).lower(...).compile()``) and counts the keys: that count is
the "one executable per shape" contract its tests pin through
``compile_counts()``.  Here an :class:`AotFunction` keys every call by one
argument's shape (:func:`shape_key`, the reference's strings) and counts
the keys the same way.  What a key holds depends on the device:

- On the card, a capturing function (``capture=True``) keeps one
  ``torch.cuda.CUDAGraph`` per key.  The first call of a key is its
  warm-up and runs eagerly, as the real step.  The second call captures
  the function (capture records the launches without running them) and
  replays the graph once, so no call runs its step twice: a cache index
  advances once and K/V are written once.  Every later call replays.
  The tensors passed to the capturing call are the key's static inputs:
  the wrapper holds them, a later call passing the same tensors copies
  nothing, and one passing other tensors of the same shapes has them
  copied into the held ones before the replay.  A step may write its
  inputs (a token fed back for the next call): callers keep such a
  buffer and pass it every call.  Other arguments must equal the capturing
  call's.  The returned tensors are the graph's static outputs,
  overwritten by the next replay.  Every other tensor the function reads
  or writes (a cache it closes over, a buffer it fills) is reached by
  address, so it must stay where it is for the wrapper's life.  A failed
  capture raises :class:`CaptureError`; nothing runs the step eagerly in
  its place.
- On the CPU, and for a function built with ``capture=False``, every call
  runs eagerly: a "compile" is then a distinct shape key, and no graph
  exists.  The keys are counted all the same, so the contract is testable
  without a card.

A kernel wrapper counts its launches where it launches, and a replay
launches without calling it: the wrapper records how far each count rose
during the capture (K3's counts per dtype), puts the counts back, and adds
that rise on every replay, so the counts stay the number of kernels run.

A graph also reads by address every tensor it closes over: the model's
parameters and buffers, a train step's optimizer state.  An owner that
passes ``watch=`` (a callable returning those tensors) has their
``data_ptr()``, shape and dtype recorded at each capture;
:meth:`AotFunction.drop_moved` drops exactly the graphs whose recorded
tensors moved (``load_state_dict(..., assign=True)``, ``param.data =``,
``module.to``, ``amp.decorate``'s cast), and the key's next call warms up
and captures again.  The key stays counted, so ``compile_counts()`` does
not move.  A changed shape or dtype is an error unless the owner allows
it (a train step re-captures; a serving step's executable is fixed to its
shapes and dtypes, as the reference's).

Captures are serialized process-wide (:data:`CAPTURE_GUARD`) and run in
``thread_local`` capture mode.  Several engines may share one card, each
ticking under its own lock on its own thread: the mode leaves the other
threads free to launch, allocate and download while one captures, and the
guard keeps two captures from meeting (``torch.cuda.graph`` synchronizes
the device and empties the allocator's cache before it begins, which
would void a capture in flight on another thread).

Cost attribution (the reference's ``analyze_compiled`` /
``AotFunction.cost_report``).  There is no compiled artifact to read, so
each key is counted once, on its first call -- the eager warm-up, which is
the real step -- and never on a replay: a ``TorchDispatchMode`` sees every
aten op of the step, ``torch.utils.flop_counter``'s formulas give the
FLOPs of the matrix-class ops (mm, bmm, addmm, baddbmm, attention), every
op's inputs and outputs give ``bytes_accessed`` (views and allocations
move nothing; a gather or an in-place scatter counts the rows it moves,
not its whole source), and each hand-written kernel adds its own count
from its shapes (``ops.kernel_cost``).  These are unfused counts, where
the reference reads XLA's counts after fusion (which include elementwise
FLOPs), so the two packages' numbers are not comparable; the report's
structure is the reference's.  The memory fields follow
``memory_analysis()``: ``argument_bytes`` are the held inputs plus the
tensors the step reads by address (the watched weights and the cache,
``watch=`` and ``reads=``), each storage once; ``output_bytes`` the
outputs, the argument storages the step writes in place among them (as a
donated buffer is an output in XLA's analysis); ``alias_bytes`` those
written arguments (the cache, the fed-back token); ``temp_bytes`` the
bytes the allocator holds in the captured graph's private pool on the card
(read from the allocator's segments of that pool, so another thread's
allocations during the capture do not count);
``hbm_reserved_bytes = argument + output - alias + temp``.
A field only the card can give is an explicit ``*_unavailable`` marker,
never a zero: ``temp_bytes`` on the CPU, on an eager key and before a
key's capture, ``generated_code_bytes`` everywhere (no step generates
code).  ``meta_fn(*args) -> dict`` runs at the count and rides the entry
(the decode steps' ``kv_cache_bytes``, :func:`kv_arg_bytes`).
"""
from __future__ import annotations

import gc
import itertools
import threading
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.errors import ExternalError, InvalidArgumentError
from ..ops import custom_kernels, decode_kernels, flash_kernels
from ..ops.flash_attention import capturing_inputs

__all__ = ["AotFunction", "CaptureError", "StaticInputs", "module_tensors",
           "shape_key", "kv_arg_bytes", "CAPTURE_GUARD"]

# at most one CUDA graph capture in flight in the process (module docstring)
CAPTURE_GUARD = threading.RLock()

# the step this thread runs under an AotFunction, for code inside it that
# prepares the key's capture (``distributed.fleet.utils.recompute``'s
# generator states), and the callables run with ``(owner, graph)`` just
# before each capture begins
_STEP = threading.local()
PRE_CAPTURE_HOOKS: list = []


class _Running:
    """One warm-up or capture of a key: ``mode`` ("warm_up" or
    "capture") and ``owner``, ``(id(function), key)``."""

    def __init__(self, mode: str, owner):
        self.mode, self.owner = mode, owner

    def __enter__(self):
        self._prev = getattr(_STEP, "now", None)
        _STEP.now = self

    def __exit__(self, *exc):
        _STEP.now = self._prev


def current_step() -> Optional[_Running]:
    """The AotFunction warm-up or capture this thread is in, or None."""
    return getattr(_STEP, "now", None)

# every kernel wrapper whose launch count a replay must advance: K1/K2 and
# K4 count in ``launches``, K3's two wrappers per dtype in
# ``launches_by_dtype``
_COUNTED = (tuple(decode_kernels._WRAPPERS.values())
            + (custom_kernels.scale_mul,)
            + tuple(flash_kernels._WRAPPERS.values()))


def _read_counts() -> list:
    return [dict(fn.launches_by_dtype) if hasattr(fn, "launches_by_dtype")
            else fn.launches for fn in _COUNTED]


def _write_counts(counts) -> None:
    for fn, n in zip(_COUNTED, counts):
        if isinstance(n, dict):
            fn.launches_by_dtype = dict(n)
        else:
            fn.launches = n


def _advance_counts(rise) -> None:
    for fn, n in zip(_COUNTED, rise):
        if isinstance(n, dict):
            for dt, k in n.items():
                fn.launches_by_dtype[dt] += k
        else:
            fn.launches += n


def _count_rise(before, after) -> list:
    return [{dt: a[dt] - b[dt] for dt in a} if isinstance(a, dict)
            else a - b for b, a in zip(before, after)]


def kv_arg_bytes(cache) -> int:
    """Bytes of the K/V payload (with int8 scales, or a recurrent state) of
    a decode cache: the figure that reconciles with the pool's
    ``cache_stats()["pool_bytes"]``.  The index vector and the block table
    are bookkeeping, not payload."""
    total = 0
    for c in cache:
        # a mesh's layer (``ShardedCache``): each distinct shard once
        parts = [p for _, p in c.parts()] if hasattr(c, "parts") else [c]
        for part in parts:
            for field in ("k", "v", "k_scale", "v_scale", "state"):
                t = getattr(part, field, None)
                if torch.is_tensor(t):
                    total += t.numel() * t.element_size()
    return total


def cache_tensors(cache) -> list:
    """Every tensor of a decode cache (K/V, scales, index, table): what a
    step over it reads by address."""
    return [t for c in cache for t in c if torch.is_tensor(t)]


def _flat_tensors(obj, out=None) -> list:
    """The tensors of a step's arguments or outputs: tensors, lists and
    tuples (caches are named tuples), dicts, and objects holding one
    ``data`` tensor (:class:`StaticInputs`)."""
    out = [] if out is None else out
    if torch.is_tensor(obj):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _flat_tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _flat_tensors(o, out)
    elif torch.is_tensor(getattr(obj, "data", None)):
        out.append(obj.data)
    return out


def _storages(tensors) -> dict:
    """{storage address: storage bytes}, each storage once."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st.data_ptr()] = st.nbytes()
    return out


def _tbytes(t) -> int:
    return t.numel() * t.element_size()


try:
    from torch.utils.flop_counter import flop_registry as _FLOPS
except ImportError:  # pragma: no cover - an old torch counts no FLOPs
    _FLOPS = {}

_aten = torch.ops.aten
# allocations move no bytes
_ALLOC = frozenset((_aten.empty, _aten.empty_like, _aten.empty_strided,
                    _aten.new_empty, _aten.new_empty_strided))
# a gather reads the rows it returns (and its indices), not its source
_GATHER = frozenset((_aten.index, _aten.index_select, _aten.gather,
                     _aten.embedding, _aten.take))
# an in-place scatter writes the rows it is given, not its whole target
_SCATTER = frozenset((_aten.index_put_, _aten._index_put_impl_,
                      _aten.index_copy_, _aten.scatter_, _aten.index_add_,
                      _aten.masked_scatter_, _aten.index_fill_))
# written, not read
_FILL = frozenset((_aten.copy_, _aten.fill_, _aten.zero_))


class _CostCounter(TorchDispatchMode):
    """Counts one step's FLOPs and bytes (module docstring) and the
    storages it writes in place."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.written = set()

    def add_kernel_cost(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if packet in _ALLOC:
            return
        schema = func._schema
        written = []
        for i, a in enumerate(schema.arguments):
            info = a.alias_info
            if info is not None and info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                written.extend(_flat_tensors(v))
        if not written and schema.returns and all(
                r.alias_info is not None for r in schema.returns):
            return  # a view moves nothing
        for t in written:
            self.written.add(t.untyped_storage().data_ptr())
        formula = _FLOPS.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, out_val=out, **kwargs))
        ins = _flat_tensors(list(args) + list(kwargs.values()))
        outs = _flat_tensors(out)
        if packet in _GATHER:
            moved = 2 * sum(map(_tbytes, outs)) + sum(
                _tbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif packet in _SCATTER:
            moved = 2 * sum(map(_tbytes, ins[1:]))
        elif packet in _FILL:
            moved = sum(map(_tbytes, ins))
        else:
            moved = sum(map(_tbytes, ins)) + sum(map(_tbytes, outs))
        self.bytes += moved


def module_tensors(*modules) -> list:
    """Every parameter and buffer of ``modules``: what a step over them
    reads by address (the ``watch=`` of their captured steps)."""
    out = []
    for m in modules:
        out.extend(m.parameters())
        out.extend(m.buffers())
    return out


def _addresses(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


def _layouts(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


# a key whose next call runs eagerly (its first, or the one after its graph
# was dropped): the warm-up is the real step
_COLD = object()


class CaptureError(ExternalError):
    """A capturing step could not be captured as a CUDA graph."""


def shape_key(arr) -> str:
    """The executable-cache key of one distinguishing argument:
    ``"<shape joined by x>_<dtype>"``, e.g. ``"8_int32"`` for an 8-slot
    decode token vector, ``"1x512_int32"`` for a batch-1 512-token
    prefill.  Reads metadata only."""
    dt = arr.dtype
    name = (str(dt).rsplit(".", 1)[-1] if isinstance(dt, torch.dtype)
            else np.dtype(dt).name)
    return "%s_%s" % ("x".join(str(int(d)) for d in arr.shape) or "scalar",
                      name)


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches", "watched")

    def __init__(self, graph, inputs, outputs, launches, watched):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.watched = watched


class AotFunction:
    """``fn`` behind a shape-keyed executable cache.

    ``key_fn(*args) -> str`` names the executable a call maps to (usually
    :func:`shape_key` of the one argument whose shape varies).  Two calls
    that key equal must run the same step on tensors of the same shapes:
    key functions are declared next to the call site's shape contract."""

    def __init__(self, fn: Callable, key_fn: Callable[..., str],
                 name: str = "", capture: bool = False,
                 watch: Optional[Callable[[], Iterable]] = None,
                 meta_fn: Optional[Callable[..., dict]] = None,
                 reads: Optional[Callable[..., Iterable]] = None):
        self._fn = fn
        self._key_fn = key_fn
        self.name = name
        self._capture = bool(capture)
        self._watch = watch
        self._meta_fn = meta_fn
        self._reads = reads
        # key -> _COLD (counted; the next call warms up), None (warm, the
        # next call on the card captures) or the key's captured graph
        self._keys: Dict[str, object] = {}
        # key -> cost entry, and the count of entry writes (a key counted,
        # a capture measured): the cost reports' version
        self._costs: Dict[str, dict] = {}
        self.cost_revision = 0

    def __call__(self, *args):
        key = self._key_fn(*args)
        entry = self._keys.get(key, _COLD)
        if entry is _COLD:
            self._keys[key] = None
            if key in self._costs:
                with _Running("warm_up", (id(self), key)):
                    return self._warm_up(args)
            # the warm-up is the real step, and the key's one count
            counter = _CostCounter()
            with counter, _Running("warm_up", (id(self), key)):
                out = self._warm_up(args)
            self._costs[key] = self._cost_entry(key, args, out, counter)
            self.cost_revision += 1
            return out
        if not (self._capture and _on_cuda(args)):
            return self._fn(*args)
        if entry is None:
            entry = self._keys[key] = self._capture_key(key, args)
        else:
            for arg, held in zip(args, entry.inputs):
                if torch.is_tensor(held):
                    if arg is not held:
                        held.copy_(arg)
                elif arg != held:
                    raise InvalidArgumentError(
                        "%s: argument %r differs from the captured call's "
                        "%r; only tensors may vary between replays"
                        % (self.name, arg, held))
        entry.graph.replay()
        _advance_counts(entry.launches)
        return entry.outputs

    def _warm_up(self, args):
        return self._fn(*args)

    def _run_eager(self, *args):
        """Run the step eagerly, outside the cache: no key is counted and
        no graph is used (graph-vs-eager comparisons on the card)."""
        return self._fn(*args)

    def _cost_entry(self, key: str, args, out, counter) -> dict:
        """The key's cost entry from its counted warm-up (module
        docstring)."""
        held = _flat_tensors(args)
        extra = list(self._watch()) if self._watch is not None else []
        if self._reads is not None:
            extra += list(self._reads(*args))
        arg = _storages(held + extra)
        # an argument written in place is an output too (XLA's donated
        # buffer appears on both sides), so the reserved sum counts it once
        aliased = {p: n for p, n in arg.items() if p in counter.written}
        outs = _storages(_flat_tensors(out))
        outs.update(aliased)
        entry = {"key": key, "flops": counter.flops,
                 "bytes_accessed": counter.bytes,
                 "argument_bytes": sum(arg.values()),
                 "output_bytes": sum(outs.values()),
                 "alias_bytes": sum(aliased.values()),
                 "generated_code_bytes_unavailable":
                     "the steps run prebuilt kernels and aten's; no code "
                     "is generated per key"}
        if not _on_cuda(args):
            entry["temp_bytes_unavailable"] = (
                "a CPU step has no graph pool: temp bytes are the size of "
                "a captured graph's private pool on the card")
        elif self._capture:
            entry["temp_bytes_unavailable"] = (
                "measured when the key's graph is captured (its second "
                "call)")
        else:
            entry["temp_bytes_unavailable"] = (
                "an eager step on the card has no graph pool to measure")
        if self._meta_fn is not None:
            entry.update(self._meta_fn(*args))
        return entry

    def _note_capture(self, key: str, temp: int) -> None:
        entry = self._costs.get(key)
        if entry is None:
            return
        entry.pop("temp_bytes_unavailable", None)
        entry["temp_bytes"] = int(temp)
        entry["hbm_reserved_bytes"] = (entry["argument_bytes"]
                                       + entry["output_bytes"]
                                       - entry["alias_bytes"] + int(temp))
        self.cost_revision += 1

    def cost_report(self) -> Dict[str, dict]:
        """{key: cost entry} for every counted key: copies, so a report
        never counts, captures or synchronizes."""
        return {k: dict(v) for k, v in self._costs.items()}

    def last_cost(self) -> Optional[dict]:
        """The most recently counted key's entry (None before the first
        call): the steady-state step of a fixed-shape call site."""
        if not self._costs:
            return None
        return dict(self._costs[next(reversed(self._costs))])

    def _capture_key(self, key: str, args) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        with CAPTURE_GUARD:
            # a dead owner's graph freed here, not during the capture (see
            # below), and its pool back to the card before this one grows
            gc.collect()
            torch.cuda.empty_cache()
            # this thread's cuBLAS handle is made at its first use, which a
            # capture forbids (it voids the capture), and the key's warm-up
            # may have run on another thread: make it now, with the card's
            # context current on this thread
            torch.cuda.synchronize()
            torch.cuda.current_blas_handle()
            before = _read_counts()
            # no cyclic garbage collection while capturing: a dead owner's
            # graph freed then (its destructor destroys a CUDA graph) is an
            # operation capture forbids, and invalidates this capture
            collecting = gc.isenabled()
            gc.disable()
            owner = (id(self), key)
            try:
                for hook in PRE_CAPTURE_HOOKS:
                    hook(owner, graph)
                with capturing_inputs(args), _Running("capture", owner), \
                        torch.cuda.graph(graph,
                                         capture_error_mode="thread_local"):
                    outputs = self._fn(*args)
            except Exception as e:  # noqa: BLE001 - re-raised typed
                raise CaptureError(
                    "%s: capturing key %s as a CUDA graph failed: %s: %s "
                    "(the step reads a value on the host, or calls an API "
                    "capture forbids)"
                    % (self.name, key, type(e).__name__, e)) from e
            finally:
                if collecting:
                    gc.enable()
                launches = _count_rise(before, _read_counts())
                _write_counts(before)
            self._note_capture(key, _pool_bytes(graph.pool()))
        watched = None
        if self._watch is not None:
            tensors = list(self._watch())
            watched = (_addresses(tensors), _layouts(tensors))
        return _Graph(graph, tuple(args), outputs, launches, watched)

    def drop_moved(self, allow_retype: bool = False) -> list:
        """Drop every captured graph whose watched tensors moved since its
        capture; the key's next call warms up and captures again, and the
        key stays counted.  Returns the dropped keys.  A watched tensor
        whose shape or dtype changed raises ``InvalidArgumentError``
        unless ``allow_retype``."""
        if self._watch is None:
            return []
        now = None
        dropped = []
        for key, entry in self._keys.items():
            if not isinstance(entry, _Graph):
                continue
            if now is None:
                tensors = list(self._watch())
                now = _addresses(tensors)
                layouts = None if allow_retype else _layouts(tensors)
            if entry.watched[0] == now and (
                    allow_retype or entry.watched[1] == layouts):
                continue
            if not allow_retype:
                for i, (was, got) in enumerate(itertools.zip_longest(
                        entry.watched[1], layouts)):
                    if was != got:
                        raise InvalidArgumentError(
                            "%s: watched tensor %d changed from %s to %s "
                            "(shape, dtype); a captured step keeps the "
                            "shapes and dtypes it was captured with"
                            % (self.name, i, was, got))
            dropped.append(key)
        for key in dropped:
            self._keys[key] = _COLD
        return dropped

    # the observable behind the one-executable-per-shape contract: one
    # entry per key, never evicted
    def _cache_size(self) -> int:
        return len(self._keys)

    @property
    def compiles(self) -> int:
        """Lifetime key count (entries are never evicted)."""
        return len(self._keys)

    def graphs(self) -> int:
        """Keys that hold a captured CUDA graph (0 on the CPU)."""
        return sum(1 for e in self._keys.values() if isinstance(e, _Graph))

    def release_graphs(self) -> None:
        """Destroy every captured graph now (their private pools go back
        to the allocator); each key warms up and captures again at its
        next call and stays counted.  For an owner being torn down: the
        collector would otherwise destroy the graphs at a time of its
        choosing, possibly during another step's capture, so they are
        freed under :data:`CAPTURE_GUARD`."""
        with CAPTURE_GUARD:
            for key, entry in self._keys.items():
                if isinstance(entry, _Graph):
                    self._keys[key] = _COLD


def _pool_bytes(pool) -> int:
    """The bytes the allocator holds in one private pool (a captured
    graph's), from its segments of that pool alone."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) == pool)


def _on_cuda(args) -> bool:
    return any(torch.is_tensor(a) and a.is_cuda for a in args)


class StaticInputs:
    """Named int32 and float32 vectors packed into ONE int32 device
    tensor: the static inputs of a captured step.  ``fields`` lists
    ``(name, length, dtype)``; each name becomes an attribute viewing its
    slice (a float32 field is a bit view of its int32 slice).
    :meth:`upload` rewrites every field in one host-to-device copy; a
    captured graph reads the fields by address."""

    def __init__(self, fields, device):
        self._spec = []
        off = 0
        for name, length, dtype in fields:
            self._spec.append((name, off, int(length), dtype))
            off += int(length)
        self.data = torch.zeros(off, dtype=torch.int32, device=device)
        for name, start, length, dtype in self._spec:
            view = self.data[start:start + length]
            setattr(self, name, view if dtype == torch.int32
                    else view.view(torch.float32))

    def upload(self, **values) -> None:
        """Rewrite every field from host values (scalars broadcast;
        integers wrap to int32, so a uint32 seed keeps its bits)."""
        host = np.empty(self.data.numel(), np.int32)
        for name, start, length, dtype in self._spec:
            v = np.asarray(values[name])
            part = host[start:start + length]
            if dtype == torch.float32:
                part[:] = np.broadcast_to(v.astype(np.float32),
                                          (length,)).view(np.int32)
            else:
                part[:] = np.broadcast_to(v.astype(np.int64)
                                          .astype(np.int32), (length,))
        self.data.copy_(torch.from_numpy(host))

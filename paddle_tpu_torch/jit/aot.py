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

The reference's compile-time cost attribution (``cost_report``) is not
ported yet.
"""
from __future__ import annotations

import gc
import itertools
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core.errors import ExternalError, InvalidArgumentError
from ..ops import custom_kernels, decode_kernels, flash_kernels
from ..ops.flash_attention import capturing_inputs

__all__ = ["AotFunction", "CaptureError", "StaticInputs", "module_tensors",
           "shape_key"]

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
                 watch: Optional[Callable[[], Iterable]] = None):
        self._fn = fn
        self._key_fn = key_fn
        self.name = name
        self._capture = bool(capture)
        self._watch = watch
        # key -> _COLD (counted; the next call warms up), None (warm, the
        # next call on the card captures) or the key's captured graph
        self._keys: Dict[str, object] = {}

    def __call__(self, *args):
        key = self._key_fn(*args)
        entry = self._keys.get(key, _COLD)
        if entry is _COLD:
            self._keys[key] = None
            return self._warm_up(args)  # the warm-up is the real step
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

    def _capture_key(self, key: str, args) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        before = _read_counts()
        # no cyclic garbage collection while capturing: a dead owner's
        # graph freed then (its destructor destroys a CUDA graph) is an
        # operation capture forbids, and invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capturing_inputs(args), torch.cuda.graph(graph):
                outputs = self._fn(*args)
        except Exception as e:  # noqa: BLE001 - re-raised typed
            raise CaptureError(
                "%s: capturing key %s as a CUDA graph failed: %s: %s (the "
                "step reads a value on the host, or calls an API capture "
                "forbids)" % (self.name, key, type(e).__name__, e)) from e
        finally:
            if collecting:
                gc.enable()
            launches = _count_rise(before, _read_counts())
            _write_counts(before)
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

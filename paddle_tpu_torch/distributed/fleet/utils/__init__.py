"""``fleet.utils.recompute``: activation checkpointing (counterpart of the
reference's ``distributed/fleet/utils/__init__.py``).

``recompute(function, *args, preserve_rng_state=True, **kwargs)`` runs
``function`` keeping none of its activations for the backward, which runs
it a second time to get them: torch's non-reentrant
``torch.utils.checkpoint``, with two things around the second run.

- Autocast.  The second run happens in the backward, outside the
  caller's ``amp.auto_cast`` region (and on the thread that runs the
  backward): it runs under the autocast state the first run had, so it
  casts what the first cast and saves the same dtypes.
- Running statistics.  The reference threads a region's buffers through
  its checkpoint and writes them back once.  Here the second run is under
  ``nn.functional.norm.frozen_running_stats``: a BatchNorm in training
  mode normalizes by the batch's statistics again (the same values) and
  leaves its running mean and variance alone, so a step advances them
  once, as without recompute.
- The random state.  With ``preserve_rng_state`` the second run draws
  what the first drew.  Eagerly that is torch's rule: the CPU and CUDA
  generator states are read before the first run and set for the second.
  A CUDA graph capture forbids reading a generator's state on the host,
  so inside a captured step (``jit.aot``: a ``TrainStep`` on the card) a
  region that drew random numbers in the key's eager warm-up draws, in
  the capture, from a pair of generator states made and registered with
  the graph before the capture began (``aot.PRE_CAPTURE_HOOKS``): the
  first run through one, the second through the other, switched in with
  ``graphsafe_set_state``.  The two start equal and every replay advances
  both by the same draws, so they stay equal.  A region that drew nothing
  in the warm-up runs as it is.  A capture that meets a region its
  warm-up did not see raises :class:`~....jit.aot.CaptureError`: nothing
  is dropped quietly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from ....core import amp_state
from ....jit import aot
from ....nn.functional.norm import frozen_running_stats

__all__ = ["recompute"]

# owner (aot's ``(id(function), key)``) -> per region of the key's step,
# in call order: whether it drew from the CUDA generator in the warm-up
_PLANS: Dict[tuple, List[bool]] = {}
# owner -> region index -> (first-run, second-run) generator states
_PAIRS: Dict[tuple, Dict[int, tuple]] = {}
_LOCAL = threading.local()


def _cuda_generator():
    return torch.cuda.default_generators[torch.cuda.current_device()]


def _register_pairs(owner, graph) -> None:
    """Before ``owner``'s capture: a registered state pair for each region
    its warm-up saw draw; the capture's regions counted from 0."""
    pairs = _PAIRS.setdefault(owner, {})
    for i, drew in enumerate(_PLANS.get(owner, [])):
        if drew and i not in pairs:
            gen = _cuda_generator()
            pairs[i] = (gen.clone_state(), gen.clone_state())
        if drew:
            for state in pairs[i]:
                graph.register_generator_state(state)
    _LOCAL.capture = (owner, 0)


aot.PRE_CAPTURE_HOOKS.append(_register_pairs)


@contextlib.contextmanager
def _switched(gen, state):
    """``gen`` drawing from ``state`` inside (graph-safe)."""
    prev = gen.graphsafe_get_state()
    gen.graphsafe_set_state(state)
    try:
        yield
    finally:
        gen.graphsafe_set_state(prev)


@contextlib.contextmanager
def _recording(owner):
    """The first run of an eager region inside ``owner``'s warm-up: notes
    whether it drew from the CUDA generator."""
    gen = _cuda_generator()
    before = gen.get_offset()
    yield
    _PLANS.setdefault(owner, []).append(gen.get_offset() != before)


@contextlib.contextmanager
def _restored(cpu_state, cuda_state):
    """The second run of an eager region: the generators as the first
    run found them, and as they were again afterwards."""
    cpu_now = torch.get_rng_state()
    cuda_now = torch.cuda.get_rng_state() if cuda_state is not None \
        else None
    torch.set_rng_state(cpu_state)
    if cuda_state is not None:
        torch.cuda.set_rng_state(cuda_state)
    try:
        yield
    finally:
        torch.set_rng_state(cpu_now)
        if cuda_now is not None:
            torch.cuda.set_rng_state(cuda_now)


def _captured(step):
    """The two runs' generator switches of the capture's next region."""
    if step is None or step.mode != "capture":
        raise aot.CaptureError(
            "recompute(preserve_rng_state=True) inside a CUDA graph capture "
            "that is not a jit.aot step: its generator states cannot be "
            "registered before the capture")
    owner, i = _LOCAL.capture
    _LOCAL.capture = (owner, i + 1)
    plan = _PLANS.get(owner, [])
    if i >= len(plan):
        raise aot.CaptureError(
            "recompute: the capture ran region %d, which the key's warm-up "
            "did not run (%d regions); a captured step must run the "
            "warm-up's regions" % (i, len(plan)))
    if not plan[i]:
        return [], []
    fwd, bwd = _PAIRS[owner][i]
    gen = _cuda_generator()
    return [_switched(gen, fwd)], [_switched(gen, bwd)]


@contextlib.contextmanager
def _autocast_as(state):
    prev = amp_state.push(state)
    try:
        yield
    finally:
        amp_state.pop(prev)


def _contexts(preserve_rng_state: bool, on_cuda: bool):
    """The first run's and the second run's context managers."""
    first = []
    second = [frozen_running_stats(), _autocast_as(amp_state.current())]
    if preserve_rng_state:
        step = aot.current_step() if on_cuda else None
        if on_cuda and torch.cuda.is_current_stream_capturing():
            f, s = _captured(step)
            first += f
            second += s
        else:
            cuda_state = torch.cuda.get_rng_state() if on_cuda else None
            second.append(_restored(torch.get_rng_state(), cuda_state))
            if step is not None and step.mode == "warm_up":
                if getattr(_LOCAL, "warming", None) is not step:
                    # a new warm-up of the key: its regions counted afresh
                    _PLANS[step.owner] = []
                    _LOCAL.warming = step
                first.append(_recording(step.owner))
    return _stack(first), _stack(second)


@contextlib.contextmanager
def _stack(managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward (module docstring)."""
    on_cuda = any(torch.is_tensor(a) and a.is_cuda for a in args)
    return checkpoint(
        function, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: _contexts(preserve_rng_state, on_cuda), **kwargs)

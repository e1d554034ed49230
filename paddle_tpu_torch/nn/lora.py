"""Batched multi-LoRA serving (counterpart of the reference's
``nn/lora.py``): a stacked per-adapter low-rank delta resolved per row
inside the shared decode step.

``attach_lora`` creates a ``[n_adapters, d_in, r]`` / ``[n_adapters, r,
d_out]`` zero bank beside each target projection's weight (parameters
``lora_a``/``lora_b`` on the Linear, so ``convert.load_reference_params``
carries a reference bank by name).  ``Linear.forward`` then adds ``(x @
A[ids]) @ B[ids]``, where ``ids`` is the ambient per-row adapter-id vector
(:func:`adapter_ids`): two row gathers and two batched products, never a
per-request dispatch.

The invariants are the reference's:

- **Adapter id 0 is the identity.**  Row 0 of every bank is zero and
  ``load_adapter`` refuses to write it, so the delta of an id-0 row is
  exactly zero and its tokens equal the base model's bit for bit.
- **The bank is read at construction.**  A session or pool reads
  :func:`lora_config` when it is built and serves ids only then: a bank
  attached later is not served (a nonzero id is refused).
- **Hot swap, never re-capture.**  ``load_adapter``/``unload_adapter``
  write bank ROWS in place (``copy_`` under ``no_grad``): the bank's
  tensors never move, so a captured step that reads them by address
  serves the new rows at its next replay, and no graph is dropped.
- **The ids are data.**  The decode steps make their static adapter-id
  buffer ambient around the forward, so which adapter a slot uses is a
  value in that buffer, rewritten by the step's one upload; only the bank
  geometry (n_adapters, rank) is part of the step.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.errors import InvalidArgumentError

__all__ = ["attach_lora", "load_adapter", "unload_adapter",
           "adapter_ids", "current_adapter_ids", "apply_delta",
           "lora_linears", "lora_config", "random_adapter",
           "adapter_bank_bytes", "DEFAULT_TARGETS"]

#: the attention projections of ``nn.MultiHeadAttention``, the classic
#: LoRA target set; MLP linears can be added with ``targets=``
DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "out_proj")

_ADAPTER_IDS = contextvars.ContextVar("lora_adapter_ids", default=None)


@contextlib.contextmanager
def adapter_ids(ids):
    """Make ``ids`` (an int [B] tensor on the model's device, or None for
    the base model) the ambient per-row adapter selection of every
    bank-attached Linear forward underneath."""
    token = _ADAPTER_IDS.set(ids)
    try:
        yield
    finally:
        _ADAPTER_IDS.reset(token)


def current_adapter_ids():
    """The ambient adapter-id vector, or None outside a decode step."""
    return _ADAPTER_IDS.get()


def apply_delta(out, x, lora_a, lora_b, ids):
    """``out + (x @ A[ids]) @ B[ids]``: the gathered batched low-rank
    delta.  ``x`` is ``[B, ..., d_in]`` with its leading batch matching
    ``ids`` [B]; id-0 rows add an exact zero.  The delta is cast to
    ``out``'s dtype and carries no gradient."""
    with torch.no_grad():
        # index_select takes the step's int32 id buffer as it is: no cast
        # kernel per Linear
        idx = ids if ids.dtype in (torch.int32, torch.int64) else ids.long()
        a = lora_a.index_select(0, idx)                # [B, d_in, r]
        b = lora_b.index_select(0, idx)                # [B, r, d_out]
        x3 = x.reshape(x.shape[0], -1, x.shape[-1])    # [B, N, d_in]
        mid = torch.bmm(x3.to(a.dtype), a)             # [B, N, r]
        delta = torch.bmm(mid, b)                      # [B, N, d_out]
    return out + delta.reshape(out.shape).to(out.dtype)


def _linears(model, targets):
    for _, sub in model.named_modules():
        for tname in targets:
            lin = getattr(sub, tname, None)
            if isinstance(lin, nn.Module) and isinstance(
                    getattr(lin, "weight", None), torch.Tensor) \
                    and lin.weight.dim() == 2:
                yield tname, lin


def attach_lora(model, n_adapters: int, rank: int,
                targets: Tuple[str, ...] = DEFAULT_TARGETS):
    """Create the stacked zero bank on every target Linear under ``model``
    (in place; returns the model).  It must run BEFORE any session, pool
    or engine is built over the model.  ``n_adapters`` counts row 0, the
    reserved identity, so serving N fine-tunes needs ``n_adapters >= N +
    1``."""
    if int(n_adapters) < 2:
        raise InvalidArgumentError(
            "n_adapters must be >= 2 (row 0 is the reserved identity "
            "adapter -- the base model), got %r" % (n_adapters,))
    if int(rank) < 1:
        raise InvalidArgumentError("rank must be >= 1, got %r" % (rank,))
    n, r = int(n_adapters), int(rank)
    count = 0
    for tname, lin in list(_linears(model, targets)):
        if lin._parameters.get("lora_a") is not None:
            raise InvalidArgumentError(
                "a LoRA bank is already attached to %r -- attach_lora "
                "runs once per model; use load_adapter/unload_adapter to "
                "change adapter contents" % (tname,))
        w = lin.weight
        d_in, d_out = int(w.shape[0]), int(w.shape[1])
        lin.lora_a = nn.Parameter(torch.zeros(n, d_in, r, device=w.device,
                                              dtype=w.dtype))
        lin.lora_b = nn.Parameter(torch.zeros(n, r, d_out, device=w.device,
                                              dtype=w.dtype))
        count += 1
    if count == 0:
        raise InvalidArgumentError(
            "attach_lora found no target Linear layers under %s "
            "(targets=%r): the model needs attention projections named "
            "like nn.MultiHeadAttention's, or pass targets= explicitly"
            % (type(model).__name__, targets))
    return model


def lora_linears(model) -> List[Tuple[str, nn.Module]]:
    """``[(qualname, Linear)]`` of every bank-attached Linear under
    ``model``, in ``named_modules`` order: the key set of an adapter's
    weight dict."""
    return [(name, sub) for name, sub in model.named_modules()
            if sub._parameters.get("lora_a") is not None]


def lora_config(model) -> Optional[Tuple[int, int]]:
    """``(n_adapters, rank)`` of the attached bank, or None without one:
    the geometry the pool's config fingerprint carries."""
    for _, lin in lora_linears(model):
        n, _, r = lin.lora_a.shape
        return int(n), int(r)
    return None


def _check_idx(model, idx: int, verb: str) -> int:
    cfg = lora_config(model)
    if cfg is None:
        raise InvalidArgumentError(
            "no LoRA bank attached: call attach_lora(model, n_adapters, "
            "rank) before %s" % (verb,))
    n, _ = cfg
    idx = int(idx)
    if not 1 <= idx < n:
        raise InvalidArgumentError(
            "adapter id must be in [1, n_adapters=%d) -- id 0 is the "
            "reserved identity row (the base model) and cannot be %sed; "
            "got %d" % (n, verb.split("_")[0], idx))
    return idx


def load_adapter(model, idx: int, weights: Dict[str, tuple]) -> None:
    """Write one adapter's ``(A [d_in, r], B [r, d_out])`` pairs into bank
    row ``idx`` in place.  ``weights`` is keyed by the qualnames
    :func:`lora_linears` yields; a missing or extra key is a typed error
    (a half-loaded adapter would serve a mix of fine-tune and base rows).
    Every pair is checked before any row is written; the rows then cross
    to the bank's device in one copy (one host-to-device transfer, not one
    per factor)."""
    idx = _check_idx(model, idx, "load_adapter")
    pairs = lora_linears(model)
    names = {name for name, _ in pairs}
    extra = set(weights) - names
    if extra:
        raise InvalidArgumentError(
            "load_adapter got weights for unknown projections %s; the "
            "attached bank covers %s" % (sorted(extra), sorted(names)))
    staged = []
    for name, lin in pairs:
        if name not in weights:
            raise InvalidArgumentError(
                "load_adapter weights missing projection %r (the bank "
                "covers %s): a partially-loaded adapter would serve a mix "
                "of fine-tune and base rows" % (name, sorted(names)))
        a_new, b_new = (torch.as_tensor(np.asarray(v)) for v in weights[name])
        pa, pb = lin.lora_a, lin.lora_b
        if tuple(a_new.shape) != tuple(pa.shape[1:]) \
                or tuple(b_new.shape) != tuple(pb.shape[1:]):
            raise InvalidArgumentError(
                "adapter weights for %r have shapes A%s/B%s; the bank row "
                "needs A%s/B%s" % (name, tuple(a_new.shape),
                                   tuple(b_new.shape), tuple(pa.shape[1:]),
                                   tuple(pb.shape[1:])))
        staged.append((pa, a_new))
        staged.append((pb, b_new))
    bank = staged[0][0]
    flat = torch.cat([v.reshape(-1).to(bank.dtype) for _, v in staged]) \
        .to(bank.device)
    with torch.no_grad():
        off = 0
        for param, value in staged:
            n = value.numel()
            param[idx].copy_(flat[off:off + n].view(value.shape))
            off += n


def unload_adapter(model, idx: int) -> None:
    """Zero bank row ``idx`` back to the identity, in place: the row is
    free for the next ``load_adapter`` (callers drain requests pinned to
    it first)."""
    idx = _check_idx(model, idx, "unload_adapter")
    with torch.no_grad():
        for _, lin in lora_linears(model):
            lin.lora_a[idx].zero_()
            lin.lora_b[idx].zero_()


def random_adapter(model, seed: int, scale: float = 0.02) \
        -> Dict[str, tuple]:
    """A deterministic random adapter for the attached bank, keyed as
    :func:`load_adapter` expects.  The reference's draws
    (``np.random.RandomState(seed)``, A then B per projection, in
    :func:`lora_linears` order), so both packages build the same arrays
    bit for bit."""
    if lora_config(model) is None:
        raise InvalidArgumentError(
            "no LoRA bank attached: call attach_lora before random_adapter")
    rng = np.random.RandomState(int(seed))
    out = {}
    for name, lin in lora_linears(model):
        _, d_in, r = lin.lora_a.shape
        _, _, d_out = lin.lora_b.shape
        out[name] = (
            rng.normal(0.0, scale, (int(d_in), int(r))).astype(np.float32),
            rng.normal(0.0, scale, (int(r), int(d_out))).astype(np.float32))
    return out


def adapter_bank_bytes(model) -> int:
    """Bytes of the attached bank (all rows, both factors): the weight
    memory one engine pays for its fine-tunes, against N dedicated
    engines' full weight copies."""
    return sum(p.numel() * p.element_size()
               for _, lin in lora_linears(model)
               for p in (lin.lora_a, lin.lora_b))

"""Shared helpers of the ``test_torch_*`` files: one tiny reference
``TransformerLM`` built at a seed, and the port's model carrying its
parameters (``convert.load_reference_params``), both on the CPU; the
margin gates of greedy agreement (fp32 and int8 caches); and the paged
allocator's invariants.

Inputs are made with numpy and handed to both packages; arrays cross
between them as numpy."""
import numpy as np
import torch

import paddle_tpu as pt
from paddle_tpu.models import TransformerLM as RefLM

from paddle_tpu_torch import TransformerLM, load_reference_params

# the tiny configuration of __graft_entry__._tiny_lm
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=128, dropout=0.0, causal=True)

# greedy agreement is only promised where the reference's top-2 logit
# margin clears this floor at every step (tests/test_quant_cache.py)
MARGIN_FLOOR = 5e-3


def reference_arrays(ref) -> dict:
    return {n: np.asarray(p.value) for n, p in ref.named_parameters()}


def build_pair(seed: int = 0, **over):
    """(reference model, port model with the reference's weights)."""
    cfg = dict(TINY, **over)
    pt.seed(seed)
    ref = RefLM(**cfg)
    ref.eval()
    port = TransformerLM(**cfg, device="cpu")
    load_reference_params(port, reference_arrays(ref))
    port.eval()
    return ref, port


def ref_logits(ref, ids) -> np.ndarray:
    return np.asarray(ref(pt.to_tensor(np.asarray(ids, np.int32))).value)


def port_logits(port, ids) -> np.ndarray:
    with torch.no_grad():
        return port(torch.from_numpy(np.asarray(ids, np.int64))).numpy()


def greedy_margin(ref, prompt, tokens) -> float:
    """Smallest top-2 logit margin over the positions that emitted
    ``tokens`` after ``prompt`` (1-D), from one uncached reference
    forward (causality makes its logits the ones each step saw)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])[None]
    steps = ref_logits(ref, seq)[0, len(prompt) - 1:-1]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def int8_margin(port, prompt, tokens) -> float:
    """Smallest top-2 logit margin along the int8-cache greedy path that
    emitted ``tokens`` (teacher-forced through the port's int8 cache): an
    int8 run's tokens are held against the reference's int8 tokens, and
    the fp32 margin says nothing about where the int8 logits cross."""
    cache = port.gen_decode_cache(1, len(prompt) + len(tokens), "int8")
    steps = [torch.from_numpy(np.asarray(prompt, np.int64))[None]]
    steps += [torch.tensor([[int(t)]]) for t in tokens[:-1]]
    margins = []
    with torch.no_grad():
        for ids in steps:
            logits, cache = port(ids, cache=cache)
            top2 = logits[0, -1].topk(2).values
            margins.append(float(top2[0] - top2[1]))
    return min(margins)


def check_allocator(pool):
    """The allocator's invariants from host state alone (spilled device
    copies are the third state beside free and resident)."""
    free = pool._free_blocks
    refs = pool._block_refs
    spilled = pool._spill_owner
    assert len(set(free)) == len(free), "duplicate free blocks"
    assert not set(free) & set(refs), "block both free and referenced"
    assert not set(spilled) & (set(free) | set(refs)), "spilled block reused"
    assert all(r >= 1 for r in refs.values()), "refcount < 1 resident"
    assert 0 not in refs and 0 not in free and 0 not in spilled, \
        "scratch block leaked"
    assert len(free) + len(refs) + len(spilled) + 1 == pool._num_blocks
    counts = {}
    for blocks in pool._slot_blocks.values():
        for b in blocks:
            counts[b] = counts.get(b, 0) + 1
    assert counts == dict(refs), "refcounts diverged from table-row references"
    for entry in pool._prefix_index.values():
        for b in entry.blocks:
            assert b in refs, "prefix index names a freed block"

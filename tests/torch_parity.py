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


# -- the serving layer, held against the reference's engine -----------------
# the reference serving tests' model (tests/test_serving.py::_tiny_model):
# it pins scheduler behaviour, so it is small
SMALL = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
             intermediate_size=64, max_position=256)


class FakeClock:
    """Deterministic monotonic time for deadline and supervisor tests."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def port_greedy_margin(port, prompt, tokens) -> float:
    """Smallest top-2 logit margin over the positions that emitted
    ``tokens`` after ``prompt``, from one uncached forward of the PORT's
    model (cheap next to the reference's per-length compiles)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])[None]
    steps = port_logits(port, seq)[0, len(prompt) - 1:-1]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min()) if len(steps) else 1.0


def assert_greedy_equal(port, prompt, got, want, what="") -> bool:
    """The port's greedy tokens equal the reference's, except where the
    top-2 margin along the path is under ``MARGIN_FLOOR`` (then the two
    packages may round to different tokens).  Returns whether they were
    compared equal."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape == want.shape and np.array_equal(got, want):
        return True
    m = min(port_greedy_margin(port, prompt, want),
            port_greedy_margin(port, prompt, got))
    assert m < MARGIN_FLOOR, ("%s: port %s != reference %s at margin %.4g"
                              % (what, got.tolist(), want.tolist(), m))
    return False


class RefEngines:
    """Reference ``ServingEngine``s cached by configuration: the first run
    of a configuration compiles its steps, later runs reuse them (a
    drained engine serves the next traffic exactly as a fresh one, and a
    recovery keeps its executables)."""

    def __init__(self, model):
        self.model = model
        self._engines = {}
        self.last_engine = None  # the engine of the last run()

    def engine(self, **kw):
        from paddle_tpu.serving import ServingEngine as RefEngine

        key = repr(sorted(kw.items()))
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = RefEngine(self.model, **kw)
        assert eng.live_requests == 0
        eng.metrics.reset_all()
        return eng

    def run(self, prompts, budgets, plane=None, ids=None, **kw):
        """Submit every prompt, pump to the end (under the reference's
        fault ``plane`` when given) and return the terminal statuses."""
        from paddle_tpu.serving import faults as ref_faults

        eng = self.last_engine = self.engine(**kw)
        ids = ids or [None] * len(prompts)
        if plane is not None:
            ref_faults.install(plane)
        try:
            streams = [eng.submit(p, n, request_id=r)
                       for p, n, r in zip(prompts, budgets, ids)]
            guard = 0
            while eng.pump(1):
                guard += 1
                assert guard < 1000, "reference engine failed to drain"
        finally:
            if plane is not None:
                ref_faults.uninstall()
        return [s.result(timeout_s=0) for s in streams]


# -- the deployment slice: ERNIE at a small size -----------------------------

# ERNIE with 2 layers, hidden 64, 4 heads, sequence 32 (the reference's
# ``ernie_base_config`` narrowed)
ERNIE_SMALL = dict(vocab_size=512, hidden_size=64, num_layers=2,
                   num_heads=4, intermediate_size=128, max_position=64,
                   causal=False, type_vocab_size=4)
ERNIE_SEQ = 32


def ernie_cls_pair(seed: int = 0):
    """(reference classifier, port classifier with its weights), 3 classes,
    dropout 0, eval mode, both on the CPU."""
    from paddle_tpu.models import TransformerForSequenceClassification as Ref

    from paddle_tpu_torch import TransformerForSequenceClassification

    pt.seed(seed)
    ref = Ref(num_classes=3, dropout=0.0, **ERNIE_SMALL)
    ref.eval()
    port = TransformerForSequenceClassification(
        num_classes=3, dropout=0.0, device="cpu", **ERNIE_SMALL)
    load_reference_params(port, reference_arrays(ref))
    port.eval()
    return ref, port


def ernie_batch(b: int, seed: int = 0):
    """ids [B, L] int64, a ragged [B, 1, 1, L] float32 additive padding
    mask (row 0 full) and token types [B, L] int64, from a numpy seed."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, ERNIE_SMALL["vocab_size"], (b, ERNIE_SEQ))
    types = rng.randint(0, 2, (b, ERNIE_SEQ))
    lens = rng.randint(ERNIE_SEQ // 4, ERNIE_SEQ + 1, b)
    lens[0] = ERNIE_SEQ
    mask = np.where(np.arange(ERNIE_SEQ)[None] < lens[:, None], 0.0,
                    np.finfo(np.float32).min).astype(np.float32)
    return ids.astype(np.int64), mask[:, None, None, :], types.astype(np.int64)


def ernie_specs(ns, int_dtype="int64"):
    """The artifact's input specs in ``ns`` (``paddle_tpu.jit`` or
    ``paddle_tpu_torch.jit``): ids, mask, token types with an open batch."""
    return [ns.InputSpec([None, ERNIE_SEQ], int_dtype),
            ns.InputSpec([None, 1, 1, ERNIE_SEQ], "float32"),
            ns.InputSpec([None, ERNIE_SEQ], int_dtype)]

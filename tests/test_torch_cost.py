"""Cost attribution of the port's steps, re-pointed from the reference's
cost tests (``tests/test_observatory.py``, the four attribution tests with
their layout x dtype parameters).

The reference reads XLA's cost and memory analyses off each compiled
executable; the port counts each step key once, on its first (eager)
call: FLOP formulas over the aten matrix ops, every aten op's bytes, and
the hand-written kernels' own counts (``jit.aot``).  The two packages'
numbers are not comparable (fused against unfused), so these tests hold
the reference's structure and reconciliations, not its values:

1. a session's report is keyed by step key, its decode step carries the
   cache's ``kv_cache_bytes``, and a card-only field is an explicit
   ``*_unavailable`` marker on the CPU, never a zero;
2. the pool's ``derived.kv_cache_bytes`` equals ``cache_stats()
   ["pool_bytes"]`` for dense/paged x fp32/int8, and the per-token
   figures divide the step's by the slots;
3. the speculative pool's round cost is ``spec_k`` draft steps + verify +
   fixup, with the acceptance rate, and no target 1-token step;
4. the engine's three gauges equal the report, and a report adds no key;
5. (port) the decode step's FLOPs equal the model's analytic count
   exactly, a key is counted once, and a kernel launch inside a count
   adds its own figures.

Tolerances: exact equality everywhere (the counts are integers from
shapes).
"""
import numpy as np
import pytest
import torch

from torch_parity import SMALL, build_pair

from paddle_tpu_torch import GenerationPool, ServingEngine
from paddle_tpu_torch.inference import SpeculativePool
from paddle_tpu_torch.jit import DecodeSession
from paddle_tpu_torch.jit.aot import AotFunction, _CostCounter, shape_key
from paddle_tpu_torch.ops import kernel_cost


@pytest.fixture(scope="module")
def model():
    return build_pair(**SMALL)[1]


@pytest.fixture(scope="module")
def draft():
    return build_pair(seed=1, **SMALL)[1]


def _prompt(rng, n=6):
    return rng.randint(0, 128, (n,)).astype("int32")


def _card_only_markers(entry):
    """The CPU cannot measure a graph's pool: the entry says so, and has
    no temp or reserved figure at all."""
    assert "temp_bytes" not in entry and "hbm_reserved_bytes" not in entry
    assert "capture" in entry["temp_bytes_unavailable"]
    assert entry["generated_code_bytes_unavailable"]


def test_session_cost_report_reads_the_artifact(model):
    sess = DecodeSession(model, max_len=48, buckets=[16], device="cpu")
    rng = np.random.RandomState(0)
    sess.generate(rng.randint(0, 128, (1, 10)).astype("int32"), 6)
    assert sess.compile_counts() == {"prefill": 1, "decode": 1}
    rep = sess.cost_report()
    (pk, prefill), = rep["prefill"].items()
    (dk, decode), = rep["decode"].items()
    assert pk == "1x16_int32" and dk == "1_int32"
    for entry in (prefill, decode):
        assert entry["flops"] > 0
        assert entry["bytes_accessed"] > 0
        assert entry["argument_bytes"] > 0
        _card_only_markers(entry)
    # 2 (K+V) x layers x heads x max_len x head_dim x 4 bytes
    assert decode["kv_cache_bytes"] == 2 * 1 * 2 * 48 * 16 * 4
    # the decode step reads the weights and the cache by address
    weights = sum(p.numel() * 4 for p in model.parameters())
    assert decode["argument_bytes"] >= weights + decode["kv_cache_bytes"]
    sess.generate(rng.randint(0, 128, (1, 10)).astype("int32"), 6)
    assert sess.compile_counts() == {"prefill": 1, "decode": 1}
    assert sess.cost_version() == 2


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_cost_report_reconciles_kv_bytes(model, layout, dtype):
    kw = dict(cache_layout="paged", block_size=8) \
        if layout == "paged" else {}
    pool = GenerationPool(model, max_len=48, slots=2, buckets=[16],
                          cache_dtype=dtype, device="cpu", **kw)
    rng = np.random.RandomState(0)
    for _ in range(2):
        pool.submit(_prompt(rng), 5)
    pool.run()
    rep = pool.cost_report()
    derived = rep["derived"]
    assert derived["kv_cache_bytes"] == pool.cache_stats()["pool_bytes"], \
        (layout, dtype)
    (step,) = rep["pool_decode"].values()
    assert step["argument_bytes"] >= derived["kv_cache_bytes"]
    # the step writes the cache (and its fed-back token) in place: those
    # storages are outputs too, so the reserved sum (arguments + outputs -
    # aliases) keeps every argument once, the cache included
    assert step["alias_bytes"] >= derived["kv_cache_bytes"]
    assert step["output_bytes"] >= step["alias_bytes"]
    assert step["argument_bytes"] + step["output_bytes"] \
        - step["alias_bytes"] >= step["argument_bytes"]
    assert derived["flops_per_token"] == step["flops"] / pool.slots
    assert derived["bytes_per_token"] == step["bytes_accessed"] / pool.slots
    assert derived["hbm_reserved_bytes"] is None
    _card_only_markers(step)
    assert pool.compile_counts() == {
        "prefill": 1, "decode": 0, "pool_decode": 1, "slot_insert": 1}


def test_speculative_pool_cost_report(model, draft):
    pool = SpeculativePool(model, draft, max_len=64, spec_k=2, slots=2,
                           buckets=[16], device="cpu")
    rng = np.random.RandomState(0)
    pool.generate([_prompt(rng), _prompt(rng)], 6)
    rep = pool.cost_report()
    derived = rep["derived"]
    assert derived["kv_cache_bytes"] == pool.cache_stats()["pool_bytes"]
    assert derived["acceptance_rate"] == \
        pool.acceptance_stats()["acceptance_rate"]
    (verify,) = rep["verify"].values()
    (dstep,) = rep["draft_decode"].values()
    (fixup,) = rep["draft_fixup"].values()
    assert derived["step_flops"] == \
        pool.spec_k * dstep["flops"] + verify["flops"] + fixup["flops"]
    assert "acceptance" in derived["basis"]
    assert "pool_decode" not in rep and "decode" not in rep
    assert derived["hbm_reserved_bytes"] is None


def test_engine_cost_gauges_and_report(model):
    eng = ServingEngine(model, max_len=48, slots=2, buckets=[16],
                        device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(2):
        eng.submit(_prompt(rng), 4)
    while eng.pump(4):
        pass
    counts = eng.compile_counts()
    version = eng.cost_version()
    rep = eng.cost_report()
    assert rep["derived"]["step_flops"] > 0
    assert eng.compile_counts() == counts  # a report adds no key
    assert eng.cost_version() == version
    snap = eng.metrics.snapshot()
    assert snap["serving_step_flops"] == rep["derived"]["step_flops"]
    assert snap["serving_step_bytes_accessed"] == \
        rep["derived"]["step_bytes_accessed"]
    # the reserved figure needs a capture: on the CPU the report says
    # None and the engine never sets the gauge
    assert rep["derived"]["hbm_reserved_bytes"] is None
    assert snap["serving_hbm_reserved_bytes"] == 0.0


def test_decode_flops_are_the_analytic_count(model):
    """The counted FLOPs of one batched decode step are the model's
    matrix products (2 x in x out per token for every linear and the tied
    head) plus the attention's two products over the
    cache's key extent, exactly; a key is counted on its first call only."""
    slots, max_len = 3, 48
    pool = GenerationPool(model, max_len=max_len, slots=slots,
                          buckets=[16], device="cpu")
    rng = np.random.RandomState(1)
    for _ in range(3):
        pool.submit(_prompt(rng), 4)
    pool.run()
    (step,) = pool.cost_report()["pool_decode"].values()
    # every 2-D weight but the position table is a matrix product per
    # token (the head is tied to the word embeddings)
    linear = sum(p.numel() for n, p in model.named_parameters()
                 if p.ndim == 2 and not n.startswith("position"))
    attention = 4 * SMALL["num_layers"] * SMALL["hidden_size"] * max_len
    assert step["flops"] == slots * (2 * linear + attention)
    before = pool.cost_report()
    pool.submit(_prompt(rng), 4)
    pool.run()
    assert pool.cost_report()["pool_decode"] == before["pool_decode"]


def test_kernel_launch_reports_into_the_open_count():
    """A kernel wrapper's report lands in every count open on the thread
    (the wrappers call it where they launch, on the card), and nowhere
    when no count is open."""
    kernel_cost.report(1.0, 2.0)  # no count open: nothing to add to
    fn = AotFunction(lambda x: (kernel_cost.report(1000.0, 64.0),
                                x * 2)[1], shape_key, name="k")
    x = torch.ones(4)
    fn(x)
    (entry,) = fn.cost_report().values()
    # the aten mul moves 2 x 16 bytes and has no FLOP formula
    assert entry["flops"] == 1000.0
    assert entry["bytes_accessed"] == 64.0 + 32.0
    with _CostCounter() as outer:
        kernel_cost.report(5.0, 7.0)
    assert (outer.flops, outer.bytes) == (5.0, 7.0)

"""The port's speculative decoding (``jit/speculative.py`` and
``inference/speculative.py``), re-pointed from the reference's
``tests/test_speculative.py`` and held against the reference's
``SpeculativePool`` on the same weights (CPU).

Pinned here:

1. greedy speculative output is token-identical to target-only greedy
   decode, session and pool, dense and paged targets, fp32 and int8
   caches, a real draft and the target as its own draft -- over prompts
   whose top-2 margin clears the floor along the whole path (a verify
   chunk reduces in a different order than a 1-token step);
2. the port's pool emits the reference pool's tokens and keys the
   reference's steps: ``compile_counts()`` is equal, also across
   ``set_spec_k`` steps down and back up (one verify key per ``k``);
3. the step keys do not grow with acceptance lengths; an EOS inside an
   accepted chunk truncates the commit at the EOS; rejection rewinds by
   the index, so cancellation returns every paged block;
4. a request whose budget ends at ``max_len`` on a paged speculative
   pool: the verify's writes past the reservation and past the table go
   to the scratch block, never into a live block;
5. the typed errors (vocab mismatch naming both sizes, greedy only,
   ``spec_k``, headroom, batch), and the engine: unchanged lifecycle,
   the ``serving_acceptance_rate`` gauge, the ladder's spec-K rung.

Not re-pointed: ``test_decode_sweep_speculate_axis`` (slow-marked; it
drives the reference's ``tools/decode_sweep.py``, a JAX tool with no
counterpart in the port).
"""
import numpy as np
import pytest

from paddle_tpu.inference import SpeculativePool as RefSpecPool
from paddle_tpu.serving import ServingEngine as RefEngine
from torch_parity import (MARGIN_FLOOR, FakeClock, build_pair,
                          check_allocator, int8_margin, port_greedy_margin)

from paddle_tpu_torch import DecodeSession, GenerationPool, ServingEngine
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.inference import SpeculativePool
from paddle_tpu_torch.jit import SpeculativeDecodeSession, truncate_at_eos
from paddle_tpu_torch.jit.decode import FINISH_EOS, classify_finish
from paddle_tpu_torch.jit.speculative import greedy_accept
from paddle_tpu_torch.serving import RequestState

TARGET = dict(vocab_size=128, max_position=256)
DRAFT = dict(vocab_size=128, hidden_size=32, num_layers=1,
             intermediate_size=64, max_position=256)
LAYOUTS = [pytest.param({}, id="dense"),
           pytest.param(dict(cache_layout="paged", block_size=8),
                        id="paged")]


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0, **TARGET)


@pytest.fixture(scope="module")
def draft_pair():
    # a REAL draft: smaller, independent weights -- its guesses are mostly
    # wrong, which drives the rejection/rewind path; the target as its own
    # draft drives the all-accepted/catch-up path
    return build_pair(seed=1, **DRAFT)


@pytest.fixture(scope="module")
def target(pair):
    return pair[1]


@pytest.fixture(scope="module")
def draft(draft_pair):
    return draft_pair[1]


def _margin(port, prompt, tokens, dtype):
    if dtype == "int8":
        return int8_margin(port, prompt, tokens)
    return port_greedy_margin(port, prompt, tokens)


def _gated_corpus(model, sess, gen, seeds, dtype="float32", min_prompts=3):
    """[(prompt, want)]: margin-gated prompts with the target-only greedy
    tokens of ``sess``."""
    out = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        ids = rng.randint(0, 128, (int(rng.randint(3, 13)),)).astype("int32")
        want = sess.generate(ids[None], gen)[0]
        if _margin(model, ids, want, dtype) >= MARGIN_FLOOR:
            out.append((ids, want))
    assert len(out) >= min_prompts, \
        "corpus too thin: only %d prompts cleared the margin" % len(out)
    return out


# -- the acceptance rule itself ----------------------------------------------
def test_greedy_accept_counts_the_first_mismatch():
    import torch

    v = 6
    chunk = torch.tensor([[1, 2, 3, 4], [1, 2, 5, 4], [1, 0, 3, 4],
                          [1, 2, 3, 4]], dtype=torch.int32)
    g = torch.tensor([[2, 3, 4, 5], [2, 3, 4, 5], [2, 3, 4, 5],
                      [2, 3, 4, 5]])
    logits = torch.nn.functional.one_hot(g, v).float()
    active = torch.tensor([True, True, True, False])
    m, emitted = greedy_accept(logits, chunk, active)
    assert m.tolist() == [3, 1, 0, 0]
    assert emitted.tolist() == [[2, 3, 4, 5], [2, 3, 0, 0], [2, 0, 0, 0],
                                [0, 0, 0, 0]]
    assert m.dtype == emitted.dtype == torch.int32


# -- the acceptance contract: token identity, session -------------------------
@pytest.mark.parametrize("layout_kw", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_session_greedy_token_identical(target, draft, layout_kw, dtype):
    ref = DecodeSession(target, max_len=64, buckets=[16], cache_dtype=dtype,
                        device="cpu", **layout_kw)
    spec = SpeculativeDecodeSession(target, draft, max_len=64, spec_k=3,
                                    buckets=[16], cache_dtype=dtype,
                                    device="cpu", **layout_kw)
    spec_self = SpeculativeDecodeSession(target, target, max_len=64,
                                         spec_k=3, buckets=[16],
                                         cache_dtype=dtype, device="cpu",
                                         **layout_kw)
    for prompt, want in _gated_corpus(target, ref, 8, range(6), dtype):
        np.testing.assert_array_equal(
            spec.generate(prompt[None], 8)[0], want,
            err_msg="small draft, %s %s" % (layout_kw, dtype))
        np.testing.assert_array_equal(
            spec_self.generate(prompt[None], 8)[0], want,
            err_msg="self draft, %s %s" % (layout_kw, dtype))
    assert spec_self.acceptance_stats()["acceptance_rate"] > 0.9
    st = spec.acceptance_stats()
    assert st["drafted"] == st["spec_k"] * st["rounds"]
    assert 0.0 <= st["acceptance_rate"] <= 1.0


def test_session_compile_counts_fixed(target, draft):
    spec = SpeculativeDecodeSession(target, draft, max_len=64, spec_k=3,
                                    buckets=[8, 16], device="cpu")
    rng = np.random.RandomState(0)
    for length in (4, 6, 7):
        spec.generate(rng.randint(0, 128, (1, length)).astype("int32"), 8)
    assert spec.compile_counts() == {
        "prefill": 1, "verify": 1, "draft_prefill": 1, "draft_decode": 1}
    spec.generate(rng.randint(0, 128, (1, 12)).astype("int32"), 8)
    assert spec.compile_counts() == {
        "prefill": 2, "verify": 1, "draft_prefill": 2, "draft_decode": 1}
    spec_self = SpeculativeDecodeSession(target, target, max_len=64,
                                         spec_k=3, buckets=[16],
                                         device="cpu")
    spec_self.generate(rng.randint(0, 128, (1, 5)).astype("int32"), 10)
    assert spec_self.compile_counts() == {
        "prefill": 1, "verify": 1, "draft_prefill": 1, "draft_decode": 1}


def test_session_eos_inside_accepted_chunk_truncates(target):
    ref = DecodeSession(target, max_len=64, buckets=[16], device="cpu")
    spec = SpeculativeDecodeSession(target, target, max_len=64, spec_k=4,
                                    buckets=[16], device="cpu")
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 128, (1, 6)).astype("int32")
    full = ref.generate(ids, 10)
    eos = int(full[0, 3])  # inside the first verify chunk
    first = int(np.argmax(full[0] == eos))
    got = spec.generate(ids, 10, eos_id=eos)
    assert got.shape == (1, 10)
    np.testing.assert_array_equal(got[0, :first + 1], full[0, :first + 1])
    assert (got[0, first + 1:] == eos).all(), got


def test_truncate_at_eos_edge_cases():
    np.testing.assert_array_equal(truncate_at_eos([4, 7, 2, 9], 2),
                                  [4, 7, 2])
    np.testing.assert_array_equal(truncate_at_eos([2, 7, 2, 9], 2), [2])
    np.testing.assert_array_equal(truncate_at_eos([4, 7, 9], 2), [4, 7, 9])
    np.testing.assert_array_equal(truncate_at_eos([4, 7], None), [4, 7])
    assert truncate_at_eos([], 2).size == 0
    assert classify_finish(truncate_at_eos([4, 2, 5], 2), 2) == FINISH_EOS


# -- construction-time validation -------------------------------------------
def test_vocab_mismatch_typed_error_names_both_sizes(target):
    _, small_vocab = build_pair(seed=2, **dict(DRAFT, vocab_size=96))
    with pytest.raises(InvalidArgumentError, match="96.*128|128.*96"):
        SpeculativeDecodeSession(target, small_vocab, max_len=64,
                                 buckets=[16], device="cpu")
    with pytest.raises(InvalidArgumentError, match="96.*128|128.*96"):
        SpeculativePool(target, small_vocab, max_len=64, slots=2,
                        buckets=[16], device="cpu")


def test_greedy_only_and_spec_k_validated(target, draft):
    with pytest.raises(InvalidArgumentError, match="greedy"):
        SpeculativeDecodeSession(target, draft, max_len=64, buckets=[16],
                                 temperature=0.7, device="cpu")
    with pytest.raises(InvalidArgumentError, match="greedy"):
        SpeculativePool(target, draft, max_len=64, slots=2, buckets=[16],
                        temperature=0.7, device="cpu")
    with pytest.raises(InvalidArgumentError, match="spec_k"):
        SpeculativeDecodeSession(target, draft, max_len=64, buckets=[16],
                                 spec_k=0, device="cpu")
    SpeculativePool(target, draft, max_len=64, slots=2, buckets=[16],
                    top_k=5, top_p=0.9, device="cpu")
    with pytest.raises(InvalidArgumentError, match="draft_model"):
        ServingEngine(target, max_len=64, slots=2, buckets=[16], spec_k=4,
                      device="cpu")
    pool = SpeculativePool(target, draft, max_len=64, slots=2, buckets=[16],
                           device="cpu")
    with pytest.raises(InvalidArgumentError, match="greedy"):
        pool.submit(np.arange(1, 5), 4, temperature=0.5)
    with pytest.raises(InvalidArgumentError, match="spec_k"):
        pool.set_spec_k(5)


def test_session_headroom_and_batch_validated(target, draft):
    spec = SpeculativeDecodeSession(target, draft, max_len=32, spec_k=4,
                                    buckets=[16], device="cpu")
    with pytest.raises(InvalidArgumentError, match="spec_k"):
        spec.generate(np.zeros((1, 10), np.int32), 20)
    with pytest.raises(InvalidArgumentError, match="SpeculativePool"):
        spec.generate(np.zeros((2, 4), np.int32), 4)


# -- the pool variant ---------------------------------------------------------
@pytest.mark.parametrize("layout_kw", LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_token_identical_with_refill(target, draft, layout_kw, dtype):
    ref = DecodeSession(target, max_len=64, buckets=[16], cache_dtype=dtype,
                        device="cpu", **layout_kw)
    corpus = _gated_corpus(target, ref, 6, range(20, 28), dtype)
    pool = SpeculativePool(target, draft, max_len=64, spec_k=3, slots=2,
                           buckets=[16], cache_dtype=dtype, device="cpu",
                           **layout_kw)
    outs = pool.generate([p for p, _ in corpus], 6)
    for (prompt, want), got in zip(corpus, outs):
        np.testing.assert_array_equal(got, want,
                                      err_msg=str((layout_kw, dtype)))
    # the plain pool over the same target emits the same tokens
    plain = GenerationPool(target, max_len=64, slots=2, buckets=[16],
                           cache_dtype=dtype, device="cpu", **layout_kw)
    for (prompt, want), got in zip(corpus, plain.generate(
            [p for p, _ in corpus], 6)):
        np.testing.assert_array_equal(got, want)
    counts = pool.compile_counts()
    assert counts == {"prefill": 1, "slot_insert": 1, "verify": 1,
                      "draft_prefill": 1, "draft_decode": 1,
                      "draft_fixup": 1, "draft_insert": 1}, counts


def test_pool_self_draft_commits_chunks(target):
    ref = DecodeSession(target, max_len=64, buckets=[16], device="cpu")
    corpus = _gated_corpus(target, ref, 12, range(40, 46), min_prompts=2)
    pool = SpeculativePool(target, target, max_len=64, spec_k=3, slots=2,
                           buckets=[16], device="cpu")
    outs = pool.generate([p for p, _ in corpus], 12)
    for (prompt, want), got in zip(corpus, outs):
        np.testing.assert_array_equal(got, want)
    st = pool.acceptance_stats()
    assert st["acceptance_rate"] > 0.9
    assert st["rounds"] <= 4 * len(corpus)


def test_pool_eos_mid_chunk_truncates_and_classifies(target):
    ref = DecodeSession(target, max_len=64, buckets=[16], device="cpu")
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 128, (6,)).astype("int32")
    full = ref.generate(ids[None], 10)[0]
    eos = int(full[2])  # inside the first accepted chunk
    first = int(np.argmax(full == eos))
    pool = SpeculativePool(target, target, max_len=64, spec_k=4, slots=1,
                           buckets=[16], eos_id=eos, device="cpu")
    rid = pool.submit(ids, 10)
    while pool.step():
        pass
    tokens, reason = pool.collect(rid)
    np.testing.assert_array_equal(tokens, full[:first + 1])
    assert reason == FINISH_EOS


def test_pool_cancel_mid_round_frees_blocks(target, draft):
    ref = DecodeSession(target, max_len=64, buckets=[16], device="cpu")
    corpus = _gated_corpus(target, ref, 6, range(60, 66), min_prompts=2)
    (pa, _), (pb, want_b) = corpus[0], corpus[1]
    pool = SpeculativePool(target, draft, max_len=64, spec_k=3, slots=2,
                           buckets=[16], cache_layout="paged", block_size=8,
                           device="cpu")
    free0 = len(pool._free_blocks)
    ra = pool.submit(pa, 20)
    rb = pool.submit(pb, 6)
    pool.step()
    assert pool.cancel(ra) == "active"
    results = pool.run()
    assert set(results) == {rb}
    np.testing.assert_array_equal(results[rb], want_b)
    assert len(pool._free_blocks) == free0
    check_allocator(pool)


# -- against the reference's SpeculativePool ---------------------------------
@pytest.mark.parametrize("layout_kw,dtype", [
    pytest.param({}, "float32", id="dense-fp32"),
    pytest.param(dict(cache_layout="paged", block_size=8), "float32",
                 id="paged-fp32"),
    pytest.param(dict(cache_layout="paged", block_size=8), "int8",
                 id="paged-int8"),
])
def test_pool_matches_reference_speculative_pool(pair, draft_pair, layout_kw,
                                                  dtype):
    (ref_t, target), (ref_d, draft) = pair, draft_pair
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, (n,)).astype("int32")
               for n in (5, 9, 7, 12)]
    kw = dict(max_len=64, spec_k=3, slots=2, buckets=[16],
              cache_dtype=dtype, **layout_kw)
    ref = RefSpecPool(ref_t, ref_d, **kw)
    want = ref.generate(prompts, 7)
    pool = SpeculativePool(target, draft, device="cpu", **kw)
    got = pool.generate(prompts, 7)
    compared = 0
    for p, g, w in zip(prompts, got, want):
        if np.array_equal(g, w):
            compared += 1
            continue
        m = min(_margin(target, p, w, dtype), _margin(target, p, g, dtype))
        assert m < MARGIN_FLOOR, (p, g, w, m)
    assert compared >= 3
    assert pool.compile_counts() == ref.compile_counts()
    st, rst = pool.acceptance_stats(), ref.acceptance_stats()
    assert set(st) == set(rst)
    if compared == len(prompts):
        assert (st["rounds"], st["drafted"], st["accepted"]) == \
            (rst["rounds"], rst["drafted"], rst["accepted"])


def test_set_spec_k_compile_counts_match_reference(pair, draft_pair):
    """One verify key per ``k`` met (the reference compiles one executable
    per chunk width), the draft steps shared by every setting; stepping
    down and back up adds no key, and greedy tokens are the same at
    every setting."""
    (ref_t, target), (ref_d, draft) = pair, draft_pair
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in (6, 8)]
    kw = dict(max_len=64, spec_k=4, slots=2, buckets=[16],
              cache_layout="paged", block_size=8)
    pools = [RefSpecPool(ref_t, ref_d, **kw),
             SpeculativePool(target, draft, device="cpu", **kw)]
    plain = GenerationPool(target, max_len=64, slots=2, buckets=[16],
                           cache_layout="paged", block_size=8, device="cpu")
    want = plain.generate(prompts, 6)
    seen = []
    for pool in pools:
        counts = []
        for k in (4, 2, 1, 2, 4):
            pool.set_spec_k(k)
            assert pool.spec_k_active == k
            outs = pool.generate(prompts, 6)
            if pool is pools[1]:
                for g, w in zip(outs, want):
                    np.testing.assert_array_equal(g, w)
            counts.append(dict(pool.compile_counts()))
        seen.append(counts)
    assert seen[0] == seen[1]
    assert [c["verify"] for c in seen[1]] == [1, 2, 3, 3, 3]
    assert {c["draft_decode"] for c in seen[1]} == {1}


def _written_kv(pool, blocks, upto):
    """Every layer's K and V at logical positions ``[0, upto)`` of a
    request's ``blocks``."""
    out = []
    for c in pool._cache:
        for t in (c.k, c.v):
            rows = t[blocks].permute(0, 2, 1, 3)
            out.append(rows.reshape(-1, *rows.shape[2:])[:upto].clone())
    return out


def test_paged_budget_ending_at_max_len_writes_scratch_only(pair,
                                                            draft_pair):
    """A request whose budget ends at ``max_len``: its last verify chunks
    write up to ``spec_k`` positions past the reservation, the last ones
    past the table's span.  They land in the scratch block: the K/V a
    concurrent request already wrote never change, the allocator stays
    whole, and the tokens are the plain pool's and the reference
    speculative pool's (whose scatter routes the same positions to its
    scratch block)."""
    import torch

    (ref_t, target), (ref_d, draft) = pair, draft_pair
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in (10, 4)]
    budgets = (22, 27)  # 10 + 22 == max_len; the other outlives it
    kw = dict(max_len=32, spec_k=4, slots=2, buckets=[16],
              cache_layout="paged", block_size=8)
    for dm in (draft, target):
        pool = SpeculativePool(target, dm, device="cpu", **kw)
        rids = [pool.submit(p, n) for p, n in zip(prompts, budgets)]
        pool.step()
        slot_b = next(s for s, st in pool._active.items()
                      if st.rid == rids[1])
        blocks_b = list(pool._slot_blocks[slot_b])
        while rids[0] not in pool._results:
            st_b = pool._active[slot_b]
            upto = len(prompts[1]) + len(st_b.tokens) - 1
            before = _written_kv(pool, blocks_b, upto)
            pool.step()
            check_allocator(pool)
            for a, b in zip(before, _written_kv(pool, blocks_b, upto)):
                assert torch.equal(a, b), "a live block was overwritten"
        got = pool.run()
        check_allocator(pool)
        assert len(pool._free_blocks) == pool._num_blocks - 1
        plain = GenerationPool(target, max_len=32, slots=2, buckets=[16],
                               cache_layout="paged", block_size=8,
                               device="cpu")
        prids = [plain.submit(p, n) for p, n in zip(prompts, budgets)]
        want = plain.run()
        for r, pr in zip(rids, prids):
            np.testing.assert_array_equal(got[r], want[pr])
    ref = RefSpecPool(ref_t, ref_d, **kw)
    rrids = [ref.submit(p, n) for p, n in zip(prompts, budgets)]
    ref_out = ref.run()
    for p, r, pr in zip(prompts, rrids, prids):
        if not np.array_equal(ref_out[r], want[pr]):
            m = min(port_greedy_margin(target, p, ref_out[r]),
                    port_greedy_margin(target, p, want[pr]))
            assert m < MARGIN_FLOOR


# -- under the serving engine -------------------------------------------------
def test_engine_speculative_token_identical_and_acceptance_gauge(target):
    ref = DecodeSession(target, max_len=64, buckets=[16], device="cpu")
    corpus = _gated_corpus(target, ref, 6, range(80, 88), min_prompts=3)
    plain = ServingEngine(target, max_len=64, slots=2, buckets=[16],
                          device="cpu")
    eng = ServingEngine(target, max_len=64, slots=2, buckets=[16],
                        draft_model=target, spec_k=3, device="cpu")
    for prompt, want in corpus:
        got = np.asarray(list(eng.submit(prompt, 6)), np.int32)
        np.testing.assert_array_equal(got, want)
    st = eng.submit(corpus[0][0], 6).result(timeout_s=None)
    assert st.state == RequestState.DONE
    assert st.new_tokens == 6
    snap = eng.metrics.snapshot()
    assert snap["serving_acceptance_rate"] > 0.9  # self-draft
    assert "serving_acceptance_rate" in eng.metrics.render_prometheus()
    assert eng.acceptance_stats()["drafted"] > 0
    assert "serving_acceptance_rate" not in plain.metrics.snapshot()
    assert plain.acceptance_stats() is None
    counts = eng.compile_counts()
    assert counts["verify"] == 1 and counts["draft_decode"] == 1


def test_engine_speculative_deadline_expiry_frees_slot(target, draft):
    clock = FakeClock()
    eng = ServingEngine(target, max_len=64, slots=1, buckets=[16],
                        draft_model=draft, spec_k=3, cache_layout="paged",
                        block_size=8, clock=clock, device="cpu")
    baseline = eng.cache_stats()["free_blocks"]
    a = eng.submit(np.zeros(5, np.int32), 40, deadline_s=1.0)
    eng.pump(2)
    assert eng.request_state(a.request_id) == RequestState.DECODING
    clock.advance(2.0)
    eng.pump(1)
    st = a.result(timeout_s=0)
    assert st.state == RequestState.EXPIRED
    assert 0 < st.new_tokens < 40
    assert eng.cache_stats()["free_blocks"] == baseline


def test_ladder_rung_two_reduces_spec_k_and_restores(pair, draft_pair):
    """The degradation ladder's rung 2 on a speculative engine: engaging
    it drops the runtime spec-K to 1 and remembers the setting,
    disengaging restores it -- the reference engine's actions, and the
    verify keys each engine then meets are equal."""
    (ref_t, target), (ref_d, draft) = pair, draft_pair
    from paddle_tpu.serving import Objective as RefObjective
    from paddle_tpu.serving import SLOTracker as RefSLOTracker
    from paddle_tpu_torch.serving import Objective, SLOTracker

    rng = np.random.RandomState(4)
    prompt = rng.randint(0, 128, (7,)).astype("int32")
    # clear_ticks past the run: only the test moves the ladder
    kw = dict(max_len=64, slots=2, buckets=[16], spec_k=3, degrade=True,
              degrade_clear_ticks=1000)
    engines = [
        ServingEngine(target, draft_model=draft, device="cpu",
                      slo=SLOTracker([Objective("a", "availability", 0.9)]),
                      **kw),
        RefEngine(ref_t, draft_model=ref_d,
                  slo=RefSLOTracker([RefObjective("a", "availability",
                                                  0.9)]),
                  **kw)]
    trail = []
    for eng in engines:
        steps = []
        eng._pool.set_spec_k(2)
        for level in (1, 2, 3, 2, 1, 0):
            eng._set_degrade_level(level, ["a"] if level else [])
            s = eng.submit(prompt, 4, priority=1)
            while eng.pump(4):
                pass
            assert s.result(timeout_s=0).state == RequestState.DONE
            steps.append((eng._pool.spec_k_active,
                          eng.degradation_snapshot()["spec_k_active"],
                          eng.compile_counts()["verify"]))
        trail.append(steps)
    assert trail[0] == trail[1]
    assert [t[0] for t in trail[0]] == [2, 1, 1, 1, 2, 2]


def test_dense_write_drops_positions_far_past_the_buffer():
    """A dense chunk write whose positions run up to ``spec_k`` past the
    buffer (a speculative draft or verify at the end of ``max_len``, or a
    finished row's frozen index) drops them as the reference's scatter
    does, and touches no valid position."""
    import torch

    from paddle_tpu_torch.nn.layer.transformer import _dense_write

    buf = torch.arange(2 * 1 * 8, dtype=torch.float32).reshape(2, 1, 8, 1)
    want = buf.clone()
    new = -torch.ones(2, 1, 4, 1)
    pos = torch.tensor([[6, 7, 8, 9], [10, 11, 12, 13]])
    _dense_write(buf, new, pos)
    want[0, 0, 6:8] = -1.0
    assert torch.equal(buf, want)


# -- the speculative cases of the scheduling, recovery and trace tests --------
def test_speculative_preempt_resume_and_runtime_spec_k(target):
    """Re-pointed from ``tests/test_scheduling.py``: preempt and resume a
    speculative slot (the draft re-prefilled to the target's position)
    while the runtime spec-K changes mid-flight; the tokens stay the
    uninterrupted run's and self-draft acceptance stays perfect."""
    from paddle_tpu_torch.serving import faults  # noqa: F401

    def mk():
        return SpeculativePool(target, target, max_len=64, spec_k=4,
                               slots=2, buckets=[32, 64],
                               cache_layout="paged", block_size=8,
                               device="cpu")

    rng = np.random.RandomState(7)
    p = [rng.randint(0, 128, (n,)).astype("int32") for n in (5, 9)]
    ref = mk()
    for i, ids in enumerate(p):
        ref.submit(ids, 16, request_id=i)
    want = ref.run()
    pool = mk()
    for i, ids in enumerate(p):
        pool.submit(ids, 16, request_id=i)
    pool.step()
    pool.set_spec_k(2)
    assert pool.spec_k_active == 2
    pool.preempt(0)
    pool.step()
    pool.set_spec_k(4)
    got = pool.run()
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    check_allocator(pool)
    assert pool.acceptance_stats()["acceptance_rate"] == 1.0
    with pytest.raises(InvalidArgumentError, match="ceiling"):
        pool.set_spec_k(5)
    with pytest.raises(InvalidArgumentError, match="ceiling"):
        pool.set_spec_k(0)


def test_manual_spec_k_survives_a_ladder_excursion(target, draft):
    """Re-pointed from ``tests/test_scheduling.py``: the rung restores the
    operator's runtime setting, not the construction ceiling."""
    from paddle_tpu_torch.serving import Objective, SLOTracker

    eng = ServingEngine(target, max_len=64, slots=2, buckets=[16],
                        draft_model=draft, spec_k=4, degrade=True,
                        slo=SLOTracker([Objective("a", "availability", 0.9)]),
                        device="cpu")
    pool = eng._pool
    pool.set_spec_k(2)
    eng._set_degrade_level(1, ["a"])
    assert pool.spec_k_active == 2
    eng._set_degrade_level(2, ["a"])
    assert pool.spec_k_active == 1
    eng._set_degrade_level(1, ["a"])
    assert pool.spec_k_active == 2, "restore clobbered the manual tune"
    eng._set_degrade_level(0, [])
    assert pool.spec_k_active == 2


def test_speculative_engine_recovers_token_identical(pair, draft_pair):
    """Re-pointed from ``tests/test_faults_recovery.py``: a transient
    ``pool.step`` fault in a speculative round resets the pool (the draft
    cache zeroed in place) and resubmits every request; the tokens are
    the reference speculative engine's, also faulted."""
    from paddle_tpu.serving import faults as ref_faults
    from torch_parity import assert_greedy_equal

    from paddle_tpu_torch.serving import faults

    (ref_t, target), (ref_d, draft) = pair, draft_pair
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 128, (n,)).astype("int32") for n in (5, 7)]
    kw = dict(max_len=64, slots=2, buckets=[32], spec_k=3)
    results = []
    for eng, fmod in ((RefEngine(ref_t, draft_model=ref_d, **kw),
                       ref_faults),
                      (ServingEngine(target, draft_model=draft,
                                     device="cpu", **kw), faults)):
        plane = fmod.FaultPlane([fmod.FaultSpec(
            "pool.step", error=fmod.TransientInjectedFault, after=2,
            times=1)])
        with fmod.injected(plane):
            streams = [eng.submit(p, 6) for p in prompts]
            guard = 0
            while eng.pump(1):
                guard += 1
                assert guard < 100
        assert plane.injected
        results.append([s.result(timeout_s=0) for s in streams])
        assert eng.metrics.snapshot()[
            "serving_requests_recovered_total"] == 2
    for p, want, got in zip(prompts, *results):
        assert got.state == RequestState.DONE, got.error
        assert_greedy_equal(target, p, got.tokens, want.tokens)
    assert eng.compile_counts()["verify"] == 1


def test_speculative_engine_gets_phase_spans(target, draft):
    """Re-pointed from ``tests/test_trace.py``: a speculative engine's
    ticks carry the plain pool's phase spans, the decode span its
    ``spec_k``."""
    eng = ServingEngine(target, max_len=64, slots=2, buckets=[32],
                        draft_model=draft, spec_k=3, device="cpu")
    tracer = eng.start_trace(capacity=2048)
    try:
        rng = np.random.RandomState(1)
        streams = [eng.submit(rng.randint(0, 128, (n,)), 6)
                   for n in (5, 8)]
        while eng.pump(1):
            pass
    finally:
        eng.stop_trace()
    assert all(s.result(timeout_s=0).state == RequestState.DONE
               for s in streams)
    names = {e.name for e in tracer.recorder.snapshot()}
    for phase in ("tick", "tick.admit", "tick.prefill", "tick.decode",
                  "tick.sample", "tick.deliver"):
        assert phase in names, phase
    decode = [e for e in tracer.recorder.snapshot()
              if e.name == "tick.decode"]
    assert decode and all(e.meta["spec_k"] == 3 for e in decode)

"""The port's scheduler: priority admission, tenant caps, preemption and
the host spill tier (``GenerationPool`` and ``ServingEngine``),
re-pointed from the reference's ``tests/test_scheduling.py`` and held
against the reference's pool on the same weights (CPU).

Pinned here:

1. admission order is (priority desc, deadline asc, arrival), with
   per-tenant slot caps; typed validation of the cap, of deadlines (pool)
   and of priorities (engine);
2. preempt -> resume is byte-identical for greedy requests, fp32 and
   int8, through both resume paths: the re-map of spilled blocks still on
   the device, and the upload after a competitor reclaimed them; also
   with prefix-shared blocks, and for a sampled request (its stream
   continues at draw ``len(tokens)``);
3. the allocator partition ``free + resident + spilled + scratch ==
   num_blocks`` at every step, under random preempt/cancel churn too;
4. typed errors, cancel and reset free the spill tier, and the engine's
   manual ``preempt`` with the ``PREEMPTED`` state;
5. against the reference's pool: equal margin-gated greedy tokens, equal
   ``spill_stats()`` byte counts and the same slot and blocks for every
   admission and resume.

The speculative pool and its runtime spec-K are held by
``tests/test_torch_speculative.py``.  The degradation ladder, the automatic victim,
recovery and the deadline-shed estimator are held by
``tests/test_torch_serving_host.py``.
"""
import numpy as np
import pytest

from paddle_tpu.inference import GenerationPool as RefPool
from torch_parity import (MARGIN_FLOOR, build_pair, check_allocator,
                          greedy_margin, int8_margin)

from paddle_tpu_torch import GenerationPool, ServingEngine, TransformerLM
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          NotFoundError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.serving import RequestState


@pytest.fixture(scope="module")
def model():
    return TransformerLM(vocab_size=128, hidden_size=32, num_layers=1,
                         num_heads=2, intermediate_size=64, max_position=256,
                         dropout=0.0, device="cpu", seed=0)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _prompts(seed, lens, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype("int32") for n in lens]


def _partition_ok(stats):
    return stats["free_blocks"] + stats["mapped_blocks"] \
        + stats["spilled_blocks"] + 1 == stats["num_blocks"]


def _paged(model, **kw):
    kw = dict(dict(max_len=64, slots=1, buckets=[32], cache_layout="paged",
                   block_size=8, device="cpu"), **kw)
    return GenerationPool(model, **kw)


# -- admission ordering --------------------------------------------------
def test_priority_orders_admission(model):
    pool = _paged(model)
    p = _prompts(0, (5, 6, 7))
    pool.submit(p[0], 4, request_id="first")
    pool.step()  # "first" takes the only slot
    pool.submit(p[1], 4, request_id="low", priority=-1)
    pool.submit(p[2], 4, request_id="high", priority=2)
    order = []
    pool.on_admit = lambda rid, slot, n: order.append(rid)
    while pool.step():
        pass
    assert order == ["high", "low"]


def test_deadline_breaks_priority_ties(model):
    pool = _paged(model)
    p = _prompts(1, (5, 6, 7, 4))
    pool.submit(p[0], 4, request_id="first")
    pool.step()
    pool.submit(p[3], 4, request_id="none")  # no deadline: sorts last
    pool.submit(p[1], 4, request_id="lax", deadline=50.0)
    pool.submit(p[2], 4, request_id="tight", deadline=10)
    order = []
    pool.on_admit = lambda rid, slot, n: order.append(rid)
    while pool.step():
        pass
    assert order == ["tight", "lax", "none"]


def test_tenant_slot_cap_bounds_one_tenant(model):
    pool = _paged(model, slots=2, tenant_slot_cap=1)
    p = _prompts(2, (5, 5, 5, 6))
    for i in range(3):
        pool.submit(p[i], 6, request_id="a%d" % i, tenant="acme")
    pool.submit(p[3], 6, request_id="b0", tenant="beta")
    admitted = []
    pool.on_admit = lambda rid, slot, n: admitted.append(rid)
    pool.step()
    # acme holds ONE slot despite three earlier requests; the second
    # slot goes to beta past them
    assert admitted == ["a0", "b0"]
    assert pool.tenant_at_cap("acme") and pool.tenant_at_cap("beta")
    assert not pool.tenant_at_cap(None) and not pool.tenant_at_cap("x")
    while pool.step():
        pass
    assert sorted(admitted) == ["a0", "a1", "a2", "b0"]


def test_tenant_cap_validation(model):
    with pytest.raises(InvalidArgumentError, match="tenant_slot_cap"):
        GenerationPool(model, max_len=64, slots=2, tenant_slot_cap=0,
                       device="cpu")
    assert not _paged(model).tenant_at_cap("acme")  # no cap configured


def test_pool_rejects_non_numeric_deadline(model):
    pool = GenerationPool(model, max_len=64, slots=1, buckets=[32],
                          device="cpu")
    with pytest.raises(InvalidArgumentError, match="deadline"):
        pool.submit(np.zeros(4, np.int32), 2, deadline="soon")
    with pytest.raises(InvalidArgumentError, match="deadline"):
        pool.submit(np.zeros(4, np.int32), 2, deadline=True)


def test_priority_validation(model):
    eng = ServingEngine(model, max_len=32, slots=1, buckets=[8],
                        device="cpu")
    with pytest.raises(InvalidArgumentError, match="priority"):
        eng.submit(np.zeros(4, np.int32), 2, priority="urgent")
    with pytest.raises(InvalidArgumentError, match="priority"):
        eng.submit(np.zeros(4, np.int32), 2, priority=1.5)
    with pytest.raises(InvalidArgumentError, match="priority"):
        eng.submit(np.zeros(4, np.int32), 2, priority=True)
    s = eng.submit(np.zeros(4, np.int32), 2, priority="high")
    while eng.pump(4):
        pass
    assert s.status.state == RequestState.DONE


# -- preempt / spill / resume byte identity ------------------------------
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_preempt_resume_byte_identity(model, cache_dtype):
    p = _prompts(3, (5, 9, 7))

    def mk():
        return _paged(model, slots=2, cache_dtype=cache_dtype)

    ref = mk()
    for i, ids in enumerate(p):
        ref.submit(ids, 8, request_id=i)
    want = ref.run()

    pool = mk()
    for i, ids in enumerate(p):
        pool.submit(ids, 8, request_id=i)
    pool.step()
    pool.step()
    assert pool.can_preempt(0)
    info = pool.preempt(0)
    assert info["blocks_spilled"] >= 1 and info["spill_bytes"] > 0
    assert pool.preempted_count == 1 and not pool.can_preempt(0)
    assert _partition_ok(pool.cache_stats())
    check_allocator(pool)
    while pool.step():
        check_allocator(pool)
    got = pool._results
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    stats = pool.cache_stats()
    assert stats["mapped_blocks"] == 0 and stats["spilled_blocks"] == 0
    assert _partition_ok(stats)
    sstats = pool.spill_stats()
    assert sstats["preempts_total"] == 1 and sstats["resumes_total"] == 1
    assert sstats["spilled_requests"] == 0
    assert sstats["upload_bytes_total"] == 0  # re-mapped, no upload


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_reclaim_forces_upload_resume(model, cache_dtype):
    # a block-hungry higher-priority competitor reclaims the victim's
    # spilled device copies, so resume uploads the K/V from the host
    p = {"victim": _prompts(4, (9,))[0], "big": _prompts(5, (48,))[0]}

    def mk():
        return _paged(model, slots=2, buckets=[32, 64], num_blocks=9,
                      cache_dtype=cache_dtype)

    ref = mk()
    ref.submit(p["victim"], 8, request_id="victim")
    ref.submit(p["big"], 8, request_id="big")
    want = ref.run()

    pool = mk()
    pool.submit(p["victim"], 8, request_id="victim")
    for _ in range(3):
        pool.step()
    pool.preempt("victim")
    pool.submit(p["big"], 8, request_id="big", priority=5)
    while pool.step():
        check_allocator(pool)
    sstats = pool.spill_stats()
    assert sstats["reclaims_total"] >= 1, "reclaim path not exercised"
    assert sstats["upload_bytes_total"] > 0, "upload path not exercised"
    for k in want:
        np.testing.assert_array_equal(pool._results[k], want[k])
    assert _partition_ok(pool.cache_stats())


def test_preempt_with_prefix_sharing(model):
    # the victim maps SHARED prefix blocks: preempt decrefs them (the
    # co-owner keeps them resident), resume restores the victim from its
    # host copy -- byte-identical, refcounts reconciled
    rng = np.random.RandomState(6)
    prefix = rng.randint(0, 128, (16,)).astype("int32")
    prompts = [np.concatenate([prefix, rng.randint(0, 128, (4,))
                               .astype("int32")]) for _ in range(2)]

    def mk():
        return GenerationPool(model, max_len=64, slots=2,
                              cache_layout="paged", block_size=8,
                              prefill_chunk_tokens=8, prefix_sharing=True,
                              device="cpu")

    ref = mk()
    for i, ids in enumerate(prompts):
        ref.submit(ids, 6, request_id=i)
    want = ref.run()

    pool = mk()
    pool.submit(prompts[0], 6, request_id=0)
    for _ in range(4):  # prefill r0 far enough to index the prefix
        pool.step()
    pool.submit(prompts[1], 6, request_id=1)  # admission matches it
    for _ in range(6):
        pool.step()
        if pool.active_count == 2:
            break
    assert pool.cache_stats()["shared_blocks"] >= 1
    victim = next(iter(pool._active.values())).rid
    info = pool.preempt(victim)
    assert info["blocks_spilled"] == 3
    assert _partition_ok(pool.cache_stats())
    check_allocator(pool)
    while pool.step():
        check_allocator(pool)
    for i in want:
        np.testing.assert_array_equal(pool._results[i], want[i])
    stats = pool.cache_stats()
    assert stats["mapped_blocks"] == 0 and stats["shared_blocks"] == 0
    assert _partition_ok(stats)
    # the two shared blocks came back from the host copy
    assert pool.spill_stats()["upload_bytes_total"] > 0


def test_sampled_request_resumes_its_stream(model):
    p = _prompts(7, (6, 8))

    def run(preempt):
        pool = _paged(model, slots=2)
        pool.submit(p[0], 10, request_id="s", temperature=0.9, top_k=20,
                    seed=7)
        pool.submit(p[1], 10, request_id="g")
        for _ in range(3):
            pool.step()
        if preempt:
            pool.preempt("s")
            pool.step()
            assert pool.preempted_count == 0  # resumed in the same tick
        return pool.run()

    want, got = run(False), run(True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_allocator_partition_under_preempt_churn(model):
    rng = np.random.RandomState(8)
    pool = _paged(model, slots=3, num_blocks=14, prefill_chunk_tokens=8,
                  prefix_sharing=True)
    prefix = rng.randint(0, 128, (16,)).astype("int32")
    live, preempts = [], 0
    for _ in range(80):
        roll = rng.rand()
        if roll < 0.3 and len(live) < 6:
            ids = np.concatenate([prefix, rng.randint(
                0, 128, (rng.randint(1, 12),)).astype("int32")])
            live.append(pool.submit(ids, int(rng.randint(2, 10)),
                                    priority=int(rng.randint(3))))
        elif roll < 0.5 and pool.active_count:
            st = list(pool._active.values())[rng.randint(pool.active_count)]
            pool.preempt(st.rid)
            preempts += 1
        elif roll < 0.6 and live:
            pool.cancel(live.pop(rng.randint(len(live))))
        else:
            pool.step()
        check_allocator(pool)
        assert _partition_ok(pool.cache_stats())
        for rid in list(live):
            if rid in pool._results:
                pool.collect(rid)
                live.remove(rid)
    while pool.step():
        check_allocator(pool)
    stats = pool.cache_stats()
    assert preempts >= 5
    assert stats["mapped_blocks"] == stats["spilled_blocks"] == 0
    assert stats["free_blocks"] == stats["num_blocks"] - 1


def test_preempt_typed_errors(model):
    dense = GenerationPool(model, max_len=64, slots=1, buckets=[32],
                           device="cpu")
    dense.submit(np.zeros(4, np.int32), 4, request_id="r")
    dense.step()
    with pytest.raises(PreconditionNotMetError, match="paged"):
        dense.preempt("r")
    assert not dense.can_preempt("r")

    paged = _paged(model)
    paged.submit(np.zeros(4, np.int32), 4, request_id="q")
    with pytest.raises(NotFoundError, match="not actively decoding"):
        paged.preempt("q")  # still queued
    with pytest.raises(NotFoundError, match="not actively decoding"):
        paged.preempt("ghost")


def test_cancel_and_reset_free_the_spill_tier(model):
    eng = ServingEngine(model, max_len=64, slots=1, buckets=[32],
                        cache_layout="paged", block_size=8, device="cpu")
    baseline = eng.cache_stats()["free_blocks"]
    b = eng.submit(_prompts(9, (6,))[0], 10)
    eng.pump(2)
    eng.preempt(b.request_id)
    assert eng.cache_stats()["spilled_blocks"] >= 1
    assert eng.cancel(b.request_id) is True
    assert b.status.state == RequestState.CANCELLED
    stats = eng.cache_stats()
    assert stats["spilled_blocks"] == 0 and _partition_ok(stats)
    assert stats["free_blocks"] == baseline
    assert eng.spill_stats()["spilled_requests"] == 0

    pool = eng.pool
    pool.submit(_prompts(10, (6,))[0], 10, request_id="x")
    pool.step()
    pool.step()
    pool.preempt("x")
    pool.reset()
    assert pool.preempted_count == 0 and pool._spill_owner == {}
    check_allocator(pool)


def test_engine_manual_preempt_and_preempted_state(model):
    eng = ServingEngine(model, max_len=64, slots=2, buckets=[32],
                        cache_layout="paged", block_size=8, device="cpu")
    p = _prompts(11, (5, 7, 6))
    want = GenerationPool(model, max_len=64, slots=2, buckets=[32],
                          cache_layout="paged", block_size=8,
                          device="cpu").generate(p[:2], 12)
    streams = [eng.submit(ids, 12, request_id="r%d" % i)
               for i, ids in enumerate(p[:2])]
    eng.pump(3)
    assert eng.preempt("r0") == "r0"
    assert eng.request_state("r0") == RequestState.PREEMPTED
    assert RequestState.PREEMPTED not in RequestState.TERMINAL
    # a higher-priority arrival takes the freed slot first
    hi = eng.submit(p[2], 3, request_id="hi", priority="high")
    eng.pump(1)
    assert eng.request_state("hi") == RequestState.DECODING
    assert eng.request_state("r0") == RequestState.PREEMPTED
    while eng.pump(8):
        pass
    assert hi.status.state == RequestState.DONE
    for s, w in zip(streams, want):
        assert s.status.state == RequestState.DONE
        np.testing.assert_array_equal(s.status.tokens, w)
    spill = eng.spill_stats()
    assert spill["preempts_total"] == spill["resumes_total"] == 1
    with pytest.raises(NotFoundError):
        eng.preempt("ghost")
    # the automatic victim: nothing is decoding any more
    assert eng.preempt(None) is None


# -- against the reference's pool --------------------------------------------
@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_preempt_resume_matches_reference(pair, cache_dtype):
    ref, port = pair
    p = _prompts(12, (9, 13, 11, 40), vocab=512)
    kw = dict(max_len=64, slots=2, cache_layout="paged", block_size=8,
              num_blocks=10, prefill_chunk_tokens=8, prefix_sharing=True,
              cache_dtype=cache_dtype)

    def drive(pool, check=None):
        log = []
        pool.on_admit = lambda rid, slot, n: log.append(
            ("admit", rid, slot, list(pool._slot_blocks[slot])))
        pool.on_resume = lambda rid, info: log.append(
            ("resume", rid, info["slot"],
             list(pool._slot_blocks[info["slot"]])))
        for i in range(3):
            pool.submit(p[i], 8, request_id=i, priority=i)
        for _ in range(5):
            pool.step()
        infos = [pool.preempt(min(st.rid for st in pool._active.values()))]
        pool.submit(p[3], 6, request_id=3, priority=9)  # reclaims
        pool.step()
        infos.append(pool.preempt(min(st.rid
                                      for st in pool._active.values())))
        while pool.step():
            if check is not None:
                check(pool)
        return pool._results, log, infos, pool.spill_stats()

    want, ref_log, ref_infos, ref_spill = drive(RefPool(ref, **kw))
    got, log, infos, spill = drive(GenerationPool(port, device="cpu", **kw),
                                   check=check_allocator)
    assert log == ref_log  # same slot and blocks, admissions and resumes
    for a, b in zip(infos, ref_infos):
        for key in ("slot", "blocks_spilled", "blocks_freed", "spill_bytes",
                    "committed_tokens"):
            assert a[key] == b[key], key
    for key in ("preempts_total", "resumes_total", "spill_bytes_total",
                "upload_bytes_total", "reclaims_total"):
        assert spill[key] == ref_spill[key], key
    assert spill["reclaims_total"] >= 1 and spill["upload_bytes_total"] > 0
    margin = greedy_margin if cache_dtype == "float32" else int8_margin
    checked = 0
    for i, ids in enumerate(p):
        if margin(ref if cache_dtype == "float32" else port, ids,
                  want[i]) < MARGIN_FLOOR:
            continue
        np.testing.assert_array_equal(got[i], want[i])
        checked += 1
    assert checked >= 2, "corpus too thin: %d prompts" % checked

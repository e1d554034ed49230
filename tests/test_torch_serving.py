"""The port's serving path -- ``DecodeSession``, ``GenerationPool`` and
``ServingEngine`` -- against the reference on the same weights (CPU).

- Greedy tokens equal the reference's for dense and paged fp32 sessions,
  and for a pool under slot churn (more requests than slots, mixed
  lengths), on prompts whose top-2 logit margin clears the floor of
  ``tests/test_quant_cache.py``.
- The paged allocator's invariants: block 0 is never handed out, free
  plus mapped blocks always make up the pool, and blocks return on finish
  and on cancel.
- int8 slot-batched logits stay within the reference int8 path's
  divergence bound (no fp32-token oracle: see ROADMAP queue 3).
- Engine streams equal the pool's tokens; a full queue raises
  ``QueueFullError``.
- Sampled rows are held by their invariants and the port's own
  determinism, never by token equality with JAX.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import GenerationPool as RefPool
from paddle_tpu.jit import DecodeSession as RefSession
from torch_parity import MARGIN_FLOOR, build_pair, greedy_margin

from paddle_tpu_torch import (DecodeSession, GenerationPool, QueueFullError,
                              ServingEngine)
from paddle_tpu_torch.jit.decode import sample_logits_data

LAYOUTS = [pytest.param({}, id="dense"),
           pytest.param(dict(cache_layout="paged", block_size=8),
                        id="paged")]


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_session_greedy_tokens_match_reference(pair, layout_kw):
    ref, port = pair
    rs = RefSession(ref, max_len=64, buckets=[16], **layout_kw)
    ps = DecodeSession(port, max_len=64, buckets=[16], device="cpu",
                       **layout_kw)
    checked = 0
    for seed in range(4):
        rng = np.random.RandomState(seed)
        ids = rng.randint(0, 512, (1, int(rng.randint(3, 15)))) \
            .astype(np.int32)
        want = rs.generate(ids, 8)
        if greedy_margin(ref, ids[0], want[0]) < MARGIN_FLOOR:
            continue
        np.testing.assert_array_equal(ps.generate(ids, 8), want,
                                      err_msg="seed %d" % seed)
        checked += 1
    assert checked >= 3, "corpus too thin: %d prompts" % checked


@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_pool_slot_churn_matches_reference(pair, layout_kw):
    ref, port = pair
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 13, 3, 9, 16, 7)]
    want = RefPool(ref, max_len=64, slots=2, buckets=[16],
                   **layout_kw).generate(prompts, 6)
    pool = GenerationPool(port, max_len=64, slots=2, buckets=[16],
                          device="cpu", **layout_kw)
    got = pool.generate(prompts, 6)
    checked = 0
    for p, w, g in zip(prompts, want, got):
        if greedy_margin(ref, p, w) < MARGIN_FLOOR:
            continue
        np.testing.assert_array_equal(g, w)
        checked += 1
    assert checked >= 4, "corpus too thin: %d prompts" % checked


def _check_partition(pool):
    stats = pool.cache_stats()
    assert stats["free_blocks"] + stats["mapped_blocks"] + 1 \
        == stats["num_blocks"], stats
    assert 0 not in pool._free_blocks and 0 not in pool._block_refs
    owned = [b for bl in pool._slot_blocks.values() for b in bl]
    assert len(owned) == len(set(owned)) == stats["mapped_blocks"]
    return stats


def test_paged_allocator_invariants(pair):
    _, port = pair
    pool = GenerationPool(port, max_len=64, slots=3, buckets=[16],
                          cache_layout="paged", block_size=8, num_blocks=9,
                          device="cpu")
    rng = np.random.RandomState(5)
    rids = [pool.submit(rng.randint(0, 512, (n,)), 10)
            for n in (12, 4, 15, 6, 9)]
    assert pool.cache_stats()["free_blocks"] == 8
    seen_blocked = False
    cancelled = False
    while pool.step():
        stats = _check_partition(pool)
        seen_blocked |= pool.admission_blocked
        if not cancelled and pool.active_count >= 2:
            # cancel mid-generation: its reservation returns at once
            slot, st = sorted(pool._active.items())[0]
            held = len(pool._slot_blocks[slot])
            assert pool.cancel(st.rid) == "active"
            after = _check_partition(pool)
            assert after["free_blocks"] == stats["free_blocks"] + held
            cancelled = True
    assert cancelled and seen_blocked  # 8 blocks cannot hold every request
    stats = _check_partition(pool)
    assert stats["free_blocks"] == 8 and stats["mapped_blocks"] == 0
    results = pool.run()
    assert len(results) == len(rids) - 1
    assert all(len(t) == 10 for t in results.values())


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_slot_batched_logits_within_reference_bound(pair, layout):
    import jax.numpy as jnp

    ref, port = pair
    ids = np.random.RandomState(3).randint(0, 512, (2, 12)).astype(np.int32)
    kw = dict(dtype="int8", per_slot=True, layout=layout, block_size=8)
    # an allocator's mapping for the paged pool: rows own blocks 1-4, 5-8
    table = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    if layout == "paged":
        kw["num_blocks"] = 9

    def run(model, to_in, to_np, cache):
        logits, cache = model(to_in(ids[:, :8]), cache=cache)
        parts = [to_np(logits)]
        for t in range(8, 12):
            logits, cache = model(to_in(ids[:, t:t + 1]), cache=cache)
            parts.append(to_np(logits))
        return np.concatenate(parts, axis=1)

    ref_cache = ref.gen_decode_cache(2, 32, **kw)
    port_cache = port.gen_decode_cache(2, 32, **kw)
    if layout == "paged":
        ref_cache = [c._replace(table=jnp.asarray(table)) for c in ref_cache]
        port_cache = [c._replace(table=torch.from_numpy(table))
                      for c in port_cache]
    want = run(ref, pt.to_tensor, lambda x: np.asarray(x.value), ref_cache)
    with torch.no_grad():
        got = run(port, lambda x: torch.from_numpy(x.astype(np.int64)),
                  lambda x: x.numpy(), port_cache)
    full = np.asarray(ref(pt.to_tensor(ids)).value)
    port_err = float(np.abs(got - full).max())
    # the reference int8 test's bound; > 0: genuinely lossy, not fp32
    assert 0.0 < port_err < 0.08, port_err
    assert float(np.abs(got - want).max()) < 0.08


@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_engine_streams_match_pool(pair, layout_kw):
    _, port = pair
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (4, 11, 7, 14, 2)]
    want = GenerationPool(port, max_len=64, slots=2, buckets=[16],
                          device="cpu", **layout_kw).generate(prompts, 5)
    engine = ServingEngine(port, max_len=64, slots=2, buckets=[16],
                           device="cpu", max_queue=8, **layout_kw)
    streams = [engine.submit(p, 5) for p in prompts]
    assert engine.queue_depth == 5 and engine.live_requests == 5
    got = [list(s) for s in streams]
    for g, w, s in zip(got, want, streams):
        np.testing.assert_array_equal(np.asarray(g, np.int32), w)
        assert s.status.state == "DONE" and s.status.new_tokens == 5
        assert s.status.ttft_s is not None
    assert engine.live_requests == 0
    if layout_kw:
        stats = engine.cache_stats()
        assert stats["free_blocks"] == stats["num_blocks"] - 1


def test_engine_queue_full_and_cancel(pair):
    _, port = pair
    engine = ServingEngine(port, max_len=64, slots=1, buckets=[16],
                           max_queue=2, cache_layout="paged", block_size=8,
                           device="cpu")
    a = engine.submit(np.arange(1, 6), 4)
    engine.submit(np.arange(1, 4), 4)
    with pytest.raises(QueueFullError):
        engine.submit(np.arange(1, 3), 4)
    engine.pump(1)  # `a` takes the one slot
    assert engine.request_state(a.request_id) == "DECODING"
    assert engine.cancel(a.request_id)
    assert a.status.state == "CANCELLED" and not engine.cancel(a.request_id)
    stats = engine.cache_stats()
    assert stats["free_blocks"] == stats["num_blocks"] - 1
    engine.submit(np.arange(1, 3), 4)  # room again
    while engine.pump(1):
        pass
    assert engine.live_requests == 0


def test_sampling_invariants_and_determinism():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(4, 50).astype(np.float32))
    temp = np.array([0.0, 1.0, 1.0, 0.7], np.float32)
    top_k = np.array([0, 3, 0, 1], np.int32)
    top_p = np.array([1.0, 1.0, 0.3, 1.0], np.float32)
    top3 = set(torch.topk(logits[1], 3).indices.tolist())
    sorted_p = torch.softmax(logits[2], -1).sort(descending=True)
    nucleus = set(sorted_p.indices[:int((sorted_p.values.cumsum(0) - sorted_p
                                          .values < 0.3).sum())].tolist())
    draws = []
    for step in range(64):
        tok = sample_logits_data(logits, temp, top_k, top_p,
                                 np.full(4, 9, np.int64),
                                 np.full(4, step, np.int64))
        assert tok[0] == logits[0].argmax() and tok[3] == logits[3].argmax()
        assert int(tok[1]) in top3 and int(tok[2]) in nucleus
        again = sample_logits_data(logits, temp, top_k, top_p,
                                   np.full(4, 9, np.int64),
                                   np.full(4, step, np.int64))
        assert torch.equal(tok, again)  # a pure function of (seed, step)
        draws.append(int(tok[1]))
    assert set(draws) == top3  # 64 draws over three candidates


def test_sampled_pool_requests_are_reproducible(pair):
    _, port = pair
    prompt = np.arange(3, 10)

    def sample():
        pool = GenerationPool(port, max_len=64, slots=2, buckets=[16],
                              device="cpu")
        rid = pool.submit(prompt, 8, temperature=0.8, top_k=20, seed=123)
        greedy = pool.submit(prompt, 8)
        out = pool.run()
        return out[rid], out[greedy]

    (s1, g1), (s2, g2) = sample(), sample()
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(g1, g2)

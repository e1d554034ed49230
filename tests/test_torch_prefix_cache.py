"""The port's chunked prefill and prefix sharing (``GenerationPool``'s
``prefill_chunk_tokens`` and ``prefix_sharing``), re-pointed from the
reference's ``tests/test_prefix_cache.py`` and held against the
reference's pool on the same weights (CPU).

Pinned here:

- the knobs are paged-only, and sharing needs chunking (typed errors);
- greedy tokens: the chunked pool equals the bucketed pool, and sharing
  on equals sharing off (fp32 and int8, with hits > 0 so the check is
  not vacuous); prompts past the largest bucket are served;
- a long prompt prefilling in chunks never stalls a resident request's
  one-token-a-tick cadence;
- the allocator's invariants under randomized shared churn (several
  seeds): free + unique resident + scratch == num_blocks, refcounts equal
  the table rows mapping each block, and the prefix index names only
  resident blocks; ``reset()`` clears the index; shared blocks count
  once; a cancel mid-prefill reclaims everything;
- the chunk path: writes never land in a shared block (their bytes are
  poisoned and checked), a prefilling slot's real table row survives the
  batched step's masking, the global index is ``start + n`` after every
  chunk, and only the final chunk's token is downloaded;
- a forced hash collision neither splices another prompt's K/V nor
  changes a token;
- the scalar ``sample_logits`` (greedy equal to the reference's, sampled
  rows held by their invariants);
- against the reference's pool with chunking and sharing on: equal
  margin-gated greedy tokens, equal ``prefix_stats()`` hits and tokens
  matched, and the same slot and blocks for every request.

Left out, because their subject is not ported yet: the speculative pool,
compile counts and the cost report, recovery and chaos runs, the
engine's metrics and structured log lines, and dp shards.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import GenerationPool as RefPool
from paddle_tpu.jit.decode import sample_logits as ref_sample_logits
from torch_parity import (MARGIN_FLOOR, build_pair, check_allocator,
                          greedy_margin, int8_margin)

from paddle_tpu_torch import GenerationPool, ServingEngine, TransformerLM
from paddle_tpu_torch.core.errors import InvalidArgumentError
from paddle_tpu_torch.inference import generation
from paddle_tpu_torch.inference import kv_reachable_bytes
from paddle_tpu_torch.jit.decode import sample_logits


def _tiny_model(layers=2):
    return TransformerLM(vocab_size=128, hidden_size=32, num_layers=layers,
                         num_heads=2, intermediate_size=64, max_position=256,
                         dropout=0.0, device="cpu", seed=0)


@pytest.fixture(scope="module")
def model():
    return _tiny_model()


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _shared_prompts(rng, prefix_len=20, tails=(5, 9, 3, 13), vocab=128):
    prefix = rng.randint(0, vocab, (prefix_len,)).astype("int32")
    prompts = [np.concatenate(
        [prefix, rng.randint(0, vocab, (n,)).astype("int32")])
        for n in tails]
    prompts.append(rng.randint(0, vocab, (12,)).astype("int32"))  # cold
    return prompts


def _pool(model, sharing, dtype="float32", slots=2, chunk=8,
          num_blocks=None):
    return GenerationPool(model, max_len=64, slots=slots, buckets=[64],
                          cache_layout="paged", block_size=8,
                          cache_dtype=dtype, num_blocks=num_blocks,
                          prefill_chunk_tokens=chunk,
                          prefix_sharing=sharing, device="cpu")


# -- knob validation ------------------------------------------------------
def test_chunk_and_sharing_knobs_require_paged(model):
    with pytest.raises(InvalidArgumentError, match="paged"):
        GenerationPool(model, max_len=32, slots=1, buckets=[16],
                       prefill_chunk_tokens=8, device="cpu")
    with pytest.raises(InvalidArgumentError, match="paged"):
        GenerationPool(model, max_len=32, slots=1, buckets=[16],
                       prefix_sharing=True, device="cpu")
    with pytest.raises(InvalidArgumentError, match="prefill_chunk_tokens"):
        GenerationPool(model, max_len=32, slots=1, buckets=[16],
                       cache_layout="paged", prefix_sharing=True,
                       device="cpu")
    with pytest.raises(InvalidArgumentError, match=">= 1"):
        GenerationPool(model, max_len=32, slots=1, buckets=[16],
                       cache_layout="paged", prefill_chunk_tokens=0,
                       device="cpu")


# -- greedy token identity ------------------------------------------------
def test_chunked_pool_token_identical_to_bucketed(model):
    rng = np.random.RandomState(0)
    prompts = _shared_prompts(rng)
    bucketed = GenerationPool(model, max_len=64, slots=2, buckets=[64],
                              cache_layout="paged", block_size=8,
                              device="cpu")
    want = bucketed.generate(prompts, 6)
    got = _pool(model, sharing=False).generate(prompts, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharing_on_off_byte_identical(model, dtype):
    rng = np.random.RandomState(1)
    prompts = _shared_prompts(rng)
    outs, hits = {}, 0
    for sharing in (True, False):
        pool = _pool(model, sharing, dtype=dtype)
        rids = [pool.submit(prompts[0], 6)]
        for _ in range(6):  # let the first owner's blocks get indexed
            pool.step()
        rids += [pool.submit(p, 6) for p in prompts[1:]]
        results = pool.run()
        outs[sharing] = [results[r] for r in rids]
        if sharing:
            hits = pool.prefix_stats()["hits"]
            assert pool.prefix_stats()["hit_rate"] > 0
    assert hits >= 1, "traffic produced no prefix hits: test is vacuous"
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


def test_chunked_pool_serves_prompts_beyond_buckets(model):
    pool = GenerationPool(model, max_len=64, slots=1, buckets=[16],
                          cache_layout="paged", block_size=8,
                          prefill_chunk_tokens=8, device="cpu")
    ids = np.random.RandomState(4).randint(0, 128, (40,)).astype("int32")
    out = pool.generate([ids], 4)[0]
    bucketed = GenerationPool(model, max_len=64, slots=1, buckets=[64],
                              cache_layout="paged", block_size=8,
                              device="cpu")
    np.testing.assert_array_equal(out, bucketed.generate([ids], 4)[0])


def test_final_chunk_past_max_position_is_served(model):
    # the pad tail of a last chunk may run past the position table (here
    # the chunk at 240 covers positions 240..263 of a 256-entry table);
    # those positions are discarded, so the prompt is served as the
    # bucketed pool serves it
    pool = GenerationPool(model, max_len=256, slots=1, cache_layout="paged",
                          block_size=8, prefill_chunk_tokens=24,
                          device="cpu")
    ids = np.random.RandomState(14).randint(0, 128, (250,)).astype("int32")
    out = pool.generate([ids], 2)[0]
    bucketed = GenerationPool(model, max_len=256, slots=1, buckets=[256],
                              cache_layout="paged", block_size=8,
                              device="cpu")
    np.testing.assert_array_equal(out, bucketed.generate([ids], 2)[0])


# -- bounded interference ---------------------------------------------------
def test_long_prompt_prefill_never_stalls_resident_decode(model):
    pool = _pool(model, sharing=False, chunk=8)
    rng = np.random.RandomState(5)
    r1 = pool.submit(rng.randint(0, 128, (5,)).astype("int32"), 20)
    pool.step()  # R1 admitted, its one chunk run, first decode
    slot1 = next(s for s, st in pool._active.items() if st.rid == r1)
    pool.submit(rng.randint(0, 128, (48,)).astype("int32"), 4)
    ticks = 0
    while pool.prefilling_count or ticks == 0:
        before = len(pool._active[slot1].tokens)
        pool.step()
        ticks += 1
        assert len(pool._active[slot1].tokens) == before + 1, \
            "a prefilling prompt stalled a resident request's cadence"
    assert ticks == 6  # 48 prompt tokens, 8 a tick
    pool.run()


# -- allocator invariants under churn ----------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_invariants_under_shared_churn(model, seed):
    rng = np.random.RandomState(seed)
    pool = _pool(model, sharing=True, num_blocks=24)
    prefixes = [rng.randint(0, 128, (16,)).astype("int32") for _ in range(2)]
    live = []
    for _ in range(60):
        roll = rng.rand()
        if roll < 0.35 and len(live) < 8:
            ids = np.concatenate(
                [prefixes[rng.randint(2)],
                 rng.randint(0, 128, (rng.randint(1, 10),)).astype("int32")])
            live.append(pool.submit(ids, int(rng.randint(1, 6))))
        elif roll < 0.5 and live:
            rid = live.pop(rng.randint(len(live)))
            pool.cancel(rid)
        else:
            pool.step()
        check_allocator(pool)
        for rid in list(live):
            if rid in pool._results:
                pool.collect(rid)
                live.remove(rid)
    while pool.step():
        check_allocator(pool)
    check_allocator(pool)
    stats = pool.cache_stats()
    assert stats["mapped_blocks"] == 0
    assert stats["free_blocks"] == stats["num_blocks"] - 1
    assert pool._prefix_index == {} and pool._block_keys == {}
    assert pool.prefix_stats()["hits"] > 0, "churn never shared a prefix"


def test_reset_clears_prefix_index(model):
    pool = _pool(model, sharing=True)
    prefix = np.random.RandomState(6).randint(0, 128, (16,)).astype("int32")
    pool.submit(np.concatenate([prefix, prefix[:5]]), 8)
    for _ in range(5):
        pool.step()
    assert pool._prefix_index, "churn produced no index entries"
    pool.reset()
    assert pool._prefix_index == {} and pool._block_keys == {}
    assert pool._block_refs == {}
    assert pool.prefilling_count == 0
    check_allocator(pool)
    assert pool.generate([prefix], 3)[0].shape == (3,)


def test_shared_blocks_counted_once(model):
    pool = _pool(model, sharing=True)
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, 128, (16,)).astype("int32")
    a = np.concatenate([prefix, rng.randint(0, 128, (5,)).astype("int32")])
    b = np.concatenate([prefix, rng.randint(0, 128, (7,)).astype("int32")])
    pool.submit(a, 30)
    for _ in range(6):
        pool.step()  # a resident and indexed, still decoding
    pool.submit(b, 30)
    pool.step()
    stats = pool.cache_stats()
    assert stats["shared_blocks"] == 2  # 16 tokens / block_size 8
    need_a = pool._blocks_needed(len(a), 30)
    need_b = pool._blocks_needed(len(b), 30)
    assert stats["mapped_blocks"] == need_a + need_b - 2
    check_allocator(pool)
    pool.run()


def test_cancel_mid_prefill_reclaims_everything(model):
    pool = _pool(model, sharing=True)
    rng = np.random.RandomState(8)
    rid = pool.submit(rng.randint(0, 128, (48,)).astype("int32"), 4)
    pool.step()  # admitted, first chunk done, still prefilling
    assert pool.prefilling_count == 1
    assert pool.cancel(rid) == "active"
    assert pool.prefilling_count == 0
    check_allocator(pool)
    assert pool.cache_stats()["mapped_blocks"] == 0
    out = pool.generate([rng.randint(0, 128, (9,)).astype("int32")], 3)
    assert out[0].shape == (3,)


def test_reachable_bytes_keeps_ragged_cap_and_leq_dense(model):
    # max_len 60 at block_size 8: 8 blocks = 64 positions, but the final
    # block's over-hang past 60 is masked and must not count
    pool = GenerationPool(model, max_len=60, slots=1, buckets=[60],
                          cache_layout="paged", block_size=8,
                          prefill_chunk_tokens=16, prefix_sharing=True,
                          device="cpu")
    pool.submit(np.random.RandomState(12).randint(0, 128, (50,))
                .astype("int32"), 10)
    for _ in range(5):
        pool.step()
    stats = pool.cache_stats()
    assert stats["mapped_blocks"] == 8  # ceil(60/8)
    assert stats["reachable_bytes"] <= stats["dense_equiv_bytes"]
    assert stats["reachable_bytes"] == kv_reachable_bytes(
        [60], max_len=60, num_layers=2, num_heads=2, head_dim=16,
        layout="paged", block_size=8)
    pool.run()


# -- the chunk path ------------------------------------------------------
def test_chunk_writes_never_touch_shared_blocks(model):
    # the shared prefix blocks are poisoned after the owner wrote them:
    # the second request's chunks (pad tail included) must leave their
    # bytes as they are, and the poison must not reach its tokens' path
    # past the match (it does reach attention over the prefix, which is
    # the point of sharing: the test only checks the writes)
    pool = _pool(model, sharing=True)
    rng = np.random.RandomState(15)
    prefix = rng.randint(0, 128, (16,)).astype("int32")
    pool.submit(np.concatenate([prefix, rng.randint(0, 128, (3,))]), 30)
    for _ in range(4):
        pool.step()
    pool.submit(np.concatenate([prefix, rng.randint(0, 128, (13,))]), 4)
    pool._refill()
    slot = next(iter(pool._prefilling))
    shared = pool._slot_blocks[slot][:2]
    assert pool._prefilling[slot].pos == 16
    assert all(pool._block_refs[b] == 2 for b in shared)
    ids = torch.as_tensor(shared)
    for c in pool._cache:
        c.k[ids] = 1e4
        c.v[ids] = -1e4
    before = [(c.k[ids].clone(), c.v[ids].clone()) for c in pool._cache]
    while pool.prefilling_count:
        pool.step()
    for c, (k, v) in zip(pool._cache, before):
        assert torch.equal(c.k[ids], k) and torch.equal(c.v[ids], v)
    pool.run()


def test_prefilling_row_survives_the_masked_step(model):
    pool = _pool(model, sharing=False, chunk=8)
    rng = np.random.RandomState(16)
    pool.submit(rng.randint(0, 128, (5,)).astype("int32"), 12)
    pool.step()  # decoding
    pool.submit(rng.randint(0, 128, (30,)).astype("int32"), 4)
    pool.step()  # admitted + first chunk, then a decode step masking it
    slot = next(iter(pool._prefilling))
    row = pool._slot_blocks[slot]
    for c in pool._cache:
        assert c.table[slot, :len(row)].tolist() == row
        assert int(c.index[slot]) == pool._prefilling[slot].pos
    pool.run()


def test_global_index_follows_every_chunk(model):
    pool = _pool(model, sharing=False, chunk=8)
    pool.submit(np.random.RandomState(17).randint(0, 128, (29,))
                .astype("int32"), 3)
    positions = []
    while True:
        pool.step()
        if not pool.prefilling_count:
            break
        slot, st = next(iter(pool._prefilling.items()))
        assert all(int(c.index[slot]) == st.pos for c in pool._cache)
        positions.append(st.pos)
    assert positions == [8, 16, 24]
    slot = next(iter(pool._active))
    # activated after the 5-token tail, then one decode step
    assert all(int(c.index[slot]) == 30 for c in pool._cache)
    pool.run()


def test_only_the_final_chunk_is_downloaded(model, monkeypatch):
    pool = _pool(model, sharing=False, chunk=8)
    pool.submit(np.random.RandomState(18).randint(0, 128, (30,))
                .astype("int32"), 2)
    syncs = []
    for name in ("__int__", "item", "cpu", "tolist", "numpy"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _r=real, _n=name, **k:
            syncs.append(_n) or _r(self, *a, **k))
    for _ in range(3):
        pool.step()  # three intermediate chunks, nothing active yet
    assert pool.prefilling_count == 1 and syncs == []
    pool.step()  # the final chunk: ONE download, then the decode step's
    assert syncs[0] == "__int__" and syncs.count("__int__") == 1


def test_hash_collision_neither_splices_nor_changes_tokens(model,
                                                           monkeypatch):
    rng = np.random.RandomState(19)
    a = rng.randint(0, 128, (21,)).astype("int32")
    b = rng.randint(0, 128, (21,)).astype("int32")  # another prompt

    def drive(pool):
        rids = [pool.submit(a, 12)]
        for _ in range(4):
            pool.step()
        rids += [pool.submit(b, 4), pool.submit(a, 4)]
        out = pool.run()
        return [out[r] for r in rids]

    want = drive(_pool(model, sharing=False, slots=3))
    monkeypatch.setattr(generation, "hash", lambda x: 7, raising=False)
    pool = _pool(model, sharing=True, slots=3)
    got = drive(pool)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    stats = pool.prefix_stats()
    # every key collides: ``a``'s first block is indexed, its second
    # collides with it and stops the chain; ``b`` never matches, the
    # repeat of ``a`` matches that one verified block only
    assert stats["hits"] == 1 and stats["tokens_matched"] == 8
    check_allocator(pool)


# -- the engine surface ----------------------------------------------------
def test_engine_prefix_stats_digest_and_reset(model):
    eng = ServingEngine(model, max_len=64, slots=2, cache_layout="paged",
                        block_size=8, prefill_chunk_tokens=8,
                        prefix_sharing=True, device="cpu")
    rng = np.random.RandomState(9)
    prefix = rng.randint(0, 128, (16,)).astype("int32")
    warm = eng.submit(np.concatenate([prefix, rng.randint(0, 128, (5,))]),
                      12, request_id="warm")
    eng.pump(4)  # warm resident and indexed, still decoding
    digest = eng.resident_prefix_digest()
    assert len(digest["keys"]) == 2
    assert "keys" not in eng.resident_prefix_digest(digest["epoch"])
    hot = eng.submit(np.concatenate([prefix, rng.randint(0, 128, (7,))]), 4,
                     request_id="hot")
    while eng.pump(8):
        pass
    stats = eng.prefix_stats()
    assert stats["queries"] == 2 and stats["hits"] == 1
    assert stats["hit_rate"] == 0.5 and stats["tokens_matched"] == 16
    assert warm.status.state == hot.status.state == "DONE"
    eng.reset_prefix_stats()
    assert eng.prefix_stats()["queries"] == 0
    assert eng.prefix_stats()["prefill_chunks_total"] == 0
    plain = ServingEngine(model, max_len=64, slots=1, buckets=[16],
                          device="cpu")
    assert plain.resident_prefix_digest() is None
    assert plain.prefix_stats()["enabled"] is False


# -- jit/decode.py: the scalar sampler -------------------------------------
def test_scalar_sample_logits_greedy_and_invariants():
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 40).astype(np.float32)
    want = np.asarray(ref_sample_logits(pt.to_tensor(logits).value, None))
    got = sample_logits(torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    top4 = [set(np.argsort(row)[-4:].tolist()) for row in logits]
    gen = torch.Generator().manual_seed(5)
    draws = set()
    for _ in range(48):
        tok = sample_logits(torch.from_numpy(logits), gen, temperature=1.0,
                            top_k=4)
        assert all(int(t) in s for t, s in zip(tok, top4))
        draws.add(int(tok[0]))
    assert draws == top4[0]
    one = sample_logits(torch.from_numpy(logits), gen, temperature=0.5,
                        top_p=1e-6)
    np.testing.assert_array_equal(one.numpy(), logits.argmax(-1))
    with pytest.raises(InvalidArgumentError, match="temperature"):
        sample_logits(torch.from_numpy(logits), temperature=-1.0)
    with pytest.raises(InvalidArgumentError, match="top_p"):
        sample_logits(torch.from_numpy(logits), top_p=0.0)


# -- against the reference's pool --------------------------------------------
def _assignment(pool, log):
    """on_admit hook recording (slot, blocks) per request."""
    def hook(rid, slot, n):
        log[rid] = (slot, list(pool._slot_blocks[slot]))
    return hook


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_chunked_sharing_pool_matches_reference(pair, dtype):
    ref, port = pair
    rng = np.random.RandomState(20)
    prefix = rng.randint(0, 512, (20,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, 512, (n,))
                               .astype(np.int32)]) for n in (5, 9, 3, 13)]
    prompts.append(rng.randint(0, 512, (12,)).astype(np.int32))
    kw = dict(max_len=64, slots=2, cache_layout="paged", block_size=8,
              prefill_chunk_tokens=8, prefix_sharing=True, cache_dtype=dtype,
              num_blocks=14)

    def drive(pool, check=None):
        log = {}
        pool.on_admit = _assignment(pool, log)
        rids = [pool.submit(prompts[0], 6, request_id=0)]
        for _ in range(4):
            pool.step()
        rids += [pool.submit(p, 6, request_id=i + 1)
                 for i, p in enumerate(prompts[1:])]
        while pool.step():
            if check is not None:
                check(pool)
        return [pool._results[r] for r in rids], log, pool.prefix_stats()

    want, ref_log, ref_stats = drive(RefPool(ref, **kw))
    got, log, stats = drive(GenerationPool(port, device="cpu", **kw),
                            check=check_allocator)
    assert log == ref_log  # same slot and blocks for every request
    for key in ("queries", "hits", "tokens_matched", "blocks_matched",
                "prefill_chunks_total", "prefill_chunk_tokens_total"):
        assert stats[key] == ref_stats[key], key
    assert stats["hits"] >= 3
    margin = greedy_margin if dtype == "float32" else int8_margin
    checked = 0
    for p, w, g in zip(prompts, want, got):
        if margin(ref if dtype == "float32" else port, p, w) < MARGIN_FLOOR:
            continue
        np.testing.assert_array_equal(g, w)
        checked += 1
    assert checked >= 3, "corpus too thin: %d prompts" % checked

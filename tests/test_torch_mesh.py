"""The port's sharded serving (``paddle_tpu_torch.jit.mesh``): the
reference's ``tests/test_sharded_serving.py`` re-pointed at the port on the
CPU, every shard of a mesh on ``"cpu"`` (``devices=["cpu"] * n``), plus
the same weights and inputs through both packages.

Pinned here, as in the reference:

1. GREEDY IDENTITY: a dp=2, mp=2 and dp x mp pool decodes the unsharded
   pool's tokens -- paged x fp32/int8 and dense -- with the same
   ``compile_counts()`` (a mesh is placement, never a new step key).
2. PER-SHARD BLOCK PARTITION: every tick ``free + mapped + spilled +
   scratch == num_blocks / dp`` in EACH shard, and no slot's table row
   names a block outside its shard.
3. LIFECYCLE: cancel / preempt / resume on logical slots, resume pinned
   to its shard, survivors identical, no new key.
4. CHAOS RECOVERY over 5 seeds on a dp-sharded engine.
5. ACCOUNTING: ``cache_stats()`` per shard beside the mesh totals, and the
   engine's mesh gauges.

The port's own: the shards are separate contiguous tensors (the decode
kernels read contiguous K/V) and the tables hold shard-local block ids; a
grid over several devices is refused; the mp weight slices refresh in
place; a bank-attached column-parallel Linear under mp equals the
unsharded one; a journal is refused across mesh shapes while a PTKV file
(all heads, the reference's capacity rule) crosses them.

Across the packages: the reference's ``GenerationPool(mesh=...)`` on the
forced host devices and the port's on the same weights decode the same
greedy tokens (margin-gated), the port's sharded forward gives the
reference's logits within 1e-4, and the fingerprints are equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.generation import GenerationPool as RefPool
from paddle_tpu.jit.mesh import DecodeMesh as RefMesh
from paddle_tpu.models import TransformerLM as RefLM
from torch_parity import assert_greedy_equal, ref_logits, reference_arrays

from paddle_tpu_torch import DecodeSession, TransformerLM
from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          UnimplementedError)
from paddle_tpu_torch.inference.generation import GenerationPool
from paddle_tpu_torch.inference.speculative import SpeculativePool
from paddle_tpu_torch.jit.cache import ShardedCache, get_layout
from paddle_tpu_torch.jit.mesh import DecodeMesh
from paddle_tpu_torch.nn import lora
from paddle_tpu_torch.serving import RequestState, ServingEngine, faults
from paddle_tpu_torch.serving.faults import FaultPlane
from paddle_tpu_torch.serving.journal import FingerprintMismatchError

CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position=64, causal=True,
           dropout=0.0)

# the port's sharded forward against the reference's uncached forward
LOGIT_TOL = 1e-4


def mesh(dp, mp, **kw):
    return DecodeMesh(dp, mp, devices=["cpu"] * (dp * mp), **kw)


def _fresh_model(seed=0):
    # every pool gets its own model (identical weights per seed)
    return TransformerLM(**CFG, device="cpu", seed=seed)


def _prompts(n=4, seed=0):
    rng = np.random.RandomState(seed)
    lens = [5, 9, 3, 12, 7, 10, 4, 8][:n]
    return [rng.randint(1, CFG["vocab_size"], (l,)).astype("int32")
            for l in lens]


def _pool(mesh=None, dtype="float32", layout="paged", slots=4, model=None,
          **kw):
    kwargs = dict(max_len=32, slots=slots, buckets=[16], cache_dtype=dtype,
                  mesh=mesh, device="cpu")
    if layout == "paged":
        kwargs.update(cache_layout="paged", block_size=4)
    kwargs.update(kw)
    return GenerationPool(model or _fresh_model(), **kwargs)


def _check_partition(pool):
    """Contract 2: the exact per-shard free/mapped/spilled/scratch
    partition, plus shard-locality of every mapping."""
    if pool.cache_layout != "paged":
        return
    for entry in pool.cache_stats()["per_shard"]:
        assert entry["free_blocks"] + entry["mapped_blocks"] \
            + entry["spilled_blocks"] + 1 == entry["num_blocks"], entry
    for slot, blocks in pool._slot_blocks.items():
        s = pool._shard_of_slot(slot)
        assert all(pool._shard_of_block(b) == s for b in blocks), \
            (slot, s, blocks)
    for s, fl in enumerate(pool._free_by_shard):
        assert all(pool._shard_of_block(b) == s for b in fl)
        assert pool._shard_scratch(s) not in fl


MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("dp,mp", MESHES)
def test_paged_byte_identity_and_compile_counts(dp, mp, dtype):
    """Contract 1 for the paged layout: the sharded output equals the
    unsharded, same compile counts, partition exact every tick."""
    prompts = _prompts()
    ref_pool = _pool(dtype=dtype)
    want = ref_pool.generate(prompts, 8)
    ref_counts = ref_pool.compile_counts()

    pool = _pool(mesh=mesh(dp, mp), dtype=dtype)
    rids = [pool.submit(p, 8) for p in prompts]
    while pool.step():
        _check_partition(pool)
    got = [pool.collect(r)[0] for r in rids]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert pool.compile_counts() == ref_counts
    _check_partition(pool)
    stats = pool.cache_stats()
    assert stats["mapped_blocks"] == 0
    assert stats["mesh"] == {"dp": dp, "mp": mp, "devices": dp * mp,
                             "collective_quant": "none",
                             "collective_quant_scale": "block"}


def test_dense_byte_identity_dp_mp():
    """Contract 1 for the dense layout (no allocator: slot-axis and
    head-axis placement only)."""
    prompts = _prompts()
    want = _pool(layout="dense").generate(prompts, 8)
    for dp, mp in MESHES:
        got = _pool(mesh=mesh(dp, mp), layout="dense").generate(prompts, 8)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)


def test_mesh_validation():
    with pytest.raises(InvalidArgumentError, match="dp >= 1"):
        DecodeMesh(0, 1, devices=["cpu"])
    with pytest.raises(InvalidArgumentError, match="devices"):
        DecodeMesh(16, 16, devices=["cpu"] * 8)
    # dp must divide slots
    with pytest.raises(InvalidArgumentError, match="divide slots"):
        _pool(mesh=mesh(3, 1), slots=4)
    # mp must divide heads (4 heads, mp=8)
    with pytest.raises(InvalidArgumentError, match="num_heads"):
        _pool(mesh=mesh(1, 8), slots=4)
    # dp must divide num_blocks
    with pytest.raises(InvalidArgumentError, match="num_blocks"):
        _pool(mesh=mesh(2, 1), num_blocks=17)
    # a request must fit ONE shard's partition
    pool = _pool(mesh=mesh(2, 1), num_blocks=8)
    with pytest.raises(InvalidArgumentError, match="shard"):
        pool.submit(np.arange(1, 13, dtype=np.int32), 16)
    # mesh must be a DecodeMesh
    with pytest.raises(InvalidArgumentError, match="DecodeMesh"):
        GenerationPool(_fresh_model(), max_len=32, mesh="dp2",
                       device="cpu")


def test_multi_device_grid_refused_and_default_devices():
    """A grid over more than one device is refused with a typed error
    naming ROADMAP; ``devices=None`` takes CUDA cards and, short of them,
    names the co-located form."""
    with pytest.raises(UnimplementedError, match="ROADMAP"):
        DecodeMesh(2, 1, devices=["cpu", "cuda:0"])
    if torch.cuda.device_count() < 4:
        with pytest.raises(InvalidArgumentError,
                           match=r'devices=\["cuda:0"\] \* 4'):
            DecodeMesh(2, 2)
    # a mesh on another device than the pool's is refused
    with pytest.raises(InvalidArgumentError, match="mesh"):
        GenerationPool(_fresh_model(), max_len=32, slots=2, device="cpu",
                       mesh=DecodeMesh(2, 1, devices=["meta"] * 2))
    m = mesh(2, 2, collective_quant="int8")
    assert m.describe() == {"dp": 2, "mp": 2, "devices": 4,
                            "collective_quant": "int8",
                            "collective_quant_scale": "block"}
    assert m.cache_field_axes("k") == ("dp", "mp")
    assert m.cache_field_axes("state") == ("dp", None)
    assert m.cache_field_axes("limit") == ()


def test_shards_are_own_contiguous_tensors():
    """Each shard's K/V (and scales) is its own contiguous tensor at the
    local shape, the table holds shard-local block ids, and the axes come
    from the layouts' ``field_axes``."""
    pool = _pool(mesh=mesh(2, 2), dtype="int8")
    pool.submit(_prompts(1)[0], 4)
    pool.step()
    layer = pool._cache[0]
    assert isinstance(layer, ShardedCache) and (layer.dp, layer.mp) == (2, 2)
    seen = set()
    for row in layer.shards:
        for part in row:
            for t in (part.k, part.v, part.k_scale, part.v_scale):
                assert t.is_contiguous()
                assert t.untyped_storage().data_ptr() not in seen
                seen.add(t.untyped_storage().data_ptr())
            assert tuple(part.k.shape) == (pool._blocks_per_shard, 2, 4, 8)
            # the table rows are views of the whole-batch table
            assert part.table.data_ptr() in {
                layer.table[d * 2].data_ptr() for d in range(2)}
    (slot, blocks), = pool._slot_blocks.items()
    shard = pool._shard_of_slot(slot)
    row = layer.table[slot].tolist()
    assert row[:len(blocks)] == [b - shard * pool._blocks_per_shard
                                 for b in blocks]
    for name in ("paged", "dense", "recurrent"):
        lay = get_layout(name)
        for field in (("state", "index", "limit") if name == "recurrent"
                      else ("k", "v", "index")):
            assert lay.field_axes(field) \
                == pool.mesh.cache_field_axes(field)


def test_cache_stats_per_shard_and_mesh_totals():
    """Contract 5: per-shard entries sum to the mesh totals, and the
    per-device bytes divide by dp x mp."""
    pool = _pool(mesh=mesh(2, 2))
    rids = [pool.submit(p, 8) for p in _prompts()]
    pool.step()
    stats = pool.cache_stats()
    per_shard = stats["per_shard"]
    assert len(per_shard) == 2
    for key in ("free_blocks", "mapped_blocks", "reachable_bytes",
                "pool_bytes"):
        assert sum(e[key] for e in per_shard) == stats[key], key
    assert stats["pool_bytes_per_device"] == stats["pool_bytes"] // 4
    # the unsharded pool restates its totals as one shard
    flat = _pool().cache_stats()
    assert len(flat["per_shard"]) == 1
    assert flat["per_shard"][0]["pool_bytes"] == flat["pool_bytes"]
    for r in rids:
        pool.cancel(r)
    _check_partition(pool)


def test_lifecycle_cancel_preempt_resume_sharded():
    """Contract 3: preempt a victim on a dp-sharded pool, resume it
    shard-pinned, everything identical, no new key, partition exact at
    every tick."""
    prompts = _prompts()
    want = _pool().generate(prompts, 12)

    pool = _pool(mesh=mesh(2, 1))
    rids = [pool.submit(p, 12) for p in prompts]
    for _ in range(3):
        pool.step()
        _check_partition(pool)
    counts0 = pool.compile_counts()
    victim = rids[0]
    shard0 = pool._shard_of_slot(
        next(s for s, st in pool._active.items() if st.rid == victim))
    info = pool.preempt(victim)
    assert info["blocks_spilled"] >= 1
    assert pool._spilled[victim].shard == shard0
    _check_partition(pool)
    # spilled device copies stay in the victim's shard partition
    assert all(pool._shard_of_block(b) == shard0 for b in pool._spill_owner)
    while pool.step():
        _check_partition(pool)
    got = {r: pool.collect(r)[0] for r in rids}
    for r, w in zip(rids, want):
        np.testing.assert_array_equal(got[r], w)
    assert pool.compile_counts() == counts0
    assert pool.spill_stats()["preempts_total"] == 1
    assert pool.spill_stats()["resumes_total"] == 1


@pytest.mark.parametrize("dp,mp,num_blocks", [(2, 2, 14), (1, 2, 13)])
def test_preempt_reclaim_upload_resume_mp(dp, mp, num_blocks):
    """A victim whose device copies were reclaimed resumes through the
    host upload, which splits the all-heads host blocks over the mp
    shards: still identical.  The victim (5 blocks) and a peer (6) fill
    their shards; a higher-priority request (6) then needs the victim's
    spilled copies."""
    prompts = _prompts()
    want = _pool().generate(prompts, 12)
    pool = _pool(mesh=mesh(dp, mp), num_blocks=num_blocks)
    rids = [pool.submit(p, 12) for p in prompts[:2]]
    for _ in range(3):
        pool.step()
    pool.preempt(rids[0])
    rids.append(pool.submit(prompts[3], 12, priority=1))
    while pool.step():
        _check_partition(pool)
    for r, w in zip(rids, (want[0], want[1], want[3])):
        np.testing.assert_array_equal(pool.collect(r)[0], w)
    assert pool.spill_stats()["reclaims_total"] >= 1


def test_cancel_frees_into_owning_shard():
    pool = _pool(mesh=mesh(2, 1))
    rids = [pool.submit(p, 8) for p in _prompts()]
    pool.step()
    _check_partition(pool)
    for r in rids:
        pool.cancel(r)
    _check_partition(pool)
    stats = pool.cache_stats()
    assert stats["mapped_blocks"] == 0
    for e in stats["per_shard"]:
        assert e["free_blocks"] == e["num_blocks"] - 1


def test_prefix_sharing_sharded_hits_and_identity():
    """Prefix sharing on a dp-sharded pool: matches are shard-local,
    output identical to the unsharded sharing pool, and queue pressure
    produces real hits (one long-running anchor lands per shard)."""
    rng = np.random.RandomState(7)
    shared = rng.randint(1, CFG["vocab_size"], (8,)).astype("int32")
    prompts = [np.concatenate([
        shared, rng.randint(1, CFG["vocab_size"], (4,)).astype("int32")])
        for _ in range(8)]
    budgets = [16, 16] + [2] * 6

    def run(m):
        pool = GenerationPool(
            _fresh_model(), max_len=32, slots=4, buckets=[32],
            cache_layout="paged", block_size=4, prefill_chunk_tokens=8,
            prefix_sharing=True, mesh=m, device="cpu")
        rids = [pool.submit(p, n) for p, n in zip(prompts, budgets)]
        while pool.step():
            _check_partition(pool)
        return pool, [pool.collect(r)[0] for r in rids]

    _ref, want = run(None)
    pool, got = run(mesh(2, 1))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert pool.prefix_stats()["hits"] >= 2
    # the chunks ran over the 2x2 mesh too (every dp shard runs a chunk,
    # the owner through the slot's row)
    _pool2, got2 = run(mesh(2, 2))
    for w, g in zip(want, got2):
        np.testing.assert_array_equal(w, g)


def test_speculative_pool_sharded_identity():
    prompts = _prompts()
    draft_cfg = dict(CFG, num_layers=1)

    def spec_pool(m):
        target = _fresh_model()
        draft = TransformerLM(**draft_cfg, device="cpu", seed=1)
        return SpeculativePool(target, draft, max_len=32, spec_k=2, slots=4,
                               buckets=[16], cache_layout="paged",
                               block_size=4, mesh=m, device="cpu")

    want = spec_pool(None).generate(prompts, 8)
    pool = spec_pool(mesh(2, 2))
    got = pool.generate(prompts, 8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert 0.0 <= pool.acceptance_stats()["acceptance_rate"] <= 1.0
    # the draft shares the mesh: its slot cache is sharded too
    assert isinstance(pool._draft_cache[0], ShardedCache)


def _engine(m=None, **kw):
    return ServingEngine(_fresh_model(), max_len=32, slots=4, buckets=[16],
                         cache_layout="paged", block_size=4, max_retries=8,
                         mesh=m, device="cpu", **kw)


def test_engine_over_sharded_pool_and_gauges():
    """ServingEngine serves unchanged above a sharded pool, and the mesh
    gauges export per-shard resident bytes."""
    prompts = _prompts()
    ref = _engine()
    ref_streams = [ref.submit(p, 8) for p in prompts]
    while ref.pump(4):
        pass
    want = [s.result(timeout_s=0).tokens for s in ref_streams]

    eng = _engine(mesh(2, 2))
    streams = [eng.submit(p, 8) for p in prompts]
    while eng.pump(4):
        pass
    for s, w in zip(streams, want):
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE
        np.testing.assert_array_equal(st.tokens, w)
    snap = eng.metrics.snapshot()
    stats = eng.cache_stats()
    assert snap["serving_mesh_devices"] == 4
    assert snap["serving_kv_resident_bytes_per_shard"] == \
        stats["pool_bytes"] // 2
    assert snap["serving_kv_resident_bytes"] == stats["pool_bytes"]
    assert "serving_kv_reachable_bytes_max_shard" in snap
    # an unsharded engine's /metrics is unchanged (the gauges are gated)
    assert "serving_mesh_devices" not in ref.metrics.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_chaos_recovery_on_sharded_pool(seed):
    """Contract 4: seeded transient chaos on a dp-sharded engine drains,
    survivors identical, blocks reclaimed per shard, no new key."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(1, CFG["vocab_size"], (n,)).astype("int32")
               for n in (5, 9, 7, 4)]
    budgets = (6, 5, 7, 4)

    def drive(eng):
        streams = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        iters = 0
        while eng.pump(1):
            _check_partition(eng._pool)
            iters += 1
            assert iters < 500, "sharded chaos run failed to drain"
        return streams

    clean = _engine(mesh(2, 1))
    want = [s.result(timeout_s=0).tokens for s in drive(clean)]
    clean_counts = clean.compile_counts()

    eng = _engine(mesh(2, 1))
    plane = FaultPlane(chaos_seed=seed, chaos_p=0.08,
                       chaos_points=("pool.step", "pool.alloc_blocks",
                                     "stream.deliver"),
                       max_faults=6)
    with faults.injected(plane):
        streams = drive(eng)
    for s, w in zip(streams, want):
        st = s.result(timeout_s=0)
        assert st.state == RequestState.DONE, (seed, st.state, st.error)
        np.testing.assert_array_equal(st.tokens, w)
    stats = eng.cache_stats()
    assert stats["mapped_blocks"] == 0
    for e in stats["per_shard"]:
        assert e["free_blocks"] == e["num_blocks"] - 1
    assert eng.compile_counts() == clean_counts


# -- the port's own ----------------------------------------------------------

def test_session_over_mesh():
    """A DecodeSession over a mesh generates the unsharded session's
    tokens (its batch shards over dp when dp divides it), and its int8
    seam refuses a decode batch dp does not divide."""
    ids = np.stack(_prompts(2, seed=3)[:1] * 2)
    want = DecodeSession(_fresh_model(), max_len=32, buckets=[16],
                         device="cpu").generate(ids, 6)
    for dp, mp in MESHES:
        got = DecodeSession(_fresh_model(), max_len=32, buckets=[16],
                            device="cpu", cache_layout="paged",
                            block_size=4, mesh=mesh(dp, mp)).generate(ids, 6)
        np.testing.assert_array_equal(got, want)
    sess = DecodeSession(_fresh_model(), max_len=32, buckets=[16],
                         device="cpu", mesh=mesh(2, 2,
                                                 collective_quant="int8"))
    with pytest.raises(InvalidArgumentError, match="divisible by dp"):
        sess.generate(ids[:1], 4)


def test_refresh_weights_updates_mp_slices():
    """The mp weight slices are copies: ``refresh_weights`` copies the
    current parameters into them in place, and the pool then serves a
    fresh pool's tokens on the new weights."""
    prompts = _prompts()
    pool = _pool(mesh=mesh(1, 2))
    before = pool.generate(prompts, 6)
    parts = pool._model.encoder.layers[0].linear1.__dict__["_mesh_parts"][2]
    addr = [w.data_ptr() for w, _ in parts]
    other = _fresh_model(seed=5)
    pool._model.load_state_dict(other.state_dict())
    pool.refresh_weights()
    assert [w.data_ptr() for w, _ in parts] == addr
    got = pool.generate(prompts, 6)
    want = _pool(model=_fresh_model(seed=5)).generate(prompts, 6)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert any(not np.array_equal(a, b) for a, b in zip(before, got))


def test_column_parallel_lora_equals_unsharded():
    """A bank-attached column-parallel Linear under mp (each shard's
    ``lora_b`` columns, ``lora_a`` whole) and the row-parallel
    ``out_proj`` (its delta re-applied after the reduce) give the
    unsharded model's outputs; a bank row loaded after construction
    reaches every shard in place."""
    from paddle_tpu_torch.nn.layer.transformer import _column_linear

    def banked():
        m = _fresh_model()
        lora.attach_lora(m, 3, 4)
        lora.load_adapter(m, 1, lora.random_adapter(m, 1, scale=0.5))
        return m

    m = banked()
    pool = _pool(mesh=mesh(2, 2), model=m)
    lin = m.encoder.layers[0].self_attn.q_proj
    x = torch.randn(4, 1, 32, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    with torch.no_grad(), lora.adapter_ids(ids):
        whole = lin(x)
    parts = lin.__dict__["_mesh_parts"][2]
    with torch.no_grad():
        cols = [_column_linear(lin, x, w, b, ids, slice(m_ * 16,
                                                        (m_ + 1) * 16))
                for m_, (w, b) in enumerate(parts)]
    np.testing.assert_allclose(torch.cat(cols, -1).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)

    prompts = _prompts()
    want_pool = _pool(model=banked())
    rids = [want_pool.submit(p, 8, adapter=i % 3)
            for i, p in enumerate(prompts)]
    want = want_pool.run()
    lora.load_adapter(m, 2, lora.random_adapter(m, 2, scale=0.5))
    lora.load_adapter(want_pool._model, 2,
                      lora.random_adapter(want_pool._model, 2, scale=0.5))
    rids2 = [pool.submit(p, 8, adapter=i % 3) for i, p in enumerate(prompts)]
    got = pool.run()
    rids3 = [want_pool.submit(p, 8, adapter=i % 3)
             for i, p in enumerate(prompts)]
    want2 = want_pool.run()
    for a, b in zip(rids3, rids2):
        np.testing.assert_array_equal(want2[a], got[b])
    # adapter 2 was loaded after both pools existed: it changed tokens
    assert any(not np.array_equal(want[a], want2[b])
               for a, b in zip(rids, rids3))


def test_journal_refused_across_meshes_ptkv_crosses(tmp_path):
    """The fingerprint names the mesh: a journal written by a (2, 1)
    engine is refused by an unsharded one and the other way round.  A
    PTKV file holds every head and the mesh is a capacity key (the
    reference's rule, as for slots), so it adopts across meshes
    byte-identically."""
    def eng(m, name, **kw):
        return ServingEngine(_fresh_model(), max_len=32, slots=4,
                             buckets=[16], cache_layout="paged",
                             block_size=4, mesh=m, device="cpu",
                             journal_path=str(tmp_path / name), **kw)

    for writer, reader in ((mesh(2, 1), None), (None, mesh(2, 1))):
        name = "wal-%s.journal" % ("mesh" if writer is not None else "flat")
        a = eng(writer, name)
        a.submit(_prompts(1)[0], 4)
        a.pump(1)
        del a
        b = ServingEngine(_fresh_model(), max_len=32, slots=4, buckets=[16],
                          cache_layout="paged", block_size=4, mesh=reader,
                          device="cpu")
        with pytest.raises(FingerprintMismatchError, match="mesh"):
            b.restore(str(tmp_path / name))

    prompt = _prompts(1)[0]
    want = _pool().generate([prompt], 10)[0]
    spill = str(tmp_path / "spill")
    for src, dst in ((mesh(2, 2), None), (None, mesh(2, 2))):
        a = _pool(mesh=src, spill_tier="disk", spill_dir=spill)
        rid = a.submit(prompt, 10, request_id="r")
        for _ in range(4):
            a.step()
        st = next(s for s in a._active.values() if s.rid == rid)
        tokens = list(st.tokens)
        a.preempt(rid)
        a.detach_spilled(rid)
        b = _pool(mesh=dst, spill_tier="disk", spill_dir=spill)
        assert b.adopt_spill(rid, prompt, tokens, 10)
        while b.step():
            _check_partition(b)
        np.testing.assert_array_equal(b.collect(rid)[0], want)


# -- across the packages -----------------------------------------------------

def _pair(seed=0):
    pt.seed(seed)
    ref = RefLM(**CFG)
    port = TransformerLM(**CFG, device="cpu")
    load_reference_params(port, reference_arrays(ref))
    return ref, port


@pytest.mark.parametrize("dp,mp", [(2, 2), (1, 2)])
def test_reference_mesh_pool_matches(dp, mp):
    """The reference's mesh pool on the forced host devices and the
    port's on the same weights: greedy tokens equal under the margin gate,
    fingerprints equal."""
    ref, port = _pair()
    prompts = _prompts()
    ref_pool = RefPool(ref, max_len=32, slots=4, buckets=[16],
                       cache_layout="paged", block_size=4,
                       mesh=RefMesh(dp, mp))
    want = ref_pool.generate(prompts, 8)
    pool = _pool(mesh=mesh(dp, mp), model=port)
    got = pool.generate(prompts, 8)
    for p, g, w in zip(prompts, got, want):
        assert_greedy_equal(port, p, g, w, "mesh %dx%d" % (dp, mp))
    assert pool.config_fingerprint() == ref_pool.config_fingerprint()
    assert pool.compile_counts() == ref_pool.compile_counts()


def test_sharded_forward_logits_match_reference():
    """The port's sharded prefill forward (dp x mp shards of a 2-row batch
    through a mesh cache) gives the reference's uncached logits within
    LOGIT_TOL."""
    ref, port = _pair(seed=1)
    rng = np.random.RandomState(4)
    ids = rng.randint(1, CFG["vocab_size"], (2, 11)).astype("int32")
    want = ref_logits(ref, ids)
    for dp, mp in MESHES:
        m = mesh(dp, mp)
        m.place_weights(port)
        for layout in ("dense", "paged"):
            cache = m.build_cache(port, 2, 16, layout=layout, block_size=4)
            with torch.no_grad():
                got, _ = port(torch.from_numpy(ids.astype(np.int64)),
                              cache=cache)
            np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                                       rtol=0)


def test_convert_after_placement_matches_reference():
    """Reference parameters loaded into an already-placed model reach the
    mp slices (``load_reference_params`` refreshes them): the pool then
    decodes the reference pool's tokens."""
    pt.seed(3)
    ref = RefLM(**CFG)
    port = _fresh_model(seed=9)
    pool = _pool(mesh=mesh(1, 2), model=port)
    load_reference_params(port, reference_arrays(ref))
    prompts = _prompts()
    got = pool.generate(prompts, 8)
    want = RefPool(ref, max_len=32, slots=4, buckets=[16],
                   cache_layout="paged", block_size=4).generate(prompts, 8)
    for p, g, w in zip(prompts, got, want):
        assert_greedy_equal(port, p, g, w, "converted after placement")

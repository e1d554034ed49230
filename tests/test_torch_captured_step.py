"""The port's compiled-step contract (``jit/aot.py``, the session's and the
pool's steps) against the reference on the CPU.

- ``compile_counts()`` equals the reference's on the same traffic: the
  session's two steps over buckets, a plain pool, the chunked pool with
  prefix sharing (and ``cost_version()`` frozen under more traffic),
  preemption and resume, and the engine's pass-through.  These scenarios
  are the reference's own contract tests (``tests/test_decode.py``,
  ``tests/test_prefix_cache.py``, ``tests/test_scheduling.py``,
  ``tests/test_serving.py``) re-pointed at both packages.
- A captured step reads its tensors by address, so every tensor of the
  pool's cache and every static step buffer keeps its ``data_ptr()``
  through admission, finish, cancel, preemption, both resume paths,
  prefix-shared admission and ``reset()``.
- Greedy tokens equal the reference pool's under membership churn (EOS,
  cancel mid-run), on prompts whose top-2 logit margin clears the floor.
- The device sampler: greedy and ``top_k == 1`` rows give the argmax,
  draws stay in the top-k set and the nucleus, a row's token depends
  only on its own logits, config, seed and step, the empirical
  distribution over 4000 (seed, step) pairs lies within total variation
  0.05 of the filtered distribution, and a sampled pool request gives the
  same tokens whatever slot it lands in.

On the CPU a key is only a distinct shape: no graph exists here
(``tests/test_torch_cuda_kernels.py`` holds the captured steps on the
card).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.inference import GenerationPool as RefPool
from paddle_tpu.jit import DecodeSession as RefSession
from paddle_tpu.serving import ServingEngine as RefEngine
from torch_parity import MARGIN_FLOOR, build_pair, greedy_margin

from paddle_tpu_torch import (DecodeSession, GenerationPool,
                              InvalidArgumentError, ServingEngine)
from paddle_tpu_torch.jit.aot import AotFunction, shape_key
from paddle_tpu_torch.jit.decode import _filtered_probs, sample_logits_data

LAYOUTS = [pytest.param({}, id="dense"),
           pytest.param(dict(cache_layout="paged", block_size=8),
                        id="paged")]
CHUNKED = dict(cache_layout="paged", block_size=8, prefill_chunk_tokens=8,
               prefix_sharing=True)


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def _prompts(seed, lens, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


# -- the wrapper --------------------------------------------------------------
def test_shape_key_strings_and_cpu_counting():
    assert shape_key(np.zeros(8, np.int32)) == "8_int32"
    assert shape_key(torch.zeros(1, 512, dtype=torch.int32)) == "1x512_int32"
    assert shape_key(torch.zeros((), dtype=torch.float32)) == "scalar_float32"
    calls = []
    fn = AotFunction(lambda x: calls.append(x.shape) or x + 1, shape_key,
                     name="f", capture=True)
    for n in (3, 3, 3, 5):
        assert torch.equal(fn(torch.zeros(n)), torch.ones(n))
    # the private eager entry runs the step but counts no key
    fn._run_eager(torch.zeros(7))
    assert fn._cache_size() == fn.compiles == 2
    assert fn.graphs() == 0 and len(calls) == 5  # the CPU never captures


class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: "capture" runs
    the step once (as the real capture records it), a replay counts."""

    replays = 0

    def replay(self):
        _FakeGraph.replays += 1

    def pool(self):
        return (0, 1)


@pytest.fixture
def fake_capture(monkeypatch):
    """``AotFunction`` captures on the CPU with :class:`_FakeGraph`: the
    bookkeeping around a graph (keys, watched addresses, launch counts)
    runs as on the card."""
    import contextlib

    from paddle_tpu_torch.jit import aot

    monkeypatch.setattr(aot, "_on_cuda", lambda args: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_blas_handle", lambda: 0)
    _FakeGraph.replays = 0
    return aot


def test_moved_weights_drop_only_their_graphs(fake_capture):
    """F3's bookkeeping: a graph records the addresses of the tensors its
    owner watches; after a parameter is replaced, ``drop_moved`` drops the
    graph captured before (and not one captured after), the key's next
    call warms up eagerly and the one after captures again; the key
    count never moves.  A dtype change is refused unless allowed."""
    lin = torch.nn.Linear(4, 4)
    calls = []
    fn = AotFunction(lambda x: calls.append(x.shape) or lin(x), shape_key,
                     name="f", capture=True,
                     watch=lambda: list(lin.parameters()))
    a, b = torch.zeros(2, 4), torch.zeros(3, 4)
    fn(a), fn(a)  # warm-up, capture (+ one replay)
    assert fn.graphs() == 1 and _FakeGraph.replays == 1
    lin.weight = torch.nn.Parameter(lin.weight.detach().clone())  # moved
    fn(b), fn(b)  # key b captured after the move
    assert fn.graphs() == 2 and fn.compiles == 2
    assert fn.drop_moved() == ["2x4_float32"]
    assert fn.graphs() == 1 and fn.compiles == 2
    assert fn.drop_moved() == []  # nothing else moved
    n = len(calls)
    fn(a)  # the dropped key warms up again: an eager call
    assert len(calls) == n + 1 and fn.graphs() == 1
    fn(a)  # and captures again
    assert fn.graphs() == 2 and fn.compiles == 2
    lin.weight = torch.nn.Parameter(lin.weight.detach().double())
    with pytest.raises(InvalidArgumentError, match="watched tensor 0"):
        fn.drop_moved()
    assert sorted(fn.drop_moved(allow_retype=True)) == ["2x4_float32",
                                                        "3x4_float32"]
    assert fn.graphs() == 0 and fn.compiles == 2


def test_no_garbage_collection_while_capturing(fake_capture):
    """A graph freed by the cyclic collector during another capture would
    invalidate that capture: collection is off while a step is captured
    and back on after, also when the capture fails."""
    import gc

    seen = []

    def step(x):
        seen.append(gc.isenabled())
        if x.shape[0] == 2 and not gc.isenabled():
            raise RuntimeError("a host read while capturing")
        return x

    fn = AotFunction(step, shape_key, name="gc", capture=True)
    fn(torch.zeros(1)), fn(torch.zeros(1))  # warm-up, capture
    fn(torch.zeros(2))  # warm-up
    with pytest.raises(fake_capture.CaptureError, match="host read"):
        fn(torch.zeros(2))
    assert seen == [True, False, True, False] and gc.isenabled()


def test_replays_advance_k3_counts_by_dtype(fake_capture):
    """K3's wrappers count per dtype: the rise during a capture is taken
    back and re-added, per dtype, on every replay."""
    from paddle_tpu_torch.ops import flash_kernels as fk

    fwd = fk.flash_attention_forward_kernel

    def step(x):
        fwd.launches_by_dtype["bfloat16"] += 2  # what a launch records
        return x

    fn = AotFunction(step, shape_key, name="k3", capture=True)
    fk.reset_launch_counts()
    x = torch.zeros(2)
    for _ in range(4):  # warm-up, capture + replay, replay, replay
        fn(x)
    counts = fk.launch_counts_by_dtype()["flash_attention_forward_kernel"]
    assert counts == {"float32": 0, "bfloat16": 8}
    fk.reset_launch_counts()


def test_refresh_weights_checks_every_captured_step(pair):
    """``refresh_weights()`` runs the address check over the pool's
    capturing steps (the speculative pool's draft steps too); on the CPU
    none holds a graph, so nothing drops and serving goes on."""
    from paddle_tpu_torch.inference import SpeculativePool

    _, port = pair
    pool = GenerationPool(port, max_len=64, slots=2, buckets=[16],
                          device="cpu")
    spec = SpeculativePool(port, port, max_len=64, spec_k=2, slots=2,
                           buckets=[16], device="cpu")
    assert len(pool._captured_steps()) == 2
    assert len(spec._captured_steps()) == 6
    assert all(fn._watch is not None for fn in spec._captured_steps())
    for p in (pool, spec):
        before = p.compile_counts()
        p.refresh_weights()
        assert p.compile_counts() == before


# -- compile_counts() against the reference --------------------------------
@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_session_counts_match_reference(pair, layout_kw):
    ref, port = pair
    rs = RefSession(ref, max_len=64, buckets=[16], **layout_kw)
    ps = DecodeSession(port, max_len=64, buckets=[16], device="cpu",
                       **layout_kw)
    for ids, n in ((_prompts(1, (9,))[0], 5), (_prompts(2, (12,))[0], 3)):
        rs.generate(ids[None], n)
        ps.generate(ids[None], n)
        assert ps.compile_counts() == rs.compile_counts() \
            == {"prefill": 1, "decode": 1}


def test_bucketed_prefill_counts_match_reference(pair):
    ref, port = pair
    rs = RefSession(ref, max_len=64, buckets=[16, 32])
    ps = DecodeSession(port, max_len=64, buckets=[16, 32], device="cpu")
    for length, want in ((5, 1), (7, 1), (20, 2)):
        ids = _prompts(length, (length,))[0][None]
        rs.generate(ids, 3)
        ps.generate(ids, 3)
        assert ps.compile_counts() == rs.compile_counts() \
            == {"prefill": want, "decode": 1}, length


@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_plain_pool_counts_match_reference(pair, layout_kw):
    ref, port = pair
    prompts = _prompts(5, (5, 11, 7))
    kw = dict(max_len=64, slots=2, buckets=[16, 32], **layout_kw)
    rp = RefPool(ref, **kw)
    pp = GenerationPool(port, device="cpu", **kw)
    rp.generate(prompts, 6)
    pp.generate(prompts, 6)
    counts = pp.compile_counts()
    assert counts == rp.compile_counts()
    assert counts["pool_decode"] == 1 and counts["slot_insert"] == 1


def test_chunked_sharing_pool_counts_and_cost_version(pair):
    ref, port = pair
    kw = dict(max_len=96, slots=2, buckets=[64], **CHUNKED)
    rp = RefPool(ref, **kw)
    pp = GenerationPool(port, device="cpu", **kw)
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, 512, (16,)).astype(np.int32)
    for n in (3, 9, 21, 40):
        ids = np.concatenate([prefix, rng.randint(0, 512, (n,))
                              .astype(np.int32)])
        rp.generate([ids], 4)
        pp.generate([ids], 4)
        assert pp.compile_counts() == rp.compile_counts()
    assert pp.compile_counts() == {
        "prefill": 0, "decode": 0, "pool_decode": 1, "slot_insert": 0,
        "prefill_chunk": 1, "slot_admit": 1}
    version = pp.cost_version()
    assert version == sum(pp.compile_counts().values())
    pp.generate([prefix, np.concatenate([prefix, prefix])], 4)
    assert pp.cost_version() == version


def test_counts_unchanged_across_preempt_and_resume(pair):
    ref, port = pair
    p = _prompts(6, (5, 9, 7))
    kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
              block_size=8)
    counts = {}
    for name, cls, extra in (("ref", RefPool, {}),
                             ("port", GenerationPool, {"device": "cpu"})):
        plain = cls(ref if name == "ref" else port, **kw, **extra)
        for i, ids in enumerate(p):
            plain.submit(ids, 8, request_id=i)
        plain.run()
        pool = cls(ref if name == "ref" else port, **kw, **extra)
        for i, ids in enumerate(p):
            pool.submit(ids, 8, request_id=i)
        pool.step()
        pool.step()
        pool.preempt(0)
        pool.run()
        assert pool.spill_stats()["resumes_total"] == 1
        assert pool.compile_counts() == plain.compile_counts()
        counts[name] = pool.compile_counts()
    assert counts["port"] == counts["ref"]


def test_engine_passes_counts_through(pair):
    ref, port = pair
    prompts = _prompts(7, (5, 9, 13))
    kw = dict(max_len=64, slots=2, buckets=[16])
    re_ = RefEngine(ref, **kw)
    pe = ServingEngine(port, device="cpu", **kw)
    for eng in (re_, pe):
        streams = [eng.submit(p, 5) for p in prompts]
        while eng.pump(4):
            pass
        assert all(s.status.state == "DONE" for s in streams)
    counts = pe.compile_counts()
    assert counts == re_.compile_counts() == pe.pool.compile_counts()
    assert counts["prefill"] == 1 and counts["pool_decode"] == 1 \
        and counts["slot_insert"] == 1
    assert pe.cost_version() == pe.pool.cost_version() \
        == sum(counts.values())


# -- static buffers -----------------------------------------------------------
def _addresses(pool):
    tensors = [t for c in pool._cache for t in c if t is not None]
    tensors.append(pool._steps.data)
    if pool._chunk_in is not None:
        tensors.append(pool._chunk_in.data)
    return [t.data_ptr() for t in tensors]


def test_static_buffers_survive_every_pool_path(pair):
    # a tight chunked, sharing pool: preempt with a re-map resume, then a
    # competitor that reclaims a spilled copy (upload resume), prefix hits,
    # a cancel mid-run, a finish, and reset
    _, port = pair
    pool = GenerationPool(port, max_len=64, slots=2, num_blocks=10,
                          device="cpu", **CHUNKED)
    want = _addresses(pool)

    def check(what):
        assert _addresses(pool) == want, what

    # the reference scheduling test's drive: the second preempt's victim
    # loses a spilled block to the high-priority newcomer
    p = _prompts(12, (9, 13, 11, 40))
    for i in range(3):
        pool.submit(p[i], 8, request_id=i, priority=i)
    for _ in range(5):
        pool.step()
    check("admit")
    pool.preempt(min(st.rid for st in pool._active.values()))
    check("preempt")
    pool.submit(p[3], 6, request_id=3, priority=9)  # reclaims
    pool.step()
    pool.preempt(min(st.rid for st in pool._active.values()))
    while pool.step():
        pass
    spill = pool.spill_stats()
    assert spill["resumes_total"] == 2 and spill["reclaims_total"] >= 1
    assert spill["upload_bytes_total"] > 0
    check("re-map and upload resumes, finish")
    rng = np.random.RandomState(4)
    pre = rng.randint(0, 512, (16,)).astype(np.int32)
    pool.submit(np.concatenate([pre, p[0][:3]]), 12, request_id="a")
    for _ in range(3):
        pool.step()
    pool.submit(np.concatenate([pre, p[2][:5]]), 6, request_id="b")
    pool.step()
    assert pool.prefix_stats()["hits"] >= 1
    check("prefix-shared admission")
    pool.cancel("a")
    check("cancel")
    pool.run()
    pool.reset()
    check("reset")
    pool.generate([p[0]], 3)
    check("after reset")
    assert pool.compile_counts()["pool_decode"] == 1


@pytest.mark.parametrize("layout_kw", LAYOUTS)
def test_bucketed_insert_writes_in_place(pair, layout_kw):
    _, port = pair
    pool = GenerationPool(port, max_len=64, slots=2, buckets=[16],
                          device="cpu", **layout_kw)
    want = _addresses(pool)
    pool.submit(_prompts(8, (5,))[0], 4)
    pool.step()  # slot_insert: the prefilled row spliced in
    assert _addresses(pool) == want
    pool.run()
    pool.reset()
    assert _addresses(pool) == want
    assert all(int(t.abs().sum()) == 0 for c in pool._cache for t in c
               if t is not None and t.dtype != torch.int32)


# -- greedy tokens under churn ------------------------------------------------
def test_greedy_tokens_match_reference_under_churn(pair):
    ref, port = pair
    prompts = _prompts(9, (5, 11, 7, 3, 14, 9))
    kw = dict(max_len=64, slots=2, buckets=[16], cache_layout="paged",
              block_size=8)
    # the EOS id: a token the reference emits mid-way for request 0
    probe = RefPool(ref, **kw).generate(prompts[:1], 8)[0]
    kw["eos_id"] = int(probe[3])

    def drive(pool):
        for i, ids in enumerate(prompts):
            pool.submit(ids, 8, request_id=i)
        for _ in range(3):
            pool.step()
        pool.cancel(2)  # queued or mid-run
        out = pool.run()
        return out, {r: pool._finish_reasons.get(r) for r in out}

    want, _ = drive(RefPool(ref, **kw))
    got, _ = drive(GenerationPool(port, device="cpu", **kw))
    assert sorted(got) == sorted(want) and 2 not in got
    assert any(len(t) < 8 for t in want.values()), "EOS never fired"
    checked = 0
    for rid, toks in want.items():
        if greedy_margin(ref, prompts[rid], toks) < MARGIN_FLOOR:
            continue
        np.testing.assert_array_equal(got[rid], toks, err_msg=str(rid))
        checked += 1
    assert checked >= 3, "corpus too thin: %d requests" % checked


# -- the device sampler -------------------------------------------------------
def _sample(logits, temp, top_k, top_p, seed, step):
    n = logits.shape[0]

    def vec(x, dt):
        return np.broadcast_to(np.asarray(x, dt), (n,)).copy()

    return sample_logits_data(logits, vec(temp, np.float32),
                              vec(top_k, np.int32), vec(top_p, np.float32),
                              vec(seed, np.int64), vec(step, np.int64))


def test_sampler_greedy_topk_nucleus_and_purity():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(6, 40).astype(np.float32) * 2)
    temp = [0.0, 0.9, 0.9, 1.3, 0.7, 0.5]
    top_k = [0, 1, 5, 0, 8, 0]
    top_p = [1.0, 1.0, 1.0, 0.4, 0.8, 1.0]
    argmax = logits.argmax(-1)
    for step in range(50):
        seed = 11 + np.arange(6)
        tok = _sample(logits, temp, top_k, top_p, seed, step)
        assert tok.dtype == torch.int32
        assert tok[0] == argmax[0] and tok[1] == argmax[1]
        probs = _filtered_probs(logits[2:], torch.tensor(temp[2:]),
                                torch.tensor(top_k[2:]),
                                torch.tensor(top_p[2:]))
        for r in range(2, 6):
            assert probs[r - 2, int(tok[r])] > 0, (step, r)
        assert int(tok[2]) in set(torch.topk(logits[2], 5).indices.tolist())
        # purity: the same row alone, in another slot, beside other rows
        for r in range(6):
            other = torch.from_numpy(rng.randn(3, 40).astype(np.float32))
            other[1] = logits[r]
            alone = _sample(other, [0.3, temp[r], 1.0], [0, top_k[r], 3],
                            [1.0, top_p[r], 0.5], [5, seed[r], 6],
                            [step + 1, step, 2])
            assert int(alone[1]) == int(tok[r]), (step, r)


def test_sampler_distribution_within_tv_005():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(1, 12).astype(np.float32) * 1.5)
    cfg = dict(temp=0.8, top_k=8, top_p=0.9)
    n = 4000
    seeds = rng.randint(0, 2 ** 32, n, dtype=np.int64)
    steps = rng.randint(0, 10_000, n)
    rows = logits.expand(n, -1).contiguous()
    toks = _sample(rows, cfg["temp"], cfg["top_k"], cfg["top_p"], seeds,
                   steps).numpy()
    want = _filtered_probs(logits, torch.tensor([cfg["temp"]]),
                           torch.tensor([cfg["top_k"]]),
                           torch.tensor([cfg["top_p"]]))[0].numpy()
    got = np.bincount(toks, minlength=12) / n
    assert got[want == 0].sum() == 0
    tv = 0.5 * np.abs(got - want).sum()
    assert tv < 0.05, tv


def test_sampled_request_same_in_any_slot(pair):
    _, port = pair
    prompt = _prompts(10, (7,))[0]

    def run(fillers):
        pool = GenerationPool(port, max_len=64, slots=3, buckets=[16],
                              device="cpu")
        for i in range(fillers):  # greedy neighbours take the first slots
            pool.submit(_prompts(20 + i, (5,))[0], 10)
        pool.step()
        rid = pool.submit(prompt, 8, temperature=0.8, top_k=20, top_p=0.9,
                          seed=321)
        pool.step()
        slot = next(s for s, st in pool._active.items() if st.rid == rid)
        return pool.run()[rid], slot

    (a, slot_a), (b, slot_b) = run(0), run(2)
    assert slot_a != slot_b
    np.testing.assert_array_equal(a, b)

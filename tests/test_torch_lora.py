"""The port's multi-LoRA serving (``paddle_tpu_torch.nn.lora``): the
reference's ``tests/test_lora_sampling.py`` re-pointed at the port on the
CPU, plus the same inputs and weights through both packages.

Pinned here, as in the reference:

1. a MIXED batch (greedy + three sampled configs across adapters {0, 1,
   2}) gives the tokens of dedicated one-slot pools, with one step key
   each, and ``cost_version()`` holds still across steady mixed traffic;
2. a ``load_adapter`` hot swap adds no key and moves no cost version, and
   later requests on the row see the new fine-tune; ``unload_adapter``
   refuses while a request is pinned to the row, then zeroes it;
3. a SAMPLED adapter request preempts, spills to disk and resumes
   byte-identically, and a detached PTKV file adopts byte-identically on
   a second pool (sampling config and adapter riding the file's meta);
4. the fingerprint carries the bank geometry; a v1 journal restores
   through the upgrade triage on a bankless engine and is refused on a
   banked one;
5. the fleet's ``register_adapter`` covers every engine and later spawns;
6. typed refusals at admission, and a bank attached after the pool was
   built is not served.

Across the packages (the reference's ``random_adapter`` and the port's
draw the same arrays): ``apply_delta`` within 1e-5 and exactly zero on
id-0 rows; a bank-attached model's logits under mixed ids within 1e-4;
pool greedy tokens equal under the reference's margin gate; the
fingerprint dicts equal; a PTKV file with ``adapter=2`` written by either
package adopted by the other.
"""
import io
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import GenerationPool as RefPool
from paddle_tpu.models import TransformerLM as RefLM
from paddle_tpu.nn import lora as ref_lora
from torch_parity import SMALL, assert_greedy_equal, reference_arrays

from paddle_tpu_torch import GenerationPool, ServingEngine, TransformerLM
from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch.core.errors import (InvalidArgumentError,
                                          PreconditionNotMetError)
from paddle_tpu_torch.nn import lora
from paddle_tpu_torch.serving import ServingFleet
from paddle_tpu_torch.serving import log as slog
from paddle_tpu_torch.serving.journal import (MAGIC, FingerprintMismatchError,
                                              frame_record)

VOCAB = 128
# the port's own pools serve its own weights: sampled tokens are held by
# determinism inside the package, never against the reference's stream


def _model(seed=0, bank_rows=0, rank=4, load=True):
    m = TransformerLM(**SMALL, dropout=0.0, causal=True, device="cpu",
                      seed=seed)
    if bank_rows:
        lora.attach_lora(m, n_adapters=bank_rows, rank=rank)
        if load:
            for idx in range(1, bank_rows):
                lora.load_adapter(
                    m, idx, lora.random_adapter(m, seed=idx, scale=0.5))
    return m


@pytest.fixture(scope="module")
def banked():
    return _model(bank_rows=4)


def _pool(model, spill=None, slots=4, **over):
    kw = dict(max_len=64, slots=slots, buckets=[32], device="cpu")
    if spill is not None:
        kw.update(cache_layout="paged", block_size=8, spill_tier="disk",
                  spill_dir=str(spill))
    kw.update(over)
    return GenerationPool(model, **kw)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype("int32") for n in lens]


def _mixed(seed):
    """Greedy + three sampled configs across adapters {0, 1, 2}."""
    return [dict(),
            dict(temperature=0.8, seed=seed + 100),
            dict(temperature=1.1, top_k=12, seed=seed + 200, adapter=1),
            dict(temperature=0.6, top_p=0.9, seed=seed + 300, adapter=2)]


# -- 1. mixed batch == dedicated pools, one step key ---------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_batch_token_identical_to_dedicated_pools(banked, seed):
    prompts = _prompts(seed, (7, 19, 12, 9))
    configs = _mixed(seed)
    pool = _pool(banked)
    for i, (ids, cfg) in enumerate(zip(prompts, configs)):
        pool.submit(ids, 8, request_id="r%d" % i, **cfg)
    mixed = pool.run()
    counts = pool.compile_counts()
    assert counts["prefill"] == 1 and counts["pool_decode"] == 1
    for i, (ids, cfg) in enumerate(zip(prompts, configs)):
        dedicated = _pool(banked, slots=1)
        dedicated.submit(ids, 8, request_id="d", **cfg)
        np.testing.assert_array_equal(mixed["r%d" % i],
                                      dedicated.run()["d"])


def test_steady_mixed_traffic_never_moves_cost_version(banked):
    pool = _pool(banked)
    prompts = _prompts(3, (7, 19, 12, 9))
    for i, (ids, cfg) in enumerate(zip(prompts, _mixed(3))):
        pool.submit(ids, 8, request_id="w%d" % i, **cfg)
    pool.run()
    counts, cost = pool.compile_counts(), pool.cost_version()
    # the configs permuted across the slots: any config dependence of the
    # step would show here
    for i, (ids, cfg) in enumerate(zip(prompts, _mixed(3)[::-1])):
        pool.submit(ids, 8, request_id="x%d" % i, **cfg)
    pool.run()
    assert pool.compile_counts() == counts
    assert pool.cost_version() == cost


# -- 2. hot swap: a row write, never a new key ----------------------------

def test_hot_load_zero_compiles_and_new_weights_serve():
    model = _model(bank_rows=4)
    pool = _pool(model)
    ids = _prompts(0, (11,))[0]
    cfg = dict(temperature=0.9, seed=5, adapter=1)
    rid = pool.submit(ids, 8, **cfg)
    got_before = pool.run()[rid]
    counts, cost = pool.compile_counts(), pool.cost_version()
    bank = [p.data_ptr() for _, lin in lora.lora_linears(model)
            for p in (lin.lora_a, lin.lora_b)]
    pool.load_adapter(1, lora.random_adapter(model, seed=101, scale=1.0))
    rid = pool.submit(ids, 8, **cfg)
    got_after = pool.run()[rid]
    assert pool.compile_counts() == counts
    assert pool.cost_version() == cost
    # the rows were written in place: a captured step still reads them
    assert bank == [p.data_ptr() for _, lin in lora.lora_linears(model)
                    for p in (lin.lora_a, lin.lora_b)]
    assert np.any(got_before != got_after)


def test_unload_refuses_while_pinned_then_zeroes():
    model = _model(bank_rows=4)
    pool = _pool(model)
    ids = _prompts(1, (9,))[0]
    pool.submit(ids, 8, adapter=2)
    pool.step()
    with pytest.raises(PreconditionNotMetError):
        pool.unload_adapter(2)
    pool.run()
    pool.unload_adapter(2)
    rid = pool.submit(ids, 8, adapter=2)
    a = pool.run()[rid]
    rid = pool.submit(ids, 8)
    np.testing.assert_array_equal(a, pool.run()[rid])


# -- 3. sampled spill / resume / migration, byte-identical -----------------

def test_sampled_preempt_spill_resume_byte_identity(banked, tmp_path):
    prompts = _prompts(2, (7, 19, 12))
    subs = [(prompts[0], dict(temperature=1.0, seed=21, adapter=1)),
            (prompts[1], dict()),
            (prompts[2], dict(temperature=0.7, seed=22))]
    undisturbed = _pool(banked, spill=tmp_path / "a")
    for i, (ids, cfg) in enumerate(subs):
        undisturbed.submit(ids, 8, request_id="r%d" % i, **cfg)
    want = undisturbed.run()
    counts = undisturbed.compile_counts()

    victimized = _pool(banked, spill=tmp_path / "b")
    for i, (ids, cfg) in enumerate(subs):
        victimized.submit(ids, 8, request_id="r%d" % i, **cfg)
    victimized.step()
    victimized.step()
    info = victimized.preempt("r0")  # the SAMPLED adapter-1 request
    assert info["committed_tokens"] > 0
    got = victimized.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert victimized.compile_counts() == counts
    ss = victimized.spill_stats()
    assert ss["preempts_total"] >= 1 and ss["resumes_total"] >= 1


def test_sampled_adapter_ptkv_migration_byte_identity(banked, tmp_path):
    ids = _prompts(4, (13,))[0]
    cfg = dict(temperature=0.9, seed=31, adapter=2)
    reference = _pool(banked, spill=tmp_path / "spill")
    reference.submit(ids, 10, request_id="ref", **cfg)
    want = reference.run()["ref"]

    donor = _pool(banked, spill=tmp_path / "spill")
    committed = {}
    donor.on_token = (lambda rid, tok:
                      committed.setdefault(rid, []).append(tok))
    donor.submit(ids, 10, request_id="mig", **cfg)
    donor.step()
    donor.step()
    donor.preempt("mig")
    handoff = donor.detach_spilled("mig")
    assert handoff["rid"] == "mig" and handoff["spill_bytes"] > 0

    peer = _pool(banked, spill=tmp_path / "spill")
    assert peer.adopt_spill("mig", ids, committed["mig"], 10)
    np.testing.assert_array_equal(peer.run()["mig"], want)
    assert peer.spill_stats()["upload_bytes_total"] > 0
    # a bankless peer cannot address adapter 2: the file is not adopted
    donor.submit(ids, 10, request_id="mig2", **cfg)
    donor.step()
    donor.step()
    donor.preempt("mig2")
    donor.detach_spilled("mig2")
    bankless = _pool(_model(), spill=tmp_path / "spill")
    assert not bankless.adopt_spill("mig2", ids, committed["mig2"], 10)


# -- 4. fingerprint + v1 journal upgrade triage ----------------------------

def test_fingerprint_drops_global_sampling_carries_bank_geometry():
    base = _model()
    a = _pool(base, temperature=0.0)
    b = _pool(base, temperature=0.9, top_k=7, seed=5)
    fa, fb = a.config_fingerprint(), b.config_fingerprint()
    assert fa == fb
    assert fa["sampling"] == "per-request"
    assert "temperature" not in fa and "sampling_seed" not in fa
    assert fa["lora"] is None
    fp = _pool(_model(bank_rows=4, rank=4)).config_fingerprint()
    assert fp["lora"] == {"n_adapters": 4, "rank": 4}
    assert fp != fa


def _engine(model, tmp_path, journal=None, **over):
    kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
              block_size=8, spill_tier="disk",
              spill_dir=str(tmp_path / "spill"), device="cpu")
    kw.update(over)
    return ServingEngine(model, journal_path=journal, **kw)


def _drain(engine, bound=400):
    n = 0
    while engine.pump(1):
        n += 1
        assert n < bound, "engine failed to drain: wedged"


def _write_v1_journal(path, fp2, ids, max_new, committed):
    """A journal as an engine from before per-request sampling left it:
    the header carries pool-global sampling scalars, the admit record no
    ``sampling``/``adapter`` fields."""
    v1 = {k: v for k, v in fp2.items() if k not in ("sampling", "lora")}
    v1.update(temperature=0.7, top_k=5, top_p=0.9, sampling_seed=123)
    body = MAGIC + frame_record({"t": "header", "v": 1, "fingerprint": v1})
    body += frame_record({"t": "admit", "rid": "old",
                          "ids": [int(t) for t in ids],
                          "max_new": int(max_new), "priority": 0,
                          "tenant": None, "deadline_s": None, "ts": None})
    body += frame_record({"t": "commit", "toks": [["old", committed]]})
    with open(path, "wb") as f:
        f.write(body)


def test_journal_v1_upgrade_triage_replays_via_resubmit(tmp_path):
    model = _model()
    probe = _engine(model, tmp_path)
    fp2 = probe._pool.config_fingerprint()
    probe.shutdown(drain=False)
    ids = _prompts(5, (9,))[0]
    jpath = str(tmp_path / "v1.journal")
    _write_v1_journal(jpath, fp2, ids, 8, [3, 7])

    def restore_once(name):
        eng = _engine(model, tmp_path,
                      journal=str(tmp_path / (name + ".journal")))
        buf = io.StringIO()
        with slog.logging_to(buf):
            summary = eng.restore(jpath)
        streams = {rid: rec.stream for rid, rec in eng._live.items()}
        _drain(eng)
        ups = [json.loads(line) for line in buf.getvalue().splitlines()
               if json.loads(line)["event"] == "journal.upgrade"]
        st = streams["old"].result(timeout_s=0)
        eng.shutdown(drain=False)
        return summary, ups, st

    summary, ups, st = restore_once("a")
    assert summary["requests_replayed"] == 1
    assert ups and ups[0]["temperature"] == 0.7 and ups[0]["seed"] == 123
    assert st.state == "DONE"
    assert list(map(int, st.tokens))[:2] == [3, 7]
    _, _, st2 = restore_once("b")
    assert list(map(int, st2.tokens)) == list(map(int, st.tokens))


def test_journal_v1_any_other_mismatch_still_refuses(tmp_path):
    model = _model()
    probe = _engine(model, tmp_path)
    fp2 = probe._pool.config_fingerprint()
    probe.shutdown(drain=False)
    jpath = str(tmp_path / "v1bad.journal")
    _write_v1_journal(jpath, dict(fp2, max_len=128), _prompts(5, (9,))[0],
                      8, [3])
    eng = _engine(model, tmp_path, journal=str(tmp_path / "fresh.journal"))
    with pytest.raises(FingerprintMismatchError):
        eng.restore(jpath)
    eng.shutdown(drain=False)


def test_journal_v1_refused_on_banked_engine(tmp_path):
    probe = _engine(_model(), tmp_path)
    fp2 = probe._pool.config_fingerprint()
    probe.shutdown(drain=False)
    jpath = str(tmp_path / "v1.journal")
    _write_v1_journal(jpath, fp2, _prompts(5, (9,))[0], 8, [3])
    banked = _engine(_model(bank_rows=4), tmp_path,
                     journal=str(tmp_path / "fresh.journal"))
    with pytest.raises(FingerprintMismatchError):
        banked.restore(jpath)
    banked.shutdown(drain=False)


# -- 5. fleet adapter registry ----------------------------------------------

def test_fleet_register_adapter_broadcasts_and_covers_spawns(tmp_path):
    # bank attached, rows EMPTY: only the registry makes adapter-1 traffic
    # differ from the base model
    model = _model(bank_rows=4, load=False)
    weights = lora.random_adapter(model, seed=7, scale=0.5)
    prompts = _prompts(6, (9, 13, 11, 8, 15, 10))

    reference = _engine(model, tmp_path, slots=4)
    reference.load_adapter(1, weights)
    want = [reference.submit(p, 8, request_id="r%d" % i, temperature=0.8,
                             seed=40 + i, adapter=1)
            for i, p in enumerate(prompts)]
    _drain(reference)
    want = [list(map(int, s.status.tokens)) for s in want]
    reference.shutdown(drain=False)
    lora.unload_adapter(model, 1)

    def factory(engine_id, registry):
        return ServingEngine(model, metrics=registry, max_len=64, slots=2,
                             buckets=[32], cache_layout="paged",
                             block_size=8, spill_tier="disk",
                             spill_dir=str(tmp_path / "fs"), device="cpu")

    fleet = ServingFleet(factory, engines=1)
    fleet.register_adapter(1, weights)
    fleet._spawn_engine("test")  # a LATER spawn inherits the registry
    assert len(fleet._active_handles()) == 2
    assert fleet.adapters == (1,)
    streams = [fleet.submit(p, 8, temperature=0.8, seed=40 + i, adapter=1)
               for i, p in enumerate(prompts)]
    while fleet.pump(1):
        pass
    assert [list(map(int, s.status.tokens)) for s in streams] == want
    fleet.shutdown(drain=False)


# -- 6. admission-edge refusals ----------------------------------------------

def test_admission_edge_refusals(banked):
    pool = _pool(banked)
    ids = _prompts(0, (7,))[0]
    with pytest.raises(InvalidArgumentError):
        pool.submit(ids, 4, adapter=9)  # no such bank row
    with pytest.raises(InvalidArgumentError):
        pool.submit(ids, 4, adapter=-1)
    with pytest.raises(InvalidArgumentError):
        pool.submit(ids, 4, temperature=-0.5)
    with pytest.raises(InvalidArgumentError):
        pool.submit(ids, 4, temperature=1.0, top_p=0.0)
    bankless = _pool(_model())
    with pytest.raises(InvalidArgumentError):
        bankless.submit(ids, 4, adapter=1)  # no bank at all
    # nothing of a refused submit was kept
    assert pool.queue_depth == 0 and bankless.queue_depth == 0


def test_bank_attached_after_the_pool_is_not_served():
    model = _model()
    pool = _pool(model)
    ids = _prompts(8, (9,))[0]
    rid = pool.submit(ids, 6)
    want = pool.run()[rid]
    lora.attach_lora(model, n_adapters=3, rank=4)
    lora.load_adapter(model, 1, lora.random_adapter(model, seed=1,
                                                    scale=1.0))
    with pytest.raises(InvalidArgumentError, match="no LoRA bank"):
        pool.submit(ids, 6, adapter=1)
    # the old pool keeps serving the base model: no ids are ambient
    rid = pool.submit(ids, 6)
    np.testing.assert_array_equal(pool.run()[rid], want)
    # a pool built now serves the bank
    fresh = _pool(model)
    rid = fresh.submit(ids, 6, adapter=1)
    assert fresh.lora_config == (3, 4)
    assert np.any(fresh.run()[rid] != want)


def test_attach_and_load_refusals():
    model = _model(bank_rows=3, load=False)
    with pytest.raises(InvalidArgumentError, match="already attached"):
        lora.attach_lora(model, n_adapters=3, rank=4)
    with pytest.raises(InvalidArgumentError, match="n_adapters"):
        lora.attach_lora(_model(), n_adapters=1, rank=4)
    w = lora.random_adapter(model, seed=3)
    with pytest.raises(InvalidArgumentError, match="reserved identity"):
        lora.load_adapter(model, 0, w)
    name = next(iter(w))
    with pytest.raises(InvalidArgumentError, match="missing projection"):
        lora.load_adapter(model, 1, {k: v for k, v in w.items()
                                     if k != name})
    bad = dict(w)
    bad[name] = (w[name][0][:, :2], w[name][1])
    with pytest.raises(InvalidArgumentError, match="shapes"):
        lora.load_adapter(model, 1, bad)
    # a refused load wrote nothing
    assert all(float(p.detach().abs().sum()) == 0.0
               for _, lin in lora.lora_linears(model)
               for p in (lin.lora_a, lin.lora_b))
    assert lora.adapter_bank_bytes(model) == sum(
        p.numel() * 4 for _, lin in lora.lora_linears(model)
        for p in (lin.lora_a, lin.lora_b))


# -- across the packages ----------------------------------------------------

def _ref_banked(seed=0, bank_rows=4, rank=4):
    """(reference banked model, port model with its weights and bank)."""
    pt.seed(seed)
    ref = RefLM(**SMALL, dropout=0.0, causal=True)
    ref.eval()
    ref_lora.attach_lora(ref, n_adapters=bank_rows, rank=rank)
    port = TransformerLM(**SMALL, dropout=0.0, causal=True, device="cpu")
    lora.attach_lora(port, n_adapters=bank_rows, rank=rank)
    for idx in range(1, bank_rows):
        w_ref = ref_lora.random_adapter(ref, seed=idx, scale=0.5)
        w_port = lora.random_adapter(port, seed=idx, scale=0.5)
        # the same seeded draws in both packages, bit for bit, same keys
        assert list(w_ref) == list(w_port)
        for k in w_ref:
            for a, b in zip(w_ref[k], w_port[k]):
                np.testing.assert_array_equal(a, b)
        ref_lora.load_adapter(ref, idx, w_ref)
    load_reference_params(port, reference_arrays(ref))
    port.eval()
    return ref, port


@pytest.fixture(scope="module")
def xpair():
    return _ref_banked()


def test_apply_delta_matches_reference_and_id0_is_exact_zero():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 16).astype(np.float32)
    out = rng.randn(4, 3, 24).astype(np.float32)
    a = rng.randn(5, 16, 4).astype(np.float32)
    b = rng.randn(5, 4, 24).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    ids = np.array([0, 3, 1, 0], np.int32)
    want = np.asarray(ref_lora.apply_delta(
        pt.to_tensor(out), x, a, b, ids).value)
    got = lora.apply_delta(torch.from_numpy(out), torch.from_numpy(x),
                           torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(ids)).numpy()
    # deltas of magnitude ~10 summed in another order: fp32 rounding
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # id-0 rows add an exact zero: bit for bit the base output
    np.testing.assert_array_equal(got[[0, 3]], out[[0, 3]])


def test_banked_model_logits_match_reference(xpair):
    ref, port = xpair
    rng = np.random.RandomState(1)
    ids = rng.randint(0, VOCAB, (4, 12)).astype(np.int32)
    rows = np.array([0, 1, 2, 3], np.int32)
    with ref_lora.adapter_ids(pt.to_tensor(rows).value):
        want = np.asarray(ref(pt.to_tensor(ids)).value)
    with torch.no_grad(), lora.adapter_ids(torch.from_numpy(rows)):
        got = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    # fp32 through the same products in another summation order
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the adapters do move the logits (rows 1-3 against the base model)
    with torch.no_grad():
        base = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got[0], base[0])
    assert np.abs(got[1:] - base[1:]).max() > 1e-2


def test_pool_greedy_and_fingerprint_match_reference(xpair):
    ref, port = xpair
    prompts = _prompts(9, (7, 19, 12, 9))
    adapters = [0, 1, 2, 3]
    kw = dict(max_len=64, slots=4, buckets=[32], cache_layout="paged",
              block_size=8)
    rp = RefPool(ref, **kw)
    pp = GenerationPool(port, device="cpu", **kw)
    assert pp.config_fingerprint() == rp.config_fingerprint()
    assert pp.config_fingerprint()["lora"] == {"n_adapters": 4, "rank": 4}
    for i, (p, a) in enumerate(zip(prompts, adapters)):
        rp.submit(p, 8, request_id=i, adapter=a)
        pp.submit(p, 8, request_id=i, adapter=a)
    want, got = rp.run(), pp.run()
    for i, (p, a) in enumerate(zip(prompts, adapters)):
        # the margin gate reads the port's logits under the row's id
        with lora.adapter_ids(torch.tensor([a])):
            assert_greedy_equal(port, p, got[i], want[i], "adapter %d" % a)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ptkv_with_adapter_crosses_packages(xpair, tmp_path, writer):
    """A disk-spilled request on adapter 2 written by one package's pool is
    adopted by the other's (same fingerprint: same configuration) and
    finishes with the greedy tokens of an uninterrupted run."""
    ref, port = xpair
    kw = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
              block_size=8, spill_tier="disk", spill_dir=str(tmp_path))
    ids = _prompts(4, (13,))[0]
    plain = GenerationPool(port, device="cpu", **dict(kw, spill_tier="host",
                                                      spill_dir=None))
    plain.submit(ids, 10, request_id="u", adapter=2)
    want = plain.run()["u"]
    if writer == "reference":
        donor, adopter = RefPool(ref, **kw), GenerationPool(
            port, device="cpu", **kw)
    else:
        donor, adopter = GenerationPool(port, device="cpu", **kw), \
            RefPool(ref, **kw)
    committed = []
    donor.on_token = lambda rid, tok: committed.append(int(tok))
    donor.submit(ids, 10, request_id="mig", adapter=2)
    donor.step()
    donor.step()
    donor.preempt("mig")
    path = donor.detach_spilled("mig")["path"]
    with open(path, "rb") as f:
        assert f.read(4) == b"PTKV"
    assert adopter.adopt_spill("mig", ids, committed, 10)
    got = np.asarray(adopter.run()["mig"])
    assert list(got[:len(committed)]) == committed
    with lora.adapter_ids(torch.tensor([2])):
        assert_greedy_equal(port, ids, got, want, "adopted from " + writer)

"""The port stands alone: ``import paddle_tpu_torch`` pulls in neither JAX
nor the reference package, no source file of the port imports either,
and the entry points run on the card unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import (DecodeSession, GenerationPool, ServingEngine,
                              TransformerLM, UnavailableError, to_tensor)

PKG_DIR = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.ops.decode_kernels"
            ", paddle_tpu_torch.ops._build, paddle_tpu_torch.ops.flash_kernels"
            ", paddle_tpu_torch.optimizer, paddle_tpu_torch.jit.train_step"
            ", paddle_tpu_torch.nn.functional.loss, paddle_tpu_torch.nn.clip"
            ", paddle_tpu_torch.regularizer, paddle_tpu_torch.framework.engine"
            ", paddle_tpu_torch.tensor.creation, paddle_tpu_torch.autograd"
            ", paddle_tpu_torch.incubate.custom_op"
            ", paddle_tpu_torch.incubate.autograd"
            ", paddle_tpu_torch.incubate.operators"
            ", paddle_tpu_torch.ops.custom_kernels"
            ", paddle_tpu_torch.utils.cpp_extension"
            ", paddle_tpu_torch.amp, paddle_tpu_torch.core.flags"
            ", paddle_tpu_torch.core.amp_state"
            ", paddle_tpu_torch.framework.dispatch"
            ", paddle_tpu_torch.tensor.linalg"
            ", paddle_tpu_torch.profiler, paddle_tpu_torch.profiler.visual"
            ", paddle_tpu_torch.serving.metrics, paddle_tpu_torch.serving.slo"
            ", paddle_tpu_torch.serving.log, paddle_tpu_torch.serving.trace"
            ", paddle_tpu_torch.serving.faults"
            ", paddle_tpu_torch.serving.supervisor"
            ", paddle_tpu_torch.serving.http"
            ", paddle_tpu_torch.compat, paddle_tpu_torch.version"
            ", paddle_tpu_torch.sysconfig, paddle_tpu_torch.device"
            ", paddle_tpu_torch.hub, paddle_tpu_torch.hapi.hub"
            ", paddle_tpu_torch.utils.download, paddle_tpu_torch.reader"
            ", paddle_tpu_torch.dataset, paddle_tpu_torch.dataset.common"
            ", paddle_tpu_torch.dataset.cifar, paddle_tpu_torch.dataset.conll05"
            ", paddle_tpu_torch.dataset.flowers, paddle_tpu_torch.dataset.image"
            ", paddle_tpu_torch.dataset.imdb, paddle_tpu_torch.dataset.imikolov"
            ", paddle_tpu_torch.dataset.mnist"
            ", paddle_tpu_torch.dataset.movielens"
            ", paddle_tpu_torch.dataset.uci_housing"
            ", paddle_tpu_torch.dataset.voc2012"
            ", paddle_tpu_torch.dataset.wmt14, paddle_tpu_torch.dataset.wmt16"
            ", paddle_tpu_torch.text, paddle_tpu_torch.text.datasets"
            ", paddle_tpu_torch.text.tokenizer"
            ", paddle_tpu_torch.vision.datasets"
            ", paddle_tpu_torch.vision.datasets.flowers"
            ", paddle_tpu_torch.vision.datasets.folder"
            ", paddle_tpu_torch.vision.datasets.voc2012"
            ", paddle_tpu_torch.distributed.launch"
            ", paddle_tpu_torch.distributed.spawn"
            ", paddle_tpu_torch.distributed.ps_compat"
            ", paddle_tpu_torch.distributed.fleet.elastic"
            ", paddle_tpu_torch.distributed.fleet.utils.fs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r)\nprint(bad)\nsys.exit(1 if bad else 0)" % (FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_or_reference():
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                elif isinstance(node, ast.Call) and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str) \
                        and getattr(node.func, "attr",
                                    getattr(node.func, "id", "")) in (
                                        "import_module", "__import__"):
                    names = [node.args[0].value]
                offenders += ["%s:%d %s" % (os.path.relpath(path, REPO),
                                            node.lineno, n)
                              for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_entry_points_default_to_cuda(monkeypatch):
    kw = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
              max_position=16)
    model = TransformerLM(device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: TransformerLM(**kw),
                  lambda: DecodeSession(model, max_len=16),
                  lambda: GenerationPool(model, max_len=16),
                  lambda: ServingEngine(model, max_len=16),
                  lambda: to_tensor([1.0])):
        with pytest.raises(UnavailableError, match='device="cpu"'):
            build()
    # asked for explicitly, the CPU runs
    out = GenerationPool(model, max_len=16, slots=1, buckets=[8],
                         device="cpu").generate([np.arange(1, 4)], 2)
    assert out[0].shape == (2,)


def test_engine_loop_start_without_a_card_raises(monkeypatch):
    """The background loop never falls back to the CPU: without a card an
    engine built for the default device refuses before any loop exists,
    and one built for the CPU runs its loop there only because it was
    asked to."""
    model = TransformerLM(vocab_size=32, hidden_size=16, num_layers=1,
                          num_heads=2, max_position=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match='device="cpu"'):
        ServingEngine(model, max_len=16, slots=1, buckets=[8]).start()
    eng = ServingEngine(model, max_len=16, slots=1, buckets=[8],
                        device="cpu").start()
    try:
        st = eng.submit(np.arange(1, 4), 2).result(timeout_s=60.0)
        assert st is not None and st.new_tokens == 2
    finally:
        eng.shutdown()


def test_engine_loop_sets_the_pools_card(monkeypatch):
    """The current CUDA device is per thread: the loop thread sets the
    engine's card by index (``torch.cuda.set_device`` refuses a device
    without one) before its first tick."""
    from torch.cuda._utils import _get_device_index

    model = TransformerLM(vocab_size=32, hidden_size=16, num_layers=1,
                          num_heads=2, max_position=16, device="cpu")
    eng = ServingEngine(model, max_len=16, slots=1, buckets=[8],
                        device="cpu")
    assert eng._loop_device is None  # a CPU engine sets no card
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.append(_get_device_index(d)))
    eng._loop_device = 0
    eng.start()
    try:
        st = eng.submit(np.arange(1, 4), 2).result(timeout_s=60.0)
        assert st is not None and st.new_tokens == 2
    finally:
        eng.shutdown()
    assert seen == [0]


# -- the speculative and durability modules ----------------------------------
def test_new_modules_import_without_jax_or_reference():
    code = ("import sys, paddle_tpu_torch.jit.speculative"
            ", paddle_tpu_torch.inference.speculative"
            ", paddle_tpu_torch.serving.journal"
            ", paddle_tpu_torch.serving.transfer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "%r)\nprint(bad)\nsys.exit(1 if bad else 0)" % (FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_speculative_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from paddle_tpu_torch.inference import SpeculativePool
    from paddle_tpu_torch.jit import SpeculativeDecodeSession

    kw = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
              max_position=32)
    model = TransformerLM(device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
            lambda: SpeculativePool(model, model, max_len=16),
            lambda: SpeculativeDecodeSession(model, model, max_len=16),
            lambda: ServingEngine(model, max_len=16, draft_model=model),
            lambda: ServingEngine(model, max_len=16,
                                  journal_path=str(tmp_path / "j"))):
        with pytest.raises(UnavailableError, match='device="cpu"'):
            build()
    pool = SpeculativePool(model, model, max_len=16, slots=1, buckets=[8],
                           device="cpu")
    assert pool.generate([np.arange(1, 4)], 3)[0].shape == (3,)


def _chaos_run(ref, model, tmp_path, seed):
    """One chaos run of the durability seams in one package: a journaled
    engine over the disk tier (``journal.append``, ``spill.write``) and a
    prefill-only pool's exports (``xfer.write``), all under ONE seeded
    plane.  Returns the plane's injections, the engine's tokens and the
    exported-and-adopted tokens."""
    if ref:
        from paddle_tpu.inference import GenerationPool as Pool
        from paddle_tpu.serving import ServingEngine as Engine
        from paddle_tpu.serving import faults as fmod
        from paddle_tpu.serving.journal import JournalWriteError as JWE
        dev = {}
    else:
        from paddle_tpu_torch.serving import faults as fmod
        from paddle_tpu_torch.serving.journal import JournalWriteError as JWE
        Pool, Engine, dev = GenerationPool, ServingEngine, {"device": "cpu"}
    tag = "ref" if ref else "port"
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 128, (n,)).astype("int32")
               for n in (5, 9, 7, 4)]
    budgets = (6, 5, 7, 4)
    paged = dict(max_len=64, slots=2, buckets=[32], cache_layout="paged",
                 block_size=8)
    plane = fmod.FaultPlane(
        chaos_seed=seed, chaos_p=0.35,
        chaos_points=("journal.append", "spill.write", "xfer.write"),
        max_faults=8)
    eng = Engine(model, journal_path=str(tmp_path / (tag + ".journal")),
                 spill_tier="disk", spill_dir=str(tmp_path / (tag + "-s")),
                 **paged, **dev)
    streams = []
    exported = {}
    with fmod.injected(plane):
        for i, (p, n) in enumerate(zip(prompts, budgets)):
            for _attempt in range(12):
                try:
                    streams.append(eng.submit(p, n, request_id="r%d" % i))
                    break
                except JWE:
                    continue
        eng.pump(2)
        try:
            eng.preempt()
        except fmod.InjectedFaultError:
            pass
        ticks = 0
        while eng.pump(1):
            ticks += 1
            assert ticks < 400, "chaos run failed to drain"
        xdir = str(tmp_path / (tag + "-x"))
        pre = Pool(model, prefill_only=True, spill_tier="disk",
                   spill_dir=xdir, **paged, **dev)
        rids = [pre.submit(p, 6, request_id="x%d" % i)
                for i, p in enumerate(prompts[:3])]
        committed = {}
        guard = 0
        while len(exported) < len(rids):
            guard += 1
            assert guard < 100, "prefill tier failed to drain"
            pre.step()
            for rid in rids:
                if rid in exported or not pre.has_prefill_done(rid):
                    continue
                committed[rid] = [int(t) for t in
                                  pre._prefill_done[rid][1].tokens]
                for _attempt in range(12):
                    try:
                        exported[rid] = pre.export_kv(rid)
                        break
                    except fmod.InjectedFaultError:
                        continue
    assert set(exported) == set(rids)
    dec = Pool(model, spill_tier="disk", spill_dir=xdir, **paged, **dev)
    for rid, p in zip(rids, prompts):
        assert dec.adopt_spill(rid, p, committed[rid], 6)
    adopted = {rid: np.concatenate([committed[rid], toks])
               for rid, toks in dec.run().items()}
    streams_out = {s.request_id: np.asarray(s.result(timeout_s=0).tokens)
                   for s in streams}
    assert all(s.result(timeout_s=0).state == "DONE" for s in streams)
    return list(plane.injected), streams_out, adopted


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_durability_seams_hit_alike_in_both_packages(tmp_path, seed):
    """One chaos seed over ``journal.append``, ``spill.write`` and
    ``xfer.write`` injects at the same hits in the port and the reference
    (the seams fire at the same call sites), and both recover to the same
    greedy tokens (margin-gated)."""
    from torch_parity import SMALL, assert_greedy_equal, build_pair

    ref_model, port_model = build_pair(**SMALL)
    want = _chaos_run(True, ref_model, tmp_path, seed)
    got = _chaos_run(False, port_model, tmp_path, seed)
    assert got[0] == want[0]
    assert any(p == "journal.append" for p, _, _ in got[0])
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 128, (n,)).astype("int32")
               for n in (5, 9, 7, 4)]
    for i, p in enumerate(prompts):
        assert_greedy_equal(port_model, p, got[1]["r%d" % i],
                            want[1]["r%d" % i], what="r%d" % i)
    for i, p in enumerate(prompts[:3]):
        assert_greedy_equal(port_model, p, got[2]["x%d" % i],
                            want[2]["x%d" % i], what="x%d" % i)

"""A/B measurements on the card that ``chip_smoke.py`` does not make.

    python3 chip_ab.py decode OTHER_ROOT   # decode step: OTHER_ROOT vs this
    python3 chip_ab.py train OTHER_ROOT    # fp32 GPT step: OTHER_ROOT vs this
    python3 chip_ab.py spill               # preempt/resume packing
    python3 chip_ab.py http                # the engine lock's handover

``decode`` runs ``chip_smoke.profile_decode`` (the 24-layer GPT-1.3B
paged decode step, 8 slots at ~1k context) for two checkouts, each in a
fresh process whose imports resolve to that checkout, in the order
other, this, this, other; each process also times 5 x 10 plain ticks and
profiles 10 ticks with ``cProfile``.  A tree whose step is a captured
CUDA graph also reports the graph's device ms (CUDA events around each
replay) and the sampler's (null for a tree without them).  The step is mostly host time, and
the host's speed drifts within one run, so compare the two trees only
within one call and read the ``cProfile`` call counts beside the times.
Unpack the other tree with ``git archive <commit> | tar -x -C <dir>``
into a git-ignored directory of the checkout (``scratch_chip/``).

``train`` runs ``chip_smoke.train_gpt()`` (GPT-1.3B fp32, 24 layers,
2 x 2048, 1 warm-up and 5 timed steps, then one profiled step) for two
checkouts in the same order and fresh processes, and reports each run's
step times, the profiled step's device busy time and idle share, and a
``cProfile`` of one more step: the host's calls and seconds (the step
synchronizes at its end, so the seconds include the wait for the card).

``spill`` times the spill tier's packing at ``preempt_4l``'s fp32 shape
(4 layers x K/V, 16 blocks of 16 heads x 32 x 128, 33.5 MB), alternated
12 times each way: the preempt download (gather on the card, one
``.cpu()``) and the resume upload (gather on the host, one ``.to`` the
card, ``index_copy_`` per field), each with ``_gather_packed`` against
the packing it replaced (``index_select`` per part, then ``torch.cat``).

``http`` serves ``chip_smoke``'s main traffic (GPT-1.3B, 24 layers, 16
requests) over HTTP from the engine's background loop, as
``serve_http_24l`` does, four times in one process: with the engine's
FIFO lock, with ``threading.RLock`` in its place, again with the stdlib
lock, and again with the FIFO one.  Each run reports both waves'
tokens/s and the engine's and the clients' TTFT (a client's starts when
its request is sent, so it includes the wait for the engine lock).

Each prints one JSON line per result.  Needs one CUDA card.
"""
import json
import os
import subprocess
import sys
import time

_DECODE_CHILD = r'''
import cProfile, io, json, os, pstats, sys, time
import numpy as np, torch
root = os.path.abspath(sys.argv[1]); sys.path.insert(0, root); os.chdir(root)
import chip_smoke as cs
from paddle_tpu_torch import ServingEngine, TransformerLM, gpt_1p3b_config
from paddle_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
_build.load("decode_attention")
model = TransformerLM(**gpt_1p3b_config(), dropout=0.0, device="cuda", seed=0)
rng = np.random.RandomState(0)
prof = cs.profile_decode(model, rng)
eng = ServingEngine(model, max_len=2048, slots=8, device="cuda",
                    cache_layout="paged", block_size=32)
for _ in range(8):
    eng.submit(rng.randint(0, model.vocab_size, 1024), 100)
eng.pump(3)
assert eng.pool.active_count == 8
reps = []
for _ in range(5):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    eng.pump(10)
    torch.cuda.synchronize(); reps.append((time.perf_counter() - t0) * 100)
pr = cProfile.Profile(); pr.enable(); eng.pump(10); torch.cuda.synchronize()
pr.disable()
st = pstats.Stats(pr)
buf = io.StringIO()
pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(12)
while eng.pump(8):
    pass
print("RESULT " + json.dumps({"profile_decode": {k: prof.get(k) for k in (
    "wall_ms_per_step", "device_busy_ms_per_step", "device_idle_share",
    "graph_device_ms_per_step", "sampler_device_ms_per_step")},
    "ms_per_step_reps": reps, "cprofile_s_per_10_ticks": st.total_tt,
    "cprofile_calls_per_10_ticks": st.total_calls}))
print(buf.getvalue())
'''


_TRAIN_CHILD = r'''
import cProfile, json, os, pstats, sys
import torch
root = os.path.abspath(sys.argv[1]); sys.path.insert(0, root); os.chdir(root)
import chip_smoke as cs
from paddle_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.load("flash_attention")
host = {}
profile_step = cs._profile_step

def host_profiled(step, batch, *a, **kw):
    torch.cuda.synchronize()
    pr = cProfile.Profile(); pr.enable(); step(*batch)
    torch.cuda.synchronize(); pr.disable()
    st = pstats.Stats(pr)
    host.update(cprofile_s_per_step=st.total_tt,
                cprofile_calls_per_step=st.total_calls)
    return profile_step(step, batch, *a, **kw)

cs._profile_step = host_profiled
out = cs.train_gpt()
prof = out["profile"]
print("RESULT " + json.dumps(dict(
    {k: out[k] for k in ("step_ms_mean", "step_ms_p50", "warmup_step_ms",
                         "losses")},
    **{k: prof.get(k) for k in ("device_busy_ms_per_step",
                                "device_idle_share", "k3_ms_per_step")},
    **host)))
'''


def _ab(child: str, label: str, other: str) -> None:
    """Run ``child`` for ``other`` and this checkout, other, this, this,
    other, each in a fresh process, printing each RESULT line as JSON."""
    here = os.path.dirname(os.path.abspath(__file__))
    for name, root in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        r = subprocess.run([sys.executable, "-c", child, root],
                           capture_output=True, text=True, timeout=600)
        line = next((ln for ln in r.stdout.splitlines()
                     if ln.startswith("RESULT ")), None)
        if line is None:
            sys.stderr.write(r.stdout + r.stderr)
            raise SystemExit("%s A/B: the %s tree's run failed"
                             % (label, name))
        print(json.dumps({"tree": name, "root": root,
                          **json.loads(line[len("RESULT "):])}), flush=True)
        print(r.stdout.split(line, 1)[1], flush=True)


def _cat_pack(tensors, idx):
    """The packing ``_gather_packed`` replaced: each part selected on its
    own, then concatenated (two copies of the selection)."""
    import torch

    chunks, specs, off = [], [], 0
    for t in tensors:
        p = t.index_select(0, idx)
        b = p.contiguous().view(torch.uint8).reshape(-1)
        pad = -b.numel() % 8
        chunks.append(b)
        if pad:
            chunks.append(b.new_zeros(pad))
        specs.append((off, p.dtype, tuple(p.shape)))
        off += b.numel() + pad
    return torch.cat(chunks), specs


def spill_ab() -> None:
    import torch

    from paddle_tpu_torch.inference.generation import (_gather_packed,
                                                       _unpack)

    packs = {"cat": _cat_pack, "gather_packed": _gather_packed}
    g = torch.Generator(device="cuda").manual_seed(0)
    cache = [torch.randn(513, 16, 32, 128, device="cuda", generator=g)
             for _ in range(8)]
    blocks = torch.randperm(512, device="cuda", generator=g)[:16] + 1
    host = [torch.randn(16, 16, 32, 128) for _ in range(8)]
    sel = torch.arange(16)

    def download(pack):
        return pack(cache, blocks)[0].cpu()

    def upload(pack):
        flat, specs = pack(host, sel)
        for f, part in zip(cache, _unpack(flat.to("cuda"), specs)):
            f.index_copy_(0, blocks, part)

    for label, fn in (("preempt_download", download),
                      ("resume_upload", upload)):
        ms = {name: [] for name in packs}
        for rep in range(12):
            order = list(packs) if rep % 2 == 0 else list(packs)[::-1]
            for name in order:
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn(packs[name])
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t) * 1e3)
        print(json.dumps({"phase": label, "bytes": 8 * 16 * 16 * 32 * 128 * 4,
                          "ms": ms}), flush=True)
    a = download(_cat_pack)
    assert torch.equal(a, download(_gather_packed))


def http_ab() -> None:
    import threading

    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import TransformerLM, gpt_1p3b_config
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import engine as engine_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load("decode_attention")
    cfg = gpt_1p3b_config()
    model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
    pumped = {}
    run = cs.serve(model, np.random.RandomState(0), cs.MAIN_REQUESTS,
                   cs.MAIN_NEW_TOKENS, cfg["num_layers"],
                   "paged_decode_attention_kernel", keep=pumped,
                   cache_layout="paged", block_size=cs.MAIN_BLOCK)
    pumped.update(run=run, compile_counts=run["compile_counts"])
    locks = {"fifo": engine_mod._FairRLock, "stdlib": threading.RLock}
    try:
        for name in ("fifo", "stdlib", "stdlib", "fifo"):
            engine_mod._FairRLock = locks[name]
            out = cs.serve_http(model, cfg["num_layers"], pumped)
            print(json.dumps({"phase": "http", "lock": name,
                              "cold": out["cold"], "warm": out["warm"],
                              "pump": out["pump"]}), flush=True)
    finally:
        engine_mod._FairRLock = locks["fifo"]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["decode"] and len(argv) == 2:
        _ab(_DECODE_CHILD, "decode", os.path.abspath(argv[1]))
    elif argv[:1] == ["train"] and len(argv) == 2:
        _ab(_TRAIN_CHILD, "train", os.path.abspath(argv[1]))
    elif argv == ["spill"]:
        spill_ab()
    elif argv == ["http"]:
        http_ab()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

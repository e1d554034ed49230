#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``paddle_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
the port's CUDA kernels from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per
source, all started together), holds each kernel against its plain
PyTorch twin, and drives the port's two main paths:

- serving: the full-width GPT-1.3B ``TransformerLM`` (random weights from
  seed 0) through the ``ServingEngine`` on the paged cache, then a 4-layer
  model of the same widths on the dense cache and on the int8 paged cache;
  each run must go through the decode kernels K1/K2 and emit the argmax of
  an uncached forward;
- the pool's scheduler: the 24-layer model serves 16 requests sharing a
  1024-token prefix (arriving one a tick) three ways -- chunked prefill
  with prefix sharing, chunked prefill alone, the bucketed prefill --
  with every prompt chunk timed alone; sharing must hit and the tokens
  stay within the greedy limit.  Then the 4-layer model preempts two of
  eight decoding requests for two higher-priority ones, in fp32 and int8,
  once resuming by re-mapping the spilled blocks and once through the
  host upload after a reclaim; the tokens must equal an uninterrupted
  run's byte for byte;
- the compiled-step contract: every engine above serves its decode steps
  (and chunks) from one captured CUDA graph per step, held by
  ``compile_counts()``; ``captured_vs_eager`` runs 4 greedy and 4 sampled
  requests through the 4-layer pool's graph and through its private eager
  entry, whose tokens must be identical; a ``DecodeSession`` generates on
  the dense and the paged cache from its captured decode step;
- speculative decoding and crash durability: the 24-layer target served
  by a speculative pool with itself and with a 2-layer model as the draft
  (every verify chunk through K1 at Lq 5, the draft through K2), beside
  a plain pool on the same prompts; at 4 layers an int8 and a dense
  target and a ``SpeculativeDecodeSession``; the main traffic with and
  without a journal (fsync ms per tick); ``preempt_4l`` on the disk tier
  (PTKV write MB/s); and a child ``python3 chip_smoke.py --crash-child
  DIR`` killed with SIGKILL mid-decode, whose journal and spill
  directory a fresh engine restores to an uninterrupted run's tokens;
- training: the same GPT-1.3B at full width and depth for 6
  ``TrainStep``s (AdamW, global-norm clipping) on one repeated 2 x 2048
  batch, every attention forward and backward through the flash kernel K3,
  first in fp32, then in bf16 O2 mixed precision as the reference's GPT
  leg runs it (``amp.decorate`` O2 bf16, the loss under ``auto_cast``;
  every K3 launch bf16), each with one more step profiled and broken down
  by part of the step and aten op; then a BERT-base encoder on a ragged
  batch whose padding reaches K3 as key-padding lanes, in fp32 and O2
  bf16.  Small 2-layer models train on the card and on the CPU first, in
  both precisions, and their losses must agree;
- the custom-op door: the user kernel K4 (``scale_mul``) registered with
  a hand-written backward through ``incubate.register_custom_op``,
  differentiated eagerly (``.backward()``, ``grad`` with
  ``create_graph``, a ``PyLayer``) and trained by 3 ``TrainStep``s at the
  GPT-1.3B FFN activation's shape [2, 2048, 8192]; then host ops compiled
  by ``utils.cpp_extension`` and called with cuda tensors.

It then times each kernel at its main path's shape beside its plain twin,
its bound and the one PyTorch call that computes the same function
(``scaled_dot_product_attention``; for K4 ``torch.mul(x, y).mul_(2.0)``;
timed as a yardstick only, the port never calls it): K3 in fp32 and bf16,
with its tensor-core bound and the CUDA-core one; K1/K2 at the serving
shape in fp32 and int8, at one request, and at a short and a full
context, and at a verify chunk of 5 queries (K1/K2, per-row positions).
K1 is also held against its twin on tables whose rows alias one
prefix's blocks, for a decode step and for chunks of 4 and 8 queries.  After the build it prints ``ptxas -v``'s registers and spills
of every K1/K2 and K3 kernel (and fails if a decode kernel, or a D 64 or
D 128 K3 one, spills); after the timing, the kernels SDPA's fp32 forward
and backward launch.

Every phase raises on failure; the exit code is 0 only when all passed.
The second-to-last lines are the card's name and power limit and a JSON
object describing every kernel; the last line is a JSON object naming the
device.  Without a CUDA card, or without the package beside this file, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet), used for the bound_ms column
# and MFU: fp32 outside K3 runs on the CUDA cores, not the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# K3's products run on the tensor cores: fp32 as 3xTF32 (three TF32
# products at 495 TFLOP/s dense each), bf16 at 989 TFLOP/s dense
FP32_3XTF32_FLOPS_PER_S = 495e12 / 3
BF16_TC_FLOPS_PER_S = 989e12

MAIN_MAX_LEN = 2048
MAIN_SLOTS = 8
MAIN_BLOCK = 32
MAIN_REQUESTS = 16
MAIN_NEW_TOKENS = 64
SHORT_LAYERS = 4
SHORT_REQUESTS = 8
SHORT_NEW_TOKENS = 16
# the shared-prefix cell: a 1024-token prefix, a 32-256 token tail, 16
# requests arriving one a tick, 32 new tokens each, 256-token chunks
SHARED_PREFIX = 1024
SHARED_TAIL = (32, 256)
SHARED_REQUESTS = 16
SHARED_NEW_TOKENS = 32
SHARED_CHUNK = 256
# the preemption cell: one 480-token prompt per slot, 32 new tokens, two
# requests preempted after 8 ticks
PREEMPT_PROMPT = 480
PREEMPT_NEW_TOKENS = 32
PREEMPT_AFTER_TICKS = 8
# serve_http_24l / recover_4l / trace_24l: each HTTP socket's timeout; the
# tick at which recover_4l's transient step fault fires; the ticks each
# trace_24l measurement covers
HTTP_TIMEOUT_S = 300.0
RECOVER_FAULT_AFTER = 5
TRACE_TICKS = 10
# the speculative decoding and crash durability phases
SPEC_K = 4
VERIFY_LQ = SPEC_K + 1
SPEC_REQUESTS = 8
SPEC_PROMPT = 512
SPEC_NEW_TOKENS = 64
SPEC_DRAFT_LAYERS = 2
SPEC_SHORT_PROMPT = 256
SPEC_SHORT_NEW_TOKENS = 16
CRASH_SLOTS = 4
CRASH_NEW_TOKENS = 32
# kernel vs plain twin: fp32 (and int8, dequantized in fp32 by both) differ
# only by summation order; a bf16 output is rounded to bf16 by both
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# a greedy token's logit in the uncached fp32 forward must be within this
# of that position's max logit (fp32 cache: summation-order noise; int8
# cache: the quantization bound the repo's int8 logit test uses)
GREEDY_TOL = {"float32": 1e-3, "int8": 8e-2}
# K3 vs its plain twins: fp32 differs by summation order (5e-5 on the
# gradients, which sum over every query or key of the row); bf16 outputs
# and gradients are rounded to bf16 by both
FLASH_TOL = {"float32": (1e-5, 5e-5), "bfloat16": (2e-2, 2e-2)}
# at the training shapes the largest bf16 outputs and gradients may
# differ by two bf16 ulps: 2^-6 of the tensor's largest value
BF16_TWO_ULPS = 2.0 ** -6
# bf16 K3 O, dQ, dK and dV, element by element, beside the limits above:
# both sides round the output to bf16 (one ulp is at most 2^-7 of the
# value) and the kernel sums bf16-rounded P and dS (noise of a few 2^-9 of
# the row's typical size), so |got - want| <= 2^-6 (|want| + rms), the rms
# taken over the element's 64-row tile of its (batch, head) slice: the
# size of its neighbours, not of the tensor's largest value.  A key tile
# left out of O or a tile of dK/dV zeroed must give ratios above 1
# (checked on the card at the GPT shape, ``_check_bf16_limit``)
BF16_REL = 2.0 ** -6
BF16_TILE_ROWS = 64
# the training runs
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6  # 1 warm-up + 5 timed
# the small training check, card against CPU over 3 AdamW steps: fp32
# sums in another order on each side; in O2 bf16 both sides round the same
# products to bf16 and accumulate in fp32, and the loss averages the
# rounding of 2 x 255 or 4 x 200 positions
SMALL_TRAIN_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
BERT_BATCH, BERT_SEQ, BERT_STEPS = 8, 512, 3
# K4 at full width: the GPT-1.3B FFN activation at the training batch
CUSTOM_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 8192)
CUSTOM_STEPS = 3
# K4 vs its twin: both compute (x * y) * 2 in fp32 and round once to the
# input dtype (a bf16/f16 product is exact in fp32), so they agree bit for
# bit; the tolerance is 0
CUSTOM_TOL = 0.0


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int = 10) -> float:
    """Device ms per call of ``fns`` (one call each, on inputs that
    together exceed the 50 MB L2, so each call finds its K/V cold as a
    decode step does), captured ``reps`` times round in one CUDA graph and
    replayed: the host's dispatch of each call is out of the timing."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for f in fns:
                f()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / (reps * len(fns)))
    del graph
    torch.cuda.empty_cache()
    return best


# -- kernel cases -----------------------------------------------------------


def _quant(x):
    from paddle_tpu_torch.ops.flash_attention import quantize_kv

    return quantize_kv(x)


def paged_case(gen, b, h, d, bs, mb, lq, q_dtype, kv_dtype, bias=False,
               ctx=None):
    """K1 inputs: a shuffled (stale-looking) table over a pool whose
    scratch block is poisoned, per-row q_pos (with B > 1, row 0 sees no
    key unless ``ctx`` fixes every row's context) and an optional
    broadcast bias."""
    import torch

    dev = torch.device("cuda")
    nb = 1 + b * mb
    q = torch.randn(b, h, lq, d, device=dev, generator=gen).to(q_dtype)
    kp = torch.randn(nb, h, bs, d, device=dev, generator=gen)
    vp = torch.randn(nb, h, bs, d, device=dev, generator=gen)
    kp[0] = 1e4  # poisoned scratch: masked, never read into the softmax
    ks = vs = None
    if kv_dtype == torch.int8:
        kp, ks = _quant(kp)
        vp, vs = _quant(vp)
    else:
        kp, vp = kp.to(kv_dtype), vp.to(kv_dtype)
    table = (torch.randperm(nb - 1, device=dev, generator=gen)[:b * mb]
             .reshape(b, mb) + 1).to(torch.int32)
    s = mb * bs
    if ctx is None:
        qpos = torch.randint(0, s, (b, lq), device=dev, generator=gen)
        if b > 1:
            qpos[0] = -1
            # a row's table tail past its context points at scratch
            table[1, (int(qpos[1].max()) // bs) + 1:] = 0
    else:
        qpos = torch.full((b, lq), ctx - 1, device=dev)
    bi = (torch.randn(1, h, lq, s, device=dev, generator=gen) if bias
          else None)
    return dict(q=q, k_pool=kp, v_pool=vp, table=table,
                q_pos=qpos.to(torch.int32), sm_scale=d ** -0.5, k_scale=ks,
                v_scale=vs, bias=bi)


def dense_of(case):
    """The same inputs as a dense [B, H, S, D] cache (K2)."""
    tbl = case["table"].long()
    b, mb = tbl.shape
    _, h, bs, d = case["k_pool"].shape

    def g(x):
        return x[tbl].permute(0, 2, 1, 3, 4).reshape(b, h, mb * bs, d) \
            .contiguous()

    def gs(x):
        return None if x is None else \
            x[tbl].permute(0, 2, 1, 3).reshape(b, h, mb * bs).contiguous()

    return dict(q=case["q"], k=g(case["k_pool"]), v=g(case["v_pool"]),
                q_pos=case["q_pos"], sm_scale=case["sm_scale"],
                k_scale=gs(case["k_scale"]), v_scale=gs(case["v_scale"]),
                bias=case["bias"])


def _decode_parity(dk, case, label, tol):
    """K1 on ``case`` and K2 on its dense layout against their twins;
    returns {kernel name: max abs error}."""
    import torch

    errs = {}
    for name, kern, plain, args in (
            ("paged_decode_attention_kernel",
             dk.paged_decode_attention_kernel,
             dk.paged_decode_attention_plain, case),
            ("decode_attention_kernel", dk.decode_attention_kernel,
             dk.decode_attention_plain, dense_of(case))):
        got = kern(**args)
        torch.cuda.synchronize()
        want = plain(**args)
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(got).all())
        log("parity %-30s %s  max_abs_err=%.3g tol=%.0e %s"
            % (name, label, err, tol, "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("%s disagrees with its plain twin: %g > %g"
                                 % (name, err, tol))
        errs[name] = err
    return errs


def check_kernels():
    """Each kernel against its plain twin on the card: fp32/bf16/int8 x
    Lq in {1, 4, 8} at small shapes (stale tables, poisoned scratch, an
    empty row, bias), at the main path's shapes and at one request (B = 1,
    25 splits); then every row at a context on a split boundary and one
    either side, at full width.  Returns the max error at the main path's
    shape per kernel (K1's int8 one as ``paged_decode_attention_kernel_int8``)."""
    import torch

    from paddle_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(0)
    combos = [(torch.float32, torch.float32), (torch.float32, torch.int8),
              (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
              (torch.float32, torch.float16)]
    main = dict(b=MAIN_SLOTS, h=16, d=128, bs=MAIN_BLOCK,
                mb=MAIN_MAX_LEN // MAIN_BLOCK)
    shapes = [dict(b=3, h=2, d=16, bs=8, mb=4), main,
              dict(main, b=1)]
    main_err = {}
    for shape in shapes:
        for q_dt, kv_dt in combos:
            for lq in (1, 4, 8):
                case = paged_case(gen, lq=lq, q_dtype=q_dt, kv_dtype=kv_dt,
                                  bias=lq == 4, **shape)
                label = ("q=%-8s kv=%-8s Lq=%d B=%d H=%d D=%d bs=%d S=%d "
                         "bias=%s splits=%d"
                         % (str(q_dt)[6:], str(kv_dt)[6:], lq, shape["b"],
                            shape["h"], shape["d"], shape["bs"],
                            shape["bs"] * shape["mb"], lq == 4,
                            dk.num_splits(shape["b"], shape["h"],
                                          shape["bs"] * shape["mb"],
                                          shape["bs"])))
                errs = _decode_parity(dk, case, label,
                                      TOL[str(q_dt).split(".")[1]])
                if shape is main and q_dt == torch.float32 and lq == 1:
                    if kv_dt == torch.float32:
                        main_err.update(errs)
                    elif kv_dt == torch.int8:
                        main_err["paged_decode_attention_kernel_int8"] = \
                            errs["paged_decode_attention_kernel"]
    # the speculative verify's shape: Lq = spec_k + 1 = 5 queries per row
    # at the row's own positions idx + j (every row starts elsewhere, one
    # at the cache's last positions), fp32 and int8, at full width
    for kv_dt, suffix in ((torch.float32, ""), (torch.int8, "_int8")):
        case = paged_case(gen, lq=VERIFY_LQ, q_dtype=torch.float32,
                          kv_dtype=kv_dt, ctx=MAIN_MAX_LEN, **main)
        case["q_pos"] = verify_qpos(gen, MAIN_SLOTS, MAIN_MAX_LEN)
        errs = _decode_parity(dk, case, "verify Lq=%d kv=%s per-row q_pos"
                              % (VERIFY_LQ, str(kv_dt)[6:]), TOL["float32"])
        for name, err in errs.items():
            main_err[name + "_verify" + suffix] = err
    # split edges at full width: 3 splits of whole 32-key chunks, so at a
    # context of 960 every span is full, at 961 the last one holds 1 key
    splits = dk.num_splits(MAIN_SLOTS, 16, MAIN_MAX_LEN, MAIN_BLOCK)
    edge = splits * 32 * 10
    for kv_dt in (torch.float32, torch.int8):
        for ctx in (edge - 1, edge, edge + 1):
            case = paged_case(gen, lq=1, q_dtype=torch.float32,
                              kv_dtype=kv_dt, ctx=ctx, **main)
            _decode_parity(dk, case, "split edge kv=%s ctx=%d splits=%d"
                           % (str(kv_dt)[6:], ctx, splits), TOL["float32"])
    return main_err


def verify_qpos(gen, b, s):
    """[B, VERIFY_LQ] int32 query positions of a verify chunk: row r's
    chunk starts at its own random index, row 0's ends at the cache's
    last position."""
    import torch

    start = torch.randint(0, s - VERIFY_LQ + 1, (b,), device="cuda",
                          generator=gen)
    start[0] = s - VERIFY_LQ
    return (start[:, None] + torch.arange(VERIFY_LQ, device="cuda")[None]) \
        .to(torch.int32)


def check_aliased_tables():
    """K1 against its twin on tables whose rows alias physical blocks, as
    prefix sharing maps them: every row's first 32 logical blocks (a
    1024-token prefix) name the same blocks, the rest are the row's own.
    At the main shape (8 rows x 16 heads x D 128, block 32), fp32 and
    int8, for a decode step (Lq 1) and for the chunks Lq in {4, 8} with
    per-row positions starting mid-block.  Returns the max errors."""
    import torch

    from paddle_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(3)
    mb = MAIN_MAX_LEN // MAIN_BLOCK
    shared = 1024 // MAIN_BLOCK
    errs = {}
    for kv_dt in (torch.float32, torch.int8):
        for lq in (1, 4, 8):
            case = paged_case(gen, MAIN_SLOTS, 16, 128, MAIN_BLOCK, mb, lq,
                              torch.float32, kv_dt, ctx=MAIN_MAX_LEN)
            table = case["table"]
            table[:, :shared] = table[0, :shared]
            # row b's chunk starts mid-block past the shared prefix
            start = 1024 + 5 + 37 * torch.arange(MAIN_SLOTS, device="cuda")
            case["q_pos"] = (start[:, None] + torch.arange(
                lq, device="cuda")[None]).to(torch.int32)
            label = ("aliased table kv=%s Lq=%d B=%d shared blocks=%d"
                     % (str(kv_dt)[6:], lq, MAIN_SLOTS, shared))
            got = dk.paged_decode_attention_kernel(**case)
            torch.cuda.synchronize()
            want = dk.paged_decode_attention_plain(**case)
            err = (got - want).abs().max().item()
            ok = err <= TOL["float32"] and bool(torch.isfinite(got).all())
            log("parity %-30s %s  max_abs_err=%.3g tol=%.0e %s"
                % ("paged_decode_attention_kernel", label, err,
                   TOL["float32"], "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("K1 disagrees with its plain twin on "
                                     "an aliased table: %g" % err)
            errs[label] = err
    return errs


# -- serving runs ----------------------------------------------------------


def greedy_gap(model, prompt, tokens):
    """Largest (max logit - logit of the emitted token) over the emitted
    positions, from one uncached forward over prompt + tokens."""
    import torch

    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits = model(torch.from_numpy(seq)[None].cuda())[0]
    steps = logits[len(prompt) - 1:].float()
    chosen = steps.gather(1, torch.from_numpy(tokens.astype(np.int64))
                          .cuda()[:, None])[:, 0]
    return float((steps.max(dim=1).values - chosen).max())


def serve(model, rng, n_requests, new_tokens, n_layers, kernel, keep=None,
          **kw):
    """Serve ``n_requests`` greedy prompts of 128-1536 tokens through a
    fresh engine; returns the run's metrics.  The kernel launch counts are
    set to 0 just before the requests are driven and read just after.
    ``keep`` (a dict) receives the warm-up and main prompts and their
    tokens, for a later run of the same traffic."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.ops import decode_kernels as dk

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", **kw)
    vocab = model.vocab_size
    # warm-up request: first cuBLAS calls, the kernel library load, and
    # the decode step's eager warm-up and capture (its first two calls)
    warmup = rng.randint(0, vocab, 64)
    warmup_tokens = engine.submit(warmup, 3).result().tokens
    lens = rng.randint(128, 1537, n_requests)
    prompts = [rng.randint(0, vocab, int(n)).astype(np.int32) for n in lens]
    pool = engine.pool
    steps0, prefills0 = pool.decode_steps_total, pool.prefills_total
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    streams = [engine.submit(p, new_tokens) for p in prompts]
    decode_tick_ms = []
    while True:
        n_prefill = pool.prefills_total
        ts = time.perf_counter()
        more = engine.pump(1)
        dt = (time.perf_counter() - ts) * 1e3
        if pool.prefills_total == n_prefill:
            decode_tick_ms.append(dt)
        if not more:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dk.launch_counts()
    steps = pool.decode_steps_total - steps0
    statuses = [s.status for s in streams]
    for st in statuses:
        assert st is not None and st.state == "DONE", st
        toks = np.asarray(st.tokens)
        assert toks.shape == (new_tokens,), toks.shape
        assert toks.min() >= 0 and toks.max() < vocab
    other = [k for k in counts if k != kernel]
    assert counts[kernel] == n_layers * steps, (counts, steps)
    assert counts[kernel] > 0 and all(counts[k] == 0 for k in other), counts
    compiled = engine.compile_counts()
    assert compiled["pool_decode"] == 1 and pool._decode_fn.graphs() == 1, \
        compiled
    gaps = [greedy_gap(model, prompts[i], np.asarray(statuses[i].tokens))
            for i in (int(np.argmin(lens)), int(np.argmax(lens)))]
    tol = GREEDY_TOL[kw.get("cache_dtype", "float32")]
    assert max(gaps) <= tol, (gaps, tol)
    ttft = sorted(st.ttft_s * 1e3 for st in statuses)
    if keep is not None:
        keep.update(warmup=warmup, warmup_tokens=list(warmup_tokens),
                    prompts=prompts,
                    tokens=[list(st.tokens) for st in statuses])
    return {
        "requests": n_requests, "prompt_tokens": int(lens.sum()),
        "new_tokens": n_requests * new_tokens,
        "prefills": pool.prefills_total - prefills0, "decode_steps": steps,
        "launches": counts, "launches_per_decode_step": counts[kernel] / steps,
        "ttft_ms_p50": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
        "decode_step_ms_mean": float(np.mean(decode_tick_ms)),
        "decode_step_ms_p50": float(np.median(decode_tick_ms)),
        "tokens_per_s": n_requests * new_tokens / wall, "wall_s": wall,
        "greedy_max_gap": max(gaps), "greedy_tol": tol,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "compile_counts": compiled,
    }


def shared_prefix_traffic(vocab):
    """The shared-prefix cell's prompts: one 1024-token prefix from numpy
    seed 0 and a unique tail of 32-256 tokens per request."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, vocab, SHARED_PREFIX).astype(np.int32)
    tails = rng.randint(SHARED_TAIL[0], SHARED_TAIL[1] + 1, SHARED_REQUESTS)
    return [np.concatenate([prefix, rng.randint(0, vocab, int(n))
                            .astype(np.int32)]) for n in tails]


def drive_shared_prefix(engine, prompts):
    """Submit ``prompts`` one a tick (32 greedy tokens each) and pump the
    engine until every request is done; returns the streams, the times of
    the ticks that ran no prompt work (decode steps) and the wall time."""
    import torch

    pool = engine.pool

    def prompt_work():
        return pool.prefills_total + pool.prefix_stats()[
            "prefill_chunks_total"]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams, decode_tick_ms = [], []
    while True:
        if len(streams) < len(prompts):
            streams.append(engine.submit(prompts[len(streams)],
                                         SHARED_NEW_TOKENS))
        n_work = prompt_work()
        ts = time.perf_counter()
        more = engine.pump(1)
        dt = (time.perf_counter() - ts) * 1e3
        if prompt_work() == n_work:
            decode_tick_ms.append(dt)
        if not more and len(streams) == len(prompts):
            break
    torch.cuda.synchronize()
    return streams, decode_tick_ms, time.perf_counter() - t0


def serve_shared_prefix(model, prompts, n_layers, **kw):
    """Serve ``prompts`` through a fresh paged engine built with ``kw``;
    returns the run's metrics and tokens.  The first pass is the measured
    one: nothing is wrapped, and the launch counts are set to 0 just
    before it and read just after.  A second pass of the same traffic on
    the same engine times every prompt-work call (a chunk, or a bucketed
    prefill) alone on the host clock, with ``torch.cuda.synchronize()`` on
    both sides; those syncs stall the host, so that pass gives only the
    prompt-work times."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.ops import decode_kernels as dk

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           cache_layout="paged", block_size=MAIN_BLOCK,
                           device="cuda", **kw)
    pool = engine.pool
    vocab = model.vocab_size
    # warm-up request (a full chunk and a part one, then two decode
    # steps): first cuBLAS calls at these shapes, and each captured step's
    # warm-up and capture
    engine.submit(np.arange(SHARED_CHUNK + SHARED_TAIL[0]) % vocab,
                  3).result()
    engine.reset_prefix_stats()
    steps0 = pool.decode_steps_total
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    streams, decode_tick_ms, wall = drive_shared_prefix(engine, prompts)
    counts = dk.launch_counts()
    steps = pool.decode_steps_total - steps0
    tokens = []
    for st in (s.status for s in streams):
        assert st is not None and st.state == "DONE", st
        toks = np.asarray(st.tokens)
        assert toks.shape == (SHARED_NEW_TOKENS,), toks.shape
        assert toks.min() >= 0 and toks.max() < vocab
        tokens.append(toks)
    k1 = counts["paged_decode_attention_kernel"]
    assert k1 == n_layers * steps and k1 > 0, (counts, steps)
    assert all(n == 0 for k, n in counts.items()
               if k != "paged_decode_attention_kernel"), counts
    compiled = engine.compile_counts()
    assert compiled["pool_decode"] == 1 and pool._decode_fn.graphs() == 1, \
        compiled
    if pool.prefill_chunk_tokens is not None:
        assert compiled["prefill_chunk"] == 1 \
            and pool._chunk_fn.graphs() == 1, compiled
    ttft = sorted(s.status.ttft_s * 1e3 for s in streams)
    stats = engine.prefix_stats()

    work_ms, work_tokens = [], []

    def timed(fn, tokens_of):
        def call(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            work_ms.append((time.perf_counter() - t) * 1e3)
            work_tokens.append(tokens_of(*a))
            return out
        return call

    if pool.prefill_chunk_tokens is not None:
        pool._prefill_chunk = timed(pool._prefill_chunk,
                                    lambda toks, slot, start, n, s: n)
    else:
        pool._session.prefill = timed(pool._session.prefill,
                                      lambda ids, s: ids.shape[1])
    timed_streams, _, timed_wall = drive_shared_prefix(engine, prompts)
    timed_ttft = sorted(s.status.ttft_s * 1e3 for s in timed_streams)
    out = {
        "requests": len(prompts),
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "new_tokens": len(prompts) * SHARED_NEW_TOKENS,
        "prefill_chunk_tokens": kw.get("prefill_chunk_tokens"),
        "prefix_sharing": bool(kw.get("prefix_sharing")),
        "decode_steps": steps, "k1_launches": k1,
        "compile_counts": compiled,
        "ttft_ms_p50": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
        "decode_step_ms_p50": float(np.median(decode_tick_ms)),
        "tokens_per_s": len(prompts) * SHARED_NEW_TOKENS / wall,
        "wall_s": wall,
        "prefix_hits": stats["hits"], "prefix_hit_rate": stats["hit_rate"],
        "prefix_tokens_matched": stats["tokens_matched"],
        "prompt_work_calls": len(work_ms),
        "prompt_work_tokens": int(sum(work_tokens)),
        "prompt_work_ms_total": float(sum(work_ms)),
        "prompt_work_ms_per_call_p50": float(np.median(work_ms)),
        "prompt_work_ms_per_call_mean": float(np.mean(work_ms)),
        "prompt_work_ms_per_token": float(sum(work_ms) / sum(work_tokens)),
        # the timing pass's own end-to-end numbers, beside the measured
        # pass's in the same run: what the synchronize() calls cost
        "timed_pass_ttft_ms_p50": timed_ttft[len(timed_ttft) // 2],
        "timed_pass_ttft_ms_max": timed_ttft[-1],
        "timed_pass_tokens_per_s": len(prompts) * SHARED_NEW_TOKENS
        / timed_wall,
    }
    del engine
    torch.cuda.empty_cache()
    return out, tokens


def shared_prefix_runs(model, n_layers):
    """The shared-prefix cell three ways on the same traffic: chunking
    with sharing, chunking alone, the bucketed prefill.  Sharing must hit,
    and every token that differs between the runs must stay within
    ``greedy_gap``'s limit, as must two requests of each run."""
    prompts = shared_prefix_traffic(model.vocab_size)
    runs, tokens = {}, {}
    for name, kw in (
            ("sharing", dict(prefill_chunk_tokens=SHARED_CHUNK,
                             prefix_sharing=True)),
            ("chunked", dict(prefill_chunk_tokens=SHARED_CHUNK)),
            ("bucketed", {})):
        runs[name], tokens[name] = serve_shared_prefix(model, prompts,
                                                       n_layers, **kw)
        log("shared-prefix run (%s, 24 layers):" % name,
            json.dumps(runs[name]))
    assert runs["sharing"]["prefix_hits"] > 0, runs["sharing"]
    tol = GREEDY_TOL["float32"]
    lens = [len(p) for p in prompts]
    for name in runs:
        # the shortest and the longest prompt of every run, and every
        # request whose tokens differ from the sharing-off run's
        check = {int(np.argmin(lens)), int(np.argmax(lens))}
        check |= {i for i in range(len(prompts))
                  if not np.array_equal(tokens[name][i],
                                        tokens["chunked"][i])}
        gaps = [greedy_gap(model, prompts[i], tokens[name][i])
                for i in sorted(check)]
        runs[name]["identical_to_chunked"] = sum(
            np.array_equal(a, b)
            for a, b in zip(tokens[name], tokens["chunked"]))
        runs[name]["greedy_max_gap"] = max(gaps)
        runs[name]["greedy_tol"] = tol
        assert max(gaps) <= tol, (name, gaps, tol)
    log("shared-prefix greedy check (requests checked: the shortest, the "
        "longest and every one that differs from the sharing-off run):",
        json.dumps({name: {k: runs[name][k] for k in (
            "identical_to_chunked", "greedy_max_gap", "greedy_tol")}
            for name in runs}))
    return runs


def profile_chunks(model, ticks: int = 3):
    """Where a prompt chunk's time goes: one 256-token chunk a tick for
    ``ticks`` ticks of one prompt that is still prefilling after them (so
    no decode step runs), under ``torch.profiler``; its CUDA kernel times
    (one stream) give the device's busy share of the chunk."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import ServingEngine

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           cache_layout="paged", block_size=MAIN_BLOCK,
                           prefill_chunk_tokens=SHARED_CHUNK, device="cuda")
    pool = engine.pool
    vocab = model.vocab_size
    engine.submit(np.arange(SHARED_CHUNK + SHARED_TAIL[0]) % vocab,
                  3).result()
    rng = np.random.RandomState(2)
    engine.submit(rng.randint(0, vocab, SHARED_CHUNK * (ticks + 1)
                              + SHARED_TAIL[0]), 2)
    engine.pump(1)  # admitted, first chunk run
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.pump(ticks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    assert pool.prefilling_count == 1 and pool.active_count == 0
    rows = [(ms / ticks, k, n // ticks)
            for ms, k, n in device_time_rows(prof)]
    busy_ms = sum(r[0] for r in rows)
    while engine.pump(1):
        pass
    del engine
    torch.cuda.empty_cache()
    if not busy_ms:
        log("profile: the profiler recorded no device time (not measured)")
    return {"chunk_tokens": SHARED_CHUNK, "chunks": ticks,
            "profiled_wall_ms_per_chunk": wall_ms,
            "device_busy_ms_per_chunk": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
            else None,
            "top": [{"kernel": k[:80], "ms_per_chunk": ms,
                     "calls_per_chunk": n} for ms, k, n in rows[:8]]}


def preempt_run(model, prompts, cache_dtype, num_blocks=None,
                interrupt=True, **pool_kw):
    """``prompts`` (one per slot, 32 greedy tokens each) through a fresh
    4-layer paged engine; with ``interrupt``, after 8 ticks two decoding
    requests are preempted and two higher-priority requests take their
    slots.  Each preempt (its one download included) and each resume
    (its upload included) is timed alone with ``torch.cuda.synchronize()``
    on both sides; on the disk tier (``pool_kw``) each PTKV write too,
    with the file's bytes.  Returns the metrics and the first requests'
    tokens."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.ops import decode_kernels as dk

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           cache_layout="paged", block_size=MAIN_BLOCK,
                           num_blocks=num_blocks, cache_dtype=cache_dtype,
                           device="cuda", **pool_kw)
    pool = engine.pool
    # warm-up: the decode step's eager call and its capture
    engine.submit(np.arange(64) % model.vocab_size, 3).result()
    resume_ms, write_ms, write_bytes = [], [], []
    real_resume = pool._resume
    real_write = pool._spill_write

    def timed_write(*a, **k):
        t = time.perf_counter()
        path = real_write(*a, **k)
        write_ms.append((time.perf_counter() - t) * 1e3)
        write_bytes.append(os.path.getsize(path))
        return path

    pool._spill_write = timed_write

    def timed_resume(sp):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_resume(sp)
        torch.cuda.synchronize()
        resume_ms.append((time.perf_counter() - t) * 1e3)

    pool._resume = timed_resume
    steps0 = pool.decode_steps_total
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    streams = [engine.submit(p, PREEMPT_NEW_TOKENS, request_id=i)
               for i, p in enumerate(prompts)]
    extra, preempt_ms = [], []
    engine.pump(PREEMPT_AFTER_TICKS)
    if interrupt:
        for rid in (1, MAIN_SLOTS // 2 + 1):
            assert engine.request_state(rid) == "DECODING"
            torch.cuda.synchronize()
            t = time.perf_counter()
            engine.preempt(rid)
            torch.cuda.synchronize()
            preempt_ms.append((time.perf_counter() - t) * 1e3)
            assert engine.request_state(rid) == "PREEMPTED"
        extra = [engine.submit(p, PREEMPT_NEW_TOKENS, priority="high")
                 for p in prompts[:2]]
    while engine.pump(8):
        pass
    torch.cuda.synchronize()
    counts = dk.launch_counts()
    steps = pool.decode_steps_total - steps0
    k1 = counts["paged_decode_attention_kernel"]
    assert k1 == SHORT_LAYERS * steps and k1 > 0, (counts, steps)
    for s in streams + extra:
        assert s.status is not None and s.status.state == "DONE", s.status
    spill = engine.spill_stats()
    if interrupt:
        assert spill["preempts_total"] == spill["resumes_total"] == 2, spill
    out = {"cache_dtype": cache_dtype, "num_blocks": pool.cache_stats()[
        "num_blocks"], "decode_steps": steps, "k1_launches": k1,
        "spill_stats": spill, "preempt_ms": preempt_ms,
        "resume_ms": resume_ms, "compile_counts": engine.compile_counts(),
        "graphs": pool._decode_fn.graphs(), "write_ms": write_ms,
        "write_bytes": write_bytes}
    tokens = [np.asarray(s.status.tokens) for s in streams]
    extra_tokens = [np.asarray(s.status.tokens) for s in extra]
    del engine
    torch.cuda.empty_cache()
    return out, tokens, extra_tokens


def preempt_runs(model, label="host", **pool_kw):
    """``preempt_4l``: fp32 and int8, each uninterrupted and then
    interrupted twice: with the default pool (resume re-maps the spilled
    blocks) and with a pool one free block short of the two newcomers'
    reservations (a spilled copy is reclaimed, resume uploads it).  The
    preempted run's tokens must equal the uninterrupted run's byte for
    byte; the newcomers' tokens are held by ``greedy_gap``.  ``pool_kw``
    (the disk tier) applies to the interrupted runs; ``label`` names the
    tier in the log."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, model.vocab_size, PREEMPT_PROMPT)
               .astype(np.int32) for _ in range(MAIN_SLOTS)]
    per_request = -(-(PREEMPT_PROMPT + PREEMPT_NEW_TOKENS) // MAIN_BLOCK)
    # the eight requests' reservations plus all but one block of one more:
    # the two newcomers must reclaim a victim's spilled copy
    tight = 1 + (MAIN_SLOTS + 1) * per_request - 1
    out = {}
    for dtype in ("float32", "int8"):
        plain, want, _ = preempt_run(model, prompts, dtype, interrupt=False)
        for variant, nb in (("remap", None), ("upload", tight)):
            rec, got, extra = preempt_run(model, prompts, dtype, nb,
                                          **pool_kw)
            # preemption is host work: no step met a new shape
            assert rec["compile_counts"] == plain["compile_counts"] \
                and rec["graphs"] == plain["graphs"] == 1, (rec, plain)
            spill = rec["spill_stats"]
            if variant == "upload":
                assert spill["reclaims_total"] >= 1 \
                    and spill["upload_bytes_total"] > 0, spill
            else:
                assert spill["upload_bytes_total"] == 0, spill
            same = [bool(np.array_equal(a, b)) for a, b in zip(got, want)]
            rec["identical_requests"] = sum(same)
            assert all(same), (dtype, variant, same)
            gaps = [greedy_gap(model, prompts[i], extra[i])
                    for i in range(len(extra))]
            rec["newcomer_greedy_max_gap"] = max(gaps)
            assert max(gaps) <= GREEDY_TOL[dtype], (gaps, dtype)
            out["%s_%s" % (dtype, variant)] = rec
            log("preempt run (%s, %s, %s tier, 4 layers):"
                % (dtype, variant, label), json.dumps(rec))
    return out


def device_time_rows(prof):
    """[(ms, kernel, calls)] of the CUDA kernels a ``torch.profiler`` run
    recorded, longest first (one stream, so their sum is the busy time)."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # host ops: their device time is their kernels' time; a profiled
        # step's ``part:`` ranges (``_StepParts``) also show on the device,
        # as annotations spanning their kernels
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("part:"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    return sorted(rows, reverse=True)


class _StepHook:
    """Stands in for one of a pool's step wrappers: calls it (or, with
    ``eager``, its private eager entry), and keeps what the caller asks
    for -- each step's logits, or CUDA events around each call.  Any other
    attribute (the key counts) reads through to the wrapper."""

    def __init__(self, fn, eager=False, logits=False, events=False):
        self.fn, self.eager = fn, eager
        self.logits = [] if logits else None
        self.events = [] if events else None

    def __call__(self, *args):
        import torch

        if self.events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        out = (self.fn._run_eager if self.eager else self.fn)(*args)
        if self.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.events.append((start, end))
        if self.logits is not None:
            self.logits.append(out[1].clone())
        return out

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def event_ms(self):
        """Device ms per call between the events (the stream is idle when
        a decode step starts: the last tick ended on its download)."""
        return float(np.mean([a.elapsed_time(b) for a, b in self.events]))


def sampler_ms(slots, vocab):
    """Device ms of one call of the branch-free sampler at the decode
    step's shape ([slots, vocab] fp32 logits; greedy and sampled rows do
    the same work), by CUDA graph replay."""
    import torch

    from paddle_tpu_torch.jit.decode import sample_logits_data

    gen = torch.Generator(device="cuda").manual_seed(6)
    logits = torch.randn(slots, vocab, device="cuda", generator=gen)
    cfg = [torch.tensor(v, device="cuda") for v in (
        [0.0, 0.8] * (slots // 2), [0, 50] * (slots // 2),
        [1.0, 0.95] * (slots // 2), list(range(slots)), [7] * slots)]
    return graph_ms([lambda: sample_logits_data(logits, *cfg)])


def profile_decode(model, rng, ticks: int = 10):
    """Where a steady decode step's time goes on the paged main path:
    8 busy slots at ~1k context; ``ticks`` pump ticks timed on the host
    clock with CUDA events around each replay of the captured step, then
    ``ticks`` more under ``torch.profiler``, whose CUDA kernel times (one
    stream, so their sum is the busy time) give the device's share of the
    unprofiled step; and the sampler's device time at the step's shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import ServingEngine

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", cache_layout="paged",
                           block_size=MAIN_BLOCK)
    pool = engine.pool
    for _ in range(MAIN_SLOTS):
        engine.submit(rng.randint(0, model.vocab_size, 1024), 2 * ticks + 8)
    engine.pump(3)  # every slot prefilled; the step warmed up and captured
    assert engine.pool.active_count == MAIN_SLOTS
    assert pool._decode_fn.graphs() == 1
    hook = pool._decode_fn = _StepHook(pool._decode_fn, events=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.pump(ticks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    graph_ms_per_step = hook.event_ms()
    pool._decode_fn = hook.fn
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.pump(ticks)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / ticks
    rows = [(ms / ticks, k, n // ticks)
            for ms, k, n in device_time_rows(prof)]
    busy_ms = sum(r[0] for r in rows)
    while engine.pump(1):
        pass
    assert engine.compile_counts()["pool_decode"] == 1
    # K1 is the split kernel plus, with more than one split, the combine
    k1_ms = sum(ms for ms, k, _ in rows
                if "decode_split_kernel" in k or "decode_combine_kernel" in k)
    samp_ms = sampler_ms(MAIN_SLOTS, model.vocab_size)
    out = {"ticks": ticks, "wall_ms_per_step": wall_ms,
           "graph_device_ms_per_step": graph_ms_per_step,
           "graph_idle_share": 1 - graph_ms_per_step / wall_ms,
           "profiled_wall_ms_per_step": profiled_ms,
           "device_busy_ms_per_step": busy_ms,
           "k1_device_ms_per_step": k1_ms,
           "sampler_device_ms_per_step": samp_ms,
           "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "top": [{"kernel": k[:80], "ms_per_step": ms, "calls_per_step": n}
                   for ms, k, n in rows[:8]]}
    if not busy_ms:
        log("profile: the profiler recorded no device time (not measured)")
    return out


def captured_vs_eager(model):
    """``captured_vs_eager``: 8 slots of the 4-layer model, 4 greedy and 4
    sampled requests (temperature 0.8, top_k 50, top_p 0.95) of 128-1023
    prompt tokens, 32 new tokens each, through a paged engine twice: once
    through the pool's captured decode step and once through the
    wrapper's private eager entry.  The tokens must be identical; the
    largest logit difference between the runs' steps is reported."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.ops import decode_kernels as dk

    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, model.vocab_size, int(n))
               for n in rng.randint(128, 1024, MAIN_SLOTS)]
    tokens, logits, out = {}, {}, {}
    for mode in ("graph", "eager"):
        engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                               cache_layout="paged", block_size=MAIN_BLOCK,
                               device="cuda")
        pool = engine.pool
        hook = pool._decode_fn = _StepHook(pool._decode_fn,
                                           eager=mode == "eager", logits=True)
        dk.reset_launch_counts()
        streams = [engine.submit(p, 2 * SHORT_NEW_TOKENS, **(
            {} if i % 2 == 0 else dict(temperature=0.8, top_k=50,
                                       top_p=0.95, seed=100 + i)))
            for i, p in enumerate(prompts)]
        while engine.pump(8):
            pass
        torch.cuda.synchronize()
        k1 = dk.launch_counts()["paged_decode_attention_kernel"]
        assert k1 == SHORT_LAYERS * pool.decode_steps_total, k1
        for st in streams:
            assert st.status.state == "DONE", st.status
        tokens[mode] = [np.asarray(st.status.tokens) for st in streams]
        logits[mode] = hook.logits
        out[mode] = {"decode_steps": pool.decode_steps_total,
                     "graphs": hook.fn.graphs(), "k1_launches": k1}
        del engine, pool, hook
    assert out["graph"]["graphs"] == 1 and out["eager"]["graphs"] == 0, out
    same = [bool(np.array_equal(a, b))
            for a, b in zip(tokens["graph"], tokens["eager"])]
    assert len(logits["graph"]) == len(logits["eager"])
    diff = max(float((a - b).abs().max())
               for a, b in zip(logits["graph"], logits["eager"]))
    out.update(identical_requests=sum(same), requests=len(same),
               max_abs_logit_diff=diff)
    log("captured_vs_eager (4 layers, 4 greedy + 4 sampled):",
        json.dumps(out))
    assert all(same), same
    torch.cuda.empty_cache()
    return out


def session_runs(model, n_layers):
    """``DecodeSession.generate`` on the card, dense and paged: 8 prompts
    of 512 tokens, 32 new tokens.  One bucket and one captured decode
    step: ``compile_counts() == {"prefill": 1, "decode": 1}``; the decode
    kernel launched ``n_layers`` times a step through the replays; row
    0's greedy tokens within ``greedy_gap``'s limit."""
    import torch

    from paddle_tpu_torch import DecodeSession
    from paddle_tpu_torch.ops import decode_kernels as dk

    ids = np.random.RandomState(5).randint(0, model.vocab_size, (8, 512))
    out = {}
    for layout, kernel in (("dense", "decode_attention_kernel"),
                           ("paged", "paged_decode_attention_kernel")):
        sess = DecodeSession(model, max_len=1024, buckets=[512],
                             cache_layout=layout, block_size=MAIN_BLOCK,
                             device="cuda")
        # warm-up in the same bucket: the decode step's eager call and
        # its capture
        sess.generate(ids[:, :64], 3)
        torch.cuda.synchronize()
        dk.reset_launch_counts()
        t0 = time.perf_counter()
        toks = sess.generate(ids, 32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dk.launch_counts()
        assert sess.compile_counts() == {"prefill": 1, "decode": 1}, \
            sess.compile_counts()
        assert sess._decode_fn.graphs() == 1
        assert counts[kernel] == n_layers * 31 and all(
            n == 0 for k, n in counts.items() if k != kernel), counts
        gap = greedy_gap(model, ids[0], toks[0])
        assert gap <= GREEDY_TOL["float32"], gap
        out[layout] = {"wall_ms": wall * 1e3, "launches": counts,
                       "compile_counts": sess.compile_counts(),
                       "greedy_max_gap": gap}
        del sess
        torch.cuda.empty_cache()
    log("session generate (4 layers, 8 x 512 prompts, 32 new tokens):",
        json.dumps(out))
    return out


# -- the serving host layer: HTTP, recovery, tracing ---------------------------
def _http_generate(base, prompt, new_tokens):
    """One ``POST /generate``; returns the status, the ndjson lines and
    the client's seconds from sending the request to reading the first
    token line."""
    import urllib.request

    body = json.dumps({"prompt": [int(t) for t in prompt],
                       "max_new_tokens": int(new_tokens)}).encode()
    req = urllib.request.Request(base + "/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first, lines = None, []
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
        for line in resp:
            if first is None:
                first = time.perf_counter() - t0
            lines.append(json.loads(line))
        return resp.status, lines, first


def _http_get(base, path):
    """(status, body) of one GET; an error status is returned, not
    raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _parse_prometheus(text):
    """{sample (with its labels): value} of a text exposition; raises on a
    line that is neither a comment nor ``name value``."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def _http_wave(base, prompts, budgets):
    """Every prompt from its own client thread, all started together, while
    another thread polls ``/healthz`` and ``/metrics``; returns each
    request's final ndjson line, the wall seconds and the probe codes."""
    import threading

    finals = [None] * len(prompts)
    errors, probes = [], []
    stop = threading.Event()

    def client(i):
        try:
            status, lines, first = _http_generate(base, prompts[i],
                                                  budgets[i])
            final = lines[-1]
            assert status == 200 and final.get("done"), (status, final)
            assert [x["token"] for x in lines[:-1]] == final["tokens"]
            final["client_ttft_s"] = first
            finals[i] = final
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append("request %d: %r" % (i, e))

    def prober():
        while not stop.is_set():
            probes.append(_http_get(base, "/healthz")[0])
            _parse_prometheus(_http_get(base, "/metrics")[1].decode())
            stop.wait(0.05)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    probe = threading.Thread(target=prober, daemon=True)
    t0 = time.perf_counter()
    probe.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    stop.set()
    probe.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "an HTTP client hung"
    assert not errors, errors
    return finals, wall, probes


def serve_http(model, n_layers, pumped):
    """``serve_http_24l``: the main run's traffic over HTTP.  A paged fp32
    engine (8 slots, block 32) runs its background loop behind
    ``ServingHTTPFrontend`` on 127.0.0.1.  The cold wave sends the
    warm-up request and the 16 requests from 17 client threads at once, so
    the loop meets every prefill bucket and captures its decode step while
    the clients wait; the warm wave sends the 16 again and is the one
    timed.  Each wave's tokens must equal the ``pump()`` run's, its K1
    launches must be 24 per decode step, ``/healthz`` must answer 200
    throughout; the engine's compile counts must equal the pump run's,
    the ``/metrics`` scrape must parse and agree with the streams, and
    ``/healthz`` must answer 503 after ``drain()``/``shutdown()``."""
    import torch

    from paddle_tpu_torch import ServingEngine, ServingHTTPFrontend
    from paddle_tpu_torch.ops import decode_kernels as dk

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", cache_layout="paged",
                           block_size=MAIN_BLOCK).start()
    front = ServingHTTPFrontend(engine, host="127.0.0.1", port=0).start()
    base = "http://%s:%d" % front.address
    pool = engine.pool
    n = len(pumped["prompts"])
    waves = {
        "cold": ([pumped["warmup"]] + pumped["prompts"],
                 [3] + [MAIN_NEW_TOKENS] * n,
                 [pumped["warmup_tokens"]] + pumped["tokens"]),
        "warm": (pumped["prompts"], [MAIN_NEW_TOKENS] * n, pumped["tokens"])}
    out, finals_all = {}, []
    try:
        for name, (prompts, budgets, want) in waves.items():
            torch.cuda.synchronize()  # the loop is idle between waves
            steps0 = pool.decode_steps_total
            dk.reset_launch_counts()
            finals, wall, probes = _http_wave(base, prompts, budgets)
            steps = pool.decode_steps_total - steps0
            k1 = dk.launch_counts()["paged_decode_attention_kernel"]
            assert k1 == n_layers * steps and k1 > 0, (k1, steps)
            same = [f["tokens"] == [int(t) for t in w]
                    for f, w in zip(finals, want)]
            assert all(same), (name, same)
            assert probes and all(c == 200 for c in probes), probes
            # the engine's TTFT starts at its submit, the client's when
            # the request was sent (the wait for the engine lock included)
            ttft = sorted(f["ttft_s"] * 1e3 for f in finals[-n:])
            client = sorted(f["client_ttft_s"] * 1e3 for f in finals[-n:])
            out[name] = {"requests": len(prompts), "decode_steps": steps,
                         "k1_launches": k1, "wall_s": wall,
                         "tokens_per_s": sum(budgets) / wall,
                         "ttft_ms_p50": ttft[len(ttft) // 2],
                         "ttft_ms_max": ttft[-1],
                         "client_ttft_ms_p50": client[len(client) // 2],
                         "client_ttft_ms_max": client[-1],
                         "healthz_probes": len(probes),
                         "identical_requests": sum(same)}
            if name == "cold":
                out["compile_counts"] = engine.compile_counts()
                assert out["compile_counts"] == pumped["compile_counts"], \
                    (out["compile_counts"], pumped["compile_counts"])
                assert pool._decode_fn.graphs() == 1
            finals_all += finals
        status, body = _http_get(base, "/metrics")
        assert status == 200
        scrape = _parse_prometheus(body.decode())
        done = len(finals_all)
        assert scrape["serving_requests_submitted_total"] == done
        assert scrape["serving_requests_completed_total"] == done
        assert scrape["serving_tokens_emitted_total"] == \
            sum(f["new_tokens"] for f in finals_all)
        assert scrape["serving_ttft_seconds_count"] == done
        assert scrape['serving_ttft_seconds_bucket{le="+Inf"}'] == done
        out["metrics_samples"] = len(scrape)
        assert engine.drain(timeout_s=60) is True
        engine.shutdown()
        status, body = _http_get(base, "/healthz")
        assert status == 503 and json.loads(body)["state"] == "stopped", \
            (status, body)
        out["healthz_after_shutdown"] = status
    finally:
        front.shutdown()
        engine.shutdown(drain=False)  # bounded: cancels what is left
    out["pump"] = {k: pumped["run"][k] for k in
                   ("tokens_per_s", "ttft_ms_p50", "ttft_ms_max",
                    "decode_steps")}
    del engine, pool
    torch.cuda.empty_cache()
    return out


def recover_run(model, prompts, specs=(), loop=False):
    """``prompts`` (one per slot, ``PREEMPT_NEW_TOKENS`` greedy tokens
    each) through a fresh 4-layer paged engine after a warm-up request,
    with a fault plane of ``specs`` installed for the traffic; pumped (or
    served by the background loop).  Each pump tick is timed with
    ``torch.cuda.synchronize()`` on both sides: the tick a recovery ran in
    and the tick after it, which re-prefills every survivor.  Returns the
    metrics and the statuses."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.ops import decode_kernels as dk
    from paddle_tpu_torch.serving import faults

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           cache_layout="paged", block_size=MAIN_BLOCK,
                           device="cuda")
    pool = engine.pool
    engine.submit(np.arange(64) % model.vocab_size, 3).result()
    plane = faults.FaultPlane([faults.FaultSpec(**s) for s in specs])
    recoveries = engine.metrics.counter("serving_recoveries_total")
    steps0 = pool.decode_steps_total
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    tick_ms, recovery_ticks = [], []
    t0 = time.perf_counter()
    with faults.injected(plane):
        streams = [engine.submit(p, PREEMPT_NEW_TOKENS) for p in prompts]
        if loop:
            # every request queued before the loop starts: its ticks are
            # the pump run's, so the fault lands on the same step
            engine.start()
            statuses = [s.result(timeout_s=HTTP_TIMEOUT_S) for s in streams]
            engine.shutdown(drain=False)
        else:
            more = True
            while more:
                before = recoveries.value
                torch.cuda.synchronize()
                ts = time.perf_counter()
                more = engine.pump(1)
                torch.cuda.synchronize()
                tick_ms.append((time.perf_counter() - ts) * 1e3)
                if recoveries.value > before:
                    recovery_ticks.append(len(tick_ms) - 1)
            statuses = [s.result(timeout_s=0) for s in streams]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = pool.decode_steps_total - steps0
    k1 = dk.launch_counts()["paged_decode_attention_kernel"]
    assert k1 == SHORT_LAYERS * steps and k1 > 0, (k1, steps)
    assert all(st is not None for st in statuses), statuses
    snap = engine.metrics.snapshot()
    out = {"decode_steps": steps, "k1_launches": k1, "wall_s": wall,
           "injected": [list(x) for x in plane.injected],
           "recoveries": snap["serving_recoveries_total"],
           "recovered": snap["serving_requests_recovered_total"],
           "failed": snap["serving_requests_failed_total"],
           "compile_counts": engine.compile_counts(),
           "graphs": pool._decode_fn.graphs()}
    if recovery_ticks:
        # the first tick prefills every request; the fault's tick resets
        # the pool and resubmits; the tick after re-prefills (when any
        # request survived)
        i = recovery_ticks[0]
        out["fault_tick_ms"] = tick_ms[i]
        if i + 1 < len(tick_ms):
            out["reprefill_tick_ms"] = tick_ms[i + 1]
        decode = [ms for j, ms in enumerate(tick_ms)
                  if j not in (0, i, i + 1)]
        if decode:
            out["decode_tick_ms_p50"] = float(np.median(decode))
    engine.shutdown(drain=False)
    del engine, pool
    torch.cuda.empty_cache()
    return out, statuses


def recover_runs(model):
    """``recover_4l``: 8 requests of 480 tokens (the preempt phase's
    prompts), 32 new tokens each, fault-free; then a transient
    ``pool.step`` fault after 5 ticks and a transient ``pool.alloc_blocks``
    fault on the first refill's 5th admission (of 8): every request is
    resubmitted once (prompt + committed tokens), its tokens must equal
    the fault-free run's byte for byte, one recovery is counted and the
    compile counts stay the fault-free run's.  A permanent step fault must
    end every request FAILED with the error in its status; the transient
    step fault under the background loop must still complete every
    request with the same tokens."""
    from paddle_tpu_torch.serving.faults import (PermanentInjectedFault,
                                                 TransientInjectedFault)

    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, model.vocab_size, PREEMPT_PROMPT)
               .astype(np.int32) for _ in range(MAIN_SLOTS)]
    plain, want = recover_run(model, prompts)
    assert all(st.state == "DONE" for st in want)
    want = [np.asarray(st.tokens) for st in want]
    step_fault = dict(point="pool.step", error=TransientInjectedFault,
                      after=RECOVER_FAULT_AFTER, times=1)
    cases = {
        "step": (dict(specs=[step_fault]), True),
        "alloc": (dict(specs=[dict(point="pool.alloc_blocks",
                                   error=TransientInjectedFault,
                                   after=MAIN_SLOTS // 2, times=1)]), True),
        "permanent": (dict(specs=[dict(step_fault,
                                       error=PermanentInjectedFault)]),
                      False),
        "step_loop": (dict(specs=[step_fault], loop=True), True)}
    out = {"fault_free": plain}
    for name, (kw, transient) in cases.items():
        rec, statuses = recover_run(model, prompts, **kw)
        assert len(rec["injected"]) == 1, rec
        if transient:
            same = [st.state == "DONE" and np.array_equal(st.tokens, w)
                    for st, w in zip(statuses, want)]
            rec["identical_requests"] = sum(same)
            assert all(same), (name, same, [st.error for st in statuses])
            assert rec["recoveries"] == 1 and rec["failed"] == 0, rec
            assert rec["recovered"] == len(prompts), rec
            assert rec["compile_counts"] == plain["compile_counts"] \
                and rec["graphs"] == 1, (rec, plain)
        else:
            for st in statuses:
                assert st.state == "FAILED" and "permanent" in st.error \
                    and "injected fault" in st.error, st
            rec["error"] = statuses[0].error
            assert rec["failed"] == len(prompts), rec
        out[name] = rec
        log("recover run (%s, 4 layers):" % name, json.dumps(rec))
    return out


def trace_decode(model, rng, graph_ms_per_step, root):
    """``trace_24l``: 8 busy slots at ~1k context, as ``profile_decode``.
    The seams' cost first: ``TRACE_TICKS`` untraced ticks with the pool's
    fault and trace seams as they are, then as many with them stubbed out
    (what a tick cost before the seams existed), alternating three times;
    each round's tokens/s is reported.  Then ``TRACE_TICKS`` ticks under
    ``Tracer(deep_timing=True)``: the mean ``tick.decode`` span (it ends at
    the device edge) beside the captured step's device ms, and the Chrome
    export, which must parse."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.inference import generation
    from paddle_tpu_torch.serving import stream

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", cache_layout="paged",
                           block_size=MAIN_BLOCK)
    pool = engine.pool
    for _ in range(MAIN_SLOTS):
        engine.submit(rng.randint(0, model.vocab_size, 1024),
                      8 * TRACE_TICKS + 8)
    engine.pump(3)
    assert pool.active_count == MAIN_SLOTS and pool._decode_fn.graphs() == 1

    class _NoFaults:
        @staticmethod
        def fire(point):
            pass

    seams = (generation._fire, generation._trace_active, stream.faults)
    rounds = {"seams": [], "stubbed": []}
    try:
        for _ in range(3):
            for mode in ("seams", "stubbed"):
                if mode == "stubbed":
                    generation._fire = lambda point: None
                    generation._trace_active = lambda: None
                    stream.faults = _NoFaults
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.pump(TRACE_TICKS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rounds[mode].append(MAIN_SLOTS * TRACE_TICKS / wall)
                generation._fire, generation._trace_active, \
                    stream.faults = seams
    finally:
        generation._fire, generation._trace_active, stream.faults = seams
    tracer = engine.start_trace(capacity=4096, deep_timing=True)
    try:
        t0 = time.perf_counter()
        engine.pump(TRACE_TICKS)
        traced_wall = time.perf_counter() - t0
    finally:
        engine.stop_trace()
    evs = tracer.recorder.snapshot()
    spans = {}
    for e in evs:
        if e.dur_s is not None:
            assert e.deep, e
            spans.setdefault(e.name, []).append(e.dur_s * 1e3)
    assert len(spans["tick.decode"]) == TRACE_TICKS, spans.keys()
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    path = os.path.join(root, "chiprun_out", "trace_24l.json")
    doc = json.loads(engine.export_chrome_trace(path=path))
    with open(path) as f:
        assert json.load(f) == doc
    phase = [e for e in doc["traceEvents"] if e.get("cat") == "phase"]
    assert phase and all(e["args"]["deep"] for e in phase
                         if e.get("ph") == "X")
    while engine.pump(8):
        pass
    out = {"ticks": TRACE_TICKS,
           "span_ms_mean": {k: float(np.mean(v)) for k, v in spans.items()},
           "graph_device_ms_per_step": graph_ms_per_step,
           "traced_tokens_per_s": MAIN_SLOTS * TRACE_TICKS / traced_wall,
           "untraced_tokens_per_s": rounds,
           "trace_events": len(evs), "export_bytes": os.path.getsize(path)}
    seam_mean = float(np.mean(rounds["seams"]))
    stub_mean = float(np.mean(rounds["stubbed"]))
    spread = max(max(v) - min(v) for v in rounds.values())
    out.update(seams_mean=seam_mean, stubbed_mean=stub_mean,
               round_spread=spread)
    del engine, pool
    torch.cuda.empty_cache()
    return out


# -- timing -------------------------------------------------------------------


# (rows, context, cache dtype) of each decode timing row: the serving
# shape in fp32 and int8, one request, a short and a full context
# -- speculative decoding ----------------------------------------------------
def _tokens_hold(model, prompt, got, want, tol):
    """True when ``got`` equals ``want``; else both must be greedy
    within ``tol`` of an uncached forward's argmax at every position (a
    near-tie the two paths may round either way), and False is
    returned."""
    if np.array_equal(got, want):
        return True
    gaps = (greedy_gap(model, prompt, got), greedy_gap(model, prompt, want))
    assert max(gaps) <= tol, ("tokens differ beyond the greedy limit",
                              gaps, tol)
    return False


def spec_pool_run(model, draft, prompts, new_tokens, n_layers, draft_layers,
                  kernel, **kw):
    """One speculative pool over ``prompts`` (after a warm-up in the same
    bucket that runs enough rounds to capture every step): the measured
    pass with CUDA events around each round, then the same traffic with
    ``time_split`` (the draft/verify wall split, synchronized), then 3
    rounds under ``torch.profiler`` for the device's busy share.  Asserts
    every launch: ``kernel`` (the target's) ``n_layers`` times a round,
    K2 ``draft_layers * (k + 1)`` times a round for the draft (plus the
    target's verify on a dense target)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import SpeculativePool
    from paddle_tpu_torch.ops import decode_kernels as dk

    pool = SpeculativePool(model, draft, max_len=MAIN_MAX_LEN, spec_k=SPEC_K,
                           slots=MAIN_SLOTS, device="cuda", **kw)
    vocab = model.vocab_size
    pool.generate([np.arange(len(prompts[0])) % vocab], 4 * VERIFY_LQ)
    assert pool._verify_fn.graphs() == 1 and \
        pool._draft_decode_fn.graphs() == 1 and \
        pool._draft_fixup_fn.graphs() == 1, "a round step was not captured"
    pool.reset_acceptance_stats()
    hook = pool._spec_round = _StepHook(pool._spec_round, events=True)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = pool.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dk.launch_counts()
    acc = pool.acceptance_stats()
    rounds = acc["rounds"]
    draft_k2 = draft_layers * (SPEC_K + 1) * rounds
    target = n_layers * rounds
    if kernel == "decode_attention_kernel":
        assert counts[kernel] == target + draft_k2, (counts, rounds)
        assert counts["paged_decode_attention_kernel"] == 0, counts
    else:
        assert counts[kernel] == target and \
            counts["decode_attention_kernel"] == draft_k2, (counts, rounds)
    round_ms = [a.elapsed_time(b) for a, b in hook.events]
    pool._spec_round = hook.fn
    pool.reset_acceptance_stats()
    pool._time_split = True
    pool.generate(prompts, new_tokens)
    split = pool.acceptance_stats()
    pool._time_split = False
    rid = [pool.submit(p, 3 * VERIFY_LQ) for p in prompts]
    pool.step()  # admissions and prefills outside the profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            pool.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3 / 3
    busy = sum(r[0] for r in device_time_rows(prof)) / 3
    while pool.step():
        pass
    for r in rid:
        pool.collect(r)
    out = {"tokens_per_s": len(prompts) * new_tokens / wall, "wall_s": wall,
           "acceptance_rate": acc["acceptance_rate"], "rounds": rounds,
           "tokens_per_round": len(prompts) * new_tokens / rounds,
           "draft_time_s": split["draft_time_s"],
           "verify_time_s": split["verify_time_s"],
           "round_device_ms_mean": float(np.mean(round_ms)),
           "round_device_ms_p50": float(np.median(round_ms)),
           "profiled_round_ms": prof_ms, "device_busy_ms_per_round": busy,
           "device_idle_share": (1 - busy / prof_ms) if busy else None,
           "launches": counts, "draft_k2_launches": draft_k2,
           "target_launches": target,
           "compile_counts": pool.compile_counts(),
           "graphs": {"verify": pool._verify_fn.graphs(),
                      "draft_decode": pool._draft_decode_fn.graphs(),
                      "draft_fixup": pool._draft_fixup_fn.graphs()}}
    del pool
    torch.cuda.empty_cache()
    return out, tokens


def plain_pool_run(model, prompts, new_tokens, **kw):
    """The same traffic through a plain ``GenerationPool`` (its decode
    step warmed up and captured first)."""
    import torch

    from paddle_tpu_torch import GenerationPool

    pool = GenerationPool(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                          device="cuda", **kw)
    pool.generate([np.arange(len(prompts[0])) % model.vocab_size], 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = pool.generate(prompts, new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"tokens_per_s": len(prompts) * new_tokens / wall, "wall_s": wall,
           "decode_steps": pool.decode_steps_total,
           "compile_counts": pool.compile_counts()}
    del pool
    torch.cuda.empty_cache()
    return out, tokens


def spec_budget(buckets: int) -> dict:
    """The reference's compile budget of a bucketed speculative pool that
    met ``buckets`` prefill buckets at one ``spec_k``."""
    return {"prefill": buckets, "slot_insert": 1, "verify": 1,
            "draft_prefill": buckets, "draft_decode": 1, "draft_fixup": 1,
            "draft_insert": 1}


def serve_spec(model, cfg):
    """``serve_spec_24l``: the full GPT-1.3B target, paged fp32 (block 32),
    8 slots, spec_k 4, 8 prompts of 512 tokens, 64 new tokens each, with
    the target as its own draft (``selfdraft``) and with a 2-layer draft
    of the same widths from seed 1 (``smalldraft``), beside a plain pool
    on the same prompts.  Every verify chunk runs K1 at Lq 5 (24 launches
    a round) and the draft K2 at Lq 1; the tokens must equal the plain
    pool's (or differ only at a near-tie both sides hold within the
    greedy limit); ``selfdraft`` accepts at least 95%; the compile counts
    are the reference's budget."""
    import torch

    from paddle_tpu_torch import TransformerLM

    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, model.vocab_size, SPEC_PROMPT).astype(np.int32)
               for _ in range(SPEC_REQUESTS)]
    paged = dict(cache_layout="paged", block_size=MAIN_BLOCK)
    out = {}
    out["plain"], want = plain_pool_run(model, prompts, SPEC_NEW_TOKENS,
                                        **paged)
    log("serve_spec_24l (plain pool, same prompts):", json.dumps(out["plain"]))
    small = TransformerLM(**dict(cfg, num_layers=SPEC_DRAFT_LAYERS),
                          dropout=0.0, device="cuda", seed=1)
    for name, draft, dl in (("selfdraft", model, cfg["num_layers"]),
                            ("smalldraft", small, SPEC_DRAFT_LAYERS)):
        rec, got = spec_pool_run(model, draft, prompts, SPEC_NEW_TOKENS,
                                 cfg["num_layers"], dl,
                                 "paged_decode_attention_kernel", **paged)
        same = [_tokens_hold(model, p, g, w, GREEDY_TOL["float32"])
                for p, g, w in zip(prompts, got, want)]
        rec["identical_requests"] = sum(same)
        assert rec["compile_counts"] == spec_budget(1), rec["compile_counts"]
        assert all(n == 1 for n in rec["graphs"].values()), rec["graphs"]
        if name == "selfdraft":
            assert rec["acceptance_rate"] >= 0.95, rec["acceptance_rate"]
        out[name] = rec
        log("serve_spec_24l (%s, paged fp32, 24-layer target):" % name,
            json.dumps(rec))
    del small
    torch.cuda.empty_cache()
    return out


def spec_short(model, cfg):
    """``spec_4l``: three contract checks at 4 layers, not times: a paged
    int8 target with the 2-layer draft (K1's int8 path at Lq 5), a dense
    fp32 target (K2 at Lq 5 for the verify and Lq 1 for the draft), each
    against the plain pool on the same prompts; and a
    ``SpeculativeDecodeSession`` batch-1 run against ``DecodeSession``."""
    import torch

    from paddle_tpu_torch import DecodeSession, TransformerLM
    from paddle_tpu_torch.jit import SpeculativeDecodeSession
    from paddle_tpu_torch.ops import decode_kernels as dk

    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, model.vocab_size, SPEC_SHORT_PROMPT)
               .astype(np.int32) for _ in range(SPEC_REQUESTS)]
    small = TransformerLM(**dict(cfg, num_layers=SPEC_DRAFT_LAYERS),
                          dropout=0.0, device="cuda", seed=1)
    out = {}
    for name, kw, kernel, dtype in (
            ("paged_int8", dict(cache_layout="paged", block_size=MAIN_BLOCK,
                                cache_dtype="int8"),
             "paged_decode_attention_kernel", "int8"),
            ("dense_fp32", dict(cache_layout="dense"),
             "decode_attention_kernel", "float32")):
        _, want = plain_pool_run(model, prompts, SPEC_SHORT_NEW_TOKENS, **kw)
        rec, got = spec_pool_run(model, small, prompts,
                                 SPEC_SHORT_NEW_TOKENS, SHORT_LAYERS,
                                 SPEC_DRAFT_LAYERS, kernel, **kw)
        same = [_tokens_hold(model, p, g, w, GREEDY_TOL[dtype])
                for p, g, w in zip(prompts, got, want)]
        rec["identical_requests"] = sum(same)
        assert rec["compile_counts"] == spec_budget(1), rec["compile_counts"]
        out[name] = rec
        log("spec_4l (%s target, 2-layer draft):" % name, json.dumps(rec))
    ids = prompts[0][None]
    ref = DecodeSession(model, max_len=1024, buckets=[SPEC_SHORT_PROMPT],
                        device="cuda")
    want = ref.generate(ids, SPEC_SHORT_NEW_TOKENS)
    sess = SpeculativeDecodeSession(model, small, max_len=1024,
                                    spec_k=SPEC_K,
                                    buckets=[SPEC_SHORT_PROMPT],
                                    device="cuda")
    sess.generate(ids, SPEC_SHORT_NEW_TOKENS)  # warm-up and captures
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    got = sess.generate(ids, SPEC_SHORT_NEW_TOKENS)
    torch.cuda.synchronize()
    counts = dk.launch_counts()
    acc = sess.acceptance_stats()
    assert sess.compile_counts() == {"prefill": 1, "verify": 1,
                                     "draft_prefill": 1, "draft_decode": 1}
    assert counts["decode_attention_kernel"] > 0 and \
        counts["paged_decode_attention_kernel"] == 0, counts
    out["session"] = {"identical": _tokens_hold(
        model, prompts[0], got[0], want[0], GREEDY_TOL["float32"]),
        "launches": counts, "acceptance": acc,
        "compile_counts": sess.compile_counts()}
    log("spec_4l (SpeculativeDecodeSession, dense, batch 1):",
        json.dumps(out["session"]))
    del small, sess, ref
    torch.cuda.empty_cache()
    return out


# -- crash durability ---------------------------------------------------------
def durable_dir(root, name):
    """A fresh directory for a phase's journal and spill files, on the
    checkout's own disk (so an fsync is the disk's), removed by the
    phase."""
    import shutil

    path = os.path.join(root, "scratch_chip", "durable", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def journal_runs(model, keep, root):
    """``journal_24l``: the main traffic (``serve()``'s 16 prompts, 64 new
    tokens) through a journaled engine (``journal_fsync="tick"``) and a
    plain one, alternating plain, journal, journal, plain after a warm-up
    of each; tokens/s per pass, the journal's records and bytes, and the
    fsync ms of each tick's flush (p50, max).  Every pass must emit the
    main run's tokens."""
    import shutil

    import torch

    from paddle_tpu_torch import ServingEngine

    path = durable_dir(root, "journal")
    kw = dict(max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS, cache_layout="paged",
              block_size=MAIN_BLOCK, device="cuda")
    engines = {"plain": ServingEngine(model, **kw),
               "journal": ServingEngine(
                   model, journal_path=os.path.join(path, "wal.journal"),
                   journal_fsync="tick", **kw)}
    for eng in engines.values():
        eng.submit(keep["warmup"], 3).result()
    sync_ms = []
    journal = engines["journal"]._journal
    real_sync = journal.sync

    def timed_sync():
        t = time.perf_counter()
        real_sync()
        sync_ms.append((time.perf_counter() - t) * 1e3)

    journal.sync = timed_sync
    out = {"plain": [], "journal": []}
    for name in ("plain", "journal", "journal", "plain"):
        eng = engines[name]
        n0 = len(sync_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = [eng.submit(p, MAIN_NEW_TOKENS) for p in keep["prompts"]]
        while eng.pump(8):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for st, want in zip(streams, keep["tokens"]):
            assert st.status.state == "DONE" and \
                list(st.status.tokens) == list(want), st.status
        rec = {"tokens_per_s": len(streams) * MAIN_NEW_TOKENS / wall,
               "wall_s": wall}
        if name == "journal":
            ticks = sync_ms[n0:]
            rec.update(fsyncs=len(ticks),
                       fsync_ms_p50=float(np.median(ticks)),
                       fsync_ms_max=float(np.max(ticks)))
        out[name].append(rec)
    snap = engines["journal"].metrics.snapshot()
    out["journal_records"] = snap["serving_journal_records_total"]
    out["journal_bytes"] = snap["serving_journal_bytes_total"]
    out["journal_file_bytes"] = os.path.getsize(
        os.path.join(path, "wal.journal"))
    out["fsync_ms_p50"] = float(np.median(sync_ms))
    out["fsync_ms_max"] = float(np.max(sync_ms))
    out["compile_counts"] = {n: e.compile_counts()
                             for n, e in engines.items()}
    assert out["compile_counts"]["plain"] == \
        out["compile_counts"]["journal"], out["compile_counts"]
    for eng in engines.values():
        eng.shutdown()
    del engines
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    log("journal_24l (main traffic, journal fsync=tick vs none):",
        json.dumps(out))
    return out


def disk_spill_runs(model, host, root):
    """``disk_spill_4l``: ``preempt_4l`` with ``spill_tier="disk"`` (PTKV
    files on the checkout's disk): per preemption the write of the file
    (tmp file, fsync, rename) timed alone, its MB/s, and each resume --
    in the upload variant it reads the file back -- against the host
    tier's run of the same call (``host``).  Tokens must equal the
    uninterrupted run's byte for byte."""
    import shutil

    path = durable_dir(root, "spill")
    out = preempt_runs(model, label="disk", spill_tier="disk",
                       spill_dir=path)
    for key, rec in out.items():
        base = host[key]
        rec["host_preempt_ms"] = base["preempt_ms"]
        rec["host_resume_ms"] = base["resume_ms"]
        if rec["write_ms"]:
            rec["write_mb_s"] = [b / 1e6 / (ms / 1e3) for b, ms in
                                 zip(rec["write_bytes"], rec["write_ms"])]
    shutil.rmtree(path, ignore_errors=True)
    log("disk_spill_4l:", json.dumps(out))
    return out


def crash_child(workdir) -> int:
    """The crashing engine of ``crash_restore_4l`` (``--crash-child``): the
    4-layer model from seed 0, a journaled engine over the disk tier,
    mixed-priority traffic with one victim spilled to disk, then SIGKILL
    mid-decode."""
    import signal

    from paddle_tpu_torch import TransformerLM, gpt_1p3b_config

    model = TransformerLM(**dict(gpt_1p3b_config(), num_layers=SHORT_LAYERS),
                          dropout=0.0, device="cuda", seed=0)
    eng = crash_engine(model, workdir, journal=True)
    crash_traffic(eng, model)
    eng.preempt()
    eng.pump(3)
    parked = sum(1 for r in eng._live.values() if r.state == "PREEMPTED")
    sys.stdout.write("LIVE %d PARKED %d\n" % (eng.live_requests, parked))
    sys.stdout.flush()
    os.kill(os.getpid(), signal.SIGKILL)
    return 1


def crash_engine(model, workdir, journal):
    from paddle_tpu_torch import ServingEngine

    eng = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=CRASH_SLOTS,
                        cache_layout="paged", block_size=MAIN_BLOCK,
                        spill_tier="disk",
                        spill_dir=os.path.join(workdir, "spill"),
                        journal_path=(os.path.join(workdir, "wal.journal")
                                      if journal else None), device="cuda")
    # warm-up in the traffic's bucket: the decode step's capture
    eng.submit(np.arange(PREEMPT_PROMPT) % model.vocab_size, 3).result()
    return eng


def crash_traffic(eng, model):
    """Four low-priority requests decode for 3 ticks, then two high ones
    arrive: the first takes a preempted low's slot, the second waits."""
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, model.vocab_size, PREEMPT_PROMPT)
               .astype(np.int32) for _ in range(CRASH_SLOTS + 2)]
    streams = [eng.submit(p, CRASH_NEW_TOKENS, request_id="low%d" % i,
                          priority="low")
               for i, p in enumerate(prompts[:CRASH_SLOTS])]
    eng.pump(3)
    streams += [eng.submit(p, CRASH_NEW_TOKENS + 16,
                           request_id="high%d" % i, priority="high")
                for i, p in enumerate(prompts[CRASH_SLOTS:])]
    return streams


def crash_restore(model, root):
    """``crash_restore_4l``: a child ``python3 chip_smoke.py --crash-child
    DIR`` serves mixed-priority traffic with a journal and one victim
    spilled to disk and is killed with SIGKILL mid-decode; this process
    builds a fresh engine (the 4-layer model from the same seed), warms
    it, restores from the journal and the spill directory and finishes.
    Every survivor must equal an uninterrupted run's tokens byte for
    byte, the compile counts a clean engine's, and
    ``serving_journal_replayed_total`` the journal's admitted minus
    terminal records."""
    import shutil
    import signal

    import torch

    workdir = durable_dir(root, "crash")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--crash-child", workdir], capture_output=True,
                          text=True, timeout=600, cwd=root)
    child_s = time.perf_counter() - t0
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-2000:])
    assert "PARKED 1" in proc.stdout, proc.stdout
    clean = crash_engine(model, durable_dir(root, "clean"), journal=False)
    streams = crash_traffic(clean, model)
    while clean.pump(8):
        pass
    want = {s.request_id: np.asarray(s.status.tokens) for s in streams}
    clean_counts = clean.compile_counts()
    clean.shutdown()
    del clean
    eng = crash_engine(model, workdir, journal=True)
    counts_before = eng.compile_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    summary = eng.restore(os.path.join(workdir, "wal.journal"))
    restore_ms = (time.perf_counter() - t1) * 1e3
    restored = {rid: rec.stream for rid, rec in eng._live.items()}
    while eng.pump(8):
        pass
    same = []
    for rid, s in restored.items():
        st = s.result(timeout_s=0)
        assert st.state == "DONE", st
        same.append(bool(np.array_equal(np.asarray(st.tokens), want[rid])))
    snap = eng.metrics.snapshot()
    jc = summary["journal_counts"]
    out = {"child_s": child_s, "child_stdout": proc.stdout.strip(),
           "restore_ms": restore_ms, "restore_s": summary["restore_s"],
           "records_replayed": summary["records"],
           "requests_replayed": summary["requests_replayed"],
           "adopted_from_spill": summary["adopted_from_spill"],
           "reprefilled": summary["requests_replayed"]
           - summary["adopted_from_spill"] - summary["finished_at_restore"],
           "tokens_replayed": summary["tokens_replayed"],
           "journal_counts": jc, "identical_requests": sum(same),
           "survivors": len(same),
           "replayed_total": snap["serving_journal_replayed_total"],
           "compile_counts": eng.compile_counts(),
           "upload_bytes": eng.spill_stats()["upload_bytes_total"]}
    log("crash_restore_4l:", json.dumps(out))
    assert all(same), same
    assert summary["adopted_from_spill"] == 1, summary
    assert out["compile_counts"] == counts_before == clean_counts, \
        (out["compile_counts"], counts_before, clean_counts)
    assert out["replayed_total"] == jc["admitted"] - jc["terminals"], out
    eng.shutdown()
    del eng
    shutil.rmtree(os.path.join(root, "scratch_chip", "durable"),
                  ignore_errors=True)
    torch.cuda.empty_cache()
    return out


DECODE_TIMING_ROWS = ((MAIN_SLOTS, 1024, "float32"), (MAIN_SLOTS, 1024, "int8"),
                      (1, 1024, "float32"), (MAIN_SLOTS, 128, "float32"),
                      (MAIN_SLOTS, MAIN_MAX_LEN - 1, "float32"),
                      (MAIN_SLOTS, 1024, "float32", VERIFY_LQ))


def time_kernels(rows=DECODE_TIMING_ROWS):
    """Each decode kernel at the main path's widths (16 heads x 128, block
    32, 2048-position cache, one query) with every row at ``ctx``
    positions, beside its plain twin, SDPA on the gathered K/V and the
    bandwidth bound.  Keyed (kernel, cache dtype, rows, ctx); a row with
    a fourth field ``lq`` is a verify chunk of ``lq`` queries at positions
    ``ctx - lq .. ctx - 1`` (keyed with ``lq`` appended).

    ``ms``, ``plain_ms`` and ``library_ms`` are device times from CUDA
    graph replay (:func:`graph_ms`) over copies of the inputs that
    together exceed L2; ``eager_ms`` is the kernel's time per call when
    the host launches it call after call (host dispatch included)."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for row in rows:
        b, ctx, kv_name = row[:3]
        lq = row[3] if len(row) > 3 else 1
        kv_dt = getattr(torch, kv_name)
        case = paged_case(gen, b, 16, 128, MAIN_BLOCK,
                          MAIN_MAX_LEN // MAIN_BLOCK, lq, torch.float32,
                          kv_dt, ctx=ctx)
        case["q_pos"] = (ctx - lq + torch.arange(lq, device="cuda")) \
            .to(torch.int32)[None].expand(b, lq).contiguous()
        _, h, lq, d = case["q"].shape
        item = case["k_pool"].element_size()
        kv_bytes = 2 * b * h * ctx * (d * item + (4 if kv_dt == torch.int8
                                                  else 0))
        io_bytes = 2 * case["q"].numel() * 4 + case["q_pos"].numel() * 4
        # query j sees ctx - lq + 1 + j keys
        flops = 4 * b * h * d * sum(ctx - lq + 1 + j for j in range(lq))
        # enough copies that one round reads over 3x L2 (50 MB)
        n_copies = max(1, -(-150_000_000 // kv_bytes))
        cases = [case] + [
            {n: (t.clone() if torch.is_tensor(t) else t)
             for n, t in case.items()} for _ in range(n_copies - 1)]
        dcases = [dense_of(c) for c in cases]
        # the SDPA yardstick: fp32 gathered K/V with the same visibility
        sdpa_args = []
        for dc in dcases:
            k_f = dk._dequant(dc["k"], dc["k_scale"])
            v_f = dk._dequant(dc["v"], dc["v_scale"])
            pos = torch.arange(k_f.shape[2], device="cuda")
            mask = (pos[None, None, None, :]
                    <= dc["q_pos"].long()[:, None, :, None])
            sdpa_args.append((dc["q"], k_f, v_f, mask))
        lib_ms = graph_ms([
            (lambda a=a: tF.scaled_dot_product_attention(a[0], a[1], a[2],
                                                         attn_mask=a[3]))
            for a in sdpa_args])
        del sdpa_args
        splits = dk.num_splits(b, h, MAIN_MAX_LEN, MAIN_BLOCK)
        for name, kern, plain, args, extra in (
                ("paged_decode_attention_kernel",
                 dk.paged_decode_attention_kernel,
                 dk.paged_decode_attention_plain, cases,
                 b * -(-ctx // MAIN_BLOCK) * 4),  # the table entries read
                ("decode_attention_kernel", dk.decode_attention_kernel,
                 dk.decode_attention_plain, dcases, 0)):
            nbytes = kv_bytes + io_bytes + extra
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_FLOPS_PER_S * 1e3
            kfns = [(lambda a=a: kern(**a)) for a in args]
            pfns = [(lambda a=a: plain(**a)) for a in args]
            # plain, kernel, kernel, plain: compare within one call
            p1 = graph_ms(pfns, reps=2)
            k1 = graph_ms(kfns)
            k2 = graph_ms(kfns)
            p2 = graph_ms(pfns, reps=2)
            eager = cuda_ms(lambda: kern(**args[0]))
            rec = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "eager_ms": eager,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
                   "kv_dtype": kv_name, "rows": b, "ctx": ctx, "lq": lq,
                   "splits": splits, "input_copies": n_copies}
            rec["achieved_gb_s"] = nbytes / rec["ms"] / 1e6
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            out[(name, kv_name, b, ctx) + ((lq,) if lq > 1 else ())] = rec
            log("timing %-30s kv=%-7s B=%d H=%d Lq=%d D=%d ctx=%d splits=%d: "
                "kernel %.4f ms (%.0f GB/s, %.0f%% of bound; eager %.4f ms), "
                "plain %.4f ms, bound %.4f ms (%s), sdpa %.4f ms"
                % (name, kv_name, b, h, lq, d, ctx, splits, rec["ms"],
                   rec["achieved_gb_s"], 100 * rec["bound_share"], eager,
                   rec["plain_ms"], rec["bound_ms"], rec["bound_by"],
                   lib_ms))
        del cases, dcases
        torch.cuda.empty_cache()
    return out


# -- K3: flash attention ------------------------------------------------------


def flash_case(gen, b, h, lq, lk, d, dtype, causal, bias=None, seg=None):
    """K3 inputs: q, k and v as the attention layer makes them (transposed
    [B, L, H, D] views), an optional bias (full [B, H, Lq, Lk], broadcast
    [1, 1, Lq, Lk] or padding-shaped [B, 1, 1, Lk]) and optional segment
    ids: ``seg="ids"`` draws random ids whose batch row 0 masks every key;
    ``seg="pad"`` gives the lanes ``flash_attention`` makes from a ragged
    ``key_padding_mask`` (queries all 0, keys 0 up to each row's length
    and 1 after it; row 0 has the full length)."""
    import torch

    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def heads(l):
        return rnd(b, l, h, d).to(dtype).transpose(1, 2)

    case = dict(q=heads(lq), k=heads(lk), v=heads(lk), bias=None, q_seg=None,
                kv_seg=None, causal=causal, sm_scale=d ** -0.5)
    if bias is not None:
        case["bias"] = rnd(*{"full": (b, h, lq, lk), "bcast": (1, 1, lq, lk),
                             "pad": (b, 1, 1, lk)}[bias])
    if seg == "ids":
        case["q_seg"] = torch.randint(0, 2, (b, lq), device=dev,
                                      generator=gen).int()
        kv = torch.randint(0, 2, (b, lk), device=dev, generator=gen).int()
        kv[0] = 5
        case["kv_seg"] = kv
    elif seg == "pad":
        lens = torch.randint(lk // 4, lk + 1, (b,), device=dev, generator=gen)
        lens[0] = lk
        valid = torch.arange(lk, device=dev)[None, :] < lens[:, None]
        case["q_seg"] = torch.zeros(b, lq, dtype=torch.int32, device=dev)
        case["kv_seg"] = torch.where(valid, 0, 1).to(torch.int32)
    return case, rnd(b, h, lq, d).to(dtype)


def bf16_error_ratio(got, want) -> float:
    """The largest ``|got - want| / (BF16_REL (|want| + rms))`` over the
    elements of [B, H, L, D] tensors, ``rms`` that of ``want`` over the
    element's ``BF16_TILE_ROWS``-row tile of its (b, h) slice (a tile of
    exact zeros, such as padded keys' dK, allows 1e-30): <= 1 passes."""
    import torch

    g, w = got.float(), want.float()
    b, h, l, d = w.shape
    tile = BF16_TILE_ROWS
    n = -(-l // tile)
    sq = torch.nn.functional.pad(w.square(), (0, 0, 0, n * tile - l))
    rows = torch.full((n,), float(tile), device=w.device)
    rows[-1] = l - (n - 1) * tile
    rms = (sq.view(b, h, n, tile * d).sum(-1) / (rows * d)).sqrt()
    rms = rms.repeat_interleave(tile, dim=-1)[..., :l, None]
    limit = BF16_REL * (w.abs() + rms) + 1e-30
    return ((g - w).abs() / limit).max().item()


def _check_bf16_limit(args, o, grads, want_o, want):
    """The bf16 limit rejects the faults it is there to catch, at the GPT
    shape: O with the keys of one 64-key tile (64-127) left out of every
    later row, and dK or dV zeroed for the last key tile.  Returns their
    ratios, each of which must exceed 1."""
    import torch

    from paddle_tpu_torch.ops import flash_kernels as fk

    l = args["q"].shape[-2]
    drop = torch.zeros(1, 1, l, l, device=o.device)
    drop[..., 128:, 64:128] = torch.finfo(torch.float32).min
    dropped_o, _ = fk.flash_attention_forward_plain(
        **dict(args, bias=drop))
    ratios = {"o_key_tile_dropped": bf16_error_ratio(dropped_o, want_o)}
    for name, g, w in zip(("dk", "dv"), grads[1:3], want[1:3]):
        cut = g.clone()
        cut[..., -BF16_TILE_ROWS:, :] = 0
        ratios[name + "_last_tile_zeroed"] = bf16_error_ratio(cut, w)
    log("bf16 limit against injected faults (ratio to the limit, each "
        "must exceed 1): %s" % {n: "%.1f" % r for n, r in ratios.items()})
    assert all(r > 1 for r in ratios.values()), ratios
    return ratios


def check_flash_kernels():
    """K3 forward (O and stats) and backward (dQ/dK/dV, and dbias before
    its broadcast sum) against the plain twins: causal and not, key
    padding (segment lanes), segment ids with fully masked rows, full and
    broadcast bias, Lq != Lk, L not a multiple of the tile, D in {64, 128},
    f32 and bf16, and both training shapes, in f32 and bf16, with the
    strides the model passes: B 2 x H 16 x L 2048 x D 128 causal (GPT) and
    B 8 x H 12 x L 512 x D 64 non-causal with ragged key padding (BERT).
    Returns the GPT shape's max errors, the bf16 ones under names ending
    in ``_bfloat16``."""
    import torch

    from paddle_tpu_torch.ops import flash_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [dict(b=2, h=3, lq=100, lk=100, d=64, causal=True),
              dict(b=2, h=3, lq=70, lk=130, d=64, causal=False, bias="full"),
              dict(b=2, h=3, lq=130, lk=70, d=128, causal=True,
                   bias="bcast"),
              dict(b=2, h=3, lq=77, lk=77, d=128, causal=True, seg="ids"),
              dict(b=2, h=2, lq=65, lk=90, d=128, causal=False, bias="pad",
                   seg="ids"),
              dict(b=2, h=3, lq=90, lk=90, d=64, causal=False, seg="pad")]
    cases = [(sh, dt) for sh in shapes
             for dt in (torch.float32, torch.bfloat16)]
    main = dict(b=TRAIN_BATCH, h=16, lq=TRAIN_SEQ, lk=TRAIN_SEQ, d=128,
                causal=True)
    bert = dict(b=BERT_BATCH, h=12, lq=BERT_SEQ, lk=BERT_SEQ, d=64,
                causal=False, seg="pad")
    cases += [(main, torch.float32), (bert, torch.float32),
              (main, torch.bfloat16), (bert, torch.bfloat16)]
    main_err = {}
    for shape, dtype in cases:
        args, do = flash_case(gen, dtype=dtype, **shape)
        bias_grad = args["bias"] is not None
        o, stats = fk.flash_attention_forward_kernel(**args)
        grads = fk.flash_attention_backward_kernel(
            o=o, stats=stats, do=do, bias_grad=bias_grad, **args)
        torch.cuda.synchronize()
        want_o, want_stats = fk.flash_attention_forward_plain(**args)
        want = fk.flash_attention_backward_plain(
            o=o, stats=stats, do=do, bias_grad=bias_grad, **args)
        fwd_tol, grad_tol = FLASH_TOL[str(dtype)[6:]]
        errs = {"o": (o.float() - want_o.float()).abs().max().item(),
                "stats": (stats - want_stats).abs().max().item()}
        for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
            if w is not None:
                errs[name] = (g.float() - w.float()).abs().max().item()
        scale = {n: t.float().abs().max().item() for n, t in
                 zip(("dq", "dk", "dv"), want)}
        if dtype == torch.bfloat16 and (shape is main or shape is bert):
            # long rows: the largest outputs and gradients reach magnitudes
            # where two bf16 ulps (2^-6 relative) exceed the small shapes'
            # 2e-2; the element-wise limit below bounds the rest
            fwd_tol = max(fwd_tol, BF16_TWO_ULPS
                          * want_o.float().abs().max().item())
            grad_tol = max(grad_tol, BF16_TWO_ULPS * max(scale.values()))
        ok = (errs["o"] <= fwd_tol and errs["stats"] <= 1e-5
              and all(errs[n] <= grad_tol for n in errs
                      if n not in ("o", "stats"))
              and bool(torch.isfinite(o).all()))
        limits = "tol %.0e/%.0e" % (fwd_tol, grad_tol)
        if dtype == torch.bfloat16:
            ratio = {n: bf16_error_ratio(g, w) for n, g, w in
                     zip(("o", "dq", "dk", "dv"), (o,) + tuple(grads[:3]),
                         (want_o,) + tuple(want[:3]))}
            ok = ok and all(r <= 1 for r in ratio.values())
            limits += ", ratio to the element-wise bf16 limit %s" % {
                n: "%.3f" % r for n, r in ratio.items()}
        log("parity flash_attention %-8s %s  errs %s  %s %s"
            % (str(dtype)[6:], shape, {n: "%.2e" % e for n, e in
                                       errs.items()}, limits,
               "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("K3 disagrees with its plain twins: %s"
                                 % errs)
        if dtype == torch.bfloat16 and shape is main:
            _check_bf16_limit(args, o, grads, want_o, want)
        if shape is main:
            suffix = "" if dtype == torch.float32 else "_bfloat16"
            main_err["flash_attention_forward_kernel" + suffix] = max(
                errs["o"], errs["stats"])
            main_err["flash_attention_backward_kernel" + suffix] = max(
                errs["dq"], errs["dk"], errs["dv"])
    return main_err


# -- training runs ---------------------------------------------------------


def _adamw(model):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                 grad_clip=ClipGradByGlobalNorm(1.0))


def _o2(model, opt):
    """The model and optimizer ``amp.decorate``d O2 bf16, as the
    reference's training legs (``bench.py``'s ``_lm_leg_runner``)."""
    from paddle_tpu_torch import amp

    return amp.decorate(model, opt, level="O2", dtype="bfloat16")


def _amp_loss(loss_fn, bf16: bool):
    """``loss_fn``, under ``auto_cast(level="O1", dtype="bfloat16")`` when
    ``bf16``, as the reference's training legs run the loss."""
    if not bf16:
        return loss_fn
    from paddle_tpu_torch import amp

    def loss_under_autocast(*args):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return loss_fn(*args)

    return loss_under_autocast


def _check_k3_dtype(by_dtype, dtype: str, n: int):
    """Each K3 wrapper launched ``n`` times in the run, all in ``dtype``."""
    want = {name: {dt: n if dt == dtype else 0 for dt in counts}
            for name, counts in by_dtype.items()}
    assert by_dtype == want, (by_dtype, want)


def _check_o2_params(model, opt) -> dict:
    """O2's contract on a decorated model: every parameter bf16 but the
    norms' (float32), and each bf16 parameter's optimizer state holds a
    float32 master."""
    import torch

    from paddle_tpu_torch.optimizer import param_name

    n = {"bfloat16": 0, "float32": 0}
    for name, p in model.named_parameters():
        norm = "norm" in name
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), \
            (name, p.dtype)
        st = opt._states[param_name(p)]
        assert ("master_weight" in st) != norm, name
        assert norm or st["master_weight"].dtype == torch.float32, name
        n["float32" if norm else "bfloat16"] += 1
    return n


def _kernel_kind(name: str) -> str:
    """"k3", "gemm" (cuBLAS and CUTLASS products, their split-K reduce) or
    "elementwise" (everything else: pointwise, reductions, copies)."""
    if "flash_" in name:
        return "k3"
    if re.search(r"gemm|gemv|xmma|cutlass|nvjet|splitK", name, re.I):
        return "gemm"
    return "elementwise"


class _StepParts:
    """Marks the parts of one training step for the profiler while it is
    entered: each part's function runs inside a ``record_function``
    range named ``part:<name>`` -- the model's forward, the embedding,
    LayerNorm, the Linear products, the attention (SDPA routing and K3),
    GELU, the tied head's matmul, the autocast casts, the loss, the
    gradient clip and the optimizer's per-parameter update.  The port's
    functions are looked up at call time, so the patch reaches them; on
    leaving, everything is put back."""

    def __init__(self, model, crit, opt):
        import paddle_tpu_torch.nn.functional as F
        import paddle_tpu_torch.tensor as T
        from paddle_tpu_torch.framework import dispatch

        self._targets = [
            (model, "forward", "forward"), (F, "embedding", "embedding"),
            (F, "layer_norm", "layer_norm"), (F, "linear", "linear"),
            (F, "scaled_dot_product_attention", "attention"),
            (F, "gelu", "gelu"), (T, "matmul", "head"),
            (dispatch, "_cast", "cast"), (crit, "forward", "loss"),
            (opt, "_grad_clip", "clip"), (opt, "_apply_one", "optimizer")]
        self._saved = []

    def __enter__(self):
        from torch.profiler import record_function

        def marked(fn, part):
            def run(*args, **kwargs):
                with record_function("part:" + part):
                    return fn(*args, **kwargs)
            return run

        for obj, attr, part in self._targets:
            self._saved.append((obj, attr, attr in vars(obj),
                                getattr(obj, attr)))
            setattr(obj, attr, marked(getattr(obj, attr), part))
        return self

    def __exit__(self, *exc):
        for obj, attr, own, fn in reversed(self._saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
        self._saved.clear()


def _chain(ev):
    """``ev`` and its enclosing events on its thread, innermost first."""
    while ev is not None:
        yield ev
        ev = ev.cpu_parent


def _step_breakdown(prof, busy_ms: float) -> dict:
    """A profiled step's kernels by part (the ``part:`` range around the
    op that launched them) and by the aten op that launched them.  A
    backward kernel runs on the autograd thread, outside every range: it
    goes to ``backward:<part>`` of the forward op whose autograd node
    launched it (the node's sequence number is the forward op's).  Kernels
    the profiler links to no op are left out; ``attributed_share`` says
    how much of the busy time the table covers.  ``host_ms`` is a part's
    host time under the profiler (its ranges' wall time, nested parts
    included; the backward's parts have none)."""
    from torch.autograd import DeviceType

    def parts_of(ev):
        return [e.name[5:] for e in _chain(ev) if e.name.startswith("part:")]

    def part_of(ev):
        return next(iter(parts_of(ev)), None)

    events = prof.events()
    # a sequence number is shared by the op that made the node and the
    # ops before it that made none (a no-op ``to`` outside the attention's
    # range, say): the most deeply nested part names the node
    seq_part = {}
    for ev in events:
        if getattr(ev, "sequence_nr", -1) >= 0 and "Backward" not in ev.name \
                and not ev.name.startswith("autograd::"):
            parts = parts_of(ev)
            if parts and len(parts) > seq_part.get(ev.sequence_nr,
                                                   (0, None))[0]:
                seq_part[ev.sequence_nr] = (len(parts), parts[0])
    table = {}
    for ev in events:
        if not ev.kernels:
            continue
        op = next((e.name for e in _chain(ev) if e.name.startswith("aten::")),
                  ev.name)
        part = part_of(ev)
        if part is None:
            node = next((e for e in _chain(ev) if "Backward" in e.name
                         or "AccumulateGrad" in e.name), None)
            part = ("other" if node is None else "backward:%s"
                    % seq_part.get(node.sequence_nr, (0, "unlinked"))[1])
        for k in ev.kernels:
            rec = table.setdefault((part, _kernel_kind(k.name), op), [0.0, 0])
            rec[0] += k.duration / 1e3
            rec[1] += 1
    parts = {}

    def record(part):
        return parts.setdefault(part, {
            "ms": 0.0, "gemm_ms": 0.0, "k3_ms": 0.0, "elementwise_ms": 0.0,
            "elementwise_launches": 0, "host_ms": 0.0})

    for ev in events:
        if ev.name.startswith("part:") and ev.device_type == DeviceType.CPU \
                and all(e.name != ev.name for e in _chain(ev.cpu_parent)):
            record(ev.name[5:])["host_ms"] += ev.cpu_time_total / 1e3
    for (part, kind, _), (ms, n) in table.items():
        d = record(part)
        d["ms"] += ms
        d[kind + "_ms"] += ms
        if kind == "elementwise":
            d["elementwise_launches"] += n
    elementwise = sorted(((ms, n, part, op) for (part, kind, op), (ms, n)
                          in table.items() if kind == "elementwise"),
                         reverse=True)
    attributed = sum(d["ms"] for d in parts.values())
    return {"attributed_ms": attributed,
            "attributed_share": attributed / busy_ms if busy_ms else None,
            "elementwise_ms": sum(r[0] for r in elementwise),
            "elementwise_launches": sum(r[1] for r in elementwise),
            "parts": dict(sorted(parts.items(), key=lambda kv: -kv[1]["ms"])),
            "elementwise_top": [{"part": part, "op": op, "ms": ms,
                                 "launches": n}
                                for ms, n, part, op in elementwise[:20]]}


def _profile_step(step, batch, step_ms, parts=None):
    """One more step under ``torch.profiler``: device busy time (CUDA
    kernel time, one stream) against the unprofiled step time, and the
    kernels that take it; with ``parts`` (a :class:`_StepParts`) entered
    around it, also the step's breakdown by part and aten op."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with parts or contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(*batch)
            torch.cuda.synchronize()
    rows = device_time_rows(prof)
    busy = sum(r[0] for r in rows)
    if not busy:
        log("profile: the profiler recorded no device time (not measured)")
    out = {"device_busy_ms_per_step": busy,
           "device_idle_share": (1 - busy / step_ms) if busy else None,
           "k3_ms_per_step": sum(ms for ms, k, _ in rows if "flash_" in k),
           "gemm_ms_per_step": sum(ms for ms, k, _ in rows
                                   if _kernel_kind(k) == "gemm"),
           "top": [{"kernel": k[:80], "ms_per_step": ms, "calls": n}
                   for ms, k, n in rows[:10]]}
    if parts is not None:
        out["breakdown"] = _step_breakdown(prof, busy)
    return out


def _padding_batch(rng, vocab, b, l):
    """ids [B, L], a ragged [B, 1, 1, L] additive padding mask (row 0 full
    length) and labels with the pads set to the ignored -100."""
    ids = rng.randint(0, vocab, (b, l))
    lens = rng.randint(l // 4, l + 1, b)
    lens[0] = l
    valid = np.arange(l)[None, :] < lens[:, None]
    mask = np.where(valid, 0.0, np.finfo(np.float32).min).astype(
        np.float32)[:, None, None, :]
    return ids, mask, np.where(valid, ids, -100), int(lens.sum())


def check_train_small(bf16: bool = False):
    """The training path on the card against the same path on the CPU,
    where K3 is its plain twins: 2-layer models of small widths, the same
    weights (seed 0) and batches, 3 AdamW steps each -- a causal LM with the
    shifted loss, and a non-causal encoder on ragged lengths (a [B, 1, 1, L]
    padding mask, taken as key-padding lanes) with the pads ignored.  With
    ``bf16`` both sides run O2 bf16 (``check_train_small_bf16``) and every
    K3 launch must be bf16.  The per-step losses must agree within
    ``SMALL_TRAIN_RTOL``."""
    import torch

    from paddle_tpu_torch import (TrainStep, TransformerLM,
                                  TransformerLMCriterion)
    from paddle_tpu_torch.ops import flash_kernels as fk

    dtype = "bfloat16" if bf16 else "float32"
    cfg = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
               intermediate_size=512, max_position=256, dropout=0.0)
    ids = np.random.RandomState(5).randint(0, 512, (2, 256))
    pad_ids, pad_mask, pad_labels, _ = _padding_batch(
        np.random.RandomState(6), 512, 4, 200)
    lm, enc = (TransformerLMCriterion(shift_labels=True),
               TransformerLMCriterion(shift_labels=False))
    legs = {"causal": (dict(cfg), lambda m, x: lm(m(x), x), (ids,)),
            "padded": (dict(cfg, causal=False),
                       lambda m, x, am, y: enc(m(x, attn_mask=am), y),
                       (pad_ids, pad_mask, pad_labels))}
    out = {}
    fk.reset_launch_counts()
    for leg, (c, loss_fn, batch) in legs.items():
        losses = {}
        for dev in ("cuda", "cpu"):
            model = TransformerLM(**c, device="cuda", seed=0).to(dev)
            opt = _adamw(model)
            if bf16:
                model, opt = _o2(model, opt)
            step = TrainStep(model, _amp_loss(loss_fn, bf16), opt)
            args = [torch.from_numpy(a).to(dev) if a.dtype == np.float32
                    else a for a in batch]
            losses[dev] = [float(step(*args)) for _ in range(3)]
        np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                                   rtol=SMALL_TRAIN_RTOL[dtype])
        log("train check %s%s (2 layers, 256 wide, %s): card %s vs cpu %s"
            % (leg, " O2 bf16" if bf16 else "",
               "x".join(map(str, batch[0].shape)), losses["cuda"],
               losses["cpu"]))
        out[leg] = losses
    # card only: 2 layers x 3 steps per leg
    _check_k3_dtype(fk.launch_counts_by_dtype(), dtype, 2 * 3 * len(legs))
    return out


def train_gpt(bf16: bool = False):
    """The training main path: GPT-1.3B at full width and depth,
    ``TrainStep`` with AdamW(1e-4, weight decay 0.01, global-norm clip 1.0)
    and the shifted LM loss, on one 2 x 2048 batch (numpy seed 0) repeated
    for 1 warm-up and 5 timed steps: in fp32, or with ``bf16``
    (``train_gpt_bf16``) as the reference's GPT leg runs it, the model and
    optimizer decorated O2 bf16 and the loss under ``auto_cast(level="O1")``
    -- every parameter bf16 but the norms', each with a float32 master.
    The K3 counts are set to 0 just before the steps and read just after:
    every launch must be in the run's dtype.  One more step runs under the
    profiler with the step's parts marked (``_StepParts``)."""
    import torch

    from paddle_tpu_torch import (TrainStep, TransformerLM,
                                  TransformerLMCriterion, gpt_1p3b_config)
    from paddle_tpu_torch.ops import flash_kernels as fk

    dtype = "bfloat16" if bf16 else "float32"
    cfg = gpt_1p3b_config()
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
    opt = _adamw(model)
    if bf16:
        model, opt = _o2(model, opt)
    log("train model: GPT-1.3B %s, %d layers, %.3f B params, built in %.1f s"
        % ("O2 bf16" if bf16 else "fp32", cfg["num_layers"],
           sum(p.numel() for p in model.parameters()) / 1e9,
           time.perf_counter() - t0))
    crit = TransformerLMCriterion(shift_labels=True)
    step = TrainStep(model, _amp_loss(lambda m, x: crit(m(x), x), bf16), opt)
    ids = np.random.RandomState(0).randint(
        0, cfg["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    counts = fk.launch_counts()
    by_dtype = fk.launch_counts_by_dtype()
    peak = torch.cuda.max_memory_allocated()
    layers = cfg["num_layers"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    _check_k3_dtype(by_dtype, dtype, layers * TRAIN_STEPS)
    timed = step_ms[1:]
    mean_ms = float(np.mean(timed))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / (mean_ms / 1e3)
    flops_s = model.flops_per_token(TRAIN_SEQ) * tok_s
    out = {"dtype": dtype, "layers": layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
           "warmup_step_ms": step_ms[0], "step_ms_mean": mean_ms,
           "step_ms_p50": float(np.median(timed)), "tokens_per_s": tok_s,
           "peak_mem_gb": peak / 2 ** 30, "launches": counts,
           "launches_by_dtype": by_dtype,
           "launches_per_step": {n: c / TRAIN_STEPS
                                 for n, c in counts.items()}}
    if bf16:
        out["params_by_dtype"] = _check_o2_params(model, opt)
        out["mfu_vs_bf16_tensor_core_peak"] = flops_s / BF16_TC_FLOPS_PER_S
        out["mfu_peak_flops_per_s"] = BF16_TC_FLOPS_PER_S
    else:
        out["mfu_vs_fp32_cuda_core_peak"] = flops_s / FP32_FLOPS_PER_S
        out["mfu_peak_flops_per_s"] = FP32_FLOPS_PER_S
    out["profile"] = _profile_step(step, (ids,), mean_ms,
                                   _StepParts(model, crit, opt))
    del step, model, opt
    torch.cuda.empty_cache()
    return out


def train_bert(bf16: bool = False):
    """BERT-base (12 layers, 768 wide, non-causal) for 3 steps on 8 x 512
    tokens with ragged lengths given as a [B, 1, 1, L] additive padding
    mask; the masked LM loss ignores the pads.  K3 must take the mask as
    key-padding (segment) lanes: the detection claims it and every K3
    call of the run carries segment ids.  With ``bf16``
    (``train_bert_bf16``) the run is O2 bf16 and K3's lanes run in bf16."""
    import torch

    from paddle_tpu_torch import (TrainStep, TransformerLM,
                                  TransformerLMCriterion, bert_base_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_kernels as fk

    dtype = "bfloat16" if bf16 else "float32"
    cfg = bert_base_config()
    model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
    opt = _adamw(model)
    if bf16:
        model, opt = _o2(model, opt)
    ids, mask, labels, real_tokens = _padding_batch(
        np.random.RandomState(1), cfg["vocab_size"], BERT_BATCH, BERT_SEQ)
    mask, labels = torch.from_numpy(mask).cuda(), torch.from_numpy(
        labels).cuda()
    assert fa.detect_padding_additive_mask(mask) is not None
    crit = TransformerLMCriterion(shift_labels=False)
    step = TrainStep(model, _amp_loss(
        lambda m, x, am, y: crit(m(x, attn_mask=am), y), bf16), opt)
    calls, reads = [], []
    apply, put = fk.FlashAttentionFunction.apply, fa._cache_put

    def recording_apply(*a):
        calls.append((a[4] is not None, str(a[0].dtype)[6:]))  # q_seg, q
        return apply(*a)

    def counting_put(cache, m, verdict):
        # a padding-mask detection that missed its cache: one readback
        if cache is fa._pad_detect_cache:
            reads[-1] += 1
        return put(cache, m, verdict)

    fk.FlashAttentionFunction.apply = recording_apply
    fa._cache_put = counting_put
    try:
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        losses, step_ms = [], []
        for _ in range(BERT_STEPS):
            reads.append(0)
            t0 = time.perf_counter()
            losses.append(float(step(ids, mask, labels)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = fk.launch_counts()
        by_dtype = fk.launch_counts_by_dtype()
    finally:
        fk.FlashAttentionFunction.apply = apply
        fa._cache_put = put
    layers = cfg["num_layers"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert calls and all(c == (True, dtype) for c in calls), calls
    # the layers share one converted mask: at most one readback a step
    assert all(n <= 1 for n in reads), reads
    _check_k3_dtype(by_dtype, dtype, layers * BERT_STEPS)
    del step, model, opt
    torch.cuda.empty_cache()
    return {"dtype": dtype, "layers": layers, "batch": BERT_BATCH,
            "seq": BERT_SEQ, "real_tokens": real_tokens, "losses": losses,
            "step_ms_mean": float(np.mean(step_ms)), "step_ms": step_ms,
            "launches": counts,
            "launches_by_dtype": by_dtype,
            "k3_calls_with_padding_lanes": len(calls),
            "mask_readbacks_per_step": reads}


def time_flash():
    """K3 forward and backward at the training shape (B 2 x H 16 x
    L 2048 x D 128, causal) in fp32 and in bf16, beside the plain twins, the
    bounds and ``scaled_dot_product_attention(is_causal=True)`` forward and
    backward in the same type.

    Bound: the larger of the operations over the tensor cores' rate for
    K3's arithmetic (fp32: 3xTF32, 495 / 3 TFLOP/s; bf16: 989 TFLOP/s) and
    the bytes over 3.35 TB/s; ``cuda_core_bound_ms`` puts the fp32
    operations over the CUDA cores' 67 TFLOP/s instead.  Operations count
    the visible (query, key) pairs, L (L + 1) / 2 per head: 4 D flops each
    forward (QK^T, PV), 10 D backward (QK^T again, dO V^T, dV, dK, dQ).
    Bytes read each input once and write each output once: forward q, k,
    v -> o, stats; backward q, k, v, o, dO, stats -> dq, dk, dv.  Returns
    {name: fp32 record} and {(name, "bfloat16"): bf16 record}."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops import flash_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, h, l, d = TRAIN_BATCH, 16, TRAIN_SEQ, 128
    pairs = b * h * l * (l + 1) // 2
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        args, do = flash_case(gen, b, h, l, l, d, dtype, causal=True)
        o, stats = fk.flash_attention_forward_kernel(**args)
        tensor_bytes = b * h * l * d * o.element_size()
        stats_bytes = stats.numel() * 4
        work = {"flash_attention_forward_kernel": (4 * d * pairs,
                                                   4 * tensor_bytes
                                                   + stats_bytes),
                "flash_attention_backward_kernel": (10 * d * pairs,
                                                    8 * tensor_bytes
                                                    + stats_bytes)}
        tc_rate = (FP32_3XTF32_FLOPS_PER_S if dtype == torch.float32
                   else BF16_TC_FLOPS_PER_S)
        q, k, v = (args[n].detach().requires_grad_() for n in "qkv")
        lib_fwd = cuda_ms(lambda: tF.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=20)
        lib_out = tF.scaled_dot_product_attention(q, k, v, is_causal=True)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (q, k, v), do, retain_graph=True), iters=10)
        runs = {"flash_attention_forward_kernel":
                (lambda: fk.flash_attention_forward_kernel(**args),
                 lambda: fk.flash_attention_forward_plain(**args), lib_fwd),
                "flash_attention_backward_kernel":
                (lambda: fk.flash_attention_backward_kernel(
                    o=o, stats=stats, do=do, **args),
                 lambda: fk.flash_attention_backward_plain(
                     o=o, stats=stats, do=do, **args), lib_bwd)}
        for name, (kern, plain, lib_ms) in runs.items():
            flops, nbytes = work[name]
            t_ops = flops / tc_rate * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            # plain, kernel, kernel, plain: compare within one call
            p1 = cuda_ms(plain, iters=5, warmup=1)
            k1 = cuda_ms(kern, iters=10, warmup=2)
            k2 = cuda_ms(kern, iters=10, warmup=1)
            p2 = cuda_ms(plain, iters=5, warmup=1)
            rec = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
                   "dtype": dt}
            if dtype == torch.float32:
                rec["cuda_core_bound_ms"] = max(
                    flops / FP32_FLOPS_PER_S * 1e3, t_bytes)
            rec["achieved_tflop_s"] = flops / rec["ms"] / 1e9
            rec["vs_library"] = rec["ms"] / lib_ms
            out[name if dtype == torch.float32 else (name, dt)] = rec
            log("timing %-32s B=%d H=%d L=%d D=%d causal %-8s: kernel %.4f "
                "ms (%.2f TFLOP/s), plain %.4f ms, bound %.4f ms (%s, tensor "
                "cores)%s, sdpa %.4f ms (kernel/sdpa %.3f)"
                % (name, b, h, l, d, dt, rec["ms"], rec["achieved_tflop_s"],
                   rec["plain_ms"], rec["bound_ms"], rec["bound_by"],
                   ", CUDA-core bound %.4f ms" % rec["cuda_core_bound_ms"]
                   if "cuda_core_bound_ms" in rec else "", lib_ms,
                   rec["vs_library"]))
        del args, do, o, stats, q, k, v, lib_out
    torch.cuda.empty_cache()
    return out


def sdpa_kernel_names():
    """The CUDA kernels ``scaled_dot_product_attention`` launches for the
    fp32 training shape's forward and backward, from one ``torch.profiler``
    window: which backend the yardstick is."""
    import torch
    import torch.nn.functional as tF
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(3)
    args, do = flash_case(gen, TRAIN_BATCH, 16, TRAIN_SEQ, TRAIN_SEQ, 128,
                          torch.float32, causal=True)
    q, k, v = (args[n].detach().requires_grad_() for n in "qkv")
    tF.scaled_dot_product_attention(q, k, v, is_causal=True).backward(do)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):  # the window's first kernel may go unrecorded
            tF.scaled_dot_product_attention(q, k, v,
                                            is_causal=True).backward(do)
        torch.cuda.synchronize()
    rows = device_time_rows(prof)
    for ms, name, n in rows:
        log("sdpa fp32 kernel: %.4f ms in %d calls  %s" % (ms, n, name[:160]))
    return [name for _, name, _ in rows]


def ptxas_report():
    """Registers and spills of every K1/K2 and K3 kernel from ``ptxas -v``
    (kept by the build beside each library); raises if a D 64 or D 128 K3
    instantiation spills, or any decode kernel does (they take every D up
    to 256 at run time, so each instantiation serves D <= 128)."""
    import re
    import shutil

    from paddle_tpu_torch.ops import _build

    out, spilled = {}, []
    for source in ("decode_attention", "flash_attention"):
        text = _build.build_log(source)
        kernels, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = kernels.setdefault(m.group(1), {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        if not kernels:
            raise AssertionError("no ptxas -v report for %s.cu" % source)
        names = list(kernels)
        if shutil.which("c++filt"):
            names = subprocess.run(
                ["c++filt"], input="\n".join(names), capture_output=True,
                text=True, check=True).stdout.split("\n")[:len(kernels)]
        for mangled, name in zip(kernels, names):
            rec = kernels[mangled]
            name = re.sub(r"\(anonymous namespace\)::|_GLOBAL__N_1", "", name)
            out[name] = rec
            log("ptxas %-60s registers %3s, spill stores %s, spill loads %s, "
                "stack %s" % (name[:60], rec.get("registers"),
                              rec.get("spill_stores"), rec.get("spill_loads"),
                              rec.get("stack")))
            spills = rec.get("spill_stores") or rec.get("spill_loads")
            m = re.search(r"flash_(?:fwd|bwd_dq|bwd_dkdv)<[^,]+, (\d+),",
                          name)
            if spills and (source == "decode_attention"
                           or (m and int(m.group(1)) <= 128)):
                spilled.append(name)
    if spilled:
        raise AssertionError("kernel instantiations serving D <= 128 spill: "
                             "%s" % spilled)
    return out


# -- K4 and the custom-op door ------------------------------------------------


def check_custom_kernel():
    """K4 against its plain twin on the card: shapes [2], [1], [7],
    [1000003], a misaligned ``x[1:]`` view (scalar path) and the main
    path's [2, 2048, 8192], each in f32, bf16 and f16, plus an empty
    input that launches nothing.  Returns the f32 main-shape max error."""
    import torch

    from paddle_tpu_torch.ops import custom_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(4)
    main_err = None
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for shape in ((2,), (1,), (7,), (1_000_003,), "x[1:]", CUSTOM_SHAPE):
            if shape == "x[1:]":
                base = torch.randn(4097, device="cuda", generator=gen)
                x, y = base.to(dtype)[1:], base.flip(0).to(dtype)[1:]
                assert x.data_ptr() % 16 != 0
            else:
                x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                y = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            got = ck.scale_mul(x, y)
            torch.cuda.synchronize()
            want = ck.scale_mul_plain(x, y)
            err = (got.float() - want.float()).abs().max().item()
            ok = (err <= CUSTOM_TOL and got.dtype == dtype
                  and got.shape == x.shape)
            log("parity scale_mul_kernel %-8s %-16s max_abs_err=%.3g tol=%g %s"
                % (str(dtype)[6:], shape, err, CUSTOM_TOL,
                   "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("K4 disagrees with its plain twin: %g"
                                     % err)
            if shape == CUSTOM_SHAPE and dtype == torch.float32:
                main_err = err
    n0 = ck.scale_mul.launches
    empty = torch.empty(0, 5, device="cuda")
    assert ck.scale_mul(empty, empty).shape == (0, 5)
    assert ck.scale_mul.launches == n0, "n == 0 launched a kernel"
    return {"scale_mul_kernel": main_err}


def _scale_mul_bwd(residuals, cot):
    """The reference test's hand-written backward of x * y * 2."""
    x, y = residuals
    return 2.0 * cot * y, 2.0 * cot * x


def custom_op_door():
    """K4 through the port's door on the card, as the reference test drives
    the Pallas kernel: registered with its hand-written backward, called on
    cuda tensors and differentiated eagerly (``.backward()``, ``grad`` with
    ``create_graph=True``), then wrapped in a ``PyLayer``.  Returns the
    registered op."""
    import torch

    from paddle_tpu_torch import autograd, grad, incubate, to_tensor
    from paddle_tpu_torch.ops import custom_kernels as ck

    op = incubate.register_custom_op("scale_mul", ck.scale_mul,
                                     backward=_scale_mul_bwd)
    n0 = ck.scale_mul.launches
    x = to_tensor([1.0, 2.0], stop_gradient=False)  # place None: the card
    y = to_tensor([3.0, 4.0], stop_gradient=False)
    out = op(x, y)
    out.sum().backward()
    assert out.device.type == "cuda" and ck.scale_mul.launches == n0 + 1
    for got, want in ((out, [6.0, 16.0]), (x.grad, [6.0, 8.0]),
                      (y.grad, [2.0, 4.0])):
        np.testing.assert_array_equal(got.detach().cpu().numpy(), want)
    # d/dx sum(2 x x) = 4x, and its derivative 4, through the op's backward
    g = grad(op(x, x).sum(), x, create_graph=True)
    gg = grad(g.sum(), x)
    np.testing.assert_array_equal(g.detach().cpu().numpy(), [4.0, 8.0])
    np.testing.assert_array_equal(gg.cpu().numpy(), [4.0, 4.0])

    class ScaleMul(autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return ck.scale_mul(a, b)

        @staticmethod
        def backward(ctx, cot):
            return _scale_mul_bwd(ctx.saved_tensor(), cot)

    x.grad = y.grad = None
    ScaleMul.apply(x, y).sum().backward()
    np.testing.assert_array_equal(x.grad.cpu().numpy(), [6.0, 8.0])
    np.testing.assert_array_equal(y.grad.cpu().numpy(), [2.0, 4.0])
    log("custom-op door on the card: out [6, 16], x.grad [6, 8], y.grad "
        "[2, 4]; grad and double grad [4, 8] / [4, 4]; PyLayer agrees")
    return op


def train_custom_op(op):
    """The door's main path: ``TrainStep`` with SGD(0.1) over a module
    holding w = ones([2, 2048, 8192]) with loss ``op(x, w).sum()``, x
    uniform in [0, 1) from numpy seed 0 (positive, so the sum is well
    conditioned), 3 steps on the card and the same 3 on the CPU (the twin).
    The K4 count is set to 0 just before the card's steps and read just
    after: one forward launch per step (the backward is torch ops).  The
    losses agree within 1e-5 relative (sums in another order)."""
    import torch

    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.ops import custom_kernels as ck
    from paddle_tpu_torch.optimizer import SGD

    x = np.random.RandomState(0).rand(*CUSTOM_SHAPE).astype(np.float32)

    class Scaler(torch.nn.Module):
        def __init__(self, device):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(CUSTOM_SHAPE,
                                                   device=device))

        def forward(self, a):
            return op(a, self.w).sum()

    losses, out = {}, {}
    for dev in ("cuda", "cpu"):
        model = Scaler(dev)
        step = TrainStep(model, lambda m, a: m(a),
                         SGD(0.1, parameters=model.parameters()))
        if dev == "cuda":
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
        losses[dev] = [float(step(x)) for _ in range(CUSTOM_STEPS)]
        if dev == "cuda":
            torch.cuda.synchronize()
            out["step_ms_mean"] = (time.perf_counter() - t0) * 1e3 \
                / CUSTOM_STEPS
            out["launches"] = ck.scale_mul.launches
        del step, model
    assert out["launches"] == CUSTOM_STEPS, out
    assert all(np.isfinite(losses["cuda"])), losses
    assert losses["cuda"][-1] < losses["cuda"][0], losses
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    out.update(shape=list(CUSTOM_SHAPE), steps=CUSTOM_STEPS, losses=losses)
    torch.cuda.empty_cache()
    return out


_HOST_OPS = """
#include "pt_extension.h"

PT_OP(ext_scale2) {
  long long n = 1;
  for (int d = 0; d < ndims[0]; ++d) n *= shapes[0][d];
  for (long long i = 0; i < n; ++i) out[i] = 2.0f * ins[0][i];
}

PT_OP(ext_dot_bias) {
  long long n = 1;
  for (int d = 0; d < ndims[0]; ++d) n *= shapes[0][d];
  for (long long i = 0; i < n; ++i) out[i] = ins[0][i] + ins[1][i];
}
"""


def check_cpp_extension():
    """``utils.cpp_extension`` on the card's machine: the reference tests'
    two host ops compiled with g++ into a temporary directory and called
    with cuda tensors.  They compute on the host, by the reference's
    design, and return on the input's device: 2x, x + 3x, and the
    registered backward's gradient."""
    import tempfile

    import torch

    from paddle_tpu_torch.utils import cpp_extension

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ext_") as d:
        src = os.path.join(d, "ops.cc")
        with open(src, "w") as f:
            f.write(_HOST_OPS)
        t0 = time.perf_counter()
        mod = cpp_extension.load(
            name="chip_smoke_ext", sources=[src], build_directory=d,
            functions={"ext_scale2": {"out_shape": lambda s: s,
                                      "backward": lambda r, ct: (2.0 * ct,)},
                       "ext_dot_bias": {"out_shape": lambda s1, s2: s1}})
        build_s = time.perf_counter() - t0
    x = torch.linspace(-1, 1, 6, device="cuda")
    y, z = mod.ext_scale2(x), mod.ext_dot_bias(x, x * 3)
    assert y.device.type == z.device.type == "cuda", (y.device, z.device)
    assert torch.equal(y, 2 * x)
    torch.testing.assert_close(z, 4 * x)
    xg = torch.tensor([1.0, -2.0], device="cuda", requires_grad=True)
    (mod.ext_scale2(xg) ** 2).sum().backward()
    assert torch.equal(xg.grad, torch.tensor([8.0, -16.0], device="cuda"))
    log("cpp_extension: g++ build %.2f s; host ops on cuda tensors return "
        "2x and 4x on cuda; backward 8x" % build_s)


def time_custom_kernel():
    """K4 at [2, 2048, 8192] in f32 and bf16 beside its plain twin, its
    bound and ``torch.mul(x, y).mul_(2.0)`` (two launches; timed as a
    yardstick only, the port never calls it).  Bound: 3 n itemsize bytes
    (x and y read once, out written once) over 3.35 TB/s against 2n fp32
    operations over 67 TFLOP/s; the bytes bound it.  The operands (134 MB
    each in f32) exceed the 50 MB L2, so every launch reads from HBM."""
    import torch

    from paddle_tpu_torch.ops import custom_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(CUSTOM_SHAPE, device="cuda", generator=gen).to(dtype)
        y = torch.randn(CUSTOM_SHAPE, device="cuda", generator=gen).to(dtype)
        n = x.numel()
        nbytes = 3 * n * x.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * n / FP32_FLOPS_PER_S * 1e3
        lib_ms = cuda_ms(lambda: torch.mul(x, y).mul_(2.0), iters=20)
        # plain, kernel, kernel, plain: compare within one call
        p1 = cuda_ms(lambda: ck.scale_mul_plain(x, y), iters=20)
        k1 = cuda_ms(lambda: ck.scale_mul(x, y), iters=50)
        k2 = cuda_ms(lambda: ck.scale_mul(x, y), iters=50)
        p2 = cuda_ms(lambda: ck.scale_mul_plain(x, y), iters=20)
        rec = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms, "bytes": nbytes, "dtype": str(dtype)[6:]}
        rec["achieved_gb_s"] = nbytes / rec["ms"] / 1e6
        out[str(dtype)[6:]] = rec
        log("timing scale_mul_kernel %-8s %s: kernel %.4f ms (%.0f GB/s), "
            "plain %.4f ms, bound %.4f ms (%s), mul+mul_ %.4f ms"
            % (str(dtype)[6:], "x".join(map(str, CUSTOM_SHAPE)), rec["ms"],
               rec["achieved_gb_s"], rec["plain_ms"], rec["bound_ms"],
               rec["bound_by"], lib_ms))
        del x, y
    torch.cuda.empty_cache()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on the card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ not found beside %s; run it "
              "from a checkout of the repository" % __file__,
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    if sys.argv[1:2] == ["--crash-child"]:
        return crash_child(sys.argv[2])
    from paddle_tpu_torch import TransformerLM, gpt_1p3b_config
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch %s, CUDA %s, %s x%d" % (torch.__version__, torch.version.cuda,
                                      torch.cuda.get_device_name(0),
                                      torch.cuda.device_count()))

    t0 = time.perf_counter()
    _build.build()
    _build.load("decode_attention")
    _build.load("flash_attention")
    _build.load("scale_mul")
    log("build: %.1f s" % (time.perf_counter() - t0))
    ptxas_report()

    parity = check_kernels()
    check_aliased_tables()
    parity.update(check_flash_kernels())
    parity.update(check_custom_kernel())
    t0 = time.perf_counter()
    door = train_custom_op(custom_op_door())
    log("custom-op main path (TrainStep over scale_mul, %s, SGD 0.1):"
        % "x".join(map(str, CUSTOM_SHAPE)), json.dumps(door))
    check_cpp_extension()
    log("custom-op phases: %.1f s" % (time.perf_counter() - t0))

    cfg = gpt_1p3b_config()
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
    log("model: GPT-1.3B widths, %d layers, %.2f B params, built in %.1f s"
        % (cfg["num_layers"], sum(p.numel() for p in model.parameters())
           / 1e9, time.perf_counter() - t0))
    runs = {}
    pumped = {}
    runs["paged_fp32_24l"] = serve(
        model, rng, MAIN_REQUESTS, MAIN_NEW_TOKENS, cfg["num_layers"],
        "paged_decode_attention_kernel", keep=pumped, cache_layout="paged",
        block_size=MAIN_BLOCK)
    log("main path (paged fp32, 24 layers):", json.dumps(runs["paged_fp32_24l"]))
    pumped.update(run=runs["paged_fp32_24l"],
                  compile_counts=runs["paged_fp32_24l"]["compile_counts"])
    decode_profile = profile_decode(model, rng)
    log("decode step profile (paged fp32, 24 layers, 8 slots at ~1k "
        "context):", json.dumps(decode_profile))
    t0 = time.perf_counter()
    runs["serve_http_24l"] = serve_http(model, cfg["num_layers"], pumped)
    log("serve_http_24l (the main traffic over HTTP, background loop):",
        json.dumps(runs["serve_http_24l"]))
    runs["trace_24l"] = trace_decode(
        model, rng, decode_profile["graph_device_ms_per_step"], root)
    log("trace_24l (deep-timed decode spans, 24 layers):",
        json.dumps(runs["trace_24l"]))
    log("serving host phases (24 layers): %.1f s"
        % (time.perf_counter() - t0))
    runs["serve_shared_prefix_24l"] = shared_prefix_runs(model,
                                                         cfg["num_layers"])
    log("prompt chunk profile (24 layers, 256-token chunks):",
        json.dumps(profile_chunks(model)))
    t0 = time.perf_counter()
    runs["serve_spec_24l"] = serve_spec(model, cfg)
    runs["journal_24l"] = journal_runs(model, pumped, root)
    log("speculative and journal phases (24 layers): %.1f s"
        % (time.perf_counter() - t0))
    del model
    torch.cuda.empty_cache()

    short = dict(cfg, num_layers=SHORT_LAYERS)
    model = TransformerLM(**short, dropout=0.0, device="cuda", seed=0)
    runs["dense_fp32_4l"] = serve(
        model, rng, SHORT_REQUESTS, SHORT_NEW_TOKENS, SHORT_LAYERS,
        "decode_attention_kernel", cache_layout="dense")
    log("dense run (fp32, 4 layers):", json.dumps(runs["dense_fp32_4l"]))
    runs["paged_int8_4l"] = serve(
        model, rng, SHORT_REQUESTS, SHORT_NEW_TOKENS, SHORT_LAYERS,
        "paged_decode_attention_kernel", cache_layout="paged",
        block_size=MAIN_BLOCK, cache_dtype="int8")
    log("int8 run (paged, 4 layers):", json.dumps(runs["paged_int8_4l"]))
    runs["preempt_4l"] = preempt_runs(model)
    t0 = time.perf_counter()
    runs["spec_4l"] = spec_short(model, short)
    runs["disk_spill_4l"] = disk_spill_runs(model, runs["preempt_4l"], root)
    runs["crash_restore_4l"] = crash_restore(model, root)
    log("speculative and durability phases (4 layers): %.1f s"
        % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    runs["recover_4l"] = recover_runs(model)
    log("recover_4l: %.1f s" % (time.perf_counter() - t0))
    runs["captured_vs_eager_4l"] = captured_vs_eager(model)
    runs["session_4l"] = session_runs(model, SHORT_LAYERS)
    del model
    torch.cuda.empty_cache()

    check_train_small()
    check_train_small(bf16=True)
    train = {"gpt_fp32_24l": train_gpt()}
    log("training main path (GPT-1.3B fp32, 24 layers, 2 x 2048):",
        json.dumps(train["gpt_fp32_24l"]))
    train["gpt_bf16_24l"] = train_gpt(bf16=True)
    log("train_gpt_bf16 (GPT-1.3B O2 bf16, 24 layers, 2 x 2048; MFU "
        "against the bf16 tensor-core peak, %.0f TFLOP/s):"
        % (BF16_TC_FLOPS_PER_S / 1e12), json.dumps(train["gpt_bf16_24l"]))
    train["bert_base_pad"] = train_bert()
    log("encoder run (BERT-base, 8 x 512 ragged, key padding):",
        json.dumps(train["bert_base_pad"]))
    train["bert_base_pad_bf16"] = train_bert(bf16=True)
    log("train_bert_bf16 (BERT-base O2 bf16, 8 x 512 ragged, key padding):",
        json.dumps(train["bert_base_pad_bf16"]))

    timing = time_kernels()
    timing.update(time_flash())
    sdpa_kernel_names()
    timing["scale_mul_kernel"] = time_custom_kernel()
    kernels = []
    for name, tpu, run, kv in (
            ("paged_decode_attention_kernel",
             "paddle_tpu/ops/pallas_decode.py:243", "paged_fp32_24l",
             "float32"),
            ("decode_attention_kernel",
             "paddle_tpu/ops/pallas_decode.py:320", "dense_fp32_4l",
             "float32"),
            ("paged_decode_attention_kernel",
             "paddle_tpu/ops/pallas_decode.py:243", "paged_int8_4l",
             "int8")):
        t = timing[(name, kv, MAIN_SLOTS, 1024)]
        label = name if kv == "float32" else name + "_" + kv
        kernels.append({
            "name": label, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": tpu,
            "launches": runs[run]["launches"][name],
            "max_abs_err": parity[label], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for name in ("flash_attention_forward_kernel",
                 "flash_attention_backward_kernel"):
        for dtype, run in (("float32", "gpt_fp32_24l"),
                           ("bfloat16", "gpt_bf16_24l")):
            t = timing[name if dtype == "float32" else (name, dtype)]
            label = name if dtype == "float32" else name + "_" + dtype
            kernels.append({
                "name": label, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                "replaces": "paddle_tpu/ops/flash_attention.py:78",
                "launches": train[run]["launches_by_dtype"][name][dtype],
                "max_abs_err": parity[label], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # the speculative verify chunk (Lq 5): K1 on the paged 24-layer
    # target, K2 on the dense 4-layer target (its draft's K2 launches
    # subtracted)
    dense_spec = runs["spec_4l"]["dense_fp32"]
    for name, launches in (
            ("paged_decode_attention_kernel",
             runs["serve_spec_24l"]["selfdraft"]["launches"][
                 "paged_decode_attention_kernel"]
             + runs["serve_spec_24l"]["smalldraft"]["launches"][
                 "paged_decode_attention_kernel"]),
            ("decode_attention_kernel", dense_spec["target_launches"])):
        t = timing[(name, "float32", MAIN_SLOTS, 1024, VERIFY_LQ)]
        kernels.append({
            "name": name + "_verify", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": ("paddle_tpu/ops/pallas_decode.py:243"
                         if name.startswith("paged")
                         else "paddle_tpu/ops/pallas_decode.py:320"),
            "launches": launches,
            "max_abs_err": parity[name + "_verify"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    t = timing["scale_mul_kernel"]["float32"]
    kernels.append({
        "name": "scale_mul_kernel", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/scale_mul.cu",
        "replaces": "tests/test_incubate.py:77",
        "launches": door["launches"],
        "max_abs_err": parity["scale_mul_kernel"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
- serving beyond one engine, and cost attribution: the main engine's
  ``cost_report()`` (``cost_24l``: the KV bytes reconcile with the pool,
  the decode step's FLOPs within 5% of the model's analytic count, the
  three gauges equal to the report, which adds no key; the decode graph's
  achieved FLOP/s and bytes/s against the card's peaks); the reference's
  disaggregated traffic (16 zipf prompts of 32-384 tokens, 24 new) through
  a ``DisaggregatedServing`` prefill tier and decode tier beside a fused
  engine, in fp32 at 24 layers (``disagg_24l``) and int8 at 4
  (``disagg_int8_4l``): identical tokens, every request a PTKV hand-off,
  none degraded; and the reference's fleet traffic (24 requests over 4
  zipf-drawn shared heads) through ``ServingFleet``s of 1, 2 and 4
  engines, a retired engine, an abandoned one replaced, and HTTP
  (``fleet_24l``: identical tokens, affinity routing, the dead engine's
  card memory given back);
- multi-LoRA serving and the recurrent model class: the reference's
  serving_lora traffic (``lora_24l``: 16 greedy 256-token prompts on 8
  adapters of rank 16, through a bankless engine, one engine over a
  9-row bank on adapter 0 -- equal to the bankless tokens bit for bit --
  and on all 8 mixed, and 8 dedicated one-adapter engines, which must
  lose no token; a hot load that keeps the decode graph; the decode
  graph's device ms with and without the bank); at 4 layers the
  reference test's mixed batch on the dense cache (K2), a sampled adapter
  row through the disk tier, a speculative pool over the bank and a
  2-engine fleet's retire (``lora_mixed_4l``); and an ``SSMLM`` at
  GPT-1.3B widths on the recurrent layout (``ssm_24l``: decode sessions
  at batch 1 and 8, the eager bucketed prefill timed and profiled alone,
  an 8-slot engine held against the eager loop, two victims preempted
  through the host and disk tiers, byte for byte);
- sharded serving on one card: the 24-layer model serves the main
  traffic over ``DecodeMesh`` (1, 2), (2, 1) and (2, 2) with every shard
  on ``cuda:0`` (``mesh_24l``: K1 at 16/mp heads on slots/dp rows, each
  shard's own contiguous pool; tokens equal to the unsharded run's on
  margin-gated prompts, its compile counts, the per-shard block
  partition, K1 launches a step == layers x dp x mp, the collective bytes
  a token == the ring formula, one decode step's logits against the
  unsharded forward; the decode graph's device ms a step at each mesh
  beside the unsharded engine's); a grid over two cards refused as a
  typed error; at 4 layers the (2, 2) mesh's int8 seams (block and
  channel: every reduction within the reference's two-hop bound, the
  logits within 3% of their scale), int8 KV, a speculative pool and the
  dense layout (``mesh_int8_4l``).  One card carries no interconnect: a
  mesh step is its shards' smaller launches one after another;
- weights replaced under a captured graph (``refresh_24l``): the
  24-layer pool's parameters swapped for another seed's with
  ``load_state_dict(..., assign=True)``, ``refresh_weights()``, and the
  pool must serve a fresh pool's tokens on the new weights;
- training: the same GPT-1.3B at full width and depth for 6
  ``TrainStep``s (AdamW, global-norm clipping) on one repeated 2 x 2048
  batch, every attention forward and backward through the flash kernel K3,
  first in fp32, then in bf16 O2 mixed precision as the reference's GPT
  leg runs it (``amp.decorate`` O2 bf16, the loss under ``auto_cast``;
  every K3 launch bf16).  Each precision runs twice from the same
  weights: eagerly (``capture=False``, one more step profiled and broken
  down by part of the step and aten op) and as one captured CUDA graph a
  step (the warm-up, the capture, replays; one replay profiled), whose
  losses must equal the eager ones; then a BERT-base encoder on ragged
  batches, each step its own padding (key-padding lanes eagerly, a
  broadcast bias in the graph), the same two ways, in fp32 and O2 bf16.
  Small 2-layer models train on the card (captured) and on the CPU first,
  in both precisions, and their losses must agree.  Then the reference's
  fine-tune (config #4): the ERNIE-base classifier in O2 bf16 on 32 x 384
  tokens of ragged length behind a key-padding mask, eagerly and
  captured (``train_ernie_cls``: equal losses, one key, K3 bf16 12
  launches a step each way); a [40000, 768] sparse embedding's lazy Adam
  held against dense Adam (the rows met equal, every other row and moment
  bit for bit) and trained under ``TrainStep`` on its dense gradient
  (``sparse_embedding``); ``FLAGS_check_nan_inf`` raising on an eager inf
  and the fine-tune step captured with it on (``nan_check``); and every
  ported ``tensor`` op on the card against the CPU and under autocast
  (``tensor_ops_cuda``);
- vision training, the reference's configs #1 and #2: ``LeNet`` in fp32
  with Adam under ``TrainStep`` at batches 512/1024/2048, captured and
  eagerly, and ``MultiStepTrainStep`` with 32 steps a call
  (``train_lenet``); ``resnet50`` in O2 bf16 with Momentum at 224 x 224
  over the reference's five legs (NHWC/NCHW, batch 64-256, every
  residual block under ``recompute``, the s2d stem), each captured, the
  running statistics advanced once a call (also under recompute and
  across the capture), two legs beside an eager run whose step is broken
  down by part (``train_resnet50``).  Convolutions, pools and BatchNorm
  are cuDNN/ATen calls, as the reference's are XLA's: no TPU kernel lies
  on this path;
- the sequence models, at their published widths from random weights:
  Transformer-base (6 + 6 layers, 512 wide, 8 heads, a shared 33708-token
  vocabulary; PaddleNLP's WMT14 en-de recipe) trained in fp32 on 128 x 64
  ragged batches with dropout 0.1, eagerly and captured from the same
  weights and dropout stream (no K3: dropout keeps training attention on
  the composition; ``train_transformer_base``), its teacher-forced loss
  in eval mode with every attention through K3's bias mode, held against
  the composition (``eval_transformer_base``), and a beam-4 translation
  of 16 sentences, each step's single query through K3 against the
  grown ``Cache`` and the memory's ``StaticCache``, held against the same
  search on the composition (``translate_transformer_base``); then the
  LSTM seq2seq with attention (2 x 512, IWSLT15 en-vi vocabularies)
  trained the same two ways (the encoder packed through cuDNN eagerly,
  its step loop in the graph; ``train_seq2seq_lstm``) and translating at
  beam 10 against a CPU copy (``translate_seq2seq_lstm``);
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
with its tensor-core bound and the CUDA-core one, and in bf16 at the
ERNIE fine-tune's shape with its padding lanes; K3's forward at the
sequence models' shapes (fp32, by graph replay, Lq 1 included); K1/K2
at the serving shape in fp32 and int8, at one request, and at a short and a full
context, and at a verify chunk of 5 queries (K1/K2, per-row positions).
K1 is also held against its twin on tables whose rows alias one
prefix's blocks, for a decode step and for chunks of 4 and 8 queries.  After the build it prints ``ptxas -v``'s registers and spills
of every K1/K2 and K3 kernel (and fails if a decode kernel, or a D 64 or
D 128 K3 one, spills); after the timing, the kernels SDPA's fp32 forward
and backward launch.

Every phase raises on failure; the exit code is 0 only when all passed.
Every phase's record is written in full to ``chiprun_out/chip_smoke.json``
beside the script.
The second-to-last lines are the card's name and power limit and a JSON
object describing every kernel; the last line is a JSON object naming the
device.  Without a CUDA card, or without the package beside this file, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
import gc
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
# serving beyond one engine: the reference's serving_disagg and
# serving_fleet legs (bench.py:1904, :2085) at the full depth; prompt
# lengths and prefix groups are drawn zipf(ZIPF_A)
ZIPF_A = 1.1
DISAGG_SHORT, DISAGG_LONG, DISAGG_NEW = 32, 384, 24
DISAGG_REQUESTS, DISAGG_SLOTS, DISAGG_CHUNK = 16, 4, 64
FLEET_GROUPS, FLEET_HEAD, FLEET_TAIL, FLEET_NEW = 4, 64, (16, 96), 24
FLEET_REQUESTS, FLEET_SLOTS, FLEET_CHUNK = 24, 4, 64
# multi-LoRA and the recurrent model class: the reference's serving_lora
# leg (bench.py:2357-2370: 8 adapters of rank 16 on q/k/v/out_proj, 16
# 256-token prompts, 32 new tokens) and decode_ssm leg (bench.py:701:
# bucket 512, 128 new tokens, d_state 2 x hidden)
LORA_ADAPTERS, LORA_RANK = 8, 16
LORA_PROMPT, LORA_NEW, LORA_REQUESTS = 256, 32, 16
# the mean context of a lora_24l decode step (K1's timing row)
LORA_CTX = LORA_PROMPT + LORA_NEW // 2
# lora_mixed_4l's prompts: the reference test's lengths (7, 19, 12, 9) x 10
LORA_MIXED_LENS = (70, 190, 120, 90)
# the mean context of a lora_mixed_4l decode step or verify chunk (the
# timing rows of its K2 and of K1 at Lq 5)
LORA_MIXED_CTX = sum(LORA_MIXED_LENS) // len(LORA_MIXED_LENS) + LORA_NEW // 2
SSM_D_STATE = 4096
SSM_BUCKET, SSM_NEW = 512, 128
SSM_REQUESTS, SSM_ENGINE_NEW = 16, 64
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
# each training cell runs its steps twice from the same weights: eagerly
# (``capture=False``: 1 warm-up + 5 timed) and captured (the warm-up, the
# capture, 4 timed replays)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6
# captured against eager on the card: the same kernels in the same order
# (fp32 to its rounding); a BERT padding mask reaches K3 as a bias under
# capture and as key-padding lanes eagerly, which add the same exact
# zeros, and in O2 bf16 a loss averages bf16-rounded products over
# thousands of positions
CAPTURED_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# the small training check, card against CPU over 3 AdamW steps: fp32
# sums in another order on each side; in O2 bf16 both sides round the same
# products to bf16 and accumulate in fp32, and the loss averages the
# rounding of 2 x 255 or 4 x 200 positions
SMALL_TRAIN_RTOL = {"float32": 1e-4, "bfloat16": 2e-3}
# BERT: every step a batch with its own padding, so the captured step's
# replays run on other padding than the capture's
BERT_BATCH, BERT_SEQ, BERT_STEPS = 8, 512, 5
# the ERNIE fine-tune (the reference's config #4, bench.py:375): its
# smallest on-chip batch, 6 steps each way, prompts of ragged length
# 128-384 behind a key-padding mask, 3 classes
ERNIE_BATCH, ERNIE_SEQ, ERNIE_STEPS = 32, 384, 6
ERNIE_MIN_LEN, ERNIE_CLASSES = 128, 3
# replays after the captured leg's steps, to see the loss fall past the
# first update's kick
ERNIE_MORE_STEPS = 24
# sparse_embedding: lazy against dense Adam on the rows a step meets: the
# same fp32 update, on gradient rows summed in another order (a coalesce
# against the dense backward's scatter-add)
SPARSE_RTOL = 1e-6
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
    gc.collect()  # a graph freed by the collector would void the capture
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                for f in fns:
                    f()
    finally:
        gc.enable()
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
                    prompts=prompts, engine=engine,
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
                                    lambda toks, slot, start, n, *r: n)
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


def profile_decode(model, rng, ticks: int = 10, adapters=None):
    """Where a steady decode step's time goes on the paged main path:
    8 busy slots at ~1k context (slot i's request on LoRA adapter
    ``adapters[i]`` when given); ``ticks`` pump ticks timed on the host
    clock with CUDA events around each replay of the captured step, then
    ``ticks`` more under ``torch.profiler``, whose CUDA kernel times (one
    stream, so their sum is the busy time) give the device's share of the
    unprofiled step and its kernels a step; and the sampler's device time
    at the step's shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import ServingEngine

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", cache_layout="paged",
                           block_size=MAIN_BLOCK)
    pool = engine.pool
    for i in range(MAIN_SLOTS):
        engine.submit(rng.randint(0, model.vocab_size, 1024), 2 * ticks + 8,
                      adapter=0 if adapters is None else adapters[i])
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
           "kernels_per_step": sum(n for _, _, n in rows),
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
                      (MAIN_SLOTS, 1024, "float32", VERIFY_LQ),
                      (MAIN_SLOTS, LORA_CTX, "float32"),
                      (MAIN_SLOTS, LORA_MIXED_CTX, "float32"),
                      (MAIN_SLOTS, LORA_MIXED_CTX, "float32", VERIFY_LQ),
                      # the (2, 2) mesh's per-shard shape: slots/2 rows of
                      # 16/2 heads
                      (MAIN_SLOTS // 2, 1024, "float32", 1, 8),
                      (MAIN_SLOTS // 2, 1024, "int8", 1, 8),
                      (MAIN_SLOTS // 2, 1024, "float32", VERIFY_LQ, 8))



# -- serving beyond one engine: tiers, the fleet, cost attribution ----------


def _wrap_times(obj, name, values):
    """Wrap ``obj.name`` so each call's host seconds land in ``values``."""
    fn = getattr(obj, name)

    def timed(*a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        values.append(time.perf_counter() - t)
        return out

    setattr(obj, name, timed)


def _record_observations(hist, values):
    """Keep every value a histogram observes from now on (a histogram's
    quantiles are bucket bounds; the phases report the values' own)."""
    observe = hist.observe

    def both(v):
        values.append(float(v))
        observe(v)

    hist.observe = both


def _p50_max_ms(values):
    if not values:
        return None, None
    v = sorted(values)
    return v[len(v) // 2] * 1e3, v[-1] * 1e3


def _burst(target, prompts, new_tokens, warm, after_warm=None,
           between=None):
    """Serve ``warm`` (3 new tokens: every step warmed up and captured),
    then the timed burst of ``prompts`` through ``target`` (an engine, a
    disaggregated front or a fleet), the K1/K2 counts set to 0 just
    before it and read just after; ``between`` pumps that many ticks after
    each submit (wave arrival).  Returns the statuses, the burst's wall
    seconds, its launch counts and its front-observed inter-token gaps."""
    import torch

    from paddle_tpu_torch.ops import decode_kernels as dk

    for w in warm:
        w()
    _settle(target)
    if after_warm is not None:
        after_warm()
    itl = []
    _record_observations(target._h_itl, itl)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    streams = []
    for i, p in enumerate(prompts):
        streams.append(target.submit(p, new_tokens, request_id="r%d" % i))
        if between:
            target.pump(between)
    while target.pump(4):
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dk.launch_counts()
    statuses = [s.result(timeout_s=0) for s in streams]
    for st in statuses:
        assert st is not None and st.state == "DONE", st
        assert len(st.tokens) == new_tokens, st
    return statuses, wall, launches, itl


def _latency(statuses, wall, itl, new_tokens):
    out = {"requests": len(statuses), "wall_s": wall,
           "tokens_per_s": len(statuses) * new_tokens / wall}
    out["ttft_ms_p50"], out["ttft_ms_max"] = _p50_max_ms(
        [st.ttft_s for st in statuses])
    out["itl_ms_p50"], out["itl_ms_max"] = _p50_max_ms(itl)
    return out


def disagg_traffic(vocab):
    """The reference's ``serving_disagg`` traffic (``bench.py:1938-1957``):
    16 prompt lengths drawn zipf(1.1) over 4 ranks evenly spaced in 32..384
    (short interactive prompts dominate, a tail of long prefills), numpy
    seed 0; plus one 384-token warm-up prompt."""
    rng = np.random.RandomState(0)
    ranks = np.linspace(DISAGG_SHORT, DISAGG_LONG, 4).astype(int)
    probs = 1.0 / np.arange(1, len(ranks) + 1) ** ZIPF_A
    probs /= probs.sum()
    choices = rng.choice(len(ranks), size=DISAGG_REQUESTS, p=probs)
    prompts = [rng.randint(0, vocab, (int(ranks[c]),)).astype(np.int32)
               for c in choices]
    return prompts, rng.randint(0, vocab, (DISAGG_LONG,)).astype(np.int32)


def disagg_run(model, root, n_layers, cache_dtype="float32"):
    """``disagg_24l`` / ``disagg_int8_4l``: the reference's serving_disagg
    leg (``bench.py:1904``) on the card.  A fused ``ServingEngine`` (8
    slots, the pair's total) and a ``DisaggregatedServing`` front over a
    prefill tier and a decode tier (4 slots each, one shared model) serve
    the same 16 zipf prompts, 24 greedy tokens each, chunk 64, block 32,
    paged.  Holds: the pair's tokens equal the fused engine's (the same
    kernels on the same card), 16 transfers in the burst and none
    degraded, the per-role step keys (no ``prefill_chunk`` on the decode
    tier, ``pool_decode`` 0 on the prefill tier, one key and one graph
    each otherwise), K1 launched ``n_layers`` times a decode-tier step and
    K2 never, and the transfer directory empty afterwards."""
    import shutil

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.serving import DisaggregatedServing

    prompts, warm = disagg_traffic(model.vocab_size)
    max_len = DISAGG_LONG + DISAGG_NEW
    shared = dict(cache_layout="paged", block_size=MAIN_BLOCK,
                  buckets=[max_len], cache_dtype=cache_dtype, device="cuda")
    fused = ServingEngine(model, max_len=max_len, slots=2 * DISAGG_SLOTS,
                          max_queue=2 * DISAGG_REQUESTS,
                          prefill_chunk_tokens=DISAGG_CHUNK, **shared)
    st, wall, launches, itl = _burst(
        fused, prompts, DISAGG_NEW, [lambda: fused.submit(warm, 3)])
    want = {s.request_id: list(s.tokens) for s in st}
    fused_out = _latency(st, wall, itl, DISAGG_NEW)
    fused.release_device()
    del fused

    xdir = durable_dir(root, "disagg-" + cache_dtype)
    front = DisaggregatedServing(
        model, max_len, transfer_dir=xdir, prefill_chunk_tokens=DISAGG_CHUNK,
        prefill_slots=DISAGG_SLOTS, decode_slots=DISAGG_SLOTS,
        max_queue=2 * DISAGG_REQUESTS, **shared)
    pool = front.decode.pool
    exports, waits, base = [], [], {}

    def after_warm():
        base.update(xfers=front._c_transfers.value,
                    bytes=front._c_transfer_bytes.value,
                    steps=pool.decode_steps_total)
        _wrap_times(front.prefill.pool, "export_kv", exports)
        _record_observations(front._h_handoff, waits)

    st, wall, launches, itl = _burst(
        front, prompts, DISAGG_NEW, [lambda: front.submit(warm, 3)],
        after_warm=after_warm)
    out = _latency(st, wall, itl, DISAGG_NEW)
    steps = pool.decode_steps_total - base["steps"]
    same = sum(list(s.tokens) == want[s.request_id] for s in st)
    assert same == len(want), ("tokens differ from the fused engine's",
                               same)
    transfers = front._c_transfers.value - base["xfers"]
    moved = front._c_transfer_bytes.value - base["bytes"]
    assert transfers == DISAGG_REQUESTS, transfers
    assert front._c_degraded.value == 0, front._c_degraded.value
    cc = front.compile_counts()
    assert "prefill_chunk" not in cc["decode"], cc
    assert cc["prefill"].get("pool_decode", 0) == 0, cc
    assert cc["prefill"]["prefill_chunk"] == 1, cc
    assert cc["decode"]["pool_decode"] == 1, cc
    assert front.prefill.pool._chunk_fn.graphs() == 1
    assert pool._decode_fn.graphs() == 1
    k1 = launches["paged_decode_attention_kernel"]
    assert k1 > 0 and k1 == n_layers * steps, (k1, steps)
    assert launches["decode_attention_kernel"] == 0, launches
    front.shutdown()
    assert os.listdir(xdir) == [], os.listdir(xdir)
    front.prefill.release_device()
    front.decode.release_device()
    shutil.rmtree(xdir, ignore_errors=True)
    out.update(
        cache_dtype=cache_dtype, identical_requests=same,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        kv_transfers=int(transfers),
        handoffs_degraded=int(front._c_degraded.value),
        kv_transfer_bytes=int(moved),
        handoff_wait_ms_p50=_p50_max_ms(waits)[0],
        handoff_wait_ms_max=_p50_max_ms(waits)[1],
        export_ms_p50=_p50_max_ms(exports)[0],
        export_ms_max=_p50_max_ms(exports)[1],
        ptkv_write_mb_s=moved / 1e6 / sum(exports),
        decode_tier_steps=steps, k1_launches=k1, compile_counts=cc,
        fused=fused_out)
    return out


def fleet_traffic(vocab):
    """The reference's ``serving_fleet`` traffic (``bench.py:2118-2143``):
    4 shared 64-token heads drawn zipf(1.1), each of 24 requests with its
    own 16-96-token tail, numpy seed 0."""
    rng = np.random.RandomState(0)
    heads = [rng.randint(0, vocab, (FLEET_HEAD,)).astype(np.int32)
             for _ in range(FLEET_GROUPS)]
    probs = 1.0 / np.arange(1, FLEET_GROUPS + 1) ** ZIPF_A
    probs /= probs.sum()
    groups = rng.choice(FLEET_GROUPS, size=FLEET_REQUESTS, p=probs)
    prompts = [np.concatenate([heads[g], rng.randint(
        0, vocab, (int(rng.randint(*FLEET_TAIL)),)).astype(np.int32)])
        for g in groups]
    warm = rng.randint(0, vocab, (FLEET_HEAD + FLEET_TAIL[1],)) \
        .astype(np.int32)
    return prompts, warm


def _fleet(model, spill, engines, min_engines=1):
    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.serving import ServingFleet

    max_len = FLEET_HEAD + FLEET_TAIL[1] + FLEET_NEW

    def factory(engine_id, registry):
        return ServingEngine(
            model, max_len=max_len, slots=FLEET_SLOTS,
            max_queue=2 * FLEET_REQUESTS, cache_layout="paged",
            block_size=MAIN_BLOCK, prefill_chunk_tokens=FLEET_CHUNK,
            prefix_sharing=True, spill_tier="disk", spill_dir=spill,
            metrics=registry, device="cuda")

    return ServingFleet(factory, engines=engines, min_engines=min_engines)


def _warm_each(fleet, warm):
    """Warm every engine directly (the router would pile warm traffic on
    one engine and leave another to capture inside the measurement)."""
    return [lambda e=e: e.submit(warm, 3) for e in fleet.engines().values()]


def _settle(target):
    """Pump until nothing is live: the front's own requests and, on a
    fleet, the warm requests its engines were given directly (which the
    fleet's ``pump`` does not count)."""
    from paddle_tpu_torch.serving import ServingFleet

    engines = target.engines if isinstance(target, ServingFleet) else dict
    while target.pump(8) or any(e.live_requests
                                for e in engines().values()):
        pass


def _fleet_down(fleet):
    fleet.shutdown(drain=False)
    for eng in fleet.engines().values():
        eng.release_device()


def _decode_steps(fleet):
    return sum(e.pool.decode_steps_total for e in fleet.engines().values())


def fleet_run(model, root, n_layers):
    """``fleet_24l``: the reference's serving_fleet leg (``bench.py:2085``)
    on the card.  The 24 prefix-group requests arrive in a wave (one tick
    between submits) at fleets of 1, 2 and 4 engines sharing one model
    (4 slots an engine, chunk 64, block 32, prefix sharing, a disk spill
    tier per fleet); then, on 2 engines each: ``retire`` (``retire_engine``
    of the owner of a live request mid-burst, its requests migrated
    through their transfer files), ``chaos`` (``hard_abandon`` of one
    engine mid-burst with ``min_engines=2``, so its replacement is
    spawned) and ``http`` (the wave from 24 client threads through
    ``ServingHTTPFrontend(fleet)``, ``/metrics`` parsed).  Holds: every
    run's tokens equal the 1-engine run's (no token lost), K1 launched
    ``n_layers`` times a decode step, a survivor's step keys unchanged by
    a migration, and after the abandon and the respawn
    ``torch.cuda.memory_allocated()`` no higher than before the abandon
    plus one engine's pool and graphs."""
    import shutil

    import torch

    from paddle_tpu_torch import ServingHTTPFrontend

    prompts, warm = fleet_traffic(model.vocab_size)
    n = len(prompts)
    out = {}
    want = None
    for engines in (1, 2, 4):
        spill = durable_dir(root, "fleet-%d" % engines)
        fleet = _fleet(model, spill, engines)
        base = {}

        def after_warm(fleet=fleet, base=base):
            base["routed"] = {k: c.value for k, c in fleet._routed.items()}
            base["steps"] = _decode_steps(fleet)

        st, wall, launches, itl = _burst(
            fleet, prompts, FLEET_NEW, _warm_each(fleet, warm),
            after_warm=after_warm, between=1)
        steps = _decode_steps(fleet) - base["steps"]
        k1 = launches["paged_decode_attention_kernel"]
        assert k1 > 0 and k1 == n_layers * steps, (k1, steps)
        assert launches["decode_attention_kernel"] == 0, launches
        got = {s.request_id: list(s.tokens) for s in st}
        if want is None:
            want = got
        same = sum(got[r] == want[r] for r in want)
        assert same == n, ("tokens differ from one engine's", engines, same)
        routed = {k: int(c.value - base["routed"][k])
                  for k, c in fleet._routed.items()}
        sub = _latency(st, wall, itl, FLEET_NEW)
        sub.update(engines=engines, identical_requests=same,
                   routed=routed, k1_launches=k1, decode_steps=steps,
                   prefix_affinity_hit_rate=routed["affinity"] / n,
                   prefix_hits=sum(e.prefix_stats()["hits"]
                                   for e in fleet.engines().values()))
        out["engines_%d" % engines] = sub
        _fleet_down(fleet)
        shutil.rmtree(spill, ignore_errors=True)

    # retire: the owner of a live request drained out mid-burst
    spill = durable_dir(root, "fleet-retire")
    fleet = _fleet(model, spill, 2)
    for w in _warm_each(fleet, warm):
        w()
    _settle(fleet)
    streams = []
    for i, p in enumerate(prompts):
        streams.append(fleet.submit(p, FLEET_NEW, request_id="r%d" % i))
        fleet.pump(1)
    victim = next(r.engine_id for r in fleet._records.values())
    survivor = "e1" if victim == "e0" else "e0"
    keys = fleet.engines()[survivor].compile_counts()
    donor = fleet.engines()[victim]
    # every DECODING victim must travel through its PTKV file (a failed
    # preempt or write would fall back to a resubmit with the same
    # tokens): its written blocks, ceil((prompt + committed - 1) / block)
    decoding = [r for r in donor._live.values()
                if r.rid in fleet._records
                and donor.request_state(r.rid) == "DECODING"]
    stats = donor.cache_stats()
    block_bytes = stats["pool_bytes"] // stats["num_blocks"]
    want_ptkv = block_bytes * sum(
        -(-(len(r.prompt) + len(r.tokens) - 1) // stats["block_size"])
        for r in decoding)
    spilled0 = donor._c_spill_bytes.value
    migrations0 = fleet._c_migrations.value
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.retire_engine(victim, reason="smoke-retire")
    retire_s = time.perf_counter() - t0
    ptkv = donor._c_spill_bytes.value - spilled0
    while fleet.pump(4):
        pass
    got = {s.request_id: list(s.result(timeout_s=0).tokens)
           for s in streams}
    assert got == want, "retire changed tokens"
    assert fleet.engines()[survivor].compile_counts() == keys
    assert res["migrated"] >= 1 and decoding, (res, len(decoding))
    assert res["adopted_from_file"] == len(decoding), (res, len(decoding))
    assert ptkv == want_ptkv, (ptkv, want_ptkv)
    assert fleet._c_migrations.value - migrations0 == res["migrated"]
    out["retire"] = {"migrated": res["migrated"],
                     "decoding_at_retire": len(decoding),
                     "adopted_from_file": res["adopted_from_file"],
                     "ms_per_migrated_request":
                         retire_s * 1e3 / res["migrated"],
                     "ptkv_bytes": int(ptkv),
                     "ptkv_bytes_per_request": ptkv / res["migrated"],
                     "survivor_compile_counts": keys}
    _fleet_down(fleet)
    shutil.rmtree(spill, ignore_errors=True)

    # chaos: one engine abandoned mid-burst, its replacement spawned
    spill = durable_dir(root, "fleet-chaos")
    gc.collect()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    fleet = _fleet(model, spill, 2, min_engines=2)
    for w in _warm_each(fleet, warm):
        w()
    _settle(fleet)
    torch.cuda.synchronize()
    per_engine = (torch.cuda.memory_allocated() - alloc0) / 2
    streams = [fleet.submit(p, FLEET_NEW, request_id="r%d" % i)
               for i, p in enumerate(prompts)]
    fleet.pump(2)
    victim = next(r.engine_id for r in fleet._records.values())
    survivor = "e1" if victim == "e0" else "e0"
    keys = fleet.engines()[survivor].compile_counts()
    pre = {r.rid: len(r.tokens) for r in fleet._records.values()
           if r.engine_id == victim}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    migrated = fleet.hard_abandon(victim, error="smoke-chaos")
    while any(rid in fleet._records
              and len(fleet._records[rid].tokens) <= pre[rid]
              for rid in migrated):
        fleet.pump(1)
    rto = time.perf_counter() - t0
    while fleet.pump(4):
        pass
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    got = {s.request_id: list(s.result(timeout_s=0).tokens)
           for s in streams}
    assert got == want, "the abandon lost or changed tokens"
    assert fleet.engines()[survivor].compile_counts() == keys
    states = fleet.engine_states()
    assert states[victim] == "dead" and len(
        [s for s in states.values() if s == "active"]) == 2, states
    assert after <= before + per_engine, (after, before, per_engine)
    # every victim was adopted by a survivor (none failed), one migration
    # each
    assert sorted(migrated) == sorted(pre), (migrated, pre)
    assert fleet._c_migrations.value == len(migrated), (
        fleet._c_migrations.value, len(migrated))
    out["chaos"] = {"victims": len(migrated), "recovery_ms": rto * 1e3,
                    "engines": states,
                    "memory_before_abandon_mb": before / 2 ** 20,
                    "memory_after_respawn_mb": after / 2 ** 20,
                    "one_engine_mb": per_engine / 2 ** 20,
                    "migrations": int(fleet._c_migrations.value)}
    _fleet_down(fleet)
    shutil.rmtree(spill, ignore_errors=True)

    # http: the wave from one client thread a request through the fleet
    spill = durable_dir(root, "fleet-http")
    fleet = _fleet(model, spill, 2)
    for w in _warm_each(fleet, warm):
        w()
    _settle(fleet)
    front = ServingHTTPFrontend(fleet, host="127.0.0.1", port=0).start()
    base = "http://%s:%d" % front.address
    try:
        finals, wall, probes = _http_wave(base, prompts, [FLEET_NEW] * n)
        status, body = _http_get(base, "/metrics")
    finally:
        front.shutdown()
    assert status == 200
    scrape = _parse_prometheus(body.decode())
    same = sum(f["tokens"] == want["r%d" % i] for i, f in enumerate(finals))
    assert same == n, ("HTTP tokens differ from one engine's", same)
    labelled = {k.split('engine="')[1].split('"')[0] for k in scrape
                if 'engine="' in k}
    assert labelled == {"e0", "e1"}, labelled
    assert scrape["serving_requests_submitted_total"] == n + 0.0
    assert probes and all(c == 200 for c in probes), probes
    out["http"] = {"requests": n, "identical_requests": same,
                   "wall_s": wall,
                   "tokens_per_s": n * FLEET_NEW / wall,
                   "engine_labels": sorted(labelled),
                   "routed": {r: scrape['fleet_requests_routed_total'
                                        '{reason="%s"}' % r]
                              for r in ("affinity", "load")},
                   "metrics_samples": len(scrape)}
    _fleet_down(fleet)
    shutil.rmtree(spill, ignore_errors=True)
    return out


# -- multi-LoRA serving and the recurrent model class -------------------------


def _drain(target):
    while target.pump(8):
        pass


def _adapter_ids(adapter):
    """The LoRA adapter ``adapter`` ambient for an uncached forward (the
    greedy-gap check of an adapter request)."""
    import torch

    from paddle_tpu_torch.nn import lora

    return lora.adapter_ids(torch.tensor([int(adapter)], device="cuda"))


def _weight_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _lora_engine(model, **kw):
    """An engine of the serving_lora leg: 8 slots, one 256-token bucket,
    the main path's paged cache (2048 positions, block 32), so K1 runs
    at the main path's shape."""
    from paddle_tpu_torch import ServingEngine

    return ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                         buckets=[LORA_PROMPT], max_queue=4 * LORA_REQUESTS,
                         cache_layout="paged", block_size=MAIN_BLOCK,
                         device="cuda", **kw)


def _lora_leg(engine, prompts, adapters, rids, warm, n_layers):
    """Warm ``engine`` (3 new tokens: its steps warmed up and captured),
    then serve ``prompts`` on ``adapters`` greedily, the K1/K2 counts set
    to 0 just before and read just after.  Holds: every step key was met
    in the warm-up (no capture inside the traffic, the cost version
    unmoved) and K1 ran ``n_layers`` times a decode step.  Returns
    ``({rid: tokens}, metrics)``."""
    import torch

    from paddle_tpu_torch.ops import decode_kernels as dk

    engine.submit(warm, 3)
    _drain(engine)
    pool = engine.pool
    keys0 = engine.compile_counts()
    cost0 = pool.cost_version()
    steps0 = pool.decode_steps_total
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    streams = [engine.submit(p, LORA_NEW, request_id=r, adapter=a)
               for p, a, r in zip(prompts, adapters, rids)]
    _drain(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dk.launch_counts()
    steps = pool.decode_steps_total - steps0
    tokens = {}
    for s in streams:
        st = s.result(timeout_s=0)
        assert st.state == "DONE" and len(st.tokens) == LORA_NEW, st
        tokens[s.request_id] = list(st.tokens)
    k1 = launches["paged_decode_attention_kernel"]
    assert k1 == n_layers * steps and k1 > 0, (launches, steps)
    compiled = sum(engine.compile_counts().values()) - sum(keys0.values())
    cost_moves = pool.cost_version() - cost0
    assert compiled == 0 and cost_moves == 0, (compiled, cost_moves)
    return tokens, {"requests": len(prompts), "wall_s": wall,
                    "tokens_per_s": len(prompts) * LORA_NEW / wall,
                    "decode_steps": steps, "k1_launches": k1,
                    "k1_per_decode_step": k1 / steps,
                    "compiles_during_traffic": compiled,
                    "cost_version_moves": cost_moves}


def _delta_alone_ms(model, rows: int) -> float:
    """Device ms of every bank-attached Linear's delta alone at the decode
    step's shape (``rows`` slots, one token each, ids 1..rows), one
    captured replay: the delta's own cost a step, measured apart from
    the step's other kernels."""
    import torch

    from paddle_tpu_torch.nn import lora

    ids = (torch.arange(rows, device="cuda") % (lora.lora_config(model)[0]
                                                - 1) + 1).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(5)
    fns = []
    for _, lin in lora.lora_linears(model):
        x = torch.randn(rows, 1, lin.in_features, device="cuda",
                        generator=gen)
        out = torch.zeros(rows, 1, lin.out_features, device="cuda")
        fns.append(lambda x=x, out=out, lin=lin: lora.apply_delta(
            out, x, lin.lora_a, lin.lora_b, ids))
    return graph_ms(fns, reps=2) * len(fns)


def lora_run(cfg, rng):
    """``lora_24l``: the reference's serving_lora leg (``bench.py:2324``)
    at GPT-1.3B width and full depth: 16 greedy 256-token prompts, 32 new
    tokens each, request i on adapter ``(i % 8) + 1``, through 8-slot
    paged engines (block 32).  Legs: ``bankless`` (an engine built before
    the bank, on adapter 0), ``adapters_1`` (every request on adapter 0
    through the engine over a 9-row rank-16 bank on q/k/v/out_proj, 96
    Linears), ``shared_8`` (all 8 adapters mixed in one batch),
    ``dedicated_8`` (8 one-adapter engines over 2-row banks, built one at
    a time, each released before the next), and a hot load into the live
    bank engine.  Holds: ``adapters_1`` equals ``bankless`` bit for bit;
    every ``dedicated_8`` request equals its ``shared_8`` tokens
    (``tokens_lost == 0``); the bankless engine refuses a nonzero adapter
    after the bank is attached; no leg captures during its traffic or
    moves the cost version; the hot load keeps the decode graph and
    changes the served tokens; K1 24 launches a decode step.  Records each
    leg's tokens/s, the weight bytes shared against dedicated, the decode
    graph's device ms with the bank against without (``profile_decode``)
    and the delta's own device ms."""
    import torch

    from paddle_tpu_torch import InvalidArgumentError, TransformerLM
    from paddle_tpu_torch.nn import lora

    n_layers = cfg["num_layers"]
    model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
    vocab = model.vocab_size
    prompts = [rng.randint(0, vocab, (LORA_PROMPT,)).astype(np.int32)
               for _ in range(LORA_REQUESTS)]
    warm = rng.randint(0, vocab, (LORA_PROMPT,)).astype(np.int32)
    adapters = [(i % LORA_ADAPTERS) + 1 for i in range(LORA_REQUESTS)]
    rids = ["r%d" % i for i in range(LORA_REQUESTS)]
    out = {"adapters": LORA_ADAPTERS, "rank": LORA_RANK,
           "prompt": LORA_PROMPT, "new_tokens": LORA_NEW,
           "slots": MAIN_SLOTS}

    engine = _lora_engine(model)
    base, out["bankless"] = _lora_leg(engine, prompts, [0] * len(prompts),
                                      rids, warm, n_layers)
    out["bankless"]["weight_hbm_bytes"] = _weight_bytes(model)
    lora.attach_lora(model, n_adapters=LORA_ADAPTERS + 1, rank=LORA_RANK)
    try:  # the engine read the (absent) bank at construction
        engine.submit(prompts[0], 2, adapter=1)
        raise AssertionError("a bank attached after the engine was served")
    except InvalidArgumentError:
        pass
    engine.release_device()
    del engine
    weights = {k: lora.random_adapter(model, seed=k)
               for k in range(1, LORA_ADAPTERS + 1)}
    engine = _lora_engine(model)
    for k, w in weights.items():
        engine.load_adapter(k, w)
    bank_bytes = lora.adapter_bank_bytes(model)
    got, out["adapters_1"] = _lora_leg(engine, prompts, [0] * len(prompts),
                                       rids, warm, n_layers)
    same = sum(got[r] == base[r] for r in rids)
    assert same == len(rids), ("adapter 0 differs from the bankless "
                               "engine", same)
    out["adapters_1"].update(identical_to_bankless=same,
                             weight_hbm_bytes=_weight_bytes(model),
                             adapter_bank_bytes=bank_bytes)
    shared, out["shared_8"] = _lora_leg(engine, prompts, adapters, rids,
                                        warm, n_layers)
    out["shared_8"].update(weight_hbm_bytes=_weight_bytes(model),
                           adapter_bank_bytes=bank_bytes,
                           requests_differing_from_base=sum(
                               shared[r] != base[r] for r in rids))
    for i in (0, LORA_REQUESTS - 1):
        with _adapter_ids(adapters[i]):
            gap = greedy_gap(model, prompts[i], np.asarray(shared[rids[i]]))
        assert gap <= GREEDY_TOL["float32"], (i, gap)
    # the hot load: a row written in place on the live engine
    fn = engine.pool._decode_fn
    graphs = {k: v for k, v in fn._keys.items()}
    keys0, cost0 = engine.compile_counts(), engine.pool.cost_version()
    fresh = lora.random_adapter(model, seed=101)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.load_adapter(1, fresh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    st = engine.submit(prompts[0], LORA_NEW, adapter=1).result()
    hot = list(st.tokens)
    assert all(fn._keys[k] is v for k, v in graphs.items()), \
        "the hot load dropped or re-captured the decode graph"
    hot_compiles = sum(engine.compile_counts().values()) \
        - sum(keys0.values())
    hot_cost_moves = engine.pool.cost_version() - cost0
    assert hot_compiles == 0 and hot_cost_moves == 0, (hot_compiles,
                                                      hot_cost_moves)
    assert hot != shared[rids[0]], "the hot-loaded adapter served old rows"
    out["hot_load"] = {"load_ms": load_ms, "hot_load_compiles": hot_compiles,
                       "cost_version_moves": hot_cost_moves,
                       "tokens_changed": int(sum(
                           a != b for a, b in zip(hot, shared[rids[0]])))}
    engine.load_adapter(1, weights[1])
    engine.release_device()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # the decode graph with the bank against without, at the main
    # profile's shape (8 slots at ~1k context): without is a fresh model
    # of the same seed, so the weights are the same
    with_bank = profile_decode(model, rng,
                               adapters=list(range(1, MAIN_SLOTS + 1)))
    delta_ms = _delta_alone_ms(model, MAIN_SLOTS)
    base_model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
    bankless_profile = profile_decode(base_model, rng)
    del base_model
    gc.collect()
    torch.cuda.empty_cache()
    out["decode_graph"] = {
        "bankless_ms": bankless_profile["graph_device_ms_per_step"],
        "bank_ms": with_bank["graph_device_ms_per_step"],
        "bank_minus_bankless_ms":
            with_bank["graph_device_ms_per_step"]
            - bankless_profile["graph_device_ms_per_step"],
        "bankless_kernels_per_step": bankless_profile["kernels_per_step"],
        "bank_kernels_per_step": with_bank["kernels_per_step"],
        "delta_launches_per_step": with_bank["kernels_per_step"]
        - bankless_profile["kernels_per_step"],
        "delta_alone_device_ms_per_step": delta_ms,
        "bankless_device_busy_ms": bankless_profile["device_busy_ms_per_step"],
        "bank_device_busy_ms": with_bank["device_busy_ms_per_step"],
        "bankless_wall_ms": bankless_profile["wall_ms_per_step"],
        "bank_wall_ms": with_bank["wall_ms_per_step"]}

    # dedicated: 8 one-adapter engines, one at a time
    dedicated, walls, steps, k1 = {}, [], 0, 0
    ded_bytes = 0
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for k in range(1, LORA_ADAPTERS + 1):
        m = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
        lora.attach_lora(m, n_adapters=2, rank=LORA_RANK)
        lora.load_adapter(m, 1, weights[k])
        ded_bytes += _weight_bytes(m)
        idx = [i for i, a in enumerate(adapters) if a == k]
        eng = _lora_engine(m)
        got, leg = _lora_leg(eng, [prompts[i] for i in idx], [1] * len(idx),
                             [rids[i] for i in idx], warm, n_layers)
        dedicated.update(got)
        walls.append(leg["wall_s"])
        steps += leg["decode_steps"]
        k1 += leg["k1_launches"]
        eng.release_device()
        del eng, m
        gc.collect()
        torch.cuda.empty_cache()
    lost = sum(dedicated[r] != shared[r] for r in rids)
    assert lost == 0, ("dedicated engines differ from the shared bank", lost)
    out["dedicated_8"] = {"engines": LORA_ADAPTERS, "wall_s": sum(walls),
                          "tokens_per_s": LORA_REQUESTS * LORA_NEW
                          / sum(walls),
                          "decode_steps": steps, "k1_launches": k1,
                          "tokens_lost": lost,
                          "weight_hbm_bytes": ded_bytes}
    out["weight_bytes_saved"] = ded_bytes - out["shared_8"]["weight_hbm_bytes"]
    out["k1_launches"] = (out["bankless"]["k1_launches"]
                          + out["adapters_1"]["k1_launches"]
                          + out["shared_8"]["k1_launches"] + k1)
    return out


def _mixed_configs(seed):
    """The reference test's mixed batch (``tests/test_lora_sampling.py:83``):
    greedy + three sampled configs across adapters {0, 1, 2}."""
    return [dict(),
            dict(temperature=0.8, seed=seed + 100),
            dict(temperature=1.1, top_k=12, seed=seed + 200, adapter=1),
            dict(temperature=0.6, top_p=0.9, seed=seed + 300, adapter=2)]


def lora_mixed_run(cfg, root):
    """``lora_mixed_4l``: 4 layers at GPT-1.3B width over a 4-row rank-16
    bank.  Legs: ``dense`` (K2: the reference test's mixed batch for two
    seeds, 8 requests on 8 slots, served twice with the configs permuted
    across slots: every request's tokens equal in both waves, one decode
    key, K2 4 launches a step); ``preempt`` (a paged pool on the disk
    tier: the sampled adapter-1 request preempted after 2 ticks resumes
    byte-identically to an uninterrupted run, with no new key);
    ``speculative`` (a ``SpeculativePool`` over the bank, spec_k 4, a
    2-layer draft: K1 at Lq 5, 4 launches a round; greedy tokens within
    the greedy limit of a plain pool's on each row's adapter); ``fleet``
    (2 engines with ``register_adapter``: retiring the owner of a live
    adapter request migrates its rows through PTKV, and every request's
    tokens equal one engine's)."""
    import shutil

    import torch

    from paddle_tpu_torch import (GenerationPool, ServingEngine,
                                  TransformerLM)
    from paddle_tpu_torch.inference import SpeculativePool
    from paddle_tpu_torch.nn import lora
    from paddle_tpu_torch.ops import decode_kernels as dk
    from paddle_tpu_torch.serving import ServingFleet

    short = dict(cfg, num_layers=SHORT_LAYERS)
    model = TransformerLM(**short, dropout=0.0, device="cuda", seed=0)
    lora.attach_lora(model, n_adapters=4, rank=LORA_RANK)
    weights = {k: lora.random_adapter(model, seed=k) for k in (1, 2, 3)}
    for k, w in weights.items():
        lora.load_adapter(model, k, w)
    vocab = model.vocab_size
    rng = np.random.RandomState(7)
    lens = LORA_MIXED_LENS * 2
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]
    configs = _mixed_configs(0) + _mixed_configs(1)
    out = {}

    # dense: the mixed batch, twice, the configs permuted across slots
    pool = GenerationPool(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                          buckets=[LORA_PROMPT], cache_layout="dense",
                          device="cuda")
    pool.generate([prompts[0]], 3)  # warm-up and capture
    waves = []
    for order in (list(range(8)), list(range(8))[::-1]):
        steps0 = pool.decode_steps_total
        torch.cuda.synchronize()
        dk.reset_launch_counts()
        t0 = time.perf_counter()
        for i in order:
            pool.submit(prompts[i], LORA_NEW, request_id=i, **configs[i])
        got = pool.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dk.launch_counts()
        steps = pool.decode_steps_total - steps0
        assert launches["decode_attention_kernel"] == SHORT_LAYERS * steps \
            and launches["paged_decode_attention_kernel"] == 0, launches
        waves.append((got, wall, launches["decode_attention_kernel"],
                      steps))
    same = sum(np.array_equal(waves[0][0][i], waves[1][0][i])
               for i in range(8))
    assert same == 8, ("the mixed batch is not deterministic per (seed, "
                       "step)", same)
    counts = pool.compile_counts()
    assert counts["pool_decode"] == 1 and pool._decode_fn.graphs() == 1
    with _adapter_ids(0):
        gap = greedy_gap(model, prompts[0], waves[0][0][0])
    assert gap <= GREEDY_TOL["float32"], gap
    out["dense"] = {"requests": 8, "identical_across_waves": same,
                    "tokens_per_s": 8 * LORA_NEW / waves[0][1],
                    "k2_launches": waves[0][2] + waves[1][2],
                    "decode_steps": waves[0][3] + waves[1][3],
                    "compile_counts": counts, "greedy_gap": gap}
    pool.release_device()
    del pool

    # preempt: a sampled adapter row through the disk tier
    spill = durable_dir(root, "lora-preempt")
    subs = [(prompts[0], dict(temperature=1.0, seed=21, adapter=1)),
            (prompts[1], dict()), (prompts[2], dict(temperature=0.7,
                                                    seed=22, adapter=2))]

    def spill_pool():
        p = GenerationPool(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           buckets=[LORA_PROMPT], cache_layout="paged",
                           block_size=MAIN_BLOCK, spill_tier="disk",
                           spill_dir=spill, device="cuda")
        p.generate([prompts[3]], 3)
        for i, (ids, c) in enumerate(subs):
            p.submit(ids, LORA_NEW, request_id="r%d" % i, **c)
        return p

    p = spill_pool()
    want = p.run()
    keys = p.compile_counts()
    p.release_device()
    p = spill_pool()
    p.step()
    p.step()
    info = p.preempt("r0")
    assert os.listdir(spill), "no PTKV file written"
    got = p.run()
    same = sum(np.array_equal(got[r], want[r]) for r in want)
    assert same == len(want), ("the resumed adapter row differs", same)
    assert p.compile_counts() == keys and not os.listdir(spill)
    out["preempt"] = {"identical_requests": same,
                      "spill_bytes": info["spill_bytes"],
                      "committed_at_preempt": info["committed_tokens"],
                      "compile_counts": keys}
    p.release_device()
    shutil.rmtree(spill, ignore_errors=True)

    # speculative: the target judges each row under its own adapter
    draft = TransformerLM(**dict(cfg, num_layers=SPEC_DRAFT_LAYERS),
                          dropout=0.0, device="cuda", seed=1)
    greedy = [prompts[i] for i in range(4)]
    spec_adapters = [0, 1, 2, 3]
    plain = GenerationPool(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           buckets=[LORA_PROMPT], cache_layout="paged",
                           block_size=MAIN_BLOCK, device="cuda")
    plain.generate([prompts[3]], 3)
    for i, (p_, a) in enumerate(zip(greedy, spec_adapters)):
        plain.submit(p_, LORA_NEW, request_id=i, adapter=a)
    want = plain.run()
    plain.release_device()
    spec = SpeculativePool(model, draft, max_len=MAIN_MAX_LEN,
                           spec_k=SPEC_K, slots=MAIN_SLOTS,
                           buckets=[LORA_PROMPT], cache_layout="paged",
                           block_size=MAIN_BLOCK, device="cuda")
    spec.generate([prompts[3]], 4 * VERIFY_LQ)
    assert spec._verify_fn.graphs() == 1
    spec.reset_acceptance_stats()
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    for i, (p_, a) in enumerate(zip(greedy, spec_adapters)):
        spec.submit(p_, LORA_NEW, request_id=i, adapter=a)
    got = spec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dk.launch_counts()
    acc = spec.acceptance_stats()
    rounds = acc["rounds"]
    assert launches["paged_decode_attention_kernel"] \
        == SHORT_LAYERS * rounds, (launches, rounds)
    held = 0
    for i, a in enumerate(spec_adapters):
        with _adapter_ids(a):
            held += _tokens_hold(model, greedy[i], np.asarray(got[i]),
                                 np.asarray(want[i]), GREEDY_TOL["float32"])
    out["speculative"] = {"requests": len(greedy), "identical_requests": held,
                          "rounds": rounds,
                          "acceptance_rate": acc["acceptance_rate"],
                          "k1_verify_launches":
                              launches["paged_decode_attention_kernel"],
                          "draft_k2_launches":
                              launches["decode_attention_kernel"],
                          "tokens_per_s": len(greedy) * LORA_NEW / wall,
                          "compile_counts": spec.compile_counts()}
    spec.release_device()
    del spec, draft
    gc.collect()
    torch.cuda.empty_cache()

    # fleet: register_adapter on 2 engines, a retire migrates adapter rows
    spill = durable_dir(root, "lora-fleet")
    fleet_prompts = prompts[:6]
    fleet_adapters = [1, 2, 3, 1, 2, 3]
    fleet_kw = dict(max_len=MAIN_MAX_LEN, slots=4, buckets=[LORA_PROMPT],
                    cache_layout="paged", block_size=MAIN_BLOCK,
                    spill_tier="disk", spill_dir=spill, device="cuda")
    one = ServingEngine(model, **fleet_kw)
    streams = [one.submit(p_, LORA_NEW, request_id="f%d" % i, adapter=a)
               for i, (p_, a) in enumerate(zip(fleet_prompts,
                                               fleet_adapters))]
    _drain(one)
    want = {s.request_id: list(s.result(timeout_s=0).tokens)
            for s in streams}
    one.release_device()
    del one

    # each engine gets its own model and an empty bank of the same
    # geometry: only register_adapter can fill its rows
    def factory(engine_id, registry):
        own = TransformerLM(**short, dropout=0.0, device="cuda", seed=0)
        lora.attach_lora(own, n_adapters=4, rank=LORA_RANK)
        return ServingEngine(own, metrics=registry, **fleet_kw)

    fleet = ServingFleet(factory, engines=2)
    banks = [lora.lora_linears(e._pool._model)[0][1].lora_a
             for e in fleet.engines().values()]
    assert banks[0].data_ptr() != banks[1].data_ptr() \
        and not any(b.any().item() for b in banks), "banks not separate"
    for k, w in weights.items():
        fleet.register_adapter(k, w)
    assert fleet.adapters == (1, 2, 3)
    first = lora.lora_linears(model)[0][1].lora_a
    assert all(torch.equal(b, first) for b in banks), \
        "register_adapter did not load every engine's rows"
    streams = []
    for i, (p_, a) in enumerate(zip(fleet_prompts, fleet_adapters)):
        streams.append(fleet.submit(p_, LORA_NEW, request_id="f%d" % i,
                                    adapter=a))
        fleet.pump(1)
    fleet.pump(2)
    victim = next(r.engine_id for r in fleet._records.values())
    donor = fleet.engines()[victim]
    decoding = sum(1 for r in donor._live.values()
                   if r.rid in fleet._records and r.adapter
                   and donor.request_state(r.rid) == "DECODING")
    spilled0 = donor._c_spill_bytes.value
    res = fleet.retire_engine(victim, reason="smoke-lora-retire")
    ptkv = donor._c_spill_bytes.value - spilled0
    while fleet.pump(4):
        pass
    got = {s.request_id: list(s.result(timeout_s=0).tokens)
           for s in streams}
    same = sum(got[r] == want[r] for r in want)
    assert same == len(want), ("the fleet's adapter tokens differ from one "
                               "engine's", same)
    assert decoding and res["adopted_from_file"] == decoding, (res, decoding)
    out["fleet"] = {"requests": len(want), "identical_requests": same,
                    "migrated": res["migrated"],
                    "adapter_rows_decoding_at_retire": decoding,
                    "adopted_from_file": res["adopted_from_file"],
                    "ptkv_bytes": int(ptkv)}
    _fleet_down(fleet)
    shutil.rmtree(spill, ignore_errors=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["k2_launches"] = out["dense"]["k2_launches"]
    out["k1_verify_launches"] = out["speculative"]["k1_verify_launches"]
    return out


def ssm_run(cfg, rng, root):
    """``ssm_24l``: an ``SSMLM`` at GPT-1.3B's widths (vocab 50304, hidden
    2048, 24 layers, d_state 4096; ~0.91 B parameters) on the recurrent
    layout.  The reference's decode_ssm leg (``bench.py:701``): a
    ``DecodeSession`` (bucket 512, 128 new tokens) at batch 1 and batch 8,
    each on a fresh session: one prefill key and one decode key, the
    decode step's graph device ms by CUDA events around each replay, the
    bucketed prefill timed alone (host ms with a synchronize on both
    sides; its kernels and device busy share from one profiled prefill).
    Then an 8-slot engine serves 16 greedy 512-token prompts, 64 new
    tokens each; two are held against the eager per-token loop (equal, or
    both within the greedy limit of an uncached forward).  Then two
    victims preempted after 8 ticks, on the host and on the disk tier,
    resume byte-identically to an uninterrupted run.  No decode kernel
    runs on this path (no attention)."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import DecodeSession, GenerationPool, ServingEngine
    from paddle_tpu_torch.nn import SSMLM
    from paddle_tpu_torch.ops import decode_kernels as dk

    model = SSMLM(vocab_size=cfg["vocab_size"],
                  hidden_size=cfg["hidden_size"],
                  num_layers=cfg["num_layers"], d_state=SSM_D_STATE,
                  device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    vocab = model.vocab_size
    max_len = SSM_BUCKET + SSM_NEW
    out = {"params": n_params, "d_state": SSM_D_STATE,
           "weight_bytes": _weight_bytes(model)}
    dk.reset_launch_counts()
    for batch in (1, MAIN_SLOTS):
        sess = DecodeSession(model, max_len=max_len, buckets=[SSM_BUCKET],
                             cache_layout="recurrent", device="cuda")
        ids = rng.randint(0, vocab, (batch, SSM_BUCKET)).astype(np.int32)
        sess.generate(ids, 3)  # warm-up and capture
        hook = sess._decode_fn = _StepHook(sess._decode_fn, events=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.generate(ids, SSM_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms = hook.event_ms()
        sess._decode_fn = hook.fn
        counts = sess.compile_counts()
        assert counts == {"prefill": 1, "decode": 1}, counts
        assert sess._decode_fn.graphs() == 1
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sess.prefill(ids)
        torch.cuda.synchronize()
        alone_ms = (time.perf_counter() - t1) * 1e3
        leg = {"batch": batch, "wall_s": wall,
               "tokens_per_s": batch * SSM_NEW / wall,
               "decode_step_graph_ms": step_ms,
               "decode_tokens_per_s": batch / step_ms * 1e3,
               "prefill_ms_alone": alone_ms, "compile_counts": counts}
        if batch == 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                sess.prefill(ids)
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t1) * 1e3
            rows = device_time_rows(prof)
            busy = sum(r[0] for r in rows)
            leg.update(profiled_prefill_ms=prof_ms,
                       prefill_device_busy_ms=busy,
                       prefill_kernels=sum(r[2] for r in rows),
                       prefill_device_idle_share=(1 - busy / prof_ms)
                       if busy else None,
                       prefill_top=[{"kernel": k[:60], "ms": ms, "calls": n}
                                    for ms, k, n in rows[:5]])
        out["session_batch%d" % batch] = leg
        del sess
        gc.collect()
        torch.cuda.empty_cache()

    # the engine: 16 greedy 512-token prompts, 64 new tokens each
    prompts = [rng.randint(0, vocab, (SSM_BUCKET,)).astype(np.int32)
               for _ in range(SSM_REQUESTS)]
    engine = ServingEngine(model, max_len=max_len, slots=MAIN_SLOTS,
                           buckets=[SSM_BUCKET], max_queue=4 * SSM_REQUESTS,
                           cache_layout="recurrent", device="cuda")
    engine.submit(prompts[0], 3)
    _drain(engine)
    keys0 = engine.compile_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = [engine.submit(p, SSM_ENGINE_NEW) for p in prompts]
    _drain(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    statuses = [s.result(timeout_s=0) for s in streams]
    assert all(st.state == "DONE" and len(st.tokens) == SSM_ENGINE_NEW
               for st in statuses)
    assert engine.compile_counts() == keys0, (keys0,
                                              engine.compile_counts())
    stats = engine.cache_stats()
    held = 0
    for i in (0, SSM_REQUESTS - 1):
        cache = model.gen_decode_cache(1, max_len)
        with torch.no_grad():
            logits, cache = model(torch.from_numpy(
                prompts[i][None].astype(np.int64)).cuda(), cache=cache)
            eager = [int(logits[0, -1].argmax())]
            while len(eager) < SSM_ENGINE_NEW:
                logits, cache = model(torch.tensor([[eager[-1]]],
                                                   device="cuda"),
                                      cache=cache)
                eager.append(int(logits[0, -1].argmax()))
        held += _tokens_hold(model, prompts[i], np.asarray(statuses[i].tokens),
                             np.asarray(eager), GREEDY_TOL["float32"])
    ttft = sorted(st.ttft_s * 1e3 for st in statuses)
    state_bytes = stats["state_bytes_per_slot"]
    assert state_bytes == cfg["num_layers"] * SSM_D_STATE * 4, state_bytes
    kv_bytes_tf = 2 * cfg["num_layers"] * cfg["hidden_size"] * max_len * 4
    out["engine"] = {"requests": SSM_REQUESTS, "wall_s": wall,
                     "tokens_per_s": SSM_REQUESTS * SSM_ENGINE_NEW / wall,
                     "ttft_ms_p50": ttft[len(ttft) // 2],
                     "ttft_ms_max": ttft[-1],
                     "identical_to_eager_loop": held,
                     "compile_counts": keys0}
    out.update(state_bytes_per_slot=state_bytes,
               slots_per_gb=(1 << 30) // state_bytes,
               transformer_kv_bytes_per_slot=kv_bytes_tf,
               transformer_slots_per_gb=(1 << 30) // kv_bytes_tf)
    engine.release_device()
    del engine

    # preemption on both tiers, against an uninterrupted run
    victims = prompts[:MAIN_SLOTS]

    def run(**kw):
        p = GenerationPool(model, max_len=max_len, slots=MAIN_SLOTS,
                           buckets=[SSM_BUCKET], cache_layout="recurrent",
                           device="cuda", **kw)
        p.generate([victims[0]], 3)
        for i, ids in enumerate(victims):
            p.submit(ids, PREEMPT_NEW_TOKENS, request_id=i)
        return p

    p = run()
    want = p.run()
    p.release_device()
    for tier in ("host", "disk"):
        spill = durable_dir(root, "ssm-" + tier)
        kw = {} if tier == "host" else dict(spill_tier="disk",
                                            spill_dir=spill)
        p = run(**kw)
        for _ in range(PREEMPT_AFTER_TICKS):
            p.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = p.preempt(1)
        preempt_ms = (time.perf_counter() - t0) * 1e3
        got = p.run()
        same = sum(np.array_equal(got[r], want[r]) for r in want)
        assert same == len(want), (tier, same)
        assert info["state_bytes"] == state_bytes and \
            p.spill_stats()["upload_bytes_total"] == state_bytes
        out["preempt_" + tier] = {"identical_requests": same,
                                  "preempt_ms": preempt_ms,
                                  "state_bytes": info["state_bytes"]}
        p.release_device()
        shutil.rmtree(spill, ignore_errors=True)
    assert sum(dk.launch_counts().values()) == 0, dk.launch_counts()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- sharded serving: the decode mesh on one card ---------------------------

MESH_SHAPES = ((1, 2), (2, 1), (2, 2))
# a prompt whose top-2 logit margin along the unsharded greedy path clears
# this floor must decode the same tokens on every mesh (mp sums its
# partials in shard order: the logits move in their last bits)
MESH_MARGIN_FLOOR = GREEDY_TOL["float32"]
# one decode step's logits through the sharded forward against the
# unsharded forward's, as a share of their largest magnitude
MESH_LOGIT_RTOL = 1e-4
# the int8 seams' decode logits against the "none" mesh's, as a share of
# their largest magnitude, while the tokens agree (every seam is also held
# by the reference's two-hop bound, call by call)
INT8_SEAM_RTOL = 3e-2
MESH_TIMING_TICKS = 10
MESH_TIMING_CTX = 1024


def _mesh(dp, mp, **kw):
    from paddle_tpu_torch import DecodeMesh

    return DecodeMesh(dp, mp, devices=["cuda:0"] * (dp * mp), **kw)


def expect_raises(cls, fn):
    """The message of the ``cls`` that ``fn()`` raises; an AssertionError
    when it raises nothing (any other error propagates)."""
    try:
        fn()
    except cls as e:
        return str(e)
    raise AssertionError("%s was not raised" % cls.__name__)


def top2_margin(model, prompt, tokens):
    """Smallest top-2 logit margin over the positions that emitted
    ``tokens`` after ``prompt`` (one uncached forward)."""
    import torch

    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits = model(torch.from_numpy(seq)[None].cuda())[0]
    top2 = logits[len(prompt) - 1:].float().topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _check_shard_partition(pool):
    """Every dp shard's ``free + mapped + spilled + scratch`` is its
    ``num_blocks / dp``, and no slot maps a block of another shard."""
    for e in pool.cache_stats()["per_shard"]:
        assert e["free_blocks"] + e["mapped_blocks"] + e["spilled_blocks"] \
            + 1 == e["num_blocks"] == pool._num_blocks // pool.dp_shards, e
    for slot, blocks in pool._slot_blocks.items():
        assert {pool._shard_of_block(b) for b in blocks} \
            <= {pool._shard_of_slot(slot)}


def mesh_step_logits(model, mesh, rows, ctx, **cache_kw):
    """One decode step's logits through the sharded forward against the
    unsharded forward on the same ``rows`` x ``ctx`` prompt (prefilled
    first): ``max |a - b| / max |a|``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, model.vocab_size, (rows, ctx + 1), device="cuda",
                        generator=gen)
    mesh.place_weights(model)
    out = []
    for build in (model.gen_decode_cache, (
            lambda *a, **k: mesh.build_cache(model, *a, **k))):
        cache = build(rows, ctx + 8, layout="paged", block_size=MAIN_BLOCK,
                      **cache_kw)
        with torch.no_grad():
            _, cache = model(ids[:, :ctx], cache=cache)
            logits, _ = model(ids[:, ctx:], cache=cache)
        out.append(logits[:, 0].float())
        del cache
    return float((out[0] - out[1]).abs().max() / out[0].abs().max())


def mesh_serve(model, keep, n_layers, dp=1, mp=1, base=None):
    """The main traffic (the paged fp32 run's warm-up and prompts) through
    a fresh engine, over a ``dp`` x ``mp`` mesh on the card when ``base``
    (the unsharded engine's run of the same traffic on the same weights,
    with each prompt's top-2 margin) is given.  The K1 counts are set to
    0 just before the requests are driven and read just after."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.distributed.qcollectives import psum_wire_bytes
    from paddle_tpu_torch.ops import decode_kernels as dk

    kernel = "paged_decode_attention_kernel"
    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", cache_layout="paged",
                           block_size=MAIN_BLOCK,
                           mesh=None if base is None else _mesh(dp, mp))
    engine.submit(keep["warmup"], 3).result()
    pool = engine.pool
    steps0 = pool.decode_steps_total
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    streams = [engine.submit(p, MAIN_NEW_TOKENS) for p in keep["prompts"]]
    decode_tick_ms = []
    while True:
        n_prefill = pool.prefills_total
        ts = time.perf_counter()
        more = engine.pump(1)
        if pool.prefills_total == n_prefill:
            decode_tick_ms.append((time.perf_counter() - ts) * 1e3)
        if not more:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dk.launch_counts()
    steps = pool.decode_steps_total - steps0
    assert counts[kernel] == n_layers * dp * mp * steps, (counts, steps)
    assert all(n == 0 for k, n in counts.items() if k != kernel), counts
    compiled = engine.compile_counts()
    assert pool._decode_fn.graphs() == 1
    statuses = [s.status for s in streams]
    assert all(st.state == "DONE" for st in statuses), statuses
    tokens = [np.asarray(st.tokens) for st in statuses]
    out = {"mesh": [dp, mp], "requests": len(streams),
           "decode_steps": steps, "launches": counts,
           "k1_launches_per_step": counts[kernel] / steps,
           "tokens_per_s": len(streams) * MAIN_NEW_TOKENS / wall,
           "wall_s": wall,
           "decode_step_ms_p50": float(np.median(decode_tick_ms)),
           "decode_step_ms_mean": float(np.mean(decode_tick_ms)),
           "compile_counts": compiled}
    if base is None:
        out["tokens"] = tokens
    else:
        assert compiled == base["compile_counts"], (compiled, base)
        _check_shard_partition(pool)
        same, gaps = 0, [0.0]
        for prompt, got, want, margin in zip(
                keep["prompts"], tokens, base["tokens"], base["margins"]):
            if np.array_equal(got, want):
                same += 1
                continue
            # a prompt whose margin clears the floor must not differ;
            # another must still be greedy within the limit of an
            # uncached forward
            assert margin < MESH_MARGIN_FLOOR, ("mesh tokens differ",
                                                margin)
            gaps.append(greedy_gap(model, prompt, got))
        assert max(gaps) <= GREEDY_TOL["float32"], gaps
        derived = engine.cost_report()["derived"]
        stats = engine.cache_stats()
        snap = engine.metrics.snapshot()
        assert snap["serving_kv_resident_bytes_per_shard"] \
            == stats["pool_bytes"] // dp
        assert derived["mesh"]["dp"] == dp and derived["mesh"]["mp"] == mp
        out.update(
            same_tokens=same, greedy_max_gap=max(gaps),
            margin_gated=sum(m >= MESH_MARGIN_FLOOR
                             for m in base["margins"]),
            per_shard=stats["per_shard"],
            serving_kv_resident_bytes_per_shard=snap[
                "serving_kv_resident_bytes_per_shard"],
            serving_kv_reachable_bytes_max_shard=snap[
                "serving_kv_reachable_bytes_max_shard"],
            serving_mesh_devices=snap["serving_mesh_devices"])
        if mp > 1:
            # per device and token: each layer's two seams reduce one
            # [hidden] fp32 row over the mp ring
            formula = 2 * n_layers * psum_wire_bytes(
                (1, model.hidden_size), mp)
            assert derived["collective_bytes_per_token"] \
                == derived["collective_dense_bytes_per_token"] \
                == formula, (derived, formula)
            out.update(collective_bytes_per_token=formula,
                       collective_dense_bytes_per_token=formula,
                       collective_calls_per_step=derived[
                           "collective_calls_per_step"])
    engine.release_device()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_decode_ms(model, rng, mesh=None, ticks=MESH_TIMING_TICKS):
    """The decode graph's device ms a step with 8 busy slots at ~1k
    context (CUDA events around each replay), then ``ticks`` more under
    ``torch.profiler`` for the device's busy share and K1's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import ServingEngine

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", cache_layout="paged",
                           block_size=MAIN_BLOCK, mesh=mesh)
    pool = engine.pool
    for _ in range(MAIN_SLOTS):
        engine.submit(rng.randint(0, model.vocab_size, MESH_TIMING_CTX),
                      2 * ticks + 8)
    engine.pump(3)
    assert pool.active_count == MAIN_SLOTS and pool._decode_fn.graphs() == 1
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
        engine.pump(ticks)
        torch.cuda.synchronize()
    rows = [(ms / ticks, k, n // ticks) for ms, k, n in device_time_rows(prof)]
    busy = sum(r[0] for r in rows)
    k1 = sum(ms for ms, k, _ in rows
             if "decode_split_kernel" in k or "decode_combine_kernel" in k)
    engine.release_device()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"graph_device_ms_per_step": graph_ms_per_step,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy or None,
            "k1_device_ms_per_step": k1 or None,
            "kernels_per_step": sum(n for _, _, n in rows),
            "device_idle_share": (1 - graph_ms_per_step / wall_ms)}


def mesh_run(model, keep, n_layers):
    """``mesh_24l``: the 24-layer GPT-1.3B serves the main traffic over
    meshes (1, 2), (2, 1) and (2, 2) with every shard on ``cuda:0`` (K1
    at 16/mp heads on slots/dp rows, each shard's own contiguous pool),
    held against an unsharded engine's run of the same traffic on the
    model's current weights (tokens on margin-gated prompts, the
    compile counts, the per-shard block partition, K1 launches a step ==
    layers x dp x mp, the collective bytes a token == the ring formula);
    one decode step's logits against the unsharded forward's; the decode
    graph's device ms at each mesh beside the unsharded engine's (timed
    unsharded, meshes, unsharded in one call).  One card carries no
    interconnect: a mesh's step runs its shards' smaller launches one
    after another.  A grid over two cards is refused as a typed error."""
    from paddle_tpu_torch import DecodeMesh
    from paddle_tpu_torch.core.errors import UnimplementedError

    out = {"refusal": expect_raises(UnimplementedError, lambda: DecodeMesh(
        2, 1, devices=["cuda:0", "cuda:1"]))}
    # the unsharded engine on the model's current weights is the baseline
    base = mesh_serve(model, keep, n_layers)
    base["margins"] = [top2_margin(model, p, t)
                       for p, t in zip(keep["prompts"], base["tokens"])]
    out["unsharded"] = {k: v for k, v in base.items()
                        if k not in ("tokens", "margins")}
    out["margins_min"] = min(base["margins"])
    for dp, mp in MESH_SHAPES:
        label = "%dx%d" % (dp, mp)
        out[label] = mesh_serve(model, keep, n_layers, dp, mp, base)
        out[label]["step_logits_rel_err"] = mesh_step_logits(
            model, _mesh(dp, mp), MAIN_SLOTS, MAIN_MAX_LEN // 4)
        assert out[label]["step_logits_rel_err"] <= MESH_LOGIT_RTOL, out
        log("mesh_24l %s:" % label, json.dumps(out[label]))
    rng = np.random.RandomState(5)
    timing = {"unsharded": [mesh_decode_ms(model, rng)]}
    for dp, mp in MESH_SHAPES:
        timing["%dx%d" % (dp, mp)] = mesh_decode_ms(model, rng,
                                                    _mesh(dp, mp))
    timing["unsharded"].append(mesh_decode_ms(model, rng))
    flat_ms = min(t["graph_device_ms_per_step"]
                  for t in timing["unsharded"])
    for dp, mp in MESH_SHAPES:
        t = timing["%dx%d" % (dp, mp)]
        t["vs_unsharded"] = t["graph_device_ms_per_step"] / flat_ms
    out["decode_timing"] = timing
    # the model keeps no mp slices past the phase
    for lin in model.modules():
        lin.__dict__.pop("_mesh_parts", None)
    return out


def _checked_qpsum(record):
    """Wrap the seam's ``qpsum`` so every reduction is held against the
    fp32 sum of the same partials within the reference's two-hop bound
    (``test_qpsum_matches_psum_within_bound``); the worst share of the
    bound lands in ``record``."""
    from paddle_tpu_torch.distributed import qcollectives as qc

    real = qc.qpsum

    def checked(parts, scale_mode="block", block=qc.QUANT_BLOCK,
                devices=None):
        got = real(parts, scale_mode, block, devices)
        want = parts[0].float()
        for p in parts[1:]:
            want = want + p.float()
        amax_in = max(float(p.abs().max()) for p in parts)
        bound = len(parts) * amax_in / 254.0 \
            + float(want.abs().max()) / 254.0
        err = float((got[0].float() - want).abs().max())
        assert err <= bound * (1 + 1e-5) + 1e-6, (err, bound)
        record["calls"] = record.get("calls", 0) + 1
        record["max_share_of_bound"] = max(
            record.get("max_share_of_bound", 0.0), err / bound)
        return got

    qc.qpsum = checked
    return real


def _mesh_pool_run(model, prompts, mesh=None, checked=None, **kw):
    """``prompts`` through a fresh 8-slot pool (over ``mesh``), its decode
    step warmed up and captured first; tokens, each decode step's logits,
    the launch counts of the measured pass and the pool's figures.  With
    ``checked`` (a dict), the same traffic again through the step's eager
    entry with every int8 reduction held by :func:`_checked_qpsum` (a
    replay runs no Python); its tokens must equal the graph's."""
    import torch

    from paddle_tpu_torch import GenerationPool
    from paddle_tpu_torch.distributed import qcollectives as qc
    from paddle_tpu_torch.ops import decode_kernels as dk

    pool = GenerationPool(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                          device="cuda", mesh=mesh, **kw)
    pool.generate([np.arange(64) % model.vocab_size], 3)
    hook = pool._decode_fn = _StepHook(pool._decode_fn, logits=True)
    steps0 = pool.decode_steps_total
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = pool.generate(prompts, SHORT_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dk.launch_counts()
    steps = pool.decode_steps_total - steps0
    pool._decode_fn = hook.fn
    if checked is not None:
        pool._decode_fn = _StepHook(hook.fn, eager=True)
        real = _checked_qpsum(checked)
        try:
            again = pool.generate(prompts, SHORT_NEW_TOKENS)
        finally:
            qc.qpsum = real
            pool._decode_fn = hook.fn
        assert all(np.array_equal(a, b) for a, b in zip(tokens, again)), \
            "the eager int8 step differs from its graph"
    res = {"tokens": tokens, "logits": hook.logits, "launches": counts,
           "steps": steps, "wall_s": wall,
           "compile_counts": pool.compile_counts(),
           "stats": pool.cache_stats()}
    del pool
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _int8_logits_share(want, got):
    """Largest ``max |a - b| / max |a|`` over the decode steps while every
    request's tokens agree (a step whose inputs already differ is not a
    perturbation of the same step)."""
    worst, compared = 0.0, 0
    for t, (a, b) in enumerate(zip(want["logits"], got["logits"])):
        # step t reads tokens[t]: its inputs agree while tokens[:t + 1] do
        if not all(np.array_equal(w[:t + 1], g[:t + 1])
                   for w, g in zip(want["tokens"], got["tokens"])):
            break
        worst = max(worst, float((a - b).abs().max() / a.abs().max()))
        compared += 1
    assert compared >= 1
    return worst, compared


def mesh_int8_run(model, rng):
    """``mesh_int8_4l``: the 4-layer model of the same widths on the (2, 2)
    mesh.  ``collective_quant="int8"`` (block and channel scales) against
    "none": every seam within the reference's two-hop bound, the decode
    logits within ``INT8_SEAM_RTOL``, the keys unchanged and the wire
    bytes below the dense ring's.  Then the int8 KV cache on the mesh (K1's
    int8 path at 8 heads), the speculative pool over the mesh (K1 at Lq 5,
    8 heads; its 2-layer draft's K2 on the sharded draft cache) and the
    dense layout on the mesh (K2 at 8 heads, fp32 and int8), each held
    against the unsharded pool."""
    import torch

    from paddle_tpu_torch import TransformerLM
    from paddle_tpu_torch.inference import SpeculativePool
    from paddle_tpu_torch.ops import decode_kernels as dk

    k1, k2 = "paged_decode_attention_kernel", "decode_attention_kernel"
    shards = 4
    vocab = model.vocab_size
    lens = rng.randint(MAIN_MAX_LEN // 16, MAIN_MAX_LEN // 2 + 1,
                       SHORT_REQUESTS)
    prompts = [rng.randint(0, vocab, int(n)).astype(np.int32) for n in lens]
    paged = dict(cache_layout="paged", block_size=MAIN_BLOCK)
    out = {}
    none = _mesh_pool_run(model, prompts, _mesh(2, 2), **paged)
    assert none["launches"][k1] == SHORT_LAYERS * shards * none["steps"]
    for scale in ("block", "channel"):
        record = {}
        q = _mesh_pool_run(model, prompts, _mesh(
            2, 2, collective_quant="int8", collective_quant_scale=scale),
            checked=record, **paged)
        share, compared = _int8_logits_share(none, q)
        assert share <= INT8_SEAM_RTOL, (scale, share)
        assert q["compile_counts"] == none["compile_counts"]
        st = q["stats"]
        assert st["collective_bytes_per_token"] \
            < st["collective_dense_bytes_per_token"], st
        assert st["collective_calls_per_step"] == 2 * SHORT_LAYERS
        assert q["launches"][k1] == SHORT_LAYERS * shards * q["steps"]
        same = sum(np.array_equal(a, b)
                   for a, b in zip(none["tokens"], q["tokens"]))
        out["int8_" + scale] = {
            "seam_calls_checked": record["calls"],
            "seam_max_share_of_bound": record["max_share_of_bound"],
            "logits_rel_err": share, "steps_compared": compared,
            "same_tokens": int(same), "requests": len(prompts),
            "collective_bytes_per_token": st["collective_bytes_per_token"],
            "collective_dense_bytes_per_token":
                st["collective_dense_bytes_per_token"],
            "tokens_per_s": len(prompts) * SHORT_NEW_TOKENS / q["wall_s"]}
    out["none_tokens_per_s"] = len(prompts) * SHORT_NEW_TOKENS \
        / none["wall_s"]
    # the int8 KV cache on the mesh: K1's int8 path at 8 heads
    flat8 = _mesh_pool_run(model, prompts, cache_dtype="int8", **paged)
    kv8 = _mesh_pool_run(model, prompts, _mesh(2, 2), cache_dtype="int8",
                         **paged)
    assert kv8["launches"][k1] == SHORT_LAYERS * shards * kv8["steps"]
    held = [_tokens_hold(model, p, g, w, GREEDY_TOL["int8"])
            for p, g, w in zip(prompts, kv8["tokens"], flat8["tokens"])]
    out["int8_kv"] = {"k1_launches": kv8["launches"][k1],
                      "steps": kv8["steps"], "same_tokens": int(sum(held))}
    # the dense layout on the mesh: K2 at 8 heads, fp32 and int8
    for dtype in ("float32", "int8"):
        flat = _mesh_pool_run(model, prompts, cache_layout="dense",
                              cache_dtype=dtype)
        dense = _mesh_pool_run(model, prompts, _mesh(2, 2),
                               cache_layout="dense", cache_dtype=dtype)
        assert dense["launches"][k2] == SHORT_LAYERS * shards \
            * dense["steps"], dense["launches"]
        assert dense["launches"][k1] == 0
        held = [_tokens_hold(model, p, g, w, GREEDY_TOL[dtype])
                for p, g, w in zip(prompts, dense["tokens"],
                                   flat["tokens"])]
        out["dense_" + dtype] = {"k2_launches": dense["launches"][k2],
                                 "steps": dense["steps"],
                                 "same_tokens": int(sum(held)),
                                 "compile_counts": dense["compile_counts"]}
    # the speculative pool over the mesh: verify through K1 at Lq 5
    draft = TransformerLM(**dict(model_cfg(model),
                                 num_layers=SPEC_DRAFT_LAYERS),
                          dropout=0.0, device="cuda", seed=1)
    spec = SpeculativePool(model, draft, max_len=MAIN_MAX_LEN, spec_k=SPEC_K,
                           slots=MAIN_SLOTS, device="cuda", mesh=_mesh(2, 2),
                           **paged)
    spec.generate([np.arange(64) % vocab], 4 * VERIFY_LQ)
    assert spec._verify_fn.graphs() == 1
    spec.reset_acceptance_stats()
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    toks = spec.generate(prompts, SHORT_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dk.launch_counts()
    rounds = spec.acceptance_stats()["rounds"]
    assert counts[k1] == SHORT_LAYERS * shards * rounds, (counts, rounds)
    assert counts[k2] == SPEC_DRAFT_LAYERS * shards * (SPEC_K + 1) \
        * rounds, (counts, rounds)
    held = [_tokens_hold(model, p, g, w, GREEDY_TOL["float32"])
            for p, g, w in zip(prompts, toks, none["tokens"])]
    out["spec"] = {"k1_verify_launches": counts[k1],
                   "k2_draft_launches": counts[k2], "rounds": rounds,
                   "acceptance_rate":
                       spec.acceptance_stats()["acceptance_rate"],
                   "same_tokens": int(sum(held)),
                   "tokens_per_s": len(prompts) * SHORT_NEW_TOKENS / wall}
    del spec, draft
    gc.collect()
    torch.cuda.empty_cache()
    for lin in model.modules():
        lin.__dict__.pop("_mesh_parts", None)
    out["k1_launches_int8"] = kv8["launches"][k1]
    return out


def model_cfg(model) -> dict:
    """A TransformerLM's constructor widths."""
    return dict(vocab_size=model.vocab_size, hidden_size=model.hidden_size,
                num_layers=model.num_layers, num_heads=model.num_heads,
                intermediate_size=model.intermediate_size,
                max_position=model.max_position)


def cost_run(engine, n_layers):
    """``cost_24l``: the main paged fp32 24-layer engine's
    ``cost_report()`` after its traffic.  Holds: ``derived.kv_cache_bytes``
    is ``cache_stats()["pool_bytes"]``; ``step_flops`` is within 5% of the
    analytic count from the model's shapes (2 x every matrix weight but
    the position table, a token a slot, plus K1's 4 x heads x head_dim x
    the table's reach a layer a slot); the three gauges equal the report;
    the report adds no key and moves no cost version."""
    counts = engine.compile_counts()
    version = engine.cost_version()
    rep = engine.cost_report()
    assert engine.compile_counts() == counts
    assert engine.cost_version() == version
    derived = rep["derived"]
    stats = engine.cache_stats()
    assert derived["kv_cache_bytes"] == stats["pool_bytes"], \
        (derived["kv_cache_bytes"], stats["pool_bytes"])
    pool = engine.pool
    matrix = sum(p.numel() for nm, p in pool._model.named_parameters()
                 if p.ndim == 2 and not nm.startswith("position"))
    first = pool._cache[0]
    heads, head_dim = first.k.shape[1], first.k.shape[3]
    reach = first.table.shape[1] * first.k.shape[2]
    analytic = pool.slots * (2 * matrix
                             + 4 * n_layers * heads * head_dim * reach)
    rel = abs(derived["step_flops"] - analytic) / analytic
    assert rel <= 0.05, (derived["step_flops"], analytic)
    snap = engine.metrics.snapshot()
    assert snap["serving_step_flops"] == derived["step_flops"]
    assert snap["serving_step_bytes_accessed"] == \
        derived["step_bytes_accessed"]
    assert derived["hbm_reserved_bytes"] is not None
    assert snap["serving_hbm_reserved_bytes"] == \
        derived["hbm_reserved_bytes"]
    (step,) = rep["pool_decode"].values()
    return {"step_flops": derived["step_flops"], "analytic_flops": analytic,
            "flops_rel_err": rel,
            "step_bytes_accessed": derived["step_bytes_accessed"],
            "kv_cache_bytes": derived["kv_cache_bytes"],
            "hbm_reserved_bytes": derived["hbm_reserved_bytes"],
            "argument_bytes": step["argument_bytes"],
            "output_bytes": step["output_bytes"],
            "alias_bytes": step["alias_bytes"],
            "temp_bytes": step["temp_bytes"],
            "flops_per_token": derived["flops_per_token"],
            "bytes_per_token": derived["bytes_per_token"],
            "keys": {k: sorted(v) for k, v in rep.items()
                     if k != "derived"}}


def time_kernels(rows=DECODE_TIMING_ROWS):
    """Each decode kernel at the main path's widths (16 heads x 128, block
    32, 2048-position cache, one query) with every row at ``ctx``
    positions, beside its plain twin, SDPA on the gathered K/V and the
    bandwidth bound.  Keyed (kernel, cache dtype, rows, ctx); a row with
    a fourth field ``lq`` is a verify chunk of ``lq`` queries at positions
    ``ctx - lq .. ctx - 1`` (keyed with ``lq`` appended when above 1); a
    fifth field is the head count (a mesh shard's 16/mp heads, keyed with
    ``("heads", h)`` appended).

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
        heads = row[4] if len(row) > 4 else 16
        kv_dt = getattr(torch, kv_name)
        case = paged_case(gen, b, heads, 128, MAIN_BLOCK,
                          MAIN_MAX_LEN // MAIN_BLOCK, lq, torch.float32,
                          kv_dt, ctx=ctx)
        case["q_pos"] = (ctx - lq + torch.arange(lq, device="cuda")) \
            .to(torch.int32)[None].expand(b, lq).contiguous()
        _, h, lq, d = case["q"].shape
        errs = _decode_parity(dk, case, "timed row kv=%s B=%d Lq=%d ctx=%d"
                              % (kv_name, b, lq, ctx), TOL["float32"])
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
                   "eager_ms": eager, "max_abs_err": errs[name],
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
                   "kv_dtype": kv_name, "rows": b, "ctx": ctx, "lq": lq,
                   "splits": splits, "input_copies": n_copies}
            rec["achieved_gb_s"] = nbytes / rec["ms"] / 1e6
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            out[(name, kv_name, b, ctx) + ((lq,) if lq > 1 else ())
                + ((("heads", heads),) if heads != 16 else ())] = rec
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
    f32 and bf16, and the training shapes with the strides the model
    passes: B 2 x H 16 x L 2048 x D 128 causal (GPT) and B 8 x H 12 x L 512
    x D 64 non-causal with ragged key padding (BERT), in f32 and bf16, and
    the ERNIE fine-tune's B 32 x H 12 x L 384 x D 64 in bf16 in both of
    the ways its step gives K3 the padding: as segment lanes (eagerly) and
    as the captured step's [B, 1, 1, L] bias, its own mask in bf16
    (``_ernie_mask_bias``).  Returns the GPT shape's max errors, the bf16
    ones under names ending in ``_bfloat16``, and the ERNIE shape's under
    names ending in ``_ernie_lanes`` and ``_ernie_bias``; then the
    sequence models' forward shapes (``_check_flash_seq2seq``), their
    errors under ``flash_attention_s2s_<case>``."""
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
    ernie = dict(b=ERNIE_BATCH, h=12, lq=ERNIE_SEQ, lk=ERNIE_SEQ, d=64,
                 causal=False, seg="pad")
    ernie_bias = dict(ernie, seg=None, bias="pad")
    cases += [(main, torch.float32), (bert, torch.float32),
              (main, torch.bfloat16), (bert, torch.bfloat16),
              (ernie, torch.bfloat16), (ernie_bias, torch.bfloat16)]
    main_err = {}
    for shape, dtype in cases:
        args, do = flash_case(gen, dtype=dtype, **shape)
        if shape is ernie_bias:
            # the captured step's input: a mask that needs no gradient
            args["bias"] = _ernie_mask_bias()
        bias_grad = args["bias"] is not None and shape is not ernie_bias
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
        if dtype == torch.bfloat16 and shape in (main, bert, ernie,
                                                 ernie_bias):
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
        if shape is main or shape is ernie or shape is ernie_bias:
            suffix = {id(ernie): "_ernie_lanes",
                      id(ernie_bias): "_ernie_bias"}.get(
                id(shape), "" if dtype == torch.float32 else "_bfloat16")
            main_err["flash_attention_forward_kernel" + suffix] = max(
                errs["o"], errs["stats"])
            main_err["flash_attention_backward_kernel" + suffix] = max(
                errs["dq"], errs["dk"], errs["dv"])
    main_err.update(("flash_attention_s2s_" + name, e) for name, e in
                    _check_flash_seq2seq(gen).items())
    return main_err


def refresh_weights_run(model, cfg):
    """``refresh_24l``: a paged pool of the 24-layer model serves 4
    prompts (its decode step captured), then every parameter is REPLACED
    by a seed-1 model's (``load_state_dict(..., assign=True)``: new
    tensors, so the graph's recorded addresses are stale) and
    ``refresh_weights()`` drops the graph.  The pool then serves the same
    prompts again: the tokens must equal a fresh pool's on the seed-1
    model and differ from the first pass's, and ``compile_counts()`` must
    not move.  The model is left on the seed-1 weights."""
    import torch

    from paddle_tpu_torch import GenerationPool, TransformerLM

    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg["vocab_size"], n) for n in (64, 96, 128,
                                                             160)]
    kw = dict(max_len=512, slots=4, buckets=[256], device="cuda",
              cache_layout="paged", block_size=MAIN_BLOCK)
    pool = GenerationPool(model, **kw)
    first = pool.generate(prompts, 16)
    counts = pool.compile_counts()
    graphs = pool._decode_fn.graphs()
    other = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=1)
    model.load_state_dict(other.state_dict(), assign=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool.refresh_weights()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    dropped = graphs - pool._decode_fn.graphs()
    got = pool.generate(prompts, 16)
    want = GenerationPool(other, **kw).generate(prompts, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any(not np.array_equal(a, b) for a, b in zip(first, got))
    assert pool.compile_counts() == counts, (pool.compile_counts(), counts)
    assert graphs == 1 and dropped == 1 and pool._decode_fn.graphs() == 1
    del pool, other
    gc.collect()
    torch.cuda.empty_cache()
    return {"prompts": len(prompts), "new_tokens": 16,
            "graphs_dropped": dropped, "refresh_ms": refresh_ms,
            "compile_counts": counts, "tokens_equal_fresh_pool": True}


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
    gradient clip and the optimizer's grouped update.  A captured replay
    runs none of these functions, so only an eager step is broken down.  The port's
    functions are looked up at call time, so the patch reaches them; on
    leaving, everything is put back.  ``targets`` replaces the
    transformer's list with another model's ``(object, attribute, part)``
    triples (``_vision_parts``)."""

    def __init__(self, model, crit, opt, targets=None):
        import paddle_tpu_torch.nn.functional as F
        import paddle_tpu_torch.tensor as T
        from paddle_tpu_torch.framework import dispatch

        self._targets = targets or [
            (model, "forward", "forward"), (F, "embedding", "embedding"),
            (F, "layer_norm", "layer_norm"), (F, "linear", "linear"),
            (F, "scaled_dot_product_attention", "attention"),
            (F, "gelu", "gelu"), (T, "matmul", "head"),
            (dispatch, "_cast", "cast"), (crit, "forward", "loss"),
            (opt, "_grad_clip", "clip"), (opt, "_apply_group", "optimizer")]
        self._saved = []

    def __enter__(self):
        from torch.profiler import record_function

        def marked(fn, part):
            def run(*args, **kwargs):
                with record_function("part:" + part):
                    return fn(*args, **kwargs)
            return run

        for obj, attr, part in self._targets:
            if getattr(obj, attr) is None:  # an optimizer without a clip
                continue
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
    how much of the busy time the table covers.  Above 1 it over-counts:
    on the full-size GPT steps the grouped optimizer's list kernels are
    linked to more than their op (1.5-2.5 on the card), so read the
    update's cost from ``_update_cost`` there.  ``host_ms`` is a part's
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
           "launches": sum(n for _, _, n in rows),
           "k3_ms_per_step": sum(ms for ms, k, _ in rows if "flash_" in k),
           "gemm_ms_per_step": sum(ms for ms, k, _ in rows
                                   if _kernel_kind(k) == "gemm"),
           # the tensor-list kernels: the optimizer's and the clip's
           # grouped updates (their per-tensor ops are not counted here)
           "foreach_ms_per_step": sum(ms for ms, k, _ in rows
                                      if "multi_tensor_apply" in k),
           "foreach_launches_per_step": sum(n for _, k, n in rows
                                            if "multi_tensor_apply" in k),
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
    weights (seed 0) and batches, 3 AdamW steps each (on the card the
    step is captured: the warm-up, the capture, a replay) -- a causal LM with the
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
            # the card's steps: the warm-up, the capture, one replay
            assert step._fn.graphs() == (dev == "cuda")
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


def _update_cost(model, opt):
    """The step's update alone, on the model's parameters with random
    gradients: the clip, then clip + optimizer, each captured and timed
    by graph replay (``graph_ms``: device time, the host out of it), and
    the kernels one eager call of each launches.  It moves the weights:
    call it last on a model."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = [p for p in model.parameters() if p.requires_grad]
    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = [torch.randn(p.shape, generator=gen, device="cuda",
                         dtype=p.dtype) * 1e-3 for p in params]
    lr = torch.full((), 1e-4, device="cuda")
    pairs = list(zip(params, grads))
    fns = {"update": lambda: opt._functional_step(params, grads, lr)}
    if opt._grad_clip is not None:
        fns = {"clip": lambda: opt._grad_clip(pairs), **fns}
    out = {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[name + "_launches"] = sum(n for _, _, n in
                                      device_time_rows(prof))
        out[name + "_graph_ms"] = graph_ms([fn], reps=2)
    out["optimizer_graph_ms"] = out["update_graph_ms"] - out.get(
        "clip_graph_ms", 0.0)
    out["optimizer_launches"] = out["update_launches"] - out.get(
        "clip_launches", 0)
    n = sum(p.numel() for p in params)
    # the AdamW floor: 28 bytes a parameter (ISSUE's count: fp32 master or
    # weight, m1 and m2 read and written, the gradient read, the model
    # weight written)
    out["optimizer_bound_ms"] = 28.0 * n / HBM_BYTES_PER_S * 1e3
    return out


def _train_leg(build, loss_fn, batches, capture, dtype, layers, seq,
               crit=None, then=0):
    """``build()``'s model and optimizer trained by one ``TrainStep``
    over ``batches`` (one call each), captured or eager; the K3 counts are
    set to 0 just before the steps and read just after (every launch in
    ``dtype``, ``layers`` a step).  Steps are timed from the first replay
    (captured) or the second step (eager).  One more step runs under the
    profiler: an eager one with its parts marked (``crit`` given), a
    captured one as one replay.  ``then`` more steps on the last batch run
    before it, their losses returned as ``then_losses``."""
    import torch

    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.ops import flash_kernels as fk

    model, opt = build()
    # batches[i][0] is the [B, L] ids: flops of one step (a classifier's
    # are its backbone's, as the reference's bench counts them)
    flops = getattr(model, "backbone", model).flops_per_token(seq) * int(
        np.prod(np.shape(
        batches[0][0])))
    step = TrainStep(model, loss_fn, opt, capture=capture)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    by_dtype = fk.launch_counts_by_dtype()
    peak = torch.cuda.max_memory_allocated()
    _check_k3_dtype(by_dtype, dtype, layers * len(batches))
    assert step.compile_counts() == {"train_step": 1}
    assert step._fn.graphs() == int(capture)
    timed = step_ms[2:] if capture else step_ms[1:]
    mean_ms = float(np.mean(timed))
    peak_flops = BF16_TC_FLOPS_PER_S if dtype == "bfloat16" \
        else FP32_FLOPS_PER_S
    then_losses = [float(step(*batches[-1])) for _ in range(then)]
    out = {"capture": capture, "losses": losses, "then_losses": then_losses,
           "warmup_step_ms": step_ms[0], "step_ms": step_ms,
           "step_ms_mean": mean_ms, "step_ms_p50": float(np.median(timed)),
           "peak_mem_gb": peak / 2 ** 30,
           "mfu": flops / (mean_ms / 1e3) / peak_flops,
           "launches_by_dtype": by_dtype}
    parts = None if capture or crit is None else _StepParts(model, crit,
                                                            opt)
    out["profile"] = _profile_step(step, batches[-1], mean_ms, parts)
    out["launches_per_step"] = out["profile"].pop("launches")
    if not capture:
        out["update"] = _update_cost(model, opt)
    del step, model, opt
    gc.collect()  # the step's wrappers hold it in reference cycles
    torch.cuda.empty_cache()
    return out


def _eager_beside(captured, eager) -> dict:
    """The captured run, with the eager run's figures beside it."""
    keys = ("step_ms_mean", "launches_per_step", "peak_mem_gb", "mfu",
            "update")
    out = dict(captured)
    out["eager"] = {k: eager[k] for k in keys}
    out["eager"]["device_idle_share"] = eager["profile"]["device_idle_share"]
    out["eager"]["profile"] = eager["profile"]
    out["eager_losses"] = eager["losses"]
    return out


def train_gpt(bf16: bool = False):
    """The training main path: GPT-1.3B at full width and depth,
    ``TrainStep`` with AdamW(1e-4, weight decay 0.01, global-norm clip 1.0)
    and the shifted LM loss, on one 2 x 2048 batch (numpy seed 0) repeated
    for 6 steps: in fp32, or with ``bf16`` (``train_gpt_bf16``) as the
    reference's GPT leg runs it, the model and optimizer decorated O2 bf16
    and the loss under ``auto_cast(level="O1")`` -- every parameter bf16
    but the norms', each with a float32 master.  The steps run twice from
    the same weights (seed 0): eagerly (``capture=False``), with one more
    step profiled and broken down by part (``_StepParts``), then captured
    -- the warm-up, the capture, and replays, one CUDA graph for the whole
    step, one key -- with one replay profiled.  The captured losses must
    equal the eager ones within ``CAPTURED_RTOL``; each run's K3 launches
    are 24 a step forward and backward in the run's dtype."""
    import torch

    from paddle_tpu_torch import (TransformerLM, TransformerLMCriterion,
                                  gpt_1p3b_config)

    dtype = "bfloat16" if bf16 else "float32"
    cfg = gpt_1p3b_config()

    def build():
        model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
        opt = _adamw(model)
        return _o2(model, opt) if bf16 else (model, opt)

    crit = TransformerLMCriterion(shift_labels=True)
    loss_fn = _amp_loss(lambda m, x: crit(m(x), x), bf16)
    ids = np.random.RandomState(0).randint(
        0, cfg["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))
    batches = [(ids,)] * TRAIN_STEPS
    model, opt = build()
    params = sum(p.numel() for p in model.parameters())
    for p in model.parameters():
        opt._state_for(p)  # as TrainStep makes them: masters under O2
    by_param_dtype = _check_o2_params(model, opt) if bf16 else None
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    layers = cfg["num_layers"]
    eager = _train_leg(build, loss_fn, batches, False, dtype, layers,
                       TRAIN_SEQ, crit)
    captured = _train_leg(build, loss_fn, batches, True, dtype, layers,
                          TRAIN_SEQ)
    losses = captured["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, eager["losses"],
                               rtol=CAPTURED_RTOL[dtype])
    out = _eager_beside(captured, eager)
    out.update(dtype=dtype, layers=layers, params_b=params / 1e9,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
               / (captured["step_ms_mean"] / 1e3),
               mfu_peak_flops_per_s=(BF16_TC_FLOPS_PER_S if bf16
                                     else FP32_FLOPS_PER_S))
    if bf16:
        out["params_by_dtype"] = by_param_dtype
    return out


def train_bert(bf16: bool = False):
    """BERT-base (12 layers, 768 wide, non-causal) on 8 x 512 tokens, each
    of 5 steps a batch with its own ragged lengths given as a [B, 1, 1, L]
    additive padding mask; the masked LM loss ignores the pads.  Run
    eagerly, then captured, from the same weights, as ``train_gpt``.
    Eagerly, K3 takes every mask as key-padding (segment) lanes (the
    detection claims it, at most one readback a step); captured, the
    warm-up does too, while the capture never claims the mask, a graph
    input, so K3 takes it as a broadcast bias and each replay reads the
    padding it is given.  The captured losses, on batches whose padding
    differs from the capture's, must equal the eager ones within
    ``CAPTURED_RTOL``.  With ``bf16`` (``train_bert_bf16``) the run is O2
    bf16 and K3 runs in bf16."""
    import torch

    from paddle_tpu_torch import (TransformerLM, TransformerLMCriterion,
                                  bert_base_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_kernels as fk

    dtype = "bfloat16" if bf16 else "float32"
    cfg = bert_base_config()

    def build():
        model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
        opt = _adamw(model)
        return _o2(model, opt) if bf16 else (model, opt)

    rng = np.random.RandomState(1)
    batches, real = [], []
    for _ in range(BERT_STEPS):
        ids, mask, labels, n = _padding_batch(rng, cfg["vocab_size"],
                                              BERT_BATCH, BERT_SEQ)
        batches.append((ids, torch.from_numpy(mask).cuda(),
                        torch.from_numpy(labels).cuda()))
        real.append(n)
    assert fa.detect_padding_additive_mask(batches[0][1]) is not None
    crit = TransformerLMCriterion(shift_labels=False)
    loss_fn = _amp_loss(lambda m, x, am, y: crit(m(x, attn_mask=am), y),
                        bf16)
    layers = cfg["num_layers"]
    calls, reads = [], []
    apply, put = fk.FlashAttentionFunction.apply, fa._cache_put

    def recording_apply(*a):
        # (bias given, segment lanes given, q's dtype)
        calls[-1].append((a[3] is not None, a[4] is not None,
                          str(a[0].dtype)[6:]))
        return apply(*a)

    def counting_put(cache, m, verdict):
        # a padding-mask detection that missed its cache: one readback
        if cache is fa._pad_detect_cache and not fa._capturing(m):
            reads[-1][-1] += 1
        return put(cache, m, verdict)

    legs = {}
    fk.FlashAttentionFunction.apply = recording_apply
    fa._cache_put = counting_put
    try:
        for capture in (False, True):
            calls.append([])
            reads.append([])

            def counted(*args, _fn=loss_fn):
                reads[-1].append(0)
                return _fn(*args)

            legs[capture] = _train_leg(build, counted, batches, capture,
                                       dtype, layers, BERT_SEQ,
                                       None if capture else crit)
    finally:
        fk.FlashAttentionFunction.apply = apply
        fa._cache_put = put
    eager, captured = legs[False], legs[True]
    lanes, bias = (False, True, dtype), (True, False, dtype)
    # eager: every step (and the profiled one) takes lanes
    assert calls[0] and all(c == lanes for c in calls[0]), calls[0]
    # captured: the warm-up takes lanes, the capture the bias; replays and
    # the profiled replay call no Python
    assert calls[1] == [lanes] * layers + [bias] * layers, calls[1]
    # at most one readback a step, none while capturing
    assert all(n <= 1 for r in reads for n in r), reads
    assert reads[1][1:] == [0] * (len(reads[1]) - 1), reads
    losses = captured["losses"]
    assert all(np.isfinite(losses)), losses
    np.testing.assert_allclose(losses, eager["losses"],
                               rtol=CAPTURED_RTOL[dtype])
    out = _eager_beside(captured, eager)
    out.update(dtype=dtype, layers=layers, batch=BERT_BATCH, seq=BERT_SEQ,
               steps=BERT_STEPS, real_tokens=real,
               k3_calls_eager=len(calls[0]), k3_calls_captured=len(calls[1]),
               mask_readbacks_per_step=reads)
    return out


def _ernie_batch(rng, cfg):
    """The fine-tune's batch as the reference's bench draws it (ids, token
    types, 3-way labels) and a ragged [B, 1, 1, L] additive key-padding
    mask from lengths of ``ERNIE_MIN_LEN``-``ERNIE_SEQ`` (row 0 full):
    (ids, types, labels, mask, lengths)."""
    b, l = ERNIE_BATCH, ERNIE_SEQ
    ids = rng.randint(0, cfg["vocab_size"], (b, l))
    types = rng.randint(0, cfg["type_vocab_size"], (b, l))
    labels = rng.randint(0, ERNIE_CLASSES, (b,))
    lens = rng.randint(ERNIE_MIN_LEN, l + 1, b)
    lens[0] = l
    valid = np.arange(l)[None, :] < lens[:, None]
    mask = np.where(valid, 0.0, np.finfo(np.float32).min).astype(
        np.float32)[:, None, None, :]
    return ids, types, labels, mask, lens


def _ernie_mask_bias():
    """The fine-tune batch's [B, 1, 1, L] additive mask as its captured
    step hands it to K3: cast to bf16 by the attention (``finfo(float32)
    .min`` becomes -inf), a broadcast bias on the card."""
    import torch

    from paddle_tpu_torch import ernie_base_config

    mask = _ernie_batch(np.random.RandomState(0), ernie_base_config())[3]
    return torch.from_numpy(mask).cuda().to(torch.bfloat16)


def _cls_criterion():
    """The fine-tune's loss as a module (so a profiled step marks it):
    cross entropy of the logits against the labels."""
    import torch

    from paddle_tpu_torch.nn import functional as F

    class ClassifierLoss(torch.nn.Module):
        def forward(self, logits, labels):
            return F.cross_entropy(logits, labels)

    return ClassifierLoss()


def _ernie_model(layers=None):
    """``TransformerForSequenceClassification`` at ``ernie_base_config()``
    (``layers`` of them), seed 0, dropout 0, on the card, with AdamW(1e-4)
    -- the reference's config #4 leg without its sharding wrapper --
    decorated O2 bf16."""
    from paddle_tpu_torch import (TransformerForSequenceClassification,
                                  ernie_base_config)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ernie_base_config()
    if layers is not None:
        cfg["num_layers"] = layers
    model = TransformerForSequenceClassification(
        num_classes=ERNIE_CLASSES, dropout=0.0, device="cuda", seed=0, **cfg)
    return _o2(model, AdamW(1e-4, parameters=model.parameters()))


def train_ernie_cls():
    """``train_ernie_cls``: the ERNIE-base sequence-classification
    fine-tune (12 layers, 768 wide, 12 heads x 64, vocab 40000, 4 token
    types, 3 classes) in O2 bf16 with AdamW(1e-4) and the loss under
    ``auto_cast``, on 32 x 384 tokens of ragged length 128-384 given as a
    [B, 1, 1, L] additive key-padding mask: one batch for 6 steps, eagerly
    and captured from the same weights (``_train_leg``).  The captured
    losses must equal the eager ones within ``CAPTURED_RTOL`` and be
    finite; one graph key; every K3 launch bf16, 12 a step forward and
    backward.  Eagerly, and in the captured run's warm-up, K3 takes the
    mask as key-padding lanes; the capture never claims it (a graph
    input), so the replays run K3 with it as a broadcast bias: the
    launches are returned by mode (``k3_launches_by_mode``).  AdamW's
    first step from a random init raises the loss (in the reference too),
    so the captured step then replays ``ERNIE_MORE_STEPS`` more times on
    the batch, whose last loss must fall below the first step's.  MFU is
    given twice: ``mfu`` by the backbone's ``flops_per_token``, as the
    reference's bench counts it (with the tied LM head, which a
    classifier never runs), and ``mfu_run`` by the flops the step runs
    (the head left out; the pooler and the classifier in)."""
    import torch

    from paddle_tpu_torch import ernie_base_config
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_kernels as fk

    cfg = ernie_base_config()
    crit = _cls_criterion()
    loss_fn = _amp_loss(lambda m, ids, types, labels, mask: crit(
        m(ids, attn_mask=mask, token_type_ids=types), labels), True)
    ids, types, labels, mask, lens = _ernie_batch(np.random.RandomState(0),
                                                  cfg)
    batch = (ids, types, labels, torch.from_numpy(mask).cuda())
    assert fa.detect_padding_additive_mask(batch[3]) is not None
    model, opt = _ernie_model()
    params = sum(p.numel() for p in model.parameters())
    ref_fpt = model.backbone.flops_per_token(ERNIE_SEQ)
    del model, opt
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    run_fpt = ref_fpt - 6.0 * v * h + 6.0 * (h * h + h * ERNIE_CLASSES) \
        / ERNIE_SEQ
    layers = cfg["num_layers"]
    calls = []
    apply = fk.FlashAttentionFunction.apply

    def recording_apply(*a):
        # (bias given, segment lanes given, q's dtype)
        calls[-1].append((a[3] is not None, a[4] is not None,
                          str(a[0].dtype)[6:]))
        return apply(*a)

    legs = {}
    fk.FlashAttentionFunction.apply = recording_apply
    try:
        for capture in (False, True):
            calls.append([])
            legs[capture] = _train_leg(
                _ernie_model, loss_fn, [batch] * ERNIE_STEPS, capture,
                "bfloat16", layers, ERNIE_SEQ, None if capture else crit,
                then=ERNIE_MORE_STEPS if capture else 0)
    finally:
        fk.FlashAttentionFunction.apply = apply
    eager, captured = legs[False], legs[True]
    lanes, bias = (False, True, "bfloat16"), (True, False, "bfloat16")
    # eager: every step (and the profiled one) takes lanes; captured: the
    # warm-up takes lanes, the capture the bias, and replays call no Python
    assert calls[0] and all(c == lanes for c in calls[0]), calls[0]
    assert calls[1] == [lanes] * layers + [bias] * layers, calls[1]
    # each forward call has its backward in the same mode; the eager run's
    # counts (read before its profiled step) are all lanes, the captured
    # run's are the warm-up's lanes and the replays' bias
    by_mode = {"lanes": {}, "bias": {}}
    for name in ("flash_attention_forward_kernel",
                 "flash_attention_backward_kernel"):
        n_eager = eager["launches_by_dtype"][name]["bfloat16"]
        n_captured = captured["launches_by_dtype"][name]["bfloat16"]
        by_mode["lanes"][name] = n_eager + layers
        by_mode["bias"][name] = n_captured - layers
        assert by_mode["bias"][name] == layers * (ERNIE_STEPS - 1), by_mode
    losses = captured["losses"]
    assert all(np.isfinite(losses)), losses
    np.testing.assert_allclose(losses, eager["losses"],
                               rtol=CAPTURED_RTOL["bfloat16"])
    # AdamW's first step from a random init kicks the loss up (the
    # reference's too); the replays then fit the batch
    more = captured["then_losses"]
    assert all(np.isfinite(more)) and more[-1] < losses[0], (losses, more)
    out = _eager_beside(captured, eager)
    tokens = ERNIE_BATCH * ERNIE_SEQ
    out.update(dtype="bfloat16", layers=layers, params_m=params / 1e6,
               batch=ERNIE_BATCH, seq=ERNIE_SEQ, steps=ERNIE_STEPS,
               real_tokens=int(lens.sum()),
               tokens_per_s=tokens / (captured["step_ms_mean"] / 1e3),
               mfu_peak_flops_per_s=BF16_TC_FLOPS_PER_S,
               flops_per_token_reference=ref_fpt, flops_per_token_run=run_fpt,
               mfu_run=captured["mfu"] * run_fpt / ref_fpt,
               k3_launches_by_mode=by_mode,
               k3_calls_eager=len(calls[0]), k3_calls_captured=len(calls[1]))
    out["eager"]["mfu_run"] = eager["mfu"] * run_fpt / ref_fpt
    return out


def sparse_embedding():
    """``sparse_embedding``: a [40000, 768] fp32 ``Embedding(sparse=True,
    padding_idx=0)`` (ERNIE's vocabulary) under eager
    ``Adam(lazy_mode=True)`` against a dense ``Embedding`` and dense Adam
    from the same weights, on the same two steps of 32 x 384 ids (pads,
    id 0, after each row's ragged length) with the same random upstream
    gradients.  After the second step: the rows it met within
    ``SPARSE_RTOL`` of dense Adam's; every other row of the weight and
    both moments bit for bit as after the first step (dense Adam moves the
    first step's rows again by their momentum); the pad row and its moments
    untouched.  Then each update alone, by CUDA events over repeated steps
    on the same gradient, beside its byte floor; then the same table under
    ``TrainStep`` (with a mean-pool and a 3-way head): the step trains on
    the dense gradient (no sparse one reaches the update) and captures."""
    import torch

    from paddle_tpu_torch import TrainStep, ernie_base_config
    from paddle_tpu_torch.nn import Embedding, Linear
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam, param_name

    cfg = ernie_base_config()
    vocab, dim = cfg["vocab_size"], cfg["hidden_size"]
    b, l = ERNIE_BATCH, ERNIE_SEQ
    rng = np.random.RandomState(7)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def table(sparse_grad):
        return Embedding(vocab, dim, padding_idx=0, sparse=sparse_grad,
                         device="cuda", generator=torch.Generator(
                             device="cuda").manual_seed(0))

    def ragged_ids():
        ids = rng.randint(1, vocab, (b, l))
        lens = rng.randint(ERNIE_MIN_LEN, l + 1, b)
        ids[np.arange(l)[None, :] >= lens[:, None]] = 0
        return torch.from_numpy(ids).cuda()

    lazy, dense = table(True), table(False)
    w0 = lazy.weight.detach().clone()
    assert torch.equal(w0, dense.weight)
    opts = {"lazy": Adam(1e-3, parameters=lazy.parameters(),
                         lazy_mode=True),
            "dense": Adam(1e-3, parameters=dense.parameters())}
    steps = [(ragged_ids(), torch.randn(b, l, dim, device="cuda",
                                        generator=gen)) for _ in range(2)]
    st = None
    for i, (ids, gout) in enumerate(steps):
        for name, emb in (("lazy", lazy), ("dense", dense)):
            emb(ids).backward(gout)
            assert emb.weight.grad.is_sparse == (name == "lazy")
            opts[name].step()
            opts[name].clear_grad()
        if i == 0:
            st = opts["lazy"]._states[param_name(lazy.weight)]
            before = {"weight": lazy.weight.detach().clone(),
                      "moment1": st["moment1"].clone(),
                      "moment2": st["moment2"].clone()}
    ids2 = steps[1][0]
    met = torch.zeros(vocab, dtype=torch.bool, device="cuda")
    met[ids2.reshape(-1)] = True
    met[0] = False  # the pad row gets no gradient
    rel = ((lazy.weight - dense.weight)[met].abs()
           / dense.weight[met].abs().clamp(min=1e-30)).max().item()
    assert rel <= SPARSE_RTOL, rel
    now = {"weight": lazy.weight.detach(), "moment1": st["moment1"],
           "moment2": st["moment2"]}
    for k in now:
        assert torch.equal(now[k][~met], before[k][~met]), k
    assert torch.equal(lazy.weight[0], w0[0])
    assert torch.equal(dense.weight[0], w0[0])
    assert not st["moment1"][0].any() and not st["moment2"][0].any()
    moved = (dense.weight.detach() != before["weight"]).any(1) & ~met
    touched_rows = int(met.sum())
    nnz = int((ids2 != 0).sum())
    out = {"rows_met": touched_rows, "ids_not_pad": nnz,
           "max_rel_err_vs_dense": rel,
           "dense_rows_moved_by_momentum_alone": int(moved.sum())}
    # each update alone, on the second step's gradient, repeated
    for name, emb in (("lazy", lazy), ("dense", dense)):
        emb(ids2).backward(steps[1][1])
        out[name + "_update_ms"] = cuda_ms(opts[name].step, iters=20,
                                           warmup=2)
        opts[name].clear_grad()
    # byte floors: dense Adam reads the weight, gradient and both moments
    # and writes the weight and moments (28 B an element); the lazy one
    # reads the ids and the gradient's rows once and reads and writes the
    # met rows of the weight and moments
    out["dense_bytes"] = 28 * vocab * dim
    out["lazy_bytes"] = nnz * (8 + 4 * dim) + 24 * touched_rows * dim
    for name in ("dense", "lazy"):
        out[name + "_bound_ms"] = out[name + "_bytes"] / HBM_BYTES_PER_S * 1e3
    out["lazy_vs_dense"] = out["lazy_update_ms"] / out["dense_update_ms"]

    # the same table under TrainStep: the dense gradient, captured
    class Bag(torch.nn.Module):
        def __init__(self, emb):
            super().__init__()
            self.emb = emb
            self.head = Linear(dim, ERNIE_CLASSES, device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(1))

        def forward(self, ids):
            return self.head(self.emb(ids).mean(dim=1))

    model = Bag(lazy)
    opt = Adam(1e-3, parameters=model.parameters(), lazy_mode=True)
    seen = []
    update = opt._functional_step

    def recording(params, grads, lr):
        seen.extend(g.is_sparse for g in grads)
        return update(params, grads, lr)

    opt._functional_step = recording
    step = TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y), opt)
    labels = torch.from_numpy(rng.randint(0, ERNIE_CLASSES, (b,))).cuda()
    losses = [float(step(ids2, labels)) for _ in range(4)]
    assert step._fn.graphs() == 1 and step.compile_counts() == {
        "train_step": 1}
    assert seen and not any(seen), seen  # warm-up and capture: dense
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    out["train_step_losses"] = losses
    del step, model, opt, lazy, dense, opts, steps, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- vision training (the reference's configs #1 and #2) ----------------------

# bench.py:40, copied: ResNet50's forward FLOPs per 224 x 224 image at 2
# FLOPs a multiply-accumulate (4.089e9 MACs); a training step is 3 forwards
# (bench.py:47 ``resnet50_mfu``)
RESNET50_FWD_FLOPS = 2 * 4.089e9
# config #1 (bench.py:325-370): LeNet, Adam(1e-3), fp32, rand images
LENET_BATCHES = (512, 1024, 2048)
LENET_STEPS = 20
LENET_MULTI_K, LENET_MULTI_BATCH, LENET_MULTI_CALLS = 32, 2048, 4
# config #2 (bench.py:237-322): ResNet50 at 224 x 224 and 1000 classes, O2
# bf16, Momentum(0.1); its legs (layout, batch, remat, s2d stem),
# bench.py:249-252, in its order
RESNET_LEGS = (("NHWC", 128, False, True), ("NHWC", 128, False, False),
               ("NHWC", 256, True, True), ("NHWC", 64, False, True),
               ("NCHW", 128, False, False))
RESNET_STEPS = 12
# the legs with an eager run from the same weights beside the captured one
RESNET_EAGER_LEGS = (("NHWC", 128, False, False),
                     ("NCHW", 128, False, False))
# calls at learning rate 0 before a leg's timed steps (the warm-up, the
# capture + one replay, one replay): the weights stay put, so each call's
# batch statistics are the same and the running statistics must follow
# (1 - 0.9^k) * batch after k calls
RESNET_STATS_CALLS = 3
# captured against eager losses: cuDNN picks the same algorithms for both
# (one process, one benchmark cache), but some weight-gradient algorithms
# sum in a data-race order, so the runs may part in the last bits and
# drift over the steps: LeNet fp32 over 20 Adam steps, ResNet50 O2 bf16
# over 15 Momentum steps (three at learning rate 0)
VISION_CAPTURED_RTOL = {"lenet": 1e-4, "resnet50": 2e-2}
# running statistics after k calls against (1 - 0.9^k) * batch: the batch
# statistics of identical calls agree to cuDNN's forward rounding; a call
# missed or counted twice moves them by 10% or more
STATS_RTOL = 1e-3


def wrap_resnet_remat(model):
    """bench.py:221's ``wrap_resnet_remat`` on the port: each residual
    block's forward (``layerN.i``) runs under
    ``distributed.fleet.utils.recompute``, its activations replayed in the
    backward instead of held."""
    from paddle_tpu_torch.distributed.fleet.utils import recompute

    for name, sub in model.named_modules():
        if name.startswith("layer") and name.count(".") == 1:
            orig = sub.forward
            sub.forward = (lambda *a, __o=orig, **kw:
                           recompute(__o, *a) if not kw else __o(*a, **kw))
    return model


def _vision_parts(model, crit, opt):
    """``_StepParts`` over a CNN step's parts: the convolutions (the s2d
    stem's too), BatchNorm, ReLU, the pools, the classifier's product, the
    autocast casts, the loss and the optimizer's grouped update."""
    import paddle_tpu_torch.nn.functional as F
    import paddle_tpu_torch.vision.models.resnet as resnet_mod
    from paddle_tpu_torch.framework import dispatch

    return _StepParts(model, crit, opt, targets=[
        (model, "forward", "forward"), (F, "conv2d", "conv"),
        (resnet_mod, "_s2d_op", "conv"), (F, "_bn_triple", "batch_norm"),
        (F, "relu", "relu"), (F, "max_pool2d", "pool"),
        (F, "adaptive_avg_pool2d", "pool"), (F, "linear", "linear"),
        (dispatch, "_cast", "cast"), (crit, "forward", "loss"),
        (opt, "_apply_group", "optimizer")])


def _bn_stats(model):
    """Every BatchNorm's running mean and variance, on the host."""
    return {n: b.detach().double().cpu().numpy()
            for n, b in model.named_buffers()}


def _stats_advanced(stats):
    """``stats[k]`` (after k = 0..K calls at learning rate 0, the same
    batch each call) against the reference's rule applied k times: the
    mean from 0, ``(1 - 0.9^k) * m`` with ``m`` the batch mean (10x the
    first call's); the variance from 1, ``0.9^k + (1 - 0.9^k) * s``.
    Returns each call's largest deviation relative to each buffer's scale,
    and the number of updates the largest running mean says it had."""
    first = stats[1]
    dev, counts = [], []
    for k in range(1, len(stats)):
        worst = 0.0
        for n, got in stats[k].items():
            if n.endswith("_mean"):
                batch = first[n] / 0.1
                want = (1 - 0.9 ** k) * batch
            else:
                batch = (first[n] - 0.9) / 0.1
                want = 0.9 ** k + (1 - 0.9 ** k) * batch
            worst = max(worst, float(np.abs(got - want).max()
                                     / max(np.abs(want).max(), 1e-12)))
        dev.append(worst)
        name = max((n for n in first if n.endswith("_mean")),
                   key=lambda n: np.abs(first[n]).max())
        i = int(np.abs(first[name]).argmax())
        counts.append(float(np.log(1 - stats[k][name][i]
                                   / (first[name][i] / 0.1))
                            / np.log(0.9)))
    return dev, counts


def _vision_leg(build, loss_fn, batch, steps, capture, stats_calls=0,
                crit=None):
    """``build()``'s model and optimizer trained by one ``TrainStep`` on
    the device-resident ``batch``: ``stats_calls`` calls at learning rate 0
    (the running statistics read after each; the optimizer's velocity
    zeroed after them), then ``steps`` more, each timed to its end.  One
    more step runs under the profiler: eager with its parts marked
    (``crit`` given), captured as one replay."""
    import torch

    from paddle_tpu_torch import TrainStep

    model, opt = build()
    step = TrainStep(model, loss_fn, opt, capture=capture)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lr = opt.get_lr()
    stats, losses, step_ms = [], [], []
    if stats_calls:
        opt.set_lr(0.0)
        stats.append(_bn_stats(model))
        for _ in range(stats_calls):
            losses.append(float(step(*batch)))
            stats.append(_bn_stats(model))
        with torch.no_grad():
            for st in opt._states.values():
                for name, t in st.items():
                    if name == "velocity":
                        t.zero_()
        opt.set_lr(lr)
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    assert step.compile_counts() == {"train_step": 1}
    assert step._fn.graphs() == int(capture)
    # the first step (warm-up) and, captured, the second (capture) are not
    # timed when they fall in the timed part
    skip = max(0, (2 if capture else 1) - stats_calls)
    timed = step_ms[skip:]
    mean_ms = float(np.mean(timed))
    out = {"capture": capture, "losses": losses, "step_ms": step_ms,
           "step_ms_mean": mean_ms, "step_ms_p50": float(np.median(timed)),
           "peak_mem_gb": peak / 2 ** 30}
    if stats_calls:
        dev, counts = _stats_advanced(stats)
        assert max(dev) < STATS_RTOL, dev
        out["stats_deviation_by_call"] = dev
        out["stats_updates_by_call"] = counts
    parts = None if capture or crit is None else _vision_parts(model, crit,
                                                               opt)
    out["profile"] = _profile_step(step, batch, mean_ms, parts)
    out["launches_per_step"] = out["profile"].pop("launches")
    out["device_idle_share"] = out["profile"]["device_idle_share"]
    del step, model, opt
    gc.collect()  # the step's wrappers hold it in reference cycles
    torch.cuda.empty_cache()
    return out


def _losses_beside(captured, eager, rtol):
    """The eager run's losses beside the captured run's: equal within
    ``rtol``, and whether bit for bit."""
    np.testing.assert_allclose(captured["losses"], eager["losses"],
                               rtol=rtol)
    diff = np.abs(np.subtract(captured["losses"], eager["losses"]))
    return {"eager_losses": eager["losses"],
            "losses_bit_equal": bool(captured["losses"] == eager["losses"]),
            "losses_max_rel_diff": float(np.max(
                diff / np.abs(eager["losses"])))}


def _eager_figures(eager) -> dict:
    keys = ("step_ms_mean", "step_ms_p50", "launches_per_step",
            "peak_mem_gb", "device_idle_share", "profile")
    return {k: eager[k] for k in keys}


def train_lenet():
    """``train_lenet`` (config #1, bench.py:325-370): ``LeNet()`` with
    ``nn.CrossEntropyLoss`` and Adam(1e-3) in fp32 under ``TrainStep``,
    on ``rand`` 1 x 28 x 28 images and labels in [0, 10) made on the host
    from one numpy seed and put on the card before the clock starts.  At
    each batch of ``LENET_BATCHES`` a fresh model (seed 0) runs
    ``LENET_STEPS`` + 2 steps captured (warm-up, capture, 20 timed
    replays) and another from the same weights the same steps eagerly:
    imgs/s by batch from the captured run, step ms mean and p50, launches
    a step (one profiled step), device idle share, peak memory, and the
    captured losses against the eager ones (``VISION_CAPTURED_RTOL``).
    Then ``MultiStepTrainStep`` with ``LENET_MULTI_K`` steps a call at
    batch ``LENET_MULTI_BATCH``: the warm-up, the capture, and
    ``LENET_MULTI_CALLS`` timed replays.  LeNet has no BatchNorm."""
    import torch

    from paddle_tpu_torch import MultiStepTrainStep, nn, optimizer
    from paddle_tpu_torch.vision.models import LeNet

    crit = nn.CrossEntropyLoss()

    def loss_fn(m, x, y):
        return crit(m(x), y)

    def build():
        model = LeNet(device="cuda", seed=0)
        return model, optimizer.Adam(1e-3, parameters=model.parameters())

    rng = np.random.RandomState(0)
    out = {"batches": {}}
    for batch in LENET_BATCHES:
        data = (torch.from_numpy(rng.rand(batch, 1, 28, 28).astype(
                    np.float32)).cuda(),
                torch.from_numpy(rng.randint(0, 10, (batch,))).cuda())
        legs = {capture: _vision_leg(build, loss_fn, data, LENET_STEPS + 2,
                                     capture, crit=None if capture else crit)
                for capture in (True, False)}
        rec = dict(legs[True])
        rec.update(_losses_beside(legs[True], legs[False],
                                  VISION_CAPTURED_RTOL["lenet"]))
        rec["eager"] = _eager_figures(legs[False])
        rec["imgs_per_s"] = batch / (rec["step_ms_mean"] / 1e3)
        rec["eager"]["imgs_per_s"] = batch / (legs[False]["step_ms_mean"]
                                              / 1e3)
        assert all(np.isfinite(rec["losses"])), rec["losses"]
        out["batches"][batch] = rec
        log("train_lenet batch %d: %.0f imgs/s captured (%.3f ms a step), "
            "%.0f eagerly" % (batch, rec["imgs_per_s"], rec["step_ms_mean"],
                              rec["eager"]["imgs_per_s"]))
    k, batch = LENET_MULTI_K, LENET_MULTI_BATCH
    model, opt = build()
    step = MultiStepTrainStep(model, loss_fn, opt, steps_per_call=k)
    data = (torch.from_numpy(rng.rand(k, batch, 1, 28, 28).astype(
                np.float32)).cuda(),
            torch.from_numpy(rng.randint(0, 10, (k, batch))).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call_ms, losses = [], []
    for _ in range(2 + LENET_MULTI_CALLS):
        t0 = time.perf_counter()
        got = step(*data)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(got.cpu().tolist())
    assert step._fn.graphs() == 1 and len(losses[-1]) == k
    assert np.isfinite(losses).all()
    mean_ms = float(np.mean(call_ms[2:]))
    prof = _profile_step(step, data, mean_ms)
    out["multi_step"] = {
        "steps_per_call": k, "batch": batch, "call_ms": call_ms,
        "call_ms_mean": mean_ms, "step_ms_mean": mean_ms / k,
        "imgs_per_s": k * batch / (mean_ms / 1e3),
        "launches_per_call": prof.pop("launches"),
        "device_idle_share": prof["device_idle_share"], "profile": prof,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "last_losses": losses[-1][-4:]}
    del step, model, opt, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_resnet50():
    """``train_resnet50`` (config #2, bench.py:237-322):
    ``resnet50(num_classes=1000)`` at 224 x 224, ``amp.decorate`` O2 bf16
    with Momentum(0.1) and ``nn.CrossEntropyLoss`` under ``auto_cast``
    O1, over the reference's legs (``RESNET_LEGS``: layout, batch,
    recompute of every residual block (``wrap_resnet_remat``), the s2d
    stem), one model alive at a time (seed 0), each captured
    (``torch.backends.cudnn.benchmark`` on: its search runs in the eager
    warm-up, which meets every shape the capture does).  Each leg first
    runs ``RESNET_STATS_CALLS`` calls at learning rate 0 -- the warm-up,
    the capture with its replay, a replay -- after each of which every
    BatchNorm's running statistics must have advanced exactly once more
    (``_stats_advanced``), then ``RESNET_STEPS`` timed steps at 0.1, whose
    losses must be finite.  Per leg: imgs/s, step ms, MFU (bench.py:47's
    formula against the bf16 tensor-core peak), device idle share of a
    profiled replay, peak memory.  The legs in ``RESNET_EAGER_LEGS`` run
    the same calls eagerly from the same weights beside: losses within
    ``VISION_CAPTURED_RTOL`` (bit-equality recorded), and one more eager
    step profiled by part (conv forward and backward, BatchNorm forward
    and backward, the casts, the optimizer)."""
    import torch

    from paddle_tpu_torch import amp, nn, optimizer
    from paddle_tpu_torch.vision.models import resnet50

    crit = nn.CrossEntropyLoss()

    def loss_fn(m, x, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(x), y)

    bench_mode = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    rng = np.random.RandomState(0)
    out = {"legs": {}, "mfu_peak_flops_per_s": BF16_TC_FLOPS_PER_S,
           "fwd_flops_per_image": RESNET50_FWD_FLOPS}
    try:
        for fmt, batch, remat, s2d in RESNET_LEGS:
            def build(fmt=fmt, remat=remat, s2d=s2d):
                model = resnet50(num_classes=1000, data_format=fmt,
                                 space_to_depth_stem=s2d, device="cuda",
                                 seed=0)
                if remat:
                    wrap_resnet_remat(model)
                opt = optimizer.Momentum(0.1, parameters=model.parameters())
                return amp.decorate(model, opt, level="O2",
                                    dtype="bfloat16")

            data = (torch.from_numpy(rng.randn(batch, 3, 224, 224).astype(
                        np.float32)).cuda(),
                    torch.from_numpy(rng.randint(0, 1000, (batch,))).cuda())
            label = "%s_b%d%s%s" % (fmt.lower(), batch,
                                    "_remat" if remat else "",
                                    "_s2d" if s2d else "")
            t0 = time.perf_counter()
            rec = _vision_leg(build, loss_fn, data, RESNET_STEPS, True,
                              stats_calls=RESNET_STATS_CALLS)
            assert all(np.isfinite(rec["losses"])), rec["losses"]
            step_s = rec["step_ms_mean"] / 1e3
            rec.update(data_format=fmt, batch=batch, remat=remat,
                       s2d_stem=s2d, imgs_per_s=batch / step_s,
                       mfu=3.0 * RESNET50_FWD_FLOPS * batch / step_s
                       / BF16_TC_FLOPS_PER_S)
            if (fmt, batch, remat, s2d) in RESNET_EAGER_LEGS:
                eager = _vision_leg(build, loss_fn, data, RESNET_STEPS,
                                    False, stats_calls=RESNET_STATS_CALLS,
                                    crit=crit)
                rec.update(_losses_beside(rec, eager,
                                          VISION_CAPTURED_RTOL["resnet50"]))
                rec["eager"] = _eager_figures(eager)
                rec["eager"]["imgs_per_s"] = batch / (
                    eager["step_ms_mean"] / 1e3)
                rec["eager"]["mfu"] = 3.0 * RESNET50_FWD_FLOPS * batch / (
                    eager["step_ms_mean"] / 1e3) / BF16_TC_FLOPS_PER_S
            rec["leg_s"] = time.perf_counter() - t0
            out["legs"][label] = rec
            del data
            gc.collect()
            torch.cuda.empty_cache()
            log("train_resnet50 %s: %.0f imgs/s, %.2f ms a step, MFU %.3f, "
                "idle %s, peak %.1f GB (%.1f s)"
                % (label, rec["imgs_per_s"], rec["step_ms_mean"], rec["mfu"],
                   rec["device_idle_share"], rec["peak_mem_gb"],
                   rec["leg_s"]))
    finally:
        torch.backends.cudnn.benchmark = bench_mode
    return out


def nan_check():
    """``nan_check``: under ``FLAGS_check_nan_inf`` an eager op whose
    output holds an inf raises ``InvalidArgumentError`` naming it, a clean
    one passes; then 3 captured steps (warm-up, capture, replay) of the
    ERNIE fine-tune at 2 layers with the flag on: the check runs on every
    installed op of the eager warm-up, is skipped while the stream
    captures (a host read would void the capture), and the step captures
    and replays with finite losses."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import InvalidArgumentError, TrainStep
    from paddle_tpu_torch.framework import dispatch

    ptt.set_flags({"FLAGS_check_nan_inf": True})
    check = dispatch.check_nan_inf
    calls = []

    def counting(out, op_name):
        calls.append(torch.cuda.is_current_stream_capturing())
        return check(out, op_name)

    try:
        msg = expect_raises(InvalidArgumentError, lambda: ptt.log(
            torch.zeros(4, device="cuda")))
        assert "'log'" in msg, msg
        msg_div = expect_raises(InvalidArgumentError, lambda: ptt.divide(
            torch.ones(4, device="cuda"), torch.zeros(4, device="cuda")))
        assert "'divide'" in msg_div, msg_div
        assert torch.isfinite(ptt.log(torch.ones(4, device="cuda"))).all()
        dispatch.check_nan_inf = counting
        model, opt = _ernie_model(layers=2)
        crit = _cls_criterion()
        loss_fn = _amp_loss(lambda m, ids, types, labels, mask: crit(
            m(ids, attn_mask=mask, token_type_ids=types), labels), True)
        from paddle_tpu_torch import ernie_base_config

        ids, types, labels, mask, _ = _ernie_batch(
            np.random.RandomState(0), ernie_base_config())
        step = TrainStep(model, loss_fn, opt)
        batch = (ids, types, labels, torch.from_numpy(mask).cuda())
        losses = [float(step(*batch)) for _ in range(3)]
    finally:
        dispatch.check_nan_inf = check
        ptt.set_flags({"FLAGS_check_nan_inf": False})
    assert step._fn.graphs() == 1, step._fn.graphs()
    assert all(np.isfinite(losses)), losses
    checked, skipped = calls.count(False), calls.count(True)
    assert checked > 0 and skipped > 0, (checked, skipped)
    out = {"eager_error": msg, "losses": losses,
           "ops_checked": checked, "ops_skipped_in_capture": skipped}
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tensor_op_cases(dev):
    """(label, op name, args, kwargs) calling every ported ``tensor`` op
    once on tensors of ``dev`` (inputs from seed 1); ``place`` is ``dev``
    for the ops with no tensor input."""
    import torch

    g = torch.Generator().manual_seed(1)

    def t(x):
        return x.to(dev)

    a = t(torch.randn(3, 4, generator=g))
    b = t(torch.rand(3, 4, generator=g) + 1)
    p = t(torch.rand(3, 4, generator=g) * 0.8 + 0.1)
    i = t(torch.randint(1, 12, (3, 4), generator=g))
    j = t(torch.randint(1, 12, (3, 4), generator=g))
    v = t(torch.randn(4, generator=g))
    m = t(torch.randn(4, 4, generator=g) + 4 * torch.eye(4))
    spd = m @ m.T + t(torch.eye(4))
    k = t(torch.randint(0, 3, (3, 6), generator=g))
    seg = t(torch.tensor([0, 0, 1, -1, 2, 2, 2, 0, 1, 1, -1, 4]))
    lens = t(torch.tensor([3, 0, 4]))
    c = t(torch.randn(2, 3, 4, generator=g))
    v3, w3 = t(torch.randn(5, 3, generator=g)), t(torch.randn(5, 3,
                                                              generator=g))
    tall = t(torch.randn(6, 3, generator=g))
    idx = t(torch.tensor([2, 0]))
    place = {"place": dev}
    cases = [(n, (a, b), {}) for n in (
        "add", "subtract", "multiply", "divide", "mod", "floor_mod",
        "maximum", "minimum", "fmax", "fmin", "atan2", "heaviside",
        "equal", "not_equal", "greater_than", "greater_equal", "less_than",
        "less_equal", "isclose", "allclose", "dist")]
    cases += [(n, (i, j), {}) for n in (
        "floor_divide", "remainder", "gcd", "lcm", "bitwise_and",
        "bitwise_or", "bitwise_xor")]
    cases += [(n, (a,), {}) for n in (
        "abs", "exp", "expm1", "sin", "cos", "tan", "sinh", "cosh", "tanh",
        "stanh", "atan", "asinh", "erf", "sigmoid", "ceil", "floor", "round",
        "trunc", "sign", "frac", "square", "neg", "deg2rad", "rad2deg",
        "nan_to_num", "conj", "sum", "nansum", "mean", "nanmean", "max",
        "min", "amax", "amin", "logsumexp", "std", "var", "cumsum", "norm",
        "t", "isnan", "isinf", "isfinite", "is_empty", "argmax", "argmin",
        "argsort", "sort", "median", "nanmedian", "shape", "rank",
        "is_floating_point", "is_integer", "is_complex", "is_tensor",
        "real", "imag", "zeros_like", "ones_like", "empty_like", "assign",
        "clone", "numel", "unstack", "unbind",
        "matrix_rank", "pinv", "histogram", "nonzero", "unique")]
    cases += [(n, (b,), {}) for n in (
        "log", "log1p", "log2", "log10", "sqrt", "rsqrt", "reciprocal",
        "lgamma", "digamma", "acosh", "prod", "cumprod")]
    cases += [(n, (p,), {}) for n in ("asin", "acos", "atanh", "erfinv",
                                      "logit")]
    cases += [(n, (m,), {}) for n in (
        "inverse", "inv", "det", "slogdet", "trace", "diagonal", "lu",
        "cond", "eig", "eigvals", "svd")]
    cases += [(n, (spd,), {}) for n in ("cholesky", "eigh", "eigvalsh")]
    cases += [(n, (a > 0,), {}) for n in (
        "all", "any", "logical_not", "bitwise_not", "where")]
    cases += [(n, (a > 0, b > 1.5), {}) for n in (
        "logical_and", "logical_or", "logical_xor")]
    cases += [
        ("clip", "clip", (a, -0.5, 0.5), {}),
        ("lerp", "lerp", (a, b, p), {}), ("cast", "cast", (a, "int32"), {}),
        ("pow", "pow", (b, a), {}), ("flip", "flip", (a, [0, 1]), {}),
        ("reverse", "reverse", (a, 1), {}),
        ("scale", "scale", (a, 2.0, 1.0), {}),
        ("increment", "increment", (a, 2.0), {}),
        ("diff", "diff", (a,), {"axis": 1}),
        ("kron", "kron", (m[:2, :2], m[2:, 2:]), {}),
        ("outer", "outer", (v, v), {}),
        ("add_n", "add_n", ([a, b, a],), {}),
        ("mm", "mm", (a, a.T), {}), ("matmul", "matmul", (a, a.T), {}),
        ("bmm", "bmm", (c, c.transpose(1, 2)), {}),
        ("mv", "mv", (a, v), {}), ("dot", "dot", (v, v), {}),
        ("addmm", "addmm", (m[:3, :3], a, a.T), {}),
        ("einsum", "einsum", ("ij,kj->ik", a, b), {}),
        ("multi_dot", "multi_dot", ([a, a.T, a],), {}),
        ("multiplex", "multiplex", ([a, b], t(torch.tensor([1, 0, 1]))), {}),
        ("matrix_power", "matrix_power", (m, 3), {}),
        ("solve", "solve", (m, a.T), {}),
        ("triangular_solve", "triangular_solve", (torch.tril(m), a.T),
         {"upper": False}),
        ("lstsq", "lstsq", (tall, tall[:, :2]), {}),
        ("qr", "qr", (a.T,), {}), ("cross", "cross", (v3, w3), {"axis": 1}),
        ("reshape", "reshape", (a, [2, 6]), {}),
        ("flatten", "flatten", (c,), {"start_axis": 1}),
        ("squeeze", "squeeze", (a[None],), {}),
        ("unsqueeze", "unsqueeze", (a, 1), {}),
        ("concat", "concat", ([a, b],), {"axis": 1}),
        ("stack", "stack", ([a, b],), {"axis": 2}),
        ("split", "split", (a, 2), {"axis": 1}),
        ("chunk", "chunk", (c, 3), {"axis": 2}),
        ("tile", "tile", (a, [1, 2]), {}),
        ("expand", "expand", (a[:1], [3, -1]), {}),
        ("expand_as", "expand_as", (a[:1], b), {}),
        ("broadcast_to", "broadcast_to", (v, [3, 4]), {}),
        ("broadcast_tensors", "broadcast_tensors", ([a[:1], b],), {}),
        ("broadcast_shape", "broadcast_shape", ([3, 1], [1, 4]), {}),
        ("transpose", "transpose", (c, [2, 0, 1]), {}),
        ("roll", "roll", (a, 2), {"axis": 1}),
        ("gather", "gather", (a, idx), {}),
        ("gather_nd", "gather_nd", (c, t(torch.tensor([[1, 2], [0, 0]]))),
         {}),
        ("take_along_axis", "take_along_axis", (a, k[:, :2]), {"axis": 1}),
        ("put_along_axis", "put_along_axis", (a, k[:, :2], 5.0, 1),
         {"reduce": "add"}),
        ("scatter", "scatter", (a, idx, b[:2]), {"overwrite": False}),
        ("scatter_nd_add", "scatter_nd_add",
         (a, t(torch.tensor([[0, 1], [2, 3]])), v[:2]), {}),
        ("scatter_nd", "scatter_nd", (t(torch.tensor([[1], [2]])), b[:2],
                                      [4, 4]), {}),
        ("index_select", "index_select", (a, idx), {"axis": 1}),
        ("slice", "slice", (c, [1, 2], [1, 0], [3, -1]), {}),
        ("strided_slice", "strided_slice", (c, [2], [3], [0], [-2]), {}),
        ("crop", "crop", (c,), {"shape": [1, -1, 2], "offsets": [1, 1, 2]}),
        ("shard_index", "shard_index", (i, 12, 3, 1), {}),
        ("topk", "topk", (a, 2), {}),
        ("kthvalue", "kthvalue", (a, 2), {}),
        ("mode", "mode", (k,), {}),
        ("where3", "where", (a > 0, a, b), {}),
        ("masked_select", "masked_select", (a, a > 0), {}),
        ("index_sample", "index_sample", (a, k[:, :3]), {}),
        ("searchsorted", "searchsorted", (torch.sort(v).values, a), {}),
        ("quantile", "quantile", (a, 0.3), {"axis": 0}),
        ("equal_all", "equal_all", (a, a), {}),
        ("full_like", "full_like", (a, 2.5), {}),
        ("meshgrid", "meshgrid", (v, v[:2]), {}),
        ("diag", "diag", (v,), {"offset": -1, "padding_value": 7.0}),
        ("diagflat", "diagflat", (v,), {}),
        ("tril", "tril", (m,), {}), ("triu", "triu", (m, 1), {}),
        ("zeros", "zeros", ([2, 3],), place),
        ("ones", "ones", ([3],), place), ("empty", "empty", ([2],), place),
        ("full", "full", ([2], 3.0), place),
        ("arange", "arange", (5,), place),
        ("linspace", "linspace", (0, 1, 5), place),
        ("eye", "eye", (3,), place),
        ("to_tensor", "to_tensor", ([1.0, 2.0],), place),
        # the segment ops: ids with dropped (-1) and empty segments, a
        # zero length
        ("segment_sum", (a.reshape(-1), seg), {}),
        ("segment_mean", (a.reshape(-1), seg), {"num_segments": 6}),
        ("segment_max", (a.reshape(-1), seg), {}),
        ("segment_min", (i.reshape(-1), seg), {"num_segments": 6}),
        ("segment_softmax", (a.reshape(-1), seg), {}),
        ("masked_mean", (a, a > 0), {"axis": 1}),
        ("sequence_mask", (lens,), {"maxlen": 6}),
        ("lengths_to_segment_ids", (lens,), {}),
        ("sequence_pad", ([a[0], a[1, :2]],), {"pad_value": -1.0}),
        ("sequence_unpad", (a, lens), {}),
    ]
    return [c if len(c) == 4 else (c[0], c[0], c[1], c[2]) for c in cases]


# decompositions whose factors are defined up to sign or phase, held by
# their sign-free parts; results whose values depend on the driver beside
# the data (nothing to compare) are listed empty
_SIGN_FREE = {"svd": lambda o: o[1], "qr": lambda o: o[1].abs(),
              "eigh": lambda o: o[0], "eig": None, "eigvals": None,
              "lstsq": lambda o: o[0]}
# card against CPU: fp32 in another summation order; decompositions by
# other solvers
TENSOR_OPS_RTOL, TENSOR_OPS_DECOMP_RTOL = 1e-4, 1e-3


def _held_equal(got, want, rtol, label):
    import torch

    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), label
        for x, y in zip(got, want):
            _held_equal(x, y, rtol, label)
        return
    if not torch.is_tensor(want):
        assert got == want, (label, got, want)
        return
    assert got.device.type == "cuda", (label, got.device)
    g, w = got.cpu(), want
    assert g.shape == w.shape, (label, g.shape, w.shape)
    if w.is_floating_point():
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * 0.1,
                                   msg=label)
    else:
        assert torch.equal(g, w), label


def tensor_ops_cuda():
    """``tensor_ops_cuda``: every ported ``tensor`` op (``__all__`` but
    the in-place variants, which the last case drives) called once on
    ``cuda`` tensors and held against the same op on the CPU
    (``TENSOR_OPS_RTOL``; decompositions by their sign-free parts); each
    op the amp lists name once more under ``auto_cast(level="O1",
    dtype="bfloat16")``: a white op's float32 inputs come out bf16, a black
    op's bf16 inputs float32; the random ops drawn on the card, a seed
    replayed."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.tensor import random as tr

    cuda_cases = _tensor_op_cases("cuda")
    cpu_cases = _tensor_op_cases("cpu")
    covered = {c[1] for c in cuda_cases}
    ops = {n for n in ptt.tensor.__all__ if not n.endswith("_")}
    missing = ops - covered - set(tr.__all__)
    assert not missing, missing
    colours = {"white": 0, "black": 0}
    for (label, name, args, kw), (_, _, cargs, ckw) in zip(cuda_cases,
                                                            cpu_cases):
        got = getattr(ptt, name)(*args, **kw)
        want = getattr(ptt, name)(*cargs, **ckw)
        rtol = TENSOR_OPS_RTOL
        if name == "histogram":  # a value on a bin edge may fall either way
            assert int(got.sum()) == int(want.sum()) == args[0].numel()
            assert int((got.cpu() - want).abs().max()) <= 1, (got, want)
            continue
        if name in _SIGN_FREE:
            if _SIGN_FREE[name] is None:
                continue
            got, want = _SIGN_FREE[name](got), _SIGN_FREE[name](want)
            rtol = TENSOR_OPS_DECOMP_RTOL
        elif name in ("pinv", "cond", "inverse", "inv", "solve", "lu",
                      "matrix_power", "triangular_solve", "eigvalsh",
                      "cholesky", "det", "slogdet"):
            rtol = TENSOR_OPS_DECOMP_RTOL
        _held_equal(got, want, rtol, label)
        white, black = name in amp.WHITE_LIST, name in amp.BLACK_LIST
        if white or black:
            cast = [x.to(torch.bfloat16) if torch.is_tensor(x)
                    and x.is_floating_point() and black else x
                    for x in args]
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                out = getattr(ptt, name)(*cast, **kw)
            want_dt = torch.bfloat16 if white else torch.float32
            assert out.dtype == want_dt, (name, out.dtype)
            colours["white" if white else "black"] += 1
    draws = {}
    for run in range(2):
        ptt.seed(5)
        draws[run] = [
            ptt.rand([64], place="cuda"), ptt.randn([64], place="cuda"),
            ptt.standard_normal([8], place="cuda"),
            ptt.uniform([64], min=-2.0, max=0.0, place="cuda"),
            ptt.uniform([8], seed=9, place="cuda"),
            ptt.normal(1.0, 2.0, [8], place="cuda"),
            ptt.randint(3, 9, [64], place="cuda"),
            ptt.randperm(16, place="cuda"),
            ptt.bernoulli(torch.full((64,), 0.5, device="cuda")),
            ptt.multinomial(torch.tensor([0.2, 0.8], device="cuda"), 3,
                            replacement=True),
            ptt.poisson(torch.full((8,), 3.0, device="cuda"))]
    for x, y in zip(draws[0], draws[1]):
        assert x.device.type == "cuda" and torch.equal(x, y)
    u, r, perm = draws[0][3], draws[0][6], draws[0][7]
    assert float(u.min()) >= -2.0 and float(u.max()) <= 0.0
    assert int(r.min()) >= 3 and int(r.max()) < 9
    assert sorted(perm.tolist()) == list(range(16))
    x = torch.tensor([[1.0, 4.0], [9.0, 16.0]], device="cuda")
    ptt.sqrt_(x)
    ptt.reshape_(x, [4])
    assert x.tolist() == [1.0, 2.0, 3.0, 4.0]
    return {"ops": len(cuda_cases), "amp_colours_checked": colours,
            "random_ops": len(draws[0])}


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


def time_flash_ernie():
    """K3 at the ERNIE fine-tune's shape (``train_ernie_cls``): bf16,
    B 32 x H 12 x L 384 x D 64, non-causal, on the padding of the
    fine-tune's ragged lengths (``_ernie_batch``, seed 0) in both of the
    ways its step gives it: ``lanes`` (segment ids, eagerly) and ``bias``
    (the captured step's [B, 1, 1, L] bf16 mask, ``_ernie_mask_bias``).
    Forward and backward beside the plain twins, the bounds and
    ``scaled_dot_product_attention`` on the same padding (a boolean [B, 1,
    1, L] mask for the lanes, the additive bf16 mask itself for the bias),
    in bf16.  Operations count the visible (query, key) pairs of this
    data, H x L x sum(lengths): 4 D flops each forward, 10 D backward,
    over the bf16 tensor-core peak; bytes read each input once (q, k, v,
    the lanes or the bias; backward also o, dO, the stats) and write each
    output once (o, stats; dq, dk, dv).  Returns {(name, mode): record}."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch import ernie_base_config
    from paddle_tpu_torch.ops import flash_kernels as fk

    b, h, l, d = ERNIE_BATCH, 12, ERNIE_SEQ, 64
    lens = _ernie_batch(np.random.RandomState(0), ernie_base_config())[4]
    gen = torch.Generator(device="cuda").manual_seed(4)
    lane_args, do = flash_case(gen, b, h, l, l, d, torch.bfloat16,
                               causal=False, seg="pad")
    valid = torch.arange(l, device="cuda")[None, :] < torch.from_numpy(
        lens).cuda()[:, None]
    lane_args["kv_seg"] = torch.where(valid, 0, 1).to(torch.int32)
    bias = _ernie_mask_bias()
    modes = {"lanes": (lane_args, valid[:, None, None, :], 2 * b * l * 4),
             "bias": (dict(lane_args, q_seg=None, kv_seg=None, bias=bias),
                      bias, b * l * bias.element_size())}
    pairs = h * l * int(lens.sum())
    tensor_bytes = b * h * l * d * 2
    q, k, v = (lane_args[n].detach().requires_grad_() for n in "qkv")
    out = {}
    for mode, (args, mask, mask_bytes) in modes.items():
        o, stats = fk.flash_attention_forward_kernel(**args)
        stats_bytes = stats.numel() * 4
        work = {"flash_attention_forward_kernel":
                (4 * d * pairs, 4 * tensor_bytes + stats_bytes + mask_bytes),
                "flash_attention_backward_kernel":
                (10 * d * pairs, 8 * tensor_bytes + stats_bytes
                 + mask_bytes)}
        lib_fwd = cuda_ms(lambda: tF.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=20)
        lib_out = tF.scaled_dot_product_attention(q, k, v, attn_mask=mask)
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
            t_ops = flops / BF16_TC_FLOPS_PER_S * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            p1 = cuda_ms(plain, iters=5, warmup=1)
            k1 = cuda_ms(kern, iters=20, warmup=2)
            k2 = cuda_ms(kern, iters=20, warmup=1)
            p2 = cuda_ms(plain, iters=5, warmup=1)
            rec = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes",
                   "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
                   "dtype": "bfloat16", "visible_pairs": pairs,
                   "mode": mode}
            rec["achieved_tflop_s"] = flops / rec["ms"] / 1e9
            rec["vs_library"] = rec["ms"] / lib_ms
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            out[(name, mode)] = rec
            log("timing %-32s ERNIE B=%d H=%d L=%d D=%d pad (%s) bfloat16: "
                "kernel %.4f ms (%.2f TFLOP/s), plain %.4f ms, bound %.4f ms "
                "(%s), sdpa (%s mask) %.4f ms (kernel/sdpa %.3f)"
                % (name, b, h, l, d, mode, rec["ms"],
                   rec["achieved_tflop_s"], rec["plain_ms"], rec["bound_ms"],
                   rec["bound_by"], "bool" if mode == "lanes" else "bf16",
                   lib_ms, rec["vs_library"]))
        del o, stats, lib_out
    del lane_args, do, q, k, v, modes
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


# -- the sequence models ------------------------------------------------------
#
# Two public translation models, each built only from the port's public
# modules (the wrappers below are harness code: the JAX package has no
# seq2seq model class).  Token ids: 0 is the pad and the start token (a
# zero embedding row, as in PaddleNLP's transformer example), 1 the end
# token; real tokens are drawn from [2, vocab).
S2S_PAD = S2S_BOS = 0
S2S_EOS = 1
# Transformer-base (Vaswani et al. 2017, Table 3 "base", as PaddleNLP's
# examples/machine_translation/transformer runs it on WMT14 en-de:
# configs/transformer.base.yaml): pre-norm, one shared 33708-token BPE
# vocabulary tied to the output projection, dropout 0.1 everywhere, label
# smoothing 0.1, Adam (0.9, 0.997, 1e-9) under NoamDecay(512, 4000, 2.0),
# ~4096 tokens a side, beam 4
TRANSFORMER_BASE = dict(vocab=33708, d_model=512, nhead=8, layers=6,
                        d_ff=2048, dropout=0.1)
TF_BATCH, TF_MIN_LEN, TF_MAX_LEN, TF_PAD_LEN = 128, 8, 56, 64
TF_STEPS, TF_LABEL_SMOOTH = 6, 0.1
TF_SENTENCES, TF_BEAM, TF_MAX_STEPS = 16, 4, 64
# the LSTM seq2seq with Luong attention and input feeding, as PaddleNLP's
# examples/machine_translation/seq2seq runs it on IWSLT15 en-vi: 2 x 512
# LSTM encoder, two stacked LSTMCells in the decoder, dropout 0.2, uniform
# init +-0.1, Adam 1e-3 with a global-norm clip of 5, beam 10
LSTM_S2S = dict(src_vocab=17191, trg_vocab=7709, embed=512, hidden=512,
                layers=2, dropout=0.2, init_scale=0.1)
LSTM_BATCH, LSTM_MIN_LEN, LSTM_MAX_LEN, LSTM_STEPS = 128, 8, 50, 6
LSTM_SENTENCES, LSTM_BEAM, LSTM_MAX_STEPS = 16, 10, 50
# train legs: captured against eager from the same weights and the same
# dropout stream (a replay draws the masks the eager step drew).  The
# Transformer runs the same kernels both ways; the LSTM encoder's
# recurrence runs packed by length eagerly and as the step loop in the
# graph (``nn/layer/rnn.py``), whose sums differ in order, and Adam turns
# gradient differences into updates of up to its learning rate
S2S_CAPTURED_RTOL = {"transformer": 1e-5, "lstm": 1e-3}
# eval and beam search, K3 against the composition it stands for (the
# plain route, ``kernel_takes`` false): the teacher-forced loss; each
# step's beam scores wherever both searches took the same path (sums of
# up to 64 log-probabilities of ~-10); ids held while a step's K-th and
# (K+1)-th best candidates are further apart than the floor
S2S_LOSS_RTOL = 1e-5
BEAM_SCORE_TOL = (1e-3, 1e-5)            # absolute, relative
BEAM_MARGIN_FLOOR = 1e-4
# K3 at the seq2seq shapes against its plain twin, forward only (fp32:
# summation order)
S2S_FLASH_TOL = 1e-5
# the cache lengths a beam step's Lq 1 self-attention is held at
S2S_CHECK_LK = (1, 17, 64)


def s2s_models():
    """The two harness model classes (made at the first call, as the
    port's modules import torch): ``TransformerSeq2Seq`` and
    ``LSTMSeq2Seq``."""
    if _S2S_CLASSES:
        return _S2S_CLASSES
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import initializer as I

    class TransformerSeq2Seq(torch.nn.Module):
        """PaddleNLP's ``TransformerModel`` with weight sharing: one
        embedding (N(0, d^-0.5), pad row zero) for source and target,
        scaled by sqrt(d), plus the fixed sinusoid at each token's
        position (0 at pads), dropout, ``nn.Transformer`` (pre-norm), and
        logits against the embedding."""

        def __init__(self, vocab, d_model, nhead, layers, d_ff, dropout,
                     max_len=256, device=None, seed=0):
            super().__init__()
            gen = torch.Generator(device=device).manual_seed(seed)
            self.d_model = d_model
            self.embedding = nn.Embedding(
                vocab, d_model, padding_idx=S2S_PAD,
                weight_attr=nn.ParamAttr(initializer=I.Normal(
                    0.0, d_model ** -0.5)), device=device, generator=gen)
            self.transformer = nn.Transformer(
                d_model, nhead, layers, layers, d_ff, dropout,
                normalize_before=True, device=device, generator=gen)
            self.dropout = nn.Dropout(dropout)
            self._pos = torch.from_numpy(
                sinusoid_table(max_len, d_model)).to(device)

        def embed(self, ids, positions=None):
            if positions is None:
                positions = (ids != S2S_PAD).long() * torch.arange(
                    ids.shape[1], device=ids.device)
            x = self.embedding(ids) * self.d_model ** 0.5 \
                + self._pos[positions]
            return self.dropout(x)

        def encode(self, src):
            bias = (src == S2S_PAD).float()[:, None, None, :] * -1e9
            return self.transformer.encoder(self.embed(src), bias), bias

        def forward(self, src, trg):
            memory, bias = self.encode(src)
            mask = self.transformer.generate_square_subsequent_mask(
                trg.shape[1])
            out = self.transformer.decoder(self.embed(trg), memory, mask,
                                           bias)
            return torch.matmul(out, self.embedding.weight.t())

        def step_cell(self, memory_bias):
            """The beam search's cell: [N] ids and the decoder's caches ->
            [N, V] logits and the grown caches (the position is the
            self-attention cache's length)."""
            def cell(ids, caches):
                t = caches[0][0].k.shape[2]
                pos = torch.full_like(ids, t)[:, None]
                out, caches = self.transformer.decoder(
                    self.embed(ids[:, None], pos), None, None, memory_bias,
                    caches)
                cell.logits = torch.matmul(out[:, -1],
                                           self.embedding.weight.t())
                return cell.logits, caches
            return cell

        def translate(self, src, beam, max_steps):
            """Beam search over ``src``: ``(ids [B, T, K], final scores
            [B, K], per-step record)``."""
            with torch.no_grad():
                memory, bias = self.encode(src)
                caches = self.transformer.decoder.gen_cache(memory)
            cell = self.step_cell(
                nn.BeamSearchDecoder.tile_beam_merge_with_batch(bias, beam))
            return _run_beam(cell, caches, beam, max_steps, src.shape[0])

    class _AttentionCell(nn.RNNCellBase):
        """The decoder's step: input feeding (the previous attention output
        beside the embedded token), two stacked LSTMCells with dropout, and
        Luong attention over the encoder's outputs (``memory``, set before
        a run with its [N, 1, Ls] additive padding bias)."""

        def __init__(self, embed, hidden, layers, dropout, attr, device,
                     gen):
            super().__init__()
            cell_kw = dict(weight_ih_attr=attr, weight_hh_attr=attr,
                           bias_ih_attr=attr, bias_hh_attr=attr,
                           device=device, generator=gen)
            self.lstm_cells = nn.LayerList(
                [nn.LSTMCell(embed + hidden if i == 0 else hidden, hidden,
                             **cell_kw) for i in range(layers)])
            self.dropout = nn.Dropout(dropout)
            lin = dict(weight_attr=attr, bias_attr=False, device=device,
                       generator=gen)
            self.input_proj = nn.Linear(hidden, hidden, **lin)
            self.output_proj = nn.Linear(2 * hidden, hidden, **lin)
            self.memory = self.memory_bias = None

        def forward(self, step_input, states):
            lstm_states, input_feed = states
            x = torch.cat([step_input, input_feed], dim=-1)
            new_states = []
            for cell, st in zip(self.lstm_cells, lstm_states):
                out, st = cell(x, st)
                x = self.dropout(out)
                new_states.append(st)
            q = self.input_proj(x)[:, None]
            scores = torch.matmul(q, self.memory.transpose(1, 2)) \
                + self.memory_bias
            ctx = torch.matmul(F.softmax(scores, axis=-1), self.memory)[:, 0]
            out = torch.tanh(self.output_proj(torch.cat([ctx, x], dim=-1)))
            return out, [new_states, out]

    class LSTMSeq2Seq(torch.nn.Module):
        """PaddleNLP's ``Seq2SeqAttnModel``: an embedding and a
        multi-layer ``nn.LSTM`` encoder over the source lengths, an
        ``nn.RNN`` of the attention cell over the embedded target,
        initialised from the encoder's final states, and an output
        projection; every parameter Uniform(-init_scale, init_scale)."""

        def __init__(self, src_vocab, trg_vocab, embed, hidden, layers,
                     dropout, init_scale, device=None, seed=0):
            super().__init__()
            gen = torch.Generator(device=device).manual_seed(seed)
            attr = nn.ParamAttr(initializer=I.Uniform(-init_scale,
                                                      init_scale))
            kw = dict(device=device, generator=gen)
            self.hidden = hidden
            self.src_embedding = nn.Embedding(src_vocab, embed,
                                              weight_attr=attr, **kw)
            self.encoder = nn.LSTM(
                embed, hidden, layers,
                dropout=dropout if layers > 1 else 0.0,
                weight_ih_attr=attr, weight_hh_attr=attr, bias_ih_attr=attr,
                bias_hh_attr=attr, **kw)
            self.trg_embedding = nn.Embedding(trg_vocab, embed,
                                              weight_attr=attr, **kw)
            self.decoder = nn.RNN(_AttentionCell(embed, hidden, layers,
                                                 dropout, attr, device, gen))
            self.output = nn.Linear(hidden, trg_vocab, weight_attr=attr,
                                    bias_attr=False, **kw)

        def encode(self, src, src_len):
            out, (h, c) = self.encoder(self.src_embedding(src),
                                       sequence_length=src_len)
            mask = (torch.arange(src.shape[1], device=src.device)[None, :]
                    < src_len[:, None]).float()
            states = [[(h[i], c[i]) for i in range(h.shape[0])],
                      torch.zeros(src.shape[0], self.hidden,
                                  device=src.device)]
            return out, ((mask - 1.0) * 1e9)[:, None, :], states

        def forward(self, src, src_len, trg):
            memory, bias, states = self.encode(src, src_len)
            cell = self.decoder.cell
            cell.memory, cell.memory_bias = memory, bias
            out, _ = self.decoder(self.trg_embedding(trg), states)
            return self.output(out)

        def translate(self, src, src_len, beam, max_steps):
            with torch.no_grad():
                memory, bias, states = self.encode(src, src_len)
            tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
            dec_cell = self.decoder.cell
            dec_cell.memory, dec_cell.memory_bias = tile(memory, beam), \
                tile(bias, beam)

            def cell(ids, st):
                out, st = dec_cell(self.trg_embedding(ids), st)
                cell.logits = self.output(out)
                return cell.logits, st
            return _run_beam(cell, states, beam, max_steps, src.shape[0])

    _S2S_CLASSES.update(transformer=TransformerSeq2Seq, lstm=LSTMSeq2Seq)
    return _S2S_CLASSES


_S2S_CLASSES: dict = {}


def sinusoid_table(n: int, d: int):
    """[n, d] float32 sinusoid position table (sines, then cosines, over
    geometric timescales from 1 to 1e4), as the transformer example's."""
    half = d // 2
    inv = np.exp(np.arange(half) * -(np.log(1e4) / max(half - 1, 1)))
    t = np.arange(n)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(t), np.cos(t)], axis=1)
    return np.pad(table, ((0, 0), (0, d % 2))).astype(np.float32)


def beam_margins(logits, log_probs, finished, beam: int, end: int):
    """[B] the smallest gap between adjacent ones of a step's K+1 best
    candidates, from the step's logits and the beam state before it (the
    step's own algebra: fp32 log-softmax, the end-only row of a finished
    beam, the [B, K*V] scores)."""
    import torch

    lp = torch.log_softmax(logits.float(), dim=-1)
    vocab = lp.shape[-1]
    lp = lp.reshape(-1, beam, vocab)
    end_only = torch.full((vocab,), -1e9, device=lp.device)
    end_only[end] = 0.0
    lp = torch.where(finished[..., None], end_only, lp)
    top = torch.topk((log_probs[..., None] + lp).reshape(lp.shape[0], -1),
                     beam + 1).values
    return (top[:, :-1] - top[:, 1:]).min(dim=1).values


def _run_beam(cell, states, beam, max_steps, batch):
    """``dynamic_decode`` of a ``BeamSearchDecoder`` over ``cell``,
    recording each step's chosen tokens, parents and scores and its
    margin (:func:`beam_margins`) on the host after the search:
    ``(ids [B, T, K], final scores [B, K], record)``."""
    import torch

    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode

    steps = []

    class Recording(BeamSearchDecoder):
        def step(self, time, inputs, states, **kw):
            out = super().step(time, inputs, states, **kw)
            steps.append((out[0], beam_margins(
                cell.logits, states["log_probs"], states["finished"], beam,
                S2S_EOS)))
            return out

    dec = Recording(cell, S2S_BOS, S2S_EOS, beam)
    ids, final = dynamic_decode(dec, inits=states, max_step_num=max_steps)
    record = {k: torch.stack([o[k] for o, _ in steps], dim=1).cpu().numpy()
              for k in ("predicted_ids", "parent_ids", "scores")}
    record["margins"] = torch.stack([m for _, m in steps], dim=1).cpu() \
        .numpy()
    return ids, final["log_probs"], record


def beam_agreement(got, want, floor=BEAM_MARGIN_FLOOR, tol=BEAM_SCORE_TOL):
    """Two searches' records (:func:`_run_beam`, ``want`` the one whose
    margins gate) held against each other.  For each sentence, its steps
    up to the first whose margin is at most ``floor`` must pick the same
    tokens and parents; the scores of every step both took along the same
    path agree within ``tol`` (absolute, relative).  Returns the counts."""
    b = want["margins"].shape[0]
    t = min(want["margins"].shape[1], got["margins"].shape[1])
    same = np.all([got[k][:, :t] == want[k][:, :t]
                   for k in ("predicted_ids", "parent_ids")], axis=(0, 3))
    gated = np.cumprod(want["margins"][:, :t] > floor, axis=1).astype(bool)
    assert not np.any(gated & ~same), (
        "beam picks differ where the margin clears %g: %s"
        % (floor, np.argwhere(gated & ~same)[:8].tolist()))
    path = np.cumprod(same, axis=1).astype(bool)
    want_scores = want["scores"][:, :t]
    err = np.abs(got["scores"][:, :t] - want_scores)
    limit = tol[0] + tol[1] * np.abs(want_scores)
    bad = path[..., None] & (err > limit)
    assert not bad.any(), ("beam scores differ along a shared path",
                           float(err[path].max()))
    return {"steps": t, "sentences": b,
            "gated_steps": int(gated.sum()), "same_path_steps":
            int(path.sum()), "sentences_gated_throughout":
            int(gated.all(axis=1).sum()),
            "max_score_err_on_shared_path":
            float(err[path].max()) if path.any() else None}


def _ragged_ids(rng, b, lens, pad_len, vocab):
    """[B, pad_len] int64 ids of [2, vocab) up to each row's length, 0
    after it."""
    ids = rng.randint(2, vocab, (b, pad_len))
    return np.where(np.arange(pad_len)[None, :] < lens[:, None], ids,
                    S2S_PAD).astype(np.int64)


def s2s_batch(rng, b, vocab_src, vocab_trg, min_len, max_len, pad_len):
    """A translation batch drawn by ``rng``: source ids, the target input
    (the start token, then the tokens) and its label (the tokens, then the
    end token), each [B, pad_len] and padded with 0, and the source and
    target lengths (tokens, the end token not counted)."""
    src_len = rng.randint(min_len, max_len + 1, b)
    trg_len = rng.randint(min_len, min(max_len, pad_len - 1) + 1, b)
    src = _ragged_ids(rng, b, src_len, pad_len, vocab_src)
    toks = _ragged_ids(rng, b, trg_len, pad_len, vocab_trg)
    trg = np.concatenate([np.full((b, 1), S2S_BOS), toks[:, :-1]], axis=1)
    label = toks.copy()
    label[np.arange(b), trg_len] = S2S_EOS
    return src, trg, label, src_len, trg_len


def _tf_batch(rng):
    v = TRANSFORMER_BASE["vocab"]
    return s2s_batch(rng, TF_BATCH, v, v, TF_MIN_LEN, TF_MAX_LEN,
                     TF_PAD_LEN)


def _tf_sentences():
    """The translation phase's 16 source sentences, of lengths 8-64."""
    rng = np.random.RandomState(7)
    lens = rng.randint(TF_MIN_LEN, TF_PAD_LEN + 1, TF_SENTENCES)
    return _ragged_ids(rng, TF_SENTENCES, lens, TF_PAD_LEN,
                       TRANSFORMER_BASE["vocab"]), lens


def _pad_bias(lens, pad_len):
    """[B, 1, 1, pad_len] float32: 0 up to each length, -1e9 after (the
    source models' additive padding mask)."""
    valid = np.arange(pad_len)[None, :] < np.asarray(lens)[:, None]
    return np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]


def label_smoothed_ce(logits, label, epsilon=TF_LABEL_SMOOTH):
    """The transformer example's criterion: cross entropy of the [B, L, V]
    logits against one-hot labels smoothed by ``epsilon`` (soft labels),
    averaged over the non-pad target tokens."""
    from paddle_tpu_torch.nn import functional as F

    weights = (label != S2S_PAD).float()
    soft = F.label_smooth(F.one_hot(label, logits.shape[-1]),
                          epsilon=epsilon)
    cost = F.cross_entropy(logits, soft, soft_label=True, reduction="none")
    return (cost * weights).sum() / weights.sum()


def masked_token_ce(logits, label):
    """The seq2seq example's criterion: per-token cross entropy over the
    non-pad labels, averaged over the batch and summed over time."""
    from paddle_tpu_torch.nn import functional as F

    cost = F.cross_entropy(logits, label, reduction="none")
    return (cost * (label != S2S_PAD).float()).mean(dim=0).sum()


def transformer_flops(cfg, b, ls, lt) -> float:
    """A Transformer training step's FLOPs on the padded slots: 2 per
    multiply-add of every product, forward and backward (3x).  Per source
    slot the encoder's products and the cross-attentions' key and value
    projections; per target slot the decoder's other products and the tied
    projection; the attention products over all (query, key) pairs."""
    d, f, n, v = cfg["d_model"], cfg["d_ff"], cfg["layers"], cfg["vocab"]
    src = n * (4 * d * d + 2 * d * f) + n * 2 * d * d
    trg = n * (4 * d * d + 2 * d * d + 2 * d * f) + d * v
    attn = n * 2 * d * (ls * ls + lt * lt + lt * ls)
    return 3.0 * 2 * b * (src * ls + trg * lt + attn)


def lstm_flops(cfg, b, ls, lt) -> float:
    """The LSTM seq2seq's training step FLOPs on the padded slots (3x the
    forward's 2 per multiply-add): the encoder's gates per source slot;
    the two cells (input feeding), the attention over ``ls`` keys and the
    output projection per target slot."""
    e, h, n, v = cfg["embed"], cfg["hidden"], cfg["layers"], cfg["trg_vocab"]
    src = sum(4 * h * ((e if i == 0 else h) + h) for i in range(n))
    trg = sum(4 * h * ((e + h if i == 0 else h) + h) for i in range(n)) \
        + h * h + 2 * ls * h + 2 * h * h + h * v
    return 3.0 * 2 * b * (src * ls + trg * lt)


def _tf_model(seed=0):
    return s2s_models()["transformer"](**TRANSFORMER_BASE, device="cuda",
                                       seed=seed)


def _lstm_model(seed=0):
    return s2s_models()["lstm"](**LSTM_S2S, device="cuda", seed=seed)


def _s2s_leg(build, loss_fn, batches, capture, seed=0):
    """``build()``'s model, optimizer and scheduler (or None) trained by
    one ``TrainStep`` over ``batches``, captured or eager, the CUDA
    generator seeded with ``seed`` first (so both legs draw the same
    dropout masks); the scheduler steps after each call.  No K3 launch
    may happen (dropout sends every training attention to the
    composition).  Steps are timed from the first replay (captured) or
    the second step (eager); one more step is profiled."""
    import torch

    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.ops import flash_kernels as fk

    torch.cuda.manual_seed(seed)
    model, opt, sched = build()
    step = TrainStep(model, loss_fn, opt, capture=capture)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launch_counts()
    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if sched is not None:
            sched.step()
    k3 = fk.launch_counts()
    assert k3 == dict.fromkeys(k3, 0), k3
    peak = torch.cuda.max_memory_allocated()
    assert step.compile_counts() == {"train_step": 1}
    assert step._fn.graphs() == int(capture)
    timed = step_ms[2:] if capture else step_ms[1:]
    mean_ms = float(np.mean(timed))
    out = {"capture": capture, "losses": losses, "step_ms": step_ms,
           "warmup_step_ms": step_ms[0], "step_ms_mean": mean_ms,
           "step_ms_p50": float(np.median(timed)),
           "peak_mem_gb": peak / 2 ** 30, "k3_launches": k3}
    out["profile"] = _profile_step(step, batches[-1], mean_ms)
    out["launches_per_step"] = out["profile"].pop("launches")
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _s2s_train(name, build, loss_fn, batches, flops, src_tokens,
               trg_tokens):
    """Both legs of a seq2seq training cell and their figures: the
    captured losses against the eager ones (``S2S_CAPTURED_RTOL``),
    finite; tokens/s of real (unpadded) source and target tokens; MFU of
    ``flops`` a step over the fp32 CUDA-core peak."""
    eager = _s2s_leg(build, loss_fn, batches, False)
    captured = _s2s_leg(build, loss_fn, batches, True)
    losses = captured["losses"]
    assert all(np.isfinite(losses)), losses
    np.testing.assert_allclose(losses, eager["losses"],
                               rtol=S2S_CAPTURED_RTOL[name])
    out = {"captured": captured, "eager": eager, "flops_per_step": flops,
           "mfu_peak_flops_per_s": FP32_FLOPS_PER_S}
    for leg in (captured, eager):
        s = leg["step_ms_mean"] / 1e3
        leg.update(src_tokens_per_s=src_tokens / s,
                   trg_tokens_per_s=trg_tokens / s,
                   mfu=flops / s / FP32_FLOPS_PER_S,
                   device_idle_share=leg["profile"]["device_idle_share"])
    return out


def train_transformer_base():
    """``train_transformer_base``: Transformer-base (6 + 6 layers, 512
    wide, 8 heads x 64, FFN 2048, shared 33708-token vocabulary, dropout
    0.1) by ``TrainStep`` with Adam (0.9, 0.997, 1e-9) under
    NoamDecay(512, 4000, 2.0) and the label-smoothed soft-label cross
    entropy, on 6 batches of 128 x 64 (lengths 8-56, numpy seed 0),
    eagerly and captured from the same weights and dropout stream
    (``_s2s_train``).  Dropout on the attention weights keeps every
    training attention off K3: 0 launches either way."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer.lr import NoamDecay

    cfg = TRANSFORMER_BASE

    def build():
        model = _tf_model()
        sched = NoamDecay(cfg["d_model"], 4000, learning_rate=2.0)
        return model, Adam(sched, beta1=0.9, beta2=0.997, epsilon=1e-9,
                           parameters=model.parameters()), sched

    rng = np.random.RandomState(0)
    batches, src_tok, trg_tok = [], 0, 0
    for _ in range(TF_STEPS):
        src, trg, label, sl, tl = _tf_batch(rng)
        batches.append((src, trg, label))
        src_tok += int(sl.sum())
        trg_tok += int(tl.sum()) + TF_BATCH
    out = _s2s_train(
        "transformer", build,
        lambda m, src, trg, label: label_smoothed_ce(m(src, trg), label),
        batches, transformer_flops(cfg, TF_BATCH, TF_PAD_LEN, TF_PAD_LEN),
        src_tok / TF_STEPS, trg_tok / TF_STEPS)
    model = _tf_model()
    out.update(params_m=sum(p.numel() for p in model.parameters()) / 1e6,
               batch=TF_BATCH, pad_len=TF_PAD_LEN, steps=TF_STEPS,
               src_tokens_per_step=src_tok / TF_STEPS,
               trg_tokens_per_step=trg_tok / TF_STEPS)
    return out


def _spy_k3():
    """Patch ``FlashAttentionFunction.apply`` to record each call's (Lq,
    Lk, bias given, segment lanes given): ``(calls, restore)``."""
    from paddle_tpu_torch.ops import flash_kernels as fk

    calls = []
    apply = fk.FlashAttentionFunction.apply

    def recording_apply(*a):
        calls.append((a[0].shape[2], a[1].shape[2], a[3] is not None,
                      a[4] is not None))
        return apply(*a)

    fk.FlashAttentionFunction.apply = recording_apply

    def restore():
        fk.FlashAttentionFunction.apply = apply

    return calls, restore


def _plain_route():
    """Within it, ``flash_attention`` takes the composition it stands for
    (``kernel_takes`` false) instead of K3."""
    from unittest import mock

    from paddle_tpu_torch.ops import flash_kernels as fk

    return mock.patch.object(fk, "kernel_takes", lambda *a, **kw: False)


def eval_transformer_base():
    """``eval_transformer_base``: the teacher-forced loss of Transformer-
    base (seed 0) on a 128 x 64 batch under ``no_grad`` and ``eval()``:
    every attention through K3 in its bias mode (the models' -1e9 masks,
    which no detection claims), 3 x 6 forward launches a call; the loss
    and logits against the same forward on the composition."""
    import torch

    from paddle_tpu_torch.ops import flash_kernels as fk

    model = _tf_model().eval()
    src, trg, label, _, _ = _tf_batch(np.random.RandomState(1))
    src, trg, label = (torch.from_numpy(a).cuda() for a in (src, trg, label))
    layers = TRANSFORMER_BASE["layers"]
    calls, restore = _spy_k3()
    try:
        fk.reset_launch_counts()
        with torch.no_grad():
            logits = model(src, trg)
            loss = float(label_smoothed_ce(logits, label))
            k3 = fk.launch_counts()
            torch.cuda.synchronize()
            ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                model(src, trg)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        restore()
    # the encoder's self-attentions, then each decoder layer's self- and
    # cross-attention: all 128 x 64 x 64, all given a bias
    assert k3 == {"flash_attention_forward_kernel": 3 * layers,
                  "flash_attention_backward_kernel": 0}, k3
    assert calls[:3 * layers] == [(TF_PAD_LEN, TF_PAD_LEN, True, False)] \
        * (3 * layers), calls[:3 * layers]
    with _plain_route(), torch.no_grad():
        plain_logits = model(src, trg)
        plain_loss = float(label_smoothed_ce(plain_logits, label))
    err = (logits - plain_logits).abs().max().item()
    assert np.isfinite(loss) and abs(loss - plain_loss) \
        <= S2S_LOSS_RTOL * abs(plain_loss), (loss, plain_loss)
    out = {"loss": loss, "plain_loss": plain_loss,
           "logits_max_abs_err": err, "forward_ms": float(np.mean(ms)),
           "k3_launches_bias_mode": k3["flash_attention_forward_kernel"],
           "k3_encoder_launches": layers, "k3_decoder_self_launches": layers,
           "k3_cross_launches": layers}
    log("eval_transformer_base: loss %.6f (composition %.6f), logits max "
        "err %.2e, K3 forward %d (bias mode), forward %.2f ms"
        % (loss, plain_loss, err, out["k3_launches_bias_mode"],
           out["forward_ms"]))
    del model
    torch.cuda.empty_cache()
    return out


# the steps of the profiled search a translation phase runs after its
# timed one (the encoder's share counts into them)
PROFILED_STEPS = 16


def _translate_figures(run, wall_s, steps, rows, profile_fn):
    """ms a step, generated tokens/s (every beam's token a step) and, from
    a ``PROFILED_STEPS``-step search under the profiler, device busy ms
    and kernels a step, and the idle share of the timed search's step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profile_fn(PROFILED_STEPS)
        torch.cuda.synchronize()
    rows_t = device_time_rows(prof)
    busy = sum(r[0] for r in rows_t) / PROFILED_STEPS
    ms = wall_s * 1e3 / steps
    run.update(steps=steps, wall_ms=wall_s * 1e3, ms_per_step=ms,
               beam_tokens_per_s=rows * steps / wall_s,
               device_busy_ms_per_step=busy,
               device_idle_share=(1 - busy / ms) if busy else None,
               launches_per_step=sum(n for _, _, n in rows_t)
               / PROFILED_STEPS)
    return run


def translate_transformer_base():
    """``translate_transformer_base``: beam search (beam 4, at most 64
    steps) over 16 source sentences of lengths 8-64 with Transformer-base
    (seed 0): the encoder through K3 once (6 launches), then each step's
    64 rows through the decoder's caches -- the self-attention's
    concatenated ``Cache`` (Lq 1 against Lk = the step, no mask) and the
    cross-attention's ``StaticCache`` with the tiled padding bias, both
    through K3: 12 launches a step.  The ids and scores are held against
    the same search on the composition (``beam_agreement``)."""
    import torch

    from paddle_tpu_torch.ops import flash_kernels as fk

    model = _tf_model().eval()
    src, lens = _tf_sentences()
    src = torch.from_numpy(src).cuda()
    model.translate(src, TF_BEAM, 2)  # warm-up
    torch.cuda.synchronize()
    layers = TRANSFORMER_BASE["layers"]
    calls, restore = _spy_k3()
    try:
        fk.reset_launch_counts()
        t0 = time.perf_counter()
        ids, scores, rec = model.translate(src, TF_BEAM, TF_MAX_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = fk.launch_counts()
    finally:
        restore()
    steps = rec["margins"].shape[1]
    rows = TF_SENTENCES * TF_BEAM
    enc = [(TF_PAD_LEN, TF_PAD_LEN, True, False)] * layers
    step_calls = [c for t in range(steps) for c in
                  [(1, t + 1, False, False), (1, TF_PAD_LEN, True, False)]
                  * layers]
    assert calls == enc + step_calls, (len(calls), calls[:20])
    assert k3 == {"flash_attention_forward_kernel": layers * (1 + 2 * steps),
                  "flash_attention_backward_kernel": 0}, k3
    assert tuple(ids.shape) == (TF_SENTENCES, steps, TF_BEAM)
    assert bool(torch.isfinite(scores).all())
    with _plain_route():
        _, plain_scores, plain_rec = model.translate(src, TF_BEAM,
                                                     TF_MAX_STEPS)
    agree = beam_agreement(rec, plain_rec)
    out = {"k3_launches": k3["flash_attention_forward_kernel"],
           "k3_encoder_launches": layers,
           "k3_step_self_launches": layers * steps,
           "k3_step_cross_launches": layers * steps,
           "k3_launches_per_step": 2 * layers, "agreement": agree,
           "src_lengths": lens.tolist(),
           "best_scores": scores[:, 0].tolist()}
    _translate_figures(out, wall, steps, rows, lambda n: model.translate(
        src, TF_BEAM, n))
    log("translate_transformer_base: %d steps, %.3f ms a step, %.0f beam "
        "tokens/s, idle %s, %.0f kernels a step, K3 %d (%d a step), "
        "against the composition %s"
        % (steps, out["ms_per_step"], out["beam_tokens_per_s"],
           out["device_idle_share"], out["launches_per_step"],
           out["k3_launches"], 2 * layers, agree))
    del model
    torch.cuda.empty_cache()
    return out


def _lstm_batch(rng):
    c = LSTM_S2S
    return s2s_batch(rng, LSTM_BATCH, c["src_vocab"], c["trg_vocab"],
                     LSTM_MIN_LEN, LSTM_MAX_LEN, LSTM_MAX_LEN)


def train_seq2seq_lstm():
    """``train_seq2seq_lstm``: the LSTM seq2seq with attention (2 x 512
    LSTM encoder, two 512 LSTMCells with input feeding and Luong attention,
    vocabularies 17191 / 7709, dropout 0.2, uniform init +-0.1) by
    ``TrainStep`` with Adam 1e-3 and a global-norm clip of 5, on 6 batches
    of 128 x 50 (lengths 8-50, numpy seed 0), eagerly (the encoder packed
    by length through cuDNN) and captured (the encoder's step loop) from
    the same weights and dropout stream.  No K3."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Adam

    def build():
        model = _lstm_model()
        return model, Adam(1e-3, parameters=model.parameters(),
                           grad_clip=ClipGradByGlobalNorm(5.0)), None

    rng = np.random.RandomState(0)
    batches, src_tok, trg_tok = [], 0, 0
    for _ in range(LSTM_STEPS):
        src, trg, label, sl, tl = _lstm_batch(rng)
        batches.append((src, sl.astype(np.int64), trg, label))
        src_tok += int(sl.sum())
        trg_tok += int(tl.sum()) + LSTM_BATCH
    out = _s2s_train(
        "lstm", build,
        lambda m, src, sl, trg, label: masked_token_ce(m(src, sl, trg),
                                                       label),
        batches, lstm_flops(LSTM_S2S, LSTM_BATCH, LSTM_MAX_LEN,
                            LSTM_MAX_LEN),
        src_tok / LSTM_STEPS, trg_tok / LSTM_STEPS)
    model = _lstm_model()
    out.update(params_m=sum(p.numel() for p in model.parameters()) / 1e6,
               batch=LSTM_BATCH, pad_len=LSTM_MAX_LEN, steps=LSTM_STEPS)
    return out


def translate_seq2seq_lstm():
    """``translate_seq2seq_lstm``: beam search (beam 10, at most 50 steps)
    over 16 source sentences of lengths 8-50 with the LSTM seq2seq (seed
    0): the encoder packed by length, then each step's 160 rows through
    the attention cell.  No K3.  The ids and scores are held against the
    same search on a CPU copy of the model (``beam_agreement``)."""
    import copy

    import torch

    from paddle_tpu_torch.ops import flash_kernels as fk

    model = _lstm_model().eval()
    rng = np.random.RandomState(8)
    lens = rng.randint(LSTM_MIN_LEN, LSTM_MAX_LEN + 1, LSTM_SENTENCES)
    src_np = _ragged_ids(rng, LSTM_SENTENCES, lens, LSTM_MAX_LEN,
                         LSTM_S2S["src_vocab"])
    src = torch.from_numpy(src_np).cuda()
    sl = torch.from_numpy(lens.astype(np.int64)).cuda()
    model.translate(src, sl, LSTM_BEAM, 2)  # warm-up
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    ids, scores, rec = model.translate(src, sl, LSTM_BEAM, LSTM_MAX_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = fk.launch_counts()
    assert k3 == dict.fromkeys(k3, 0), k3
    steps = rec["margins"].shape[1]
    assert tuple(ids.shape) == (LSTM_SENTENCES, steps, LSTM_BEAM)
    assert bool(torch.isfinite(scores).all())
    host = copy.deepcopy(model).cpu()
    _, _, host_rec = host.translate(torch.from_numpy(src_np),
                                    torch.from_numpy(lens.astype(np.int64)),
                                    LSTM_BEAM, LSTM_MAX_STEPS)
    agree = beam_agreement(rec, host_rec)
    out = {"k3_launches": 0, "agreement_with_cpu": agree,
           "src_lengths": lens.tolist(),
           "best_scores": scores[:, 0].tolist()}
    _translate_figures(out, wall, steps, LSTM_SENTENCES * LSTM_BEAM,
                       lambda n: model.translate(src, sl, LSTM_BEAM, n))
    log("translate_seq2seq_lstm: %d steps, %.3f ms a step, %.0f beam "
        "tokens/s, idle %s, %.0f kernels a step, against the CPU %s"
        % (steps, out["ms_per_step"], out["beam_tokens_per_s"],
           out["device_idle_share"], out["launches_per_step"], agree))
    del model, host
    torch.cuda.empty_cache()
    return out


def s2s_flash_cases(gen):
    """K3's inputs at the seq2seq shapes (fp32, 8 heads x 64, q/k/v as
    the layers make them), each ``(args, pairs)``: ``encoder`` and
    ``cross`` (128 x 64 x 64, the training batch's [B, 1, 1, 64] -1e9
    padding bias), ``encoder_fully_padded`` (the same, with every key of
    row 1 masked), ``decoder_self`` (the [64, 64] -1e9 subsequent mask,
    broadcast), ``translate_encoder`` (the 16 sentences), ``step_self_<Lk>``
    (64 rows, one query against Lk = 1..64 cached keys, no mask) and
    ``step_cross`` (one query against 64 keys, the sentences' padding
    tiled by beam)."""
    import torch

    b, h, d, l = TF_BATCH, 8, 64, TF_PAD_LEN
    rows = TF_SENTENCES * TF_BEAM
    f32 = torch.float32
    pad = torch.from_numpy(_pad_bias(_tf_batch(np.random.RandomState(1))[3],
                                     l)).cuda()
    full = pad.clone()
    full[1] = -1e9
    sent = torch.from_numpy(_pad_bias(_tf_sentences()[1], l)).cuda()
    causal = torch.full((l, l), -1e9, device="cuda").triu(1)
    specs = {"encoder": (b, l, l, pad), "encoder_fully_padded":
             (b, l, l, full), "decoder_self": (b, l, l, causal),
             "cross": (b, l, l, pad),
             "translate_encoder": (TF_SENTENCES, l, l, sent),
             "step_cross": (rows, 1, l, sent.repeat_interleave(TF_BEAM, 0))}
    specs.update({"step_self_%d" % lk: (rows, 1, lk, None)
                  for lk in range(1, l + 1)})
    out = {}
    for name, (bb, lq, lk, bias) in specs.items():
        args, _ = flash_case(gen, bb, h, lq, lk, d, f32, causal=False)
        args["bias"] = bias
        out[name] = args
    return out


def _check_flash_seq2seq(gen):
    """K3's forward against its plain twin at the seq2seq shapes (Lq 1 at
    each Lk of ``S2S_CHECK_LK``), fp32, within ``S2S_FLASH_TOL``.  Returns
    the max errors by case."""
    import torch

    from paddle_tpu_torch.ops import flash_kernels as fk

    cases = s2s_flash_cases(gen)
    errs = {}
    for name in ("encoder", "encoder_fully_padded", "decoder_self", "cross",
                 "translate_encoder", "step_cross") + tuple(
                     "step_self_%d" % lk for lk in S2S_CHECK_LK):
        args = cases[name]
        o, stats = fk.flash_attention_forward_kernel(**args)
        torch.cuda.synchronize()
        want_o, want_stats = fk.flash_attention_forward_plain(**args)
        e = {"o": (o - want_o).abs().max().item(),
             "stats": (stats - want_stats).abs().max().item()}
        ok = e["o"] <= S2S_FLASH_TOL and e["stats"] <= S2S_FLASH_TOL \
            and bool(torch.isfinite(o).all())
        log("parity flash_attention float32 seq2seq %-20s q %s k %s bias %s"
            "  errs %s  tol %.0e %s"
            % (name, tuple(args["q"].shape), tuple(args["k"].shape),
               None if args["bias"] is None else tuple(args["bias"].shape),
               {n: "%.2e" % v for n, v in e.items()}, S2S_FLASH_TOL,
               "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("K3 disagrees with its plain twin at the "
                                 "seq2seq shape %s: %s" % (name, e))
        errs[name] = max(e.values())
    errs["step_self"] = max(errs.pop("step_self_%d" % lk)
                            for lk in S2S_CHECK_LK)
    return errs


def time_flash_seq2seq():
    """K3's forward at the seq2seq shapes (``s2s_flash_cases``) beside its
    plain twin, ``scaled_dot_product_attention`` with the same additive
    mask, and the bound: 4 D flops a (query, key) pair (every pair: a bias
    masks none) over 3xTF32's 165 TFLOP/s, against q, k, v, the bias, o
    and the stats read or written once over 3.35 TB/s.  Every time is
    device time from CUDA-graph replays (``graph_ms``: at these sizes the
    wrapper's host work outlasts the kernel), with the eager launch's
    ``eager_ms`` beside the kernel's.  ``step_self`` is the mean a launch
    over one launch at each Lk of a 64-step search (one graph holding all
    64), with Lk ``S2S_CHECK_LK`` beside it.  Returns {case: record}."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops import flash_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = s2s_flash_cases(gen)
    calls = {}
    out = {}
    for name, args in cases.items():
        if name == "encoder_fully_padded":
            continue
        q, k, v, bias = args["q"], args["k"], args["v"], args["bias"]
        bb, h, lq, d = q.shape
        lk = k.shape[2]
        flops = 4.0 * d * bb * h * lq * lk
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + 2 * bb * h * lq
                      + (0 if bias is None else bias.numel()))
        mask = None if bias is None else bias.expand(bb, 1, lq, lk) \
            if bias.ndim == 4 else bias
        calls[name] = (
            functools.partial(fk.flash_attention_forward_kernel, **args),
            functools.partial(fk.flash_attention_forward_plain, **args),
            functools.partial(tF.scaled_dot_product_attention, q, k, v,
                              attn_mask=mask))
        out[name] = {"flops": flops, "bytes": nbytes, "q": list(q.shape),
                     "k": list(k.shape),
                     "bias": None if bias is None else list(bias.shape)}
    steps = ["step_self_%d" % lk for lk in range(1, TF_PAD_LEN + 1)]
    timed = [n for n in out if n not in steps] + [
        "step_self_%d" % lk for lk in S2S_CHECK_LK]
    for name in timed:
        kern, plain, lib = calls[name]
        # plain, kernel, kernel, plain: compare within one call
        p1, k1, k2, p2 = (graph_ms([f]) for f in (plain, kern, kern, plain))
        out[name].update(ms=min(k1, k2), plain_ms=min(p1, p2),
                         library_ms=graph_ms([lib]),
                         eager_ms=cuda_ms(kern, iters=20))
    mean = {key: float(np.mean([out[s][key] for s in steps]))
            for key in ("flops", "bytes")}
    for key, i in (("ms", 0), ("plain_ms", 1), ("library_ms", 2)):
        mean[key] = graph_ms([calls[s][i] for s in steps], reps=3)
    mean["by_lk"] = {lk: out["step_self_%d" % lk] for lk in S2S_CHECK_LK}
    for s in steps:
        del out[s]
    out["step_self"] = mean
    for name, rec in out.items():
        t_ops = rec["flops"] / FP32_3XTF32_FLOPS_PER_S * 1e3
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        rec.update(bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   vs_library=rec["ms"] / rec["library_ms"])
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        log("timing flash_attention_forward_kernel seq2seq %-17s float32: "
            "kernel %.4f ms (graph; eager %s), plain %.4f ms, bound %.4f ms "
            "(%s), sdpa %.4f ms (kernel/sdpa %.3f)%s"
            % (name, rec["ms"], "%.4f" % rec["eager_ms"] if "eager_ms" in
               rec else "-", rec["plain_ms"], rec["bound_ms"],
               rec["bound_by"], rec["library_ms"], rec["vs_library"],
               "" if "by_lk" not in rec else "; at Lk %s: kernel %s, "
               "sdpa %s" % (S2S_CHECK_LK, ["%.4f" % s["ms"] for s in
                                           rec["by_lk"].values()],
                            ["%.4f" % s["library_ms"] for s in
                             rec["by_lk"].values()])))
    del cases, calls
    torch.cuda.empty_cache()
    return out


# the kernels line's K3 rows of the seq2seq path: (row, timed case, the
# phase and its record key for the launches)
S2S_K3_ROWS = (
    ("encoder", "eval", "k3_encoder_launches"),
    ("decoder_self", "eval", "k3_decoder_self_launches"),
    ("cross", "eval", "k3_cross_launches"),
    ("translate_encoder", "translate", "k3_encoder_launches"),
    ("step_self", "translate", "k3_step_self_launches"),
    ("step_cross", "translate", "k3_step_cross_launches"))


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
    engine = pumped.pop("engine")
    runs["cost_24l"] = cost_run(engine, cfg["num_layers"])
    engine.release_device()
    del engine
    log("cost_24l (the main engine's cost_report):",
        json.dumps(runs["cost_24l"]))
    decode_profile = profile_decode(model, rng)
    log("decode step profile (paged fp32, 24 layers, 8 slots at ~1k "
        "context):", json.dumps(decode_profile))
    graph_s = decode_profile["graph_device_ms_per_step"] / 1e3
    cost = runs["cost_24l"]
    log(card)
    log("cost_24l achieved by the decode graph (%.3f ms a step): %.4g "
        "TFLOP/s of %.0f (fp32 CUDA cores), %.4g TB/s of %.2f (HBM)"
        % (graph_s * 1e3, cost["step_flops"] / graph_s / 1e12,
           FP32_FLOPS_PER_S / 1e12,
           cost["step_bytes_accessed"] / graph_s / 1e12,
           HBM_BYTES_PER_S / 1e12))
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
    runs["refresh_24l"] = refresh_weights_run(model, cfg)
    log("refresh_24l (weights replaced under captured graphs, 24 layers):",
        json.dumps(runs["refresh_24l"]))
    t0 = time.perf_counter()
    runs["disagg_24l"] = disagg_run(model, root, cfg["num_layers"])
    log("disagg_24l (prefill tier + decode tier against the fused engine, "
        "24 layers):", json.dumps(runs["disagg_24l"]))
    runs["fleet_24l"] = fleet_run(model, root, cfg["num_layers"])
    log("fleet_24l (1/2/4 engines, retire, chaos, HTTP; 24 layers):",
        json.dumps(runs["fleet_24l"]))
    log("tier and fleet phases (24 layers): %.1f s"
        % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    runs["mesh_24l"] = mesh_run(model, pumped, cfg["num_layers"])
    log(card)
    log("mesh_24l (the main traffic over meshes (1,2), (2,1), (2,2) on "
        "cuda:0, 24 layers):", json.dumps(runs["mesh_24l"]))
    log("mesh phase (24 layers): %.1f s" % (time.perf_counter() - t0))
    del model
    gc.collect()
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
    runs["disagg_int8_4l"] = disagg_run(model, root, SHORT_LAYERS, "int8")
    log("disagg_int8_4l (the disaggregated traffic on the int8 cache, 4 "
        "layers):", json.dumps(runs["disagg_int8_4l"]))
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
    t0 = time.perf_counter()
    runs["mesh_int8_4l"] = mesh_int8_run(model, rng)
    log("mesh_int8_4l (the (2,2) mesh: int8 seams, int8 KV, speculative, "
        "dense; 4 layers):", json.dumps(runs["mesh_int8_4l"]))
    log("mesh_int8_4l: %.1f s" % (time.perf_counter() - t0))
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    runs["lora_24l"] = lora_run(cfg, rng)
    log("lora_24l (serving_lora: 8 adapters of rank 16 over one bank "
        "against 8 dedicated engines, 24 layers):",
        json.dumps(runs["lora_24l"]))
    runs["lora_mixed_4l"] = lora_mixed_run(cfg, root)
    log("lora_mixed_4l (the mixed batch on K2, a sampled adapter row "
        "through the disk tier, speculative over the bank, a 2-engine "
        "fleet's retire; 4 layers):", json.dumps(runs["lora_mixed_4l"]))
    runs["ssm_24l"] = ssm_run(cfg, rng, root)
    log("ssm_24l (SSMLM at GPT-1.3B widths on the recurrent layout, 24 "
        "layers):", json.dumps(runs["ssm_24l"]))
    log("multi-LoRA and recurrent phases: %.1f s"
        % (time.perf_counter() - t0))

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
    t0 = time.perf_counter()
    train["ernie_cls"] = train_ernie_cls()
    log(card)
    log("train_ernie_cls (ERNIE-base sequence classification, O2 bf16, "
        "AdamW 1e-4, 32 x 384 ragged 128-384, key padding; MFU against "
        "%.0f TFLOP/s):" % (BF16_TC_FLOPS_PER_S / 1e12),
        json.dumps(train["ernie_cls"]))
    runs["sparse_embedding"] = sparse_embedding()
    log("sparse_embedding ([40000, 768] fp32, lazy Adam against dense, "
        "32 x 384 ids):", json.dumps(runs["sparse_embedding"]))
    t1 = time.perf_counter()
    train["lenet"] = train_lenet()
    log(card)
    log("train_lenet (config #1: LeNet fp32, Adam 1e-3, batches %s, "
        "captured and eager; MultiStepTrainStep %d x %d):"
        % (LENET_BATCHES, LENET_MULTI_K, LENET_MULTI_BATCH),
        json.dumps(train["lenet"]))
    train["resnet50"] = train_resnet50()
    log(card)
    log("train_resnet50 (config #2: ResNet50 O2 bf16, Momentum 0.1, 224 x "
        "224, legs %s; MFU against %.0f TFLOP/s):"
        % (RESNET_LEGS, BF16_TC_FLOPS_PER_S / 1e12),
        json.dumps(train["resnet50"]))
    log("vision phases: %.1f s" % (time.perf_counter() - t1))
    runs["nan_check"] = nan_check()
    log("nan_check (FLAGS_check_nan_inf: eager raise, captured ERNIE step "
        "at 2 layers):", json.dumps(runs["nan_check"]))
    runs["tensor_ops_cuda"] = tensor_ops_cuda()
    log("tensor_ops_cuda:", json.dumps(runs["tensor_ops_cuda"]))
    log("fine-tune, sparse, nan-check and tensor-op phases: %.1f s"
        % (time.perf_counter() - t0))
    t0 = time.perf_counter()
    s2s = {"train_transformer_base": train_transformer_base()}
    log(card)
    log("train_transformer_base (Transformer-base, 6 + 6 layers, 512 wide, "
        "vocab 33708, fp32, Adam + NoamDecay, label smoothing 0.1, %d x %d; "
        "MFU against %.0f TFLOP/s):" % (TF_BATCH, TF_PAD_LEN,
                                        FP32_FLOPS_PER_S / 1e12),
        json.dumps(s2s["train_transformer_base"]))
    s2s["eval_transformer_base"] = eval_transformer_base()
    s2s["translate_transformer_base"] = translate_transformer_base()
    log("translate_transformer_base (beam %d, %d sentences, at most %d "
        "steps):" % (TF_BEAM, TF_SENTENCES, TF_MAX_STEPS),
        json.dumps(s2s["translate_transformer_base"]))
    s2s["train_seq2seq_lstm"] = train_seq2seq_lstm()
    log(card)
    log("train_seq2seq_lstm (2 x 512 LSTM encoder, attention decoder, "
        "vocabs 17191 / 7709, fp32, Adam 1e-3 + clip 5, %d x %d; MFU "
        "against %.0f TFLOP/s):" % (LSTM_BATCH, LSTM_MAX_LEN,
                                    FP32_FLOPS_PER_S / 1e12),
        json.dumps(s2s["train_seq2seq_lstm"]))
    s2s["translate_seq2seq_lstm"] = translate_seq2seq_lstm()
    log("translate_seq2seq_lstm (beam %d, %d sentences, at most %d steps):"
        % (LSTM_BEAM, LSTM_SENTENCES, LSTM_MAX_STEPS),
        json.dumps(s2s["translate_seq2seq_lstm"]))
    log("sequence-model phases: %.1f s" % (time.perf_counter() - t0))

    timing = time_kernels()
    timing.update(time_flash())
    timing.update({(name, "ernie", mode): rec
                   for (name, mode), rec in time_flash_ernie().items()})
    timing.update({("s2s", case): rec
                   for case, rec in time_flash_seq2seq().items()})
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
    # the ERNIE fine-tune's K3 (bf16, B 32 x H 12 x L 384 x D 64), one row
    # for each way train_ernie_cls gives it the padding, each with the
    # launches made that way: lanes (the eager run and the captured run's
    # warm-up), bias (the captured run's replays)
    for name, direction in (("flash_attention_forward_kernel", "forward"),
                            ("flash_attention_backward_kernel",
                             "backward")):
        for mode in ("lanes", "bias"):
            t = timing[(name, "ernie", mode)]
            kernels.append({
                "name": "flash_attention_ernie_%s_%s" % (mode, direction),
                "route": "cuda",
                "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                "replaces": "paddle_tpu/ops/flash_attention.py:78",
                "launches": train["ernie_cls"]["k3_launches_by_mode"][mode][
                    name],
                "max_abs_err": parity[name + "_ernie_" + mode],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]})
    # the sequence models' K3 forward in its bias mode (fp32, 8 heads x
    # 64), one row a shape, each with the launches of the phase that ran
    # it: eval_transformer_base (128 x 64 x 64) and
    # translate_transformer_base (its encoder; each step's Lq 1 self- and
    # cross-attention)
    s2s_phase = {"eval": s2s["eval_transformer_base"],
                 "translate": s2s["translate_transformer_base"]}
    for case, phase, key in S2S_K3_ROWS:
        t = timing[("s2s", case)]
        kernels.append({
            "name": "flash_attention_s2s_%s_forward" % case,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/flash_attention.py:78",
            "launches": s2s_phase[phase][key],
            "max_abs_err": parity["flash_attention_s2s_" + case],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
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
    # the multi-LoRA paths, each timed and held at its phase's mean
    # context: K1 in lora_24l's decode steps, K2 in lora_mixed_4l's dense
    # pool, K1 at Lq 5 in its speculative verify
    for name, launches, ctx, lq in (
            ("paged_decode_attention_kernel",
             runs["lora_24l"]["k1_launches"], LORA_CTX, 1),
            ("decode_attention_kernel",
             runs["lora_mixed_4l"]["k2_launches"], LORA_MIXED_CTX, 1),
            ("paged_decode_attention_kernel",
             runs["lora_mixed_4l"]["k1_verify_launches"], LORA_MIXED_CTX,
             VERIFY_LQ)):
        label = name + ("_verify" if lq > 1 else "")
        t = timing[(name, "float32", MAIN_SLOTS, ctx)
                   + ((lq,) if lq > 1 else ())]
        kernels.append({
            "name": label + "_lora", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": ("paddle_tpu/ops/pallas_decode.py:243"
                         if name.startswith("paged")
                         else "paddle_tpu/ops/pallas_decode.py:320"),
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the mesh paths at the (2, 2) mesh's per-shard shape (4 rows x 8
    # heads): K1 fp32 in mesh_24l's (2, 2) run, K1 int8 and K2 in
    # mesh_int8_4l, K1 at Lq 5 in its speculative verify
    mesh_int8 = runs["mesh_int8_4l"]
    for label, name, kv, lq, launches in (
            ("paged_decode_attention_kernel_mesh",
             "paged_decode_attention_kernel", "float32", 1,
             runs["mesh_24l"]["2x2"]["launches"][
                 "paged_decode_attention_kernel"]),
            ("paged_decode_attention_kernel_mesh_int8",
             "paged_decode_attention_kernel", "int8", 1,
             mesh_int8["k1_launches_int8"]),
            ("decode_attention_kernel_mesh", "decode_attention_kernel",
             "float32", 1, mesh_int8["dense_float32"]["k2_launches"]),
            ("paged_decode_attention_kernel_verify_mesh",
             "paged_decode_attention_kernel", "float32", VERIFY_LQ,
             mesh_int8["spec"]["k1_verify_launches"])):
        t = timing[(name, kv, MAIN_SLOTS // 2, 1024)
                   + ((lq,) if lq > 1 else ()) + (("heads", 8),)]
        kernels.append({
            "name": label, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": ("paddle_tpu/ops/pallas_decode.py:243"
                         if name.startswith("paged")
                         else "paddle_tpu/ops/pallas_decode.py:320"),
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    t = timing["scale_mul_kernel"]["float32"]
    kernels.append({
        "name": "scale_mul_kernel", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/scale_mul.cu",
        "replaces": "tests/test_incubate.py:77",
        "launches": door["launches"],
        "max_abs_err": parity["scale_mul_kernel"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # every phase's record in full (the end of the output keeps only its
    # last lines)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": card, "runs": runs, "train": train,
                   "seq2seq": s2s,
                   "timing": {str(k): v for k, v in timing.items()},
                   "kernels": kernels}, f,
                  default=lambda o: o.item() if hasattr(o, "item")
                  else str(o))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

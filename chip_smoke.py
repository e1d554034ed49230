#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``paddle_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
the port's CUDA kernels from ``paddle_tpu_torch/csrc``, holds each kernel
against its plain PyTorch twin, serves the full-width GPT-1.3B
``TransformerLM`` (random weights from seed 0) through the ``ServingEngine``
on the paged cache, then a 4-layer model of the same widths on the dense
cache and on the int8 paged cache, checks that each run went through the
kernels and that its greedy tokens are the argmax of an uncached forward,
and times each kernel at the main path's shape beside its plain twin, its
bandwidth bound and ``scaled_dot_product_attention`` (timed as a yardstick
only; the port never calls it).

Every phase raises on failure; the exit code is 0 only when all passed.
The second-to-last lines are the card's name and power limit and a JSON
object describing every kernel; the last line is a JSON object naming the
device.  Without a CUDA card, or without the package beside this file, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet), used for the bound_ms column
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

MAIN_MAX_LEN = 2048
MAIN_SLOTS = 8
MAIN_BLOCK = 32
MAIN_REQUESTS = 16
MAIN_NEW_TOKENS = 64
SHORT_LAYERS = 4
SHORT_REQUESTS = 8
SHORT_NEW_TOKENS = 16
# kernel vs plain twin: fp32 (and int8, dequantized in fp32 by both) differ
# only by summation order; a bf16 output is rounded to bf16 by both
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# a greedy token's logit in the uncached fp32 forward must be within this
# of that position's max logit (fp32 cache: summation-order noise; int8
# cache: the quantization bound the repo's int8 logit test uses)
GREEDY_TOL = {"float32": 1e-3, "int8": 8e-2}


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


# -- kernel cases -----------------------------------------------------------


def _quant(x):
    from paddle_tpu_torch.ops.flash_attention import quantize_kv

    return quantize_kv(x)


def paged_case(gen, b, h, d, bs, mb, lq, q_dtype, kv_dtype, bias=False,
               ctx=None):
    """K1 inputs: a shuffled (stale-looking) table over a pool whose
    scratch block is poisoned, per-row q_pos (row 0 sees no key unless
    ``ctx`` fixes every row's context) and an optional broadcast bias."""
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


def check_kernels():
    """Each kernel against its plain twin on the card: fp32/bf16/int8 x
    Lq in {1, 4, 8} at small shapes (stale tables, poisoned scratch, an
    empty row, bias) and at the main path's shapes.  Returns the max error
    at the main path's shape per kernel."""
    import torch

    from paddle_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(0)
    combos = [(torch.float32, torch.float32), (torch.float32, torch.int8),
              (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
              (torch.float32, torch.float16)]
    shapes = [dict(b=3, h=2, d=16, bs=8, mb=4),
              dict(b=MAIN_SLOTS, h=16, d=128, bs=MAIN_BLOCK,
                   mb=MAIN_MAX_LEN // MAIN_BLOCK)]
    main_err = {}
    for shape in shapes:
        for q_dt, kv_dt in combos:
            for lq in (1, 4, 8):
                case = paged_case(gen, lq=lq, q_dtype=q_dt, kv_dtype=kv_dt,
                                  bias=lq == 4, **shape)
                dcase = dense_of(case)
                tol = TOL[str(q_dt).split(".")[1]]
                for name, kern, plain, args in (
                        ("paged_decode_attention_kernel",
                         dk.paged_decode_attention_kernel,
                         dk.paged_decode_attention_plain, case),
                        ("decode_attention_kernel", dk.decode_attention_kernel,
                         dk.decode_attention_plain, dcase)):
                    got = kern(**args)
                    torch.cuda.synchronize()
                    want = plain(**args)
                    err = (got.float() - want.float()).abs().max().item()
                    ok = err <= tol and bool(torch.isfinite(got).all())
                    log("parity %-30s q=%-8s kv=%-8s Lq=%d B=%d H=%d D=%d "
                        "bs=%d S=%d bias=%s  max_abs_err=%.3g tol=%.0e %s"
                        % (name, str(q_dt)[6:], str(kv_dt)[6:], lq,
                           shape["b"], shape["h"], shape["d"], shape["bs"],
                           shape["bs"] * shape["mb"], lq == 4, err, tol,
                           "ok" if ok else "FAIL"))
                    if not ok:
                        raise AssertionError("%s disagrees with its plain "
                                             "twin: %g > %g" % (name, err,
                                                                 tol))
                    if shape is shapes[1] and q_dt == kv_dt == torch.float32 \
                            and lq == 1:
                        main_err[name] = err
    return main_err


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


def serve(model, rng, n_requests, new_tokens, n_layers, kernel, **kw):
    """Serve ``n_requests`` greedy prompts of 128-1536 tokens through a
    fresh engine; returns the run's metrics.  The kernel launch counts are
    set to 0 just before the requests are driven and read just after."""
    import torch

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.ops import decode_kernels as dk

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", **kw)
    vocab = model.vocab_size
    # warm-up request: first cuBLAS calls and the kernel library load
    engine.submit(rng.randint(0, vocab, 64), 2).result()
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
    gaps = [greedy_gap(model, prompts[i], np.asarray(statuses[i].tokens))
            for i in (int(np.argmin(lens)), int(np.argmax(lens)))]
    tol = GREEDY_TOL[kw.get("cache_dtype", "float32")]
    assert max(gaps) <= tol, (gaps, tol)
    ttft = sorted(st.ttft_s * 1e3 for st in statuses)
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
    }


def profile_decode(model, rng, ticks: int = 10):
    """Where a steady decode step's time goes on the paged main path:
    8 busy slots at ~1k context; ``ticks`` pump ticks timed on the host
    clock, then ``ticks`` more under ``torch.profiler``, whose CUDA
    kernel times (one stream, so their sum is the busy time) give the
    device's share of the unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import ServingEngine

    engine = ServingEngine(model, max_len=MAIN_MAX_LEN, slots=MAIN_SLOTS,
                           device="cuda", cache_layout="paged",
                           block_size=MAIN_BLOCK)
    for _ in range(MAIN_SLOTS):
        engine.submit(rng.randint(0, model.vocab_size, 1024), 2 * ticks + 8)
    engine.pump(3)  # every slot prefilled and decoding
    assert engine.pool.active_count == MAIN_SLOTS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.pump(ticks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.pump(ticks)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / ticks
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host ops: their device time is their kernels' time
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / ticks / 1e3, ev.key, ev.count // ticks))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    while engine.pump(1):
        pass
    out = {"ticks": ticks, "wall_ms_per_step": wall_ms,
           "profiled_wall_ms_per_step": profiled_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "top": [{"kernel": k[:80], "ms_per_step": ms, "calls_per_step": n}
                   for ms, k, n in rows[:8]]}
    if not busy_ms:
        log("profile: the profiler recorded no device time (not measured)")
    return out


# -- timing -------------------------------------------------------------------


def time_kernels(ctx: int = 1024):
    """Each kernel at the main path's shape (8 slots x 16 heads x 128,
    block 32, 2048-position cache, one query) with every row at ``ctx``
    positions, beside its plain twin, SDPA on the gathered K/V and the
    bandwidth bound."""
    import torch
    import torch.nn.functional as tF

    from paddle_tpu_torch.ops import decode_kernels as dk

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for kv_dt in (torch.float32, torch.int8):
        case = paged_case(gen, MAIN_SLOTS, 16, 128, MAIN_BLOCK,
                          MAIN_MAX_LEN // MAIN_BLOCK, 1, torch.float32, kv_dt,
                          ctx=ctx)
        dcase = dense_of(case)
        b, h, lq, d = case["q"].shape
        item = case["k_pool"].element_size()
        kv_bytes = 2 * b * h * ctx * (d * item + (4 if kv_dt == torch.int8
                                                  else 0))
        io_bytes = 2 * case["q"].numel() * 4 + case["q_pos"].numel() * 4
        flops = 4 * b * h * lq * ctx * d
        # the SDPA yardstick: fp32 gathered K/V with the same visibility
        k_f = dk._dequant(dcase["k"], dcase["k_scale"])
        v_f = dk._dequant(dcase["v"], dcase["v_scale"])
        pos = torch.arange(k_f.shape[2], device="cuda")
        mask = (pos[None, None, None, :]
                <= dcase["q_pos"].long()[:, None, :, None])
        lib_ms = cuda_ms(lambda: tF.scaled_dot_product_attention(
            case["q"], k_f, v_f, attn_mask=mask))
        for name, kern, plain, args, extra in (
                ("paged_decode_attention_kernel",
                 dk.paged_decode_attention_kernel,
                 dk.paged_decode_attention_plain, case,
                 b * -(-ctx // MAIN_BLOCK) * 4),  # the table entries read
                ("decode_attention_kernel", dk.decode_attention_kernel,
                 dk.decode_attention_plain, dcase, 0)):
            nbytes = kv_bytes + io_bytes + extra
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_FLOPS_PER_S * 1e3
            # plain, kernel, kernel, plain: compare within one call
            p1 = cuda_ms(lambda: plain(**args), iters=20)
            k1 = cuda_ms(lambda: kern(**args))
            k2 = cuda_ms(lambda: kern(**args))
            p2 = cuda_ms(lambda: plain(**args), iters=20)
            rec = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms, "bytes": nbytes, "flops": flops,
                   "kv_dtype": str(kv_dt)[6:], "ctx": ctx}
            rec["achieved_gb_s"] = nbytes / rec["ms"] / 1e6
            out[(name, str(kv_dt)[6:])] = rec
            log("timing %-30s kv=%-7s B=%d H=%d D=%d ctx=%d: kernel %.4f ms "
                "(%.0f GB/s), plain %.4f ms, bound %.4f ms (%s), sdpa %.4f ms"
                % (name, str(kv_dt)[6:], b, h, d, ctx, rec["ms"],
                   rec["achieved_gb_s"], rec["plain_ms"], rec["bound_ms"],
                   rec["bound_by"], lib_ms))
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
    log("build: %.1f s" % (time.perf_counter() - t0))

    parity = check_kernels()

    cfg = gpt_1p3b_config()
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    model = TransformerLM(**cfg, dropout=0.0, device="cuda", seed=0)
    log("model: GPT-1.3B widths, %d layers, %.2f B params, built in %.1f s"
        % (cfg["num_layers"], sum(p.numel() for p in model.parameters())
           / 1e9, time.perf_counter() - t0))
    runs = {}
    runs["paged_fp32_24l"] = serve(
        model, rng, MAIN_REQUESTS, MAIN_NEW_TOKENS, cfg["num_layers"],
        "paged_decode_attention_kernel", cache_layout="paged",
        block_size=MAIN_BLOCK)
    log("main path (paged fp32, 24 layers):", json.dumps(runs["paged_fp32_24l"]))
    log("decode step profile (paged fp32, 24 layers, 8 slots at ~1k "
        "context):", json.dumps(profile_decode(model, rng)))
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
    del model
    torch.cuda.empty_cache()

    timing = time_kernels()
    kernels = []
    for name, tpu, run in (
            ("paged_decode_attention_kernel",
             "paddle_tpu/ops/pallas_decode.py:243", "paged_fp32_24l"),
            ("decode_attention_kernel",
             "paddle_tpu/ops/pallas_decode.py:320", "dense_fp32_4l")):
        t = timing[(name, "float32")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/decode_attention.cu",
            "replaces": tpu,
            "launches": runs[run]["launches"][name],
            "max_abs_err": parity[name], "ms": t["ms"],
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

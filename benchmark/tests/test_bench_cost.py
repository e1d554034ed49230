"""The frozen cost arithmetic reproduces the figures PERF.md was built
on."""
import pytest

import cost
from harness import manifest
from reference import leaf_specs

GPT = manifest.cell(manifest.load_manifest(), "gpt3-1.3b.serve-chat")["cfg"]


def _gpt_params():
    n = 0
    for _, shape, _, _ in leaf_specs(GPT):
        k = 1
        for d in shape:
            k *= d
        n += k
    return n


def test_k3_bf16_causal_bound():
    pairs = 2 * cost.causal_pairs(2048)
    fwd, bwd = cost.k3_bound_s(pairs, 2, 16, 2048, 128, "bfloat16",
                               cost.BF16_FLOPS)
    assert round(fwd * 1e3, 4) == 0.0348
    assert round(bwd * 1e3, 4) == 0.0869


def test_k1_fp32_bound():
    # 8 rows x 16 heads x 1024 positions x D 128: K and V read once
    one_layer = dict(GPT, num_layers=1)
    nbytes = cost.k1_step_bytes(one_layer, [1024] * 8) \
        - 8 * 2 * 2048 * 4  # the rows' query and output, not in PERF.md's
    assert round(nbytes / cost.HBM_BYTES_PER_S * 1e3, 4) == 0.0401


def test_gpt_optimizer_floor():
    n = _gpt_params()
    assert abs(n - 1.3159e9) < 1e6
    floor = cost.adamw_floor_bytes([(n, "bfloat16")]) / cost.HBM_BYTES_PER_S
    assert round(floor * 1e3, 2) == 11.00
    # a norm's fp32 parameter costs the same 28 bytes
    assert cost.adamw_floor_bytes([(1, "float32")]) == 28
    assert cost.clip_floor_bytes([(10, "bfloat16")]) == 20


def test_gpt_mfu_of_the_bring_up_step():
    # 2 x 2048 tokens a step in 209.47 ms (O2 bf16, captured)
    rate = 2 * 2048 / 0.20947
    mfu = rate * cost.train_flops_per_token(GPT, 2048) / cost.BF16_FLOPS
    assert round(mfu, 3) == 0.179


def test_forward_flops_counts_the_head_only_where_asked():
    body = cost.forward_flops(GPT, 1, 0, 0)
    head = cost.forward_flops(GPT, 1, 0, 1) - body
    assert head == pytest.approx(2 * GPT["vocab_size"] * GPT["hidden_size"])
    assert cost.forward_flops(GPT, 0, 10, 0) == pytest.approx(
        4 * 24 * 2048 * 10)

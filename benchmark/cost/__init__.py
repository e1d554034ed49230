"""The benchmark's frozen cost arithmetic: FLOPs a token, the operations
and bytes of the attention kernels K3 (flash attention, training) and K1
(paged decode attention, serving), the byte floor of the O2 AdamW update
with its global-norm clip, and the H100 SXM peaks they are divided by.

Everything here is computed from shapes alone, never from which kernel
ran, so a roofline share reads the same work whatever implements it.
Nothing here imports the program.
"""
from __future__ import annotations

from typing import Iterable, Sequence

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# fp32 at fp32 accuracy on the tensor cores: three TF32 products (3xTF32)
FP32_3XTF32_FLOPS = TF32_FLOPS / 3
# fp32 outside the tensor cores
FP32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once per token: each
    layer's q/k/v/out projections and the two FFN matrices, plus the
    tied LM head when the model has one (a classifier's pooler and head
    act on one position a row and are left out)."""
    h, ff = cfg["hidden_size"], cfg["intermediate_size"]
    per_layer = 4 * h * h + 2 * h * ff
    head = cfg["vocab_size"] * h if cfg.get("head") == "lm" else 0
    return cfg["num_layers"] * per_layer + head


def train_flops_per_token(cfg: dict, ctx: int) -> float:
    """Forward and backward FLOPs of one token (PaLM, appendix B):
    6 x matmul parameters + 12 x layers x hidden x ``ctx``, the keys the
    token's row attends over.  Recomputation is not counted."""
    return 6.0 * matmul_params(cfg) \
        + 12.0 * cfg["num_layers"] * cfg["hidden_size"] * ctx


def forward_flops(cfg: dict, positions: int, keys: int,
                  head_positions: int) -> float:
    """Forward FLOPs of ``positions`` positions that attend over ``keys``
    keys in all (summed over the positions), ``head_positions`` of which
    need the LM head's logits (a decoded token, a prompt's last
    position): 2 x the body's matmul parameters a position, 4 x layers x
    hidden a key (QK^T and PV), 2 x vocab x hidden a head position."""
    body = dict(cfg, head=None)
    h = cfg["hidden_size"]
    return (2.0 * matmul_params(body) * positions
            + 4.0 * cfg["num_layers"] * h * keys
            + 2.0 * cfg["vocab_size"] * h * head_positions)


def roofline_s(flops: float, nbytes: float, peak_flops: float,
               bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The least time the work can take: operations over the peak or
    bytes over the bandwidth, whichever is larger."""
    return max(flops / peak_flops, nbytes / bytes_per_s)


# -- K3: flash attention, forward and backward ------------------------------

def causal_pairs(length: int) -> int:
    """Query-key pairs of one causal [L, L] attention: L (L + 1) / 2."""
    return length * (length + 1) // 2


def padded_pairs(lengths: Iterable[int]) -> int:
    """Query-key pairs of bidirectional attention over rows padded to a
    common length: each row's real queries against its real keys."""
    return sum(int(n) * int(n) for n in lengths)


def k3_flops(pairs: int, heads: int, head_dim: int) -> tuple:
    """(forward, backward) FLOPs over ``pairs`` query-key pairs a head:
    the forward's QK^T and PV, 4 D a pair; the backward's five products
    (recomputed S, dP, dV, dQ, dK), 2.5 x the forward."""
    fwd = 4.0 * pairs * heads * head_dim
    return fwd, 2.5 * fwd


def k3_bytes(rows: int, heads: int, length: int, head_dim: int,
             dtype: str, bias_bytes: int = 0) -> tuple:
    """(forward, backward) bytes, each tensor read or written once: the
    forward reads Q, K, V (and an additive bias) and writes O and the
    fp32 log-sum-exp; the backward reads Q, K, V, O, dO, the log-sum-exp
    (and the bias) and writes dQ, dK, dV."""
    t = rows * heads * length * head_dim * DTYPE_BYTES[dtype]
    lse = rows * heads * length * 4
    return 4 * t + lse + bias_bytes, 8 * t + lse + bias_bytes


def k3_bound_s(pairs: int, rows: int, heads: int, length: int,
               head_dim: int, dtype: str, peak_flops: float,
               bias_bytes: int = 0) -> tuple:
    """(forward, backward) roofline seconds of one K3 call."""
    f_fwd, f_bwd = k3_flops(pairs, heads, head_dim)
    b_fwd, b_bwd = k3_bytes(rows, heads, length, head_dim, dtype, bias_bytes)
    return (roofline_s(f_fwd, b_fwd, peak_flops),
            roofline_s(f_bwd, b_bwd, peak_flops))


# -- K1: paged decode attention ---------------------------------------------

def k1_step_bytes(cfg: dict, row_keys: Sequence[int], shared_keys: int = 0,
                  dtype: str = "float32") -> float:
    """Bytes one decode step's attention needs over every layer: each
    distinct K/V position read once (``row_keys``: each row's keys not
    shared with another row; ``shared_keys``: keys of prefix blocks that
    rows share, counted once), each row's query read and output written."""
    h, layers = cfg["hidden_size"], cfg["num_layers"]
    e = DTYPE_BYTES[dtype]
    kv = 2 * h * e * (sum(row_keys) + shared_keys)
    qo = 2 * h * e * len(row_keys)
    return float(layers * (kv + qo))


def k1_step_flops(cfg: dict, row_keys_total: int) -> float:
    """FLOPs of one decode step's attention: 4 x hidden a (row, key)
    pair a layer."""
    return 4.0 * cfg["num_layers"] * cfg["hidden_size"] * row_keys_total


# -- the update: O2 AdamW and the global-norm clip --------------------------

def adamw_floor_bytes(params: Sequence[tuple]) -> float:
    """Bytes of one fused AdamW step over ``params`` [(numel, dtype of
    the parameter)]: a 16-bit parameter reads its gradient (2), reads and
    writes its fp32 master (8) and both fp32 moments (16) and writes
    itself (2); an fp32 parameter (a norm's, no master) reads its fp32
    gradient (4) and reads and writes itself (8) and the moments (16).
    Both come to 28 bytes a parameter."""
    total = 0.0
    for n, dtype in params:
        e = DTYPE_BYTES[dtype]
        if e == 4:
            total += n * (4 + 8 + 16)
        else:
            total += n * (e + 8 + 16 + e)
    return total


def clip_floor_bytes(params: Sequence[tuple]) -> float:
    """Bytes the global-norm clip adds to a fused update: one read of
    every gradient for the norm (the scaling fuses into the update)."""
    return float(sum(n * DTYPE_BYTES[dtype] for n, dtype in params))


def update_floor_s(params: Sequence[tuple]) -> float:
    """The clipped AdamW update's byte floor in seconds."""
    return (adamw_floor_bytes(params) + clip_floor_bytes(params)) \
        / HBM_BYTES_PER_S

"""Shared helpers of the ``test_torch_*`` files: one tiny reference
``TransformerLM`` built at a seed, and the port's model carrying its
parameters (``convert.load_reference_params``), both on the CPU.

Inputs are made with numpy and handed to both packages; arrays cross
between them as numpy."""
import numpy as np
import torch

import paddle_tpu as pt
from paddle_tpu.models import TransformerLM as RefLM

from paddle_tpu_torch import TransformerLM, load_reference_params

# the tiny configuration of __graft_entry__._tiny_lm
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=128, dropout=0.0, causal=True)

# greedy agreement is only promised where the reference's top-2 logit
# margin clears this floor at every step (tests/test_quant_cache.py)
MARGIN_FLOOR = 5e-3


def reference_arrays(ref) -> dict:
    return {n: np.asarray(p.value) for n, p in ref.named_parameters()}


def build_pair(seed: int = 0, **over):
    """(reference model, port model with the reference's weights)."""
    cfg = dict(TINY, **over)
    pt.seed(seed)
    ref = RefLM(**cfg)
    ref.eval()
    port = TransformerLM(**cfg, device="cpu")
    load_reference_params(port, reference_arrays(ref))
    port.eval()
    return ref, port


def ref_logits(ref, ids) -> np.ndarray:
    return np.asarray(ref(pt.to_tensor(np.asarray(ids, np.int32))).value)


def port_logits(port, ids) -> np.ndarray:
    with torch.no_grad():
        return port(torch.from_numpy(np.asarray(ids, np.int64))).numpy()


def greedy_margin(ref, prompt, tokens) -> float:
    """Smallest top-2 logit margin over the positions that emitted
    ``tokens`` after ``prompt`` (1-D), from one uncached reference
    forward (causality makes its logits the ones each step saw)."""
    seq = np.concatenate([np.asarray(prompt), np.asarray(tokens)])[None]
    steps = ref_logits(ref, seq)[0, len(prompt) - 1:-1]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())

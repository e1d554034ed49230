"""A pre-LN transformer language model with a tied head (GPT-3 1.3B) in
plain PyTorch.

Parameters are a dict of float32 tensors named and laid out as
:func:`leaf_specs` says (a ``Linear``'s weight is [in, out]).  A layer
is ``h += attn(LN1(h)); h += W2 gelu(W1 LN2(h))``, the encoder ends in a
final LayerNorm, attention is softmax(Q K^T / sqrt(D) + mask) V with an
additive causal mask, GELU is the exact (erf) one.  Dropout is 0.  It
runs in float32 with TF32 off; the serving control is this same code
with TF32 on (:func:`set_precision`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def set_precision(mode: str) -> None:
    """``"fp32"``: float32 products with TF32 off (the reference);
    ``"tf32"``: the same with TF32 on (the serving control)."""
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def leaf_specs(cfg: dict) -> List[tuple]:
    """[(name, shape, init, group)]: ``init`` is "normal" (std
    ``init_std``), "ones" or "zeros"; ``group`` names the block of leaves
    made together (the embeddings, each layer, the final norm and head)."""
    h, ff = cfg["hidden_size"], cfg["intermediate_size"]
    out = [("word_embeddings.weight", (cfg["vocab_size"], h), "normal",
            "embed"),
           ("position_embeddings.weight", (cfg["max_position"], h),
            "normal", "embed")]
    for i in range(cfg["num_layers"]):
        lp, g = "encoder.layers.%d." % i, "layer%d" % i
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(lp + "self_attn.%s.weight" % proj, (h, h), "normal", g),
                    (lp + "self_attn.%s.bias" % proj, (h,), "zeros", g)]
        out += [(lp + "linear1.weight", (h, ff), "normal", g),
                (lp + "linear1.bias", (ff,), "zeros", g),
                (lp + "linear2.weight", (ff, h), "normal", g),
                (lp + "linear2.bias", (h,), "zeros", g)]
        for norm in ("norm1", "norm2"):
            out += [(lp + norm + ".weight", (h,), "ones", g),
                    (lp + norm + ".bias", (h,), "zeros", g)]
    out += [("final_norm.weight", (h,), "ones", "final"),
            ("final_norm.bias", (h,), "zeros", "final")]
    return out


def _linear(x, P, name):
    return x @ P[name + ".weight"] + P[name + ".bias"]


def _norm(x, P, name, eps):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"],
                        P[name + ".bias"], eps)


def encode(P: Params, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """Final hidden states [B, L, H] of ``ids`` [B, L], under the causal
    mask where the model is causal."""
    eps = cfg["layer_norm_eps"]
    b, length = ids.shape
    heads = cfg["num_heads"]
    d = cfg["hidden_size"] // heads
    h = P["word_embeddings.weight"][ids] \
        + P["position_embeddings.weight"][:length]
    mask = None
    if cfg.get("causal"):
        pos = torch.arange(length, device=ids.device)
        mask = torch.where(pos[None, :] <= pos[:, None], 0.0,
                           torch.finfo(torch.float32).min)
    for i in range(cfg["num_layers"]):
        lp = "encoder.layers.%d." % i
        x = _norm(h, P, lp + "norm1", eps)
        q, k, v = (_linear(x, P, lp + "self_attn." + n)
                   .reshape(b, length, heads, d).transpose(1, 2)
                   for n in ("q_proj", "k_proj", "v_proj"))
        s = q @ k.transpose(-1, -2) / math.sqrt(d)
        if mask is not None:
            s = s + mask
        o = torch.softmax(s, dim=-1) @ v
        o = o.transpose(1, 2).reshape(b, length, heads * d)
        h = h + _linear(o, P, lp + "self_attn.out_proj")
        x = _norm(h, P, lp + "norm2", eps)
        h = h + _linear(F.gelu(_linear(x, P, lp + "linear1")), P,
                        lp + "linear2")
    return _norm(h, P, "final_norm", eps)


def lm_logits(P: Params, cfg: dict, ids: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits [B, L or len(positions), vocab] through the tied head."""
    h = encode(P, cfg, ids)
    if positions is not None:
        h = h[:, positions]
    return h @ P["word_embeddings.weight"].t()


@torch.no_grad()
def served_gaps(P: Params, cfg: dict, prompt: torch.Tensor,
                tokens: torch.Tensor, control: bool = False) -> torch.Tensor:
    """At each served position, how far the served token's logit lies
    below the reference's best: the logits of one forward over the prompt
    and the served tokens but the last.  With ``control`` the token judged
    is the one the reference computed with TF32 puts first (the lower
    precision's choice), still judged by the float32 logits."""
    ids = torch.cat([prompt, tokens[:-1]])[None]
    pos = torch.arange(len(prompt) - 1, ids.shape[1], device=ids.device)
    set_precision("fp32")
    logits = lm_logits(P, cfg, ids, positions=pos)[0]
    if control:
        set_precision("tf32")
        tokens = lm_logits(P, cfg, ids, positions=pos)[0].argmax(-1)
        set_precision("fp32")
    chosen = logits.gather(1, tokens[:, None].long())[:, 0]
    return logits.max(dim=1).values - chosen

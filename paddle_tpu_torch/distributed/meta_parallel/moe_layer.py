"""Expert parallelism (counterpart of the reference's
``meta_parallel/moe_layer.py``): GShard top-k gating and a mixture of
expert MLPs over an ``ep`` group.

The routing is the reference's dense algebra: a capacity-bounded
dispatch tensor [B, S, E, C] built from a cumulative sum over the token
axis (no data-dependent shape, so a step captures), the tokens gathered
into per-expert buffers by one einsum and combined back by another.
The expert weights are one stacked tensor [E, ...] whose ep ranks each
own ``E/ep`` experts; the ranks run in rank order on views of their
experts' slices, and their outputs meet again in the combine (the
reference's two all-to-alls).  The batch rows are the dp axis: gating is
per row, so a dp split changes nothing.

Gating picks by ``argmax``; where two router probabilities tie the pick
may differ from JAX's, so cross-package checks hold the picks only where
the margin clears a floor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.errors import InvalidArgumentError
from ...nn import initializer as I
from ...nn.layer.layers import Layer, create_parameter
from ..collective import Group

__all__ = ["MoELayer", "top2_gating"]


def top2_gating(logits, capacity: int, top_k: int = 2):
    """GShard top-k dispatch and combine from router logits [B, S, E]:
    (dispatch [B, S, E, C], combine [B, S, E, C], aux_loss scalar).  Each
    expert takes at most ``capacity`` tokens a row, in token order; a
    token past it is dropped for that pick (its slot gets 0)."""
    probs = torch.softmax(logits, dim=-1)
    b, s, e = probs.shape
    dispatch = combine = top1_frac = None
    remaining = probs
    fills = torch.zeros(b, e, dtype=probs.dtype, device=probs.device)
    for k in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = torch.nn.functional.one_hot(idx, e).to(probs.dtype)
        if k == 0:
            top1_frac = onehot.mean(dim=1)
        gate = (remaining * onehot).sum(-1)
        pos = torch.cumsum(onehot, dim=1) - onehot + fills[:, None, :]
        pos_tok = (pos * onehot).sum(-1)
        keep = pos_tok < capacity
        gate = torch.where(keep, gate, torch.zeros_like(gate))
        pos_cap = torch.nn.functional.one_hot(
            pos_tok.long().clamp(0, capacity), capacity + 1)[..., :capacity] \
            .to(probs.dtype)
        d_k = onehot[..., None] * pos_cap[:, :, None, :] \
            * keep[..., None, None].to(probs.dtype)
        c_k = d_k * gate[..., None, None]
        dispatch = d_k if dispatch is None else dispatch + d_k
        combine = c_k if combine is None else combine + c_k
        fills = fills + (onehot * keep[..., None].to(probs.dtype)).sum(1)
        remaining = remaining * (1.0 - onehot)
    me = probs.mean(dim=1)
    aux = (me * top1_frac).sum(-1).mean() * e
    return dispatch, combine, aux


class MoELayer(Layer):
    """Router + E expert MLPs (``gate_weight`` [M, E], ``w1`` [E, M, H],
    ``b1`` [E, H], ``w2`` [E, H, M], ``b2`` [E, M]: the reference's names
    and shapes).  With ``ep_group`` (or a fleet topology with
    ``ep_degree > 1``) rank r runs experts ``[r E/ep, (r+1) E/ep)``;
    without one, one rank runs them all (the same math).  ``aux_loss``
    is the last forward's load-balance loss (differentiable)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu", renormalize: bool = True,
                 ep_group: Optional[Group] = None, name=None, device=None):
        super().__init__()
        if num_experts < 1:
            raise InvalidArgumentError("num_experts must be >= 1")
        if top_k < 1:
            raise InvalidArgumentError("top_k must be >= 1")
        if top_k > num_experts:
            raise InvalidArgumentError(
                "top_k %d > num_experts %d" % (top_k, num_experts))
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.renormalize = renormalize
        group = ep_group or self._fleet_ep_group()
        self.ep_group = group
        self.ep_degree = group.nranks if group is not None else 1
        if num_experts % self.ep_degree:
            raise InvalidArgumentError(
                "num_experts %d not divisible by ep degree %d"
                % (num_experts, self.ep_degree))
        if device is None and group is not None:
            device = group.device
        e = num_experts
        kw = dict(device=device)
        self.gate_weight = create_parameter(
            [d_model, e], default_initializer=I.XavierUniform(), **kw)
        self.w1 = create_parameter([e, d_model, d_hidden],
                                   default_initializer=I.XavierUniform(),
                                   **kw)
        self.b1 = create_parameter([e, d_hidden], is_bias=True, **kw)
        self.w2 = create_parameter([e, d_hidden, d_model],
                                   default_initializer=I.XavierUniform(),
                                   **kw)
        self.b2 = create_parameter([e, d_model], is_bias=True, **kw)
        if group is not None:
            for p in (self.w1, self.b1, self.w2, self.b2):
                p.is_distributed = True
        self._aux = None

    @staticmethod
    def _fleet_ep_group() -> Optional[Group]:
        from ..fleet import fleet

        if fleet.is_initialized:
            hcg = fleet.get_hybrid_communicate_group()
            if hcg.get_expert_parallel_world_size() > 1:
                return hcg.get_expert_parallel_group()
        return None

    def capacity(self, seq_len: int) -> int:
        return max(1, int(math.ceil(
            self.top_k * seq_len * self.capacity_factor / self.num_experts)))

    def forward(self, x):
        if x.ndim != 3:
            raise InvalidArgumentError(
                "MoELayer expects [batch, seq, d_model], got %s"
                % (tuple(x.shape),))
        cap = self.capacity(int(x.shape[1]))
        # route in float32: a small product, and the picks are
        # precision-sensitive
        logits = torch.matmul(x.float(), self.gate_weight.float())
        dispatch, combine, aux = top2_gating(logits, cap, self.top_k)
        if self.renormalize:
            denom = combine.sum(dim=(2, 3), keepdim=True)
            combine = combine / denom.clamp_min(1e-9)
        dispatch = dispatch.to(x.dtype)
        combine = combine.to(x.dtype)
        xs = torch.einsum("bsec,bsm->ebcm", dispatch, x)
        if self.activation == "gelu":  # jax.nn.gelu: the tanh form
            def act(t):
                return torch.nn.functional.gelu(t, approximate="tanh")
        else:
            act = torch.relu
        per = self.num_experts // self.ep_degree
        ys = []
        for r in range(self.ep_degree):  # each ep rank's own experts
            e = slice(r * per, (r + 1) * per)
            h = act(torch.einsum("ebcm,emh->ebch", xs[e], self.w1[e])
                    + self.b1[e][:, None, None, :])
            ys.append(torch.einsum("ebch,ehm->ebcm", h, self.w2[e])
                      + self.b2[e][:, None, None, :])
        out = torch.einsum("bsec,ebcm->bsm", combine, torch.cat(ys))
        self._aux = aux.float()
        return out

    @property
    def aux_loss(self):
        """The last forward's load-balance loss (0 before any)."""
        if self._aux is None:
            return torch.zeros((), device=self.gate_weight.device)
        return self._aux

    def extra_repr(self):
        return ("d_model=%d, d_hidden=%d, num_experts=%d, top_k=%d, ep=%d"
                % (self.d_model, self.d_hidden, self.num_experts, self.top_k,
                   self.ep_degree))

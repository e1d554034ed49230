"""Tensor-parallel layers (counterpart of the reference's
``meta_parallel/mp_layers.py``): ``VocabParallelEmbedding``,
``ColumnParallelLinear``, ``RowParallelLinear`` and
``ParallelCrossEntropy``.

As in the reference, a layer keeps its FULL logical parameters (the
reference's names and shapes, so ``state_dict`` and
``convert.load_reference_params`` see the unsharded layer) and its ranks
each own a slice.  The reference places the slices with ``NamedSharding``
and lets the partitioner write the collectives; here the mp ranks run in
rank order on one device, each reading its slice as a VIEW of the one
parameter (so every gradient lands in it), and the collective is written
out: a column-parallel output is the ranks' columns side by side, a
row-parallel one the float32 rank-order sum of the ranks' partial
products (:func:`~..collective.rank_sum`), the bias added once after.

:func:`shard_linear` marks an existing ``nn.Linear`` column- or
row-parallel over ``mp`` ranks; a ``MultiHeadAttention`` whose q/k/v are
column-parallel and whose ``out_proj`` is row-parallel runs each rank's
``H/mp`` heads through its own attention call, and a
``TransformerEncoderLayer`` whose ``linear1``/``linear2`` are marked runs
each rank's MLP columns (the Megatron placement that
``spmd_pipeline.megatron_param_spec`` names).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.errors import InvalidArgumentError
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer.layers import Layer, create_parameter
from ..collective import Group, rank_sum

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "shard_linear",
           "column_linear", "row_linear"]


def _mp_group(mp_group: Optional[Group]) -> Group:
    if mp_group is not None:
        return mp_group
    from ..fleet import fleet

    if fleet.is_initialized:
        return fleet.get_hybrid_communicate_group().get_model_parallel_group()
    raise InvalidArgumentError(
        "mp layers need a model-parallel group: pass mp_group= or call "
        "fleet.init(strategy) with hybrid_configs mp_degree>1 first")


def _bounds(n: int, mp: int, what: str):
    if n % mp:
        raise InvalidArgumentError(
            "%s %d not divisible by mp degree %d" % (what, n, mp))
    k = n // mp
    return [slice(m * k, (m + 1) * k) for m in range(mp)]


def column_linear(x, weight, bias, mp: int, gather: bool = True):
    """Each rank's columns ``x @ W[:, s_m] + b[s_m]`` (views of the one
    weight); ``gather``: side by side (the global view), else the list."""
    parts = [F.linear(x, weight[:, s], None if bias is None else bias[s])
             for s in _bounds(weight.shape[1], mp, "out_features")]
    return torch.cat(parts, dim=-1) if gather else parts


def row_linear(x, weight, bias, mp: int):
    """The rank-order float32 sum of the ranks' partial products
    ``x[..., s_m] @ W[s_m]`` (``x`` the global view or the list of the
    ranks' inputs), then the bias once."""
    rows = _bounds(weight.shape[0], mp, "in_features")
    xs = x if isinstance(x, (list, tuple)) else [x[..., s] for s in rows]
    out = rank_sum([torch.matmul(xm, weight[s]) for xm, s in zip(xs, rows)])
    return out if bias is None else out + bias


def shard_linear(linear, kind: str, mp: int):
    """Mark ``linear`` (an ``nn.Linear``) column- or row-parallel over
    ``mp`` ranks (``mp == 1`` clears the mark).  Its parameters stay
    whole; its forward runs per rank on views of them."""
    if kind not in ("column", "row"):
        raise InvalidArgumentError(
            "shard_linear kind must be 'column' or 'row', got %r" % (kind,))
    n = linear.weight.shape[1 if kind == "column" else 0]
    _bounds(int(n), mp, "out_features" if kind == "column"
            else "in_features")
    if mp <= 1:
        linear.__dict__.pop("_tp", None)
    else:
        linear.__dict__["_tp"] = (kind, int(mp))
    return linear


def _dist(param):
    if param is not None:
        param.is_distributed = True
    return param


class VocabParallelEmbedding(Layer):
    """The table [num_embeddings, embedding_dim], rank m owning rows
    ``[m*V/mp, (m+1)*V/mp)``: each rank looks up the ids in its rows
    (others give zeros) and the lookups are summed in rank order."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group: Optional[Group] = None,
                 name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        self._rows = _bounds(num_embeddings, self.group.nranks,
                             "vocab size")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = _dist(create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=I.XavierNormal(), device=self.group.device))

    def forward(self, x):
        ids = x.long()
        parts = []
        for s in self._rows:
            local = ids - s.start
            inside = (local >= 0) & (local < s.stop - s.start)
            rows = self.weight[s][local.clamp(0, s.stop - s.start - 1)]
            parts.append(rows * inside.unsqueeze(-1).to(rows.dtype))
        return rank_sum(parts)

    def extra_repr(self):
        return "%d, %d, mp=%d" % (self._num_embeddings, self._embedding_dim,
                                  self.group.nranks)


class ColumnParallelLinear(Layer):
    """Weight [in, out] split on the OUT dim over the mp ranks.
    ``gather_output=True`` returns the global [..., out]; False returns
    the list of the ranks' [..., out/mp] slices, the input a following
    ``RowParallelLinear(input_is_parallel=True)`` takes (the Megatron
    pair: no communication at the boundary)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: Optional[bool] = None,
                 gather_output: bool = True, fuse_matmul_bias: bool = False,
                 mp_group: Optional[Group] = None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        _bounds(out_features, self.group.nranks, "out_features")
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        dev = self.group.device
        self.weight = _dist(create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=I.XavierNormal(), device=dev))
        self.bias = _dist(create_parameter([out_features], None,
                                           is_bias=True, device=dev)
                          if has_bias is not False else None)

    def forward(self, x):
        return column_linear(x, self.weight, self.bias, self.group.nranks,
                             gather=self.gather_output)

    def extra_repr(self):
        return "in=%d, out=%d, gather_output=%s, mp=%d" % (
            self.in_features, self.out_features, self.gather_output,
            self.group.nranks)


class RowParallelLinear(Layer):
    """Weight [in, out] split on the IN dim: the ranks' partial products
    summed in rank order (the reference's ``mp_allreduce_sum``), the bias
    (whole, replicated) added once after.  ``input_is_parallel=True``
    takes the list of the ranks' input slices (a
    ``ColumnParallelLinear(gather_output=False)``'s output) or the global
    view."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: Optional[bool] = None,
                 input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False,
                 mp_group: Optional[Group] = None, name=None):
        super().__init__()
        self.group = _mp_group(mp_group)
        _bounds(in_features, self.group.nranks, "in_features")
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        dev = self.group.device
        self.weight = _dist(create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=I.XavierNormal(), device=dev))
        self.bias = (create_parameter([out_features], None, is_bias=True,
                                      device=dev)
                     if has_bias is not False else None)

    def forward(self, x):
        if isinstance(x, (list, tuple)) and not self.input_is_parallel:
            raise InvalidArgumentError(
                "RowParallelLinear got the ranks' slices but "
                "input_is_parallel=False")
        return row_linear(x, self.weight, self.bias, self.group.nranks)

    def extra_repr(self):
        return "in=%d, out=%d, input_is_parallel=%s, mp=%d" % (
            self.in_features, self.out_features, self.input_is_parallel,
            self.group.nranks)


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy over vocab-split logits (the reference's
    ``c_softmax_with_cross_entropy``): each rank's row max and exp-sum
    over its vocabulary slice, reduced over the ranks (max, then the
    rank-order sum), and the label's logit from the rank that owns it.
    Takes the global [..., V] logits or the list of the ranks' slices;
    labels [...] or [..., 1]; returns the loss [..., 1] (0 where the label
    is ``ignore_index``)."""

    def __init__(self, mp_group: Optional[Group] = None, name=None,
                 ignore_index: int = -100):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        mp = self.group.nranks
        if isinstance(logits, (list, tuple)):
            parts = list(logits)
        else:
            parts = [logits[..., s] for s in
                     _bounds(logits.shape[-1], mp, "vocab size")]
        lab = labels if torch.is_tensor(labels) else torch.as_tensor(labels)
        lab = lab.to(parts[0].device).long()
        if lab.ndim == parts[0].ndim:
            lab = lab.squeeze(-1)
        width = parts[0].shape[-1]
        m = torch.stack([p.detach().amax(-1) for p in parts]).amax(0)
        total = rank_sum([torch.exp(p - m.unsqueeze(-1)).sum(-1)
                          for p in parts])
        picked = []
        for r, p in enumerate(parts):
            local = lab - r * width
            inside = (local >= 0) & (local < width)
            got = torch.gather(p, -1, local.clamp(0, width - 1)
                               .unsqueeze(-1)).squeeze(-1)
            picked.append(torch.where(inside, got, torch.zeros_like(got)))
        loss = torch.log(total) - (rank_sum(picked) - m)
        loss = torch.where(lab != self.ignore_index, loss,
                           torch.zeros_like(loss))
        return loss.unsqueeze(-1)

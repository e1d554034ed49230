"""Row-sparse gradients of embedding tables (counterpart of the
reference's ``framework/sparse.py``, the SelectedRows analog).

The carrier is torch's own sparse COO gradient.  A custom class cannot be
a tensor's ``.grad``, while ``F.embedding(..., sparse=True)`` already
gives its weight an uncoalesced COO gradient (one row of ``indices`` and
one ``[rows, dim]`` block of ``values``), which autograd accumulates over
several backwards by concatenation, as the reference's engine adds its
``SparseGrad``s.  So ``p.grad`` holds the COO tensor, the optimizers read
it there, and :class:`SparseGrad` is a thin view over one with the
reference's surface: rows, values and dense shape, ``+`` (``None`` the
identity), ``*`` and ``/`` by a scalar, ``coalesce`` and ``to_dense``.

The reference's public ``param.grad`` view densifies, while its
optimizers read the raw form.  Here ``p.grad`` is the raw form (its
``shape`` is the dense shape); :func:`dense_grad` is the densified view.

A captured train step cannot hold a sparse gradient: coalescing has a
data-dependent shape.  ``jit.TrainStep`` runs its steps under
:func:`dense_gradients`, where a sparse embedding gives its dense
gradient, as the reference's traced path does.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["SparseGrad", "dense_grad", "dense_gradients",
           "sparse_gradients_enabled"]


class SparseGrad:
    """rows + values: ``dense[rows[i]] += values[i]``, a view over an
    uncoalesced sparse COO tensor (``coo``)."""

    __slots__ = ("coo",)

    def __init__(self, indices, values=None, dense_shape=None):
        if values is None:
            if not (torch.is_tensor(indices) and indices.is_sparse):
                raise ValueError("SparseGrad(coo) needs a sparse COO tensor")
            self.coo = indices
            return
        rows = torch.as_tensor(indices).reshape(-1).long()
        vals = torch.as_tensor(values)
        if vals.shape[0] != rows.shape[0]:
            raise ValueError("SparseGrad rows/values mismatch: %s vs %s"
                             % (tuple(rows.shape), tuple(vals.shape)))
        # rows from a caller: checked against the dense shape
        self.coo = torch.sparse_coo_tensor(rows.to(vals.device)[None], vals,
                                           tuple(dense_shape),
                                           check_invariants=True)

    @property
    def indices(self) -> torch.Tensor:
        return self.coo._indices()[0]

    @property
    def values(self) -> torch.Tensor:
        return self.coo._values()

    @property
    def dense_shape(self) -> tuple:
        return tuple(self.coo.shape)

    shape = dense_shape

    @property
    def dtype(self):
        return self.coo.dtype

    def __add__(self, other):
        if other is None:
            return self
        if isinstance(other, SparseGrad):
            if other.dense_shape != self.dense_shape:
                raise ValueError("SparseGrad shape mismatch")
            return SparseGrad(torch.cat([self.indices, other.indices]),
                              torch.cat([self.values, other.values]),
                              self.dense_shape)
        return self.to_dense() + other  # mixed: densify

    __radd__ = __add__

    def __mul__(self, other):
        if isinstance(other, (int, float)) or (torch.is_tensor(other)
                                               and other.ndim == 0):
            return SparseGrad(self.indices, self.values * other,
                              self.dense_shape)
        return self.to_dense() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, (int, float)) or (torch.is_tensor(other)
                                               and other.ndim == 0):
            return SparseGrad(self.indices, self.values / other,
                              self.dense_shape)
        return self.to_dense() / other

    def coalesce(self) -> "SparseGrad":
        """Duplicate rows merged (summed), rows sorted."""
        return SparseGrad(self.coo.coalesce())

    def to_dense(self) -> torch.Tensor:
        return self.coo.to_dense()

    def __repr__(self):
        return "SparseGrad(rows=%d, dense_shape=%s)" % (
            int(self.indices.shape[0]), (self.dense_shape,))


def dense_grad(p: torch.Tensor):
    """``p``'s gradient as a dense tensor (the reference's public
    ``param.grad`` view); None when it has none."""
    g = p.grad
    return g.to_dense() if g is not None and g.is_sparse else g


_tls = threading.local()


@contextlib.contextmanager
def dense_gradients():
    """Inside, a sparse embedding gives its weight a dense gradient."""
    _tls.dense = getattr(_tls, "dense", 0) + 1
    try:
        yield
    finally:
        _tls.dense -= 1


def sparse_gradients_enabled() -> bool:
    return not getattr(_tls, "dense", 0)

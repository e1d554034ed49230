"""Linear algebra (counterpart of the reference's ``tensor/linalg.py``):
its names and arguments over ``torch.linalg``.  ``matmul``, ``bmm``,
``mv`` and ``dot`` are products the autocast lists name."""
from __future__ import annotations

import torch

from ..core.errors import InvalidArgumentError

__all__ = ["matmul", "bmm", "dot", "mv", "t", "transpose", "norm", "dist",
           "cross", "cholesky", "matrix_power", "svd", "qr", "inv", "pinv",
           "solve", "triangular_solve", "lstsq", "det", "slogdet", "eig",
           "eigh", "eigvals", "eigvalsh", "matrix_rank", "cond",
           "multi_dot", "lu", "histogram"]


def matmul(x, y, transpose_x: bool = False, transpose_y: bool = False):
    """matmul_v2: ``x @ y`` with either operand's last two axes swapped
    first when asked."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def bmm(x, y):
    return torch.matmul(x, y)


def dot(x, y):
    return (x * y).sum(dim=-1)


def mv(x, vec):
    return torch.matmul(x, vec)


def t(x):
    return x if x.ndim < 2 else x.transpose(-1, -2)


def transpose(x, perm):
    return x.permute(*perm)


def norm(x, p="fro", axis=None, keepdim: bool = False):
    """Frobenius (or 2 over every axis), inf, -inf, 0 (the count of
    non-zeros) or the p-norm, over ``axis`` (every axis when None)."""
    dims = None if axis is None else (
        (axis,) if isinstance(axis, int) else tuple(axis))
    if dims is None:
        dims = tuple(range(x.ndim))
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.square(x).sum(dim=dims, keepdim=keepdim))
    if p == float("inf"):
        return torch.abs(x).amax(dim=dims, keepdim=keepdim)
    if p == float("-inf"):
        return torch.abs(x).amin(dim=dims, keepdim=keepdim)
    if p == 0:
        return (x != 0).to(x.dtype).sum(dim=dims, keepdim=keepdim)
    return torch.pow(torch.pow(torch.abs(x), p).sum(dim=dims,
                                                    keepdim=keepdim),
                     1.0 / p)


def dist(x, y, p: float = 2):
    return norm(x - y, p=p)


def cross(x, y, axis: int = -1):
    return torch.linalg.cross(x, y, dim=axis)


def cholesky(x, upper: bool = False):
    low = torch.linalg.cholesky(x)
    return low.transpose(-1, -2) if upper else low


def matrix_power(x, n: int):
    return torch.linalg.matrix_power(x, n)


def svd(x, full_matrices: bool = False):
    """``(U, S, VH)``."""
    return torch.linalg.svd(x, full_matrices=full_matrices)


def qr(x, mode: str = "reduced"):
    """``(Q, R)``; ``mode="r"`` gives R alone."""
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def inv(x):
    return torch.linalg.inv(x)


def pinv(x, rcond: float = 1e-15, hermitian: bool = False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def solve(x, y):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper: bool = True, transpose: bool = False,
                     unitriangular: bool = False):
    """The solution of ``op(x) @ out = y``, ``op`` the transpose when
    ``transpose``."""
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper != transpose,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None):
    """``(solution, residuals, rank, singular_values)``."""
    return tuple(torch.linalg.lstsq(x, y, rcond=rcond, driver=driver))


def det(x):
    return torch.linalg.det(x)


def slogdet(x):
    """``[sign, log|det|]`` stacked."""
    sign, logabsdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logabsdet])


def eig(x):
    return torch.linalg.eig(x)


def eigh(x, UPLO: str = "L"):
    return torch.linalg.eigh(x, UPLO=UPLO)


def eigvals(x):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO: str = "L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def matrix_rank(x, tol=None, hermitian: bool = False):
    return torch.linalg.matrix_rank(x, rtol=tol)


def cond(x, p=None):
    return torch.linalg.cond(x, p)


def multi_dot(tensors):
    return torch.linalg.multi_dot(list(tensors))


def lu(x, pivot: bool = True, get_infos: bool = False):
    """``(LU, pivots)`` with 1-based pivots (and zero infos when asked);
    partial pivoting only."""
    if not pivot:
        raise InvalidArgumentError(
            "lu only supports pivot=True (partial pivoting)")
    lu_mat, piv = torch.linalg.lu_factor(x)
    if get_infos:
        return lu_mat, piv, torch.zeros(x.shape[:-2], dtype=torch.int32,
                                        device=x.device)
    return lu_mat, piv


def histogram(x, bins: int = 100, min: float = 0.0, max: float = 0.0):
    """Counts of ``bins`` equal bins over [min, max] (the data's range
    when both are 0), int64."""
    if min == 0.0 and max == 0.0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = min, max
    return torch.histc(x.float().reshape(-1), bins=bins, min=lo,
                       max=hi).long()

"""Spatial-transformer functionals (counterpart of the reference's
``nn/functional/vision.py``): ``affine_grid`` and ``grid_sample``.

NCHW input, an [N, H, W, 2] grid of (x, y) in [-1, 1].  Both default to
``align_corners=True``, the reference's default (torch's is False).
``grid_sample``'s reflection padding is the reference's ``_reflect``:
about the span's edges (``[0, size - 1]`` with ``align_corners``, else
``[-0.5, size - 0.5]`` and then clipped into the image).  Sampling is
gathers and weights on the device, each corner zeroed when it lies
outside the image (``padding_mode="zeros"``).
"""
from __future__ import annotations

import torch

from ...core.errors import InvalidArgumentError

__all__ = ["affine_grid", "grid_sample"]


def affine_grid(theta, out_shape, align_corners: bool = True):
    """theta [N, 2, 3] affine maps -> the sampling grid [N, H, W, 2] of
    ``out_shape`` [N, C, H, W]."""
    if theta.ndim != 3 or tuple(theta.shape[1:]) != (2, 3):
        raise InvalidArgumentError(
            "affine_grid expects theta [N, 2, 3], got %s"
            % (tuple(theta.shape),))
    _, _, h, w = [int(s) for s in out_shape]
    dev = theta.device

    def coords(n):
        if align_corners:
            return (torch.linspace(-1.0, 1.0, n, device=dev) if n > 1
                    else torch.zeros(1, device=dev))
        step = 2.0 / n
        return -1.0 + step / 2 + step * torch.arange(
            n, dtype=torch.float32, device=dev)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("hwk,njk->nhwj", base, theta.float())


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _reflect(ix, low, high):
    span = high - low
    if span == 0:
        return torch.zeros_like(ix)
    ix = torch.remainder((ix - low).abs(), 2 * span)
    return torch.where(ix > span, 2 * span - ix, ix) + low


def grid_sample(x, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True):
    """Sample ``x`` [N, C, H, W] at ``grid`` [N, Hg, Wg, 2]; ``mode``
    bilinear or nearest (half to even), ``padding_mode`` zeros, border or
    reflection."""
    if mode not in ("bilinear", "nearest"):
        raise InvalidArgumentError("grid_sample mode must be bilinear or "
                                   "nearest, got %r" % mode)
    if padding_mode not in ("zeros", "border", "reflection"):
        raise InvalidArgumentError(
            "grid_sample padding_mode must be zeros/border/reflection, "
            "got %r" % padding_mode)
    n, c, h, w = x.shape
    ix = _unnormalize(grid[..., 0].float(), w, align_corners)
    iy = _unnormalize(grid[..., 1].float(), h, align_corners)
    if padding_mode == "border":
        ix = ix.clamp(0, w - 1)
        iy = iy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        if align_corners:
            ix = _reflect(ix, 0.0, float(w - 1))
            iy = _reflect(iy, 0.0, float(h - 1))
        else:
            ix = _reflect(ix, -0.5, w - 0.5).clamp(0, w - 1)
            iy = _reflect(iy, -0.5, h - 0.5).clamp(0, h - 1)
    flat = x.reshape(n, c, h * w)

    def gather(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        got = flat.gather(2, idx.reshape(n, 1, -1).expand(n, c, -1))
        return got * inside.reshape(n, 1, -1).to(x.dtype)

    hg, wg = grid.shape[1], grid.shape[2]
    if mode == "nearest":
        return gather(torch.round(iy).long(),
                      torch.round(ix).long()).reshape(n, c, hg, wg)
    x0 = torch.floor(ix).long()
    y0 = torch.floor(iy).long()
    wx = (ix - x0).to(x.dtype).reshape(n, 1, -1)
    wy = (iy - y0).to(x.dtype).reshape(n, 1, -1)
    out = (gather(y0, x0) * (1 - wy) * (1 - wx)
           + gather(y0, x0 + 1) * (1 - wy) * wx
           + gather(y0 + 1, x0) * wy * (1 - wx)
           + gather(y0 + 1, x0 + 1) * wy * wx)
    return out.reshape(n, c, hg, wg)

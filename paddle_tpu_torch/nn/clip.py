"""Gradient clipping (counterpart of the reference's ``nn/clip.py``).

Each clip maps a list of ``(param, grad)`` pairs to a new list (the input
gradients are not written); the same object serves the eager
``Optimizer.step()`` path and ``TrainStep``.  Each works on the gradient
list at once (``torch._foreach_*``): a few launches per list, whatever the
parameter count.  The norms stay on the device: no host read, so a clip
runs inside a captured step."""
from __future__ import annotations

from typing import Dict, List

import torch


def _by_dtype(grads) -> Dict[tuple, List[int]]:
    """Positions of ``grads`` grouped by dtype and device (one list
    operation takes tensors of one dtype on one device)."""
    groups: Dict[tuple, List[int]] = {}
    for i, g in enumerate(grads):
        groups.setdefault((g.dtype, g.device), []).append(i)
    return groups


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        idx = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        out = list(params_grads)
        if not idx:
            return out
        clipped = torch._foreach_clamp_min([params_grads[i][1] for i in idx],
                                           self.min)
        torch._foreach_clamp_max_(clipped, self.max)
        for i, g in zip(idx, clipped):
            out[i] = (params_grads[i][0], g)
        return out


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm`` (its norm
    in its own dtype, as the reference's)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        idx = [i for i, (_, g) in enumerate(params_grads) if g is not None]
        out = list(params_grads)
        grads = [params_grads[i][1] for i in idx]
        for pos in _by_dtype(grads).values():
            part = [grads[j] for j in pos]
            norms = torch.stack(torch._foreach_norm(part))
            scale = torch.clamp(self.clip_norm / torch.clamp(norms,
                                                             min=1e-12),
                                max=1.0)
            scaled = torch._foreach_mul(part, list(scale.unbind(0)))
            for j, g in zip(pos, scaled):
                out[idx[j]] = (params_grads[idx[j]][0], g)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by ``clip_norm / max(norm, clip_norm)``,
    ``norm`` the L2 norm of all of them together in float32.  Parameters
    with ``need_clip = False`` keep their gradients and do not count."""

    def __init__(self, clip_norm: float, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads, device=None):
        """The float32 L2 norm of ``grads`` together (None entries
        skipped): one list norm per dtype and one sum.  With no gradient
        it is 0 on ``device``."""
        grads = [g for g in grads if g is not None]
        if not grads:
            return torch.zeros((), dtype=torch.float32, device=device)
        norms = []
        for pos in _by_dtype(grads).values():
            norms.extend(torch._foreach_norm([grads[j] for j in pos],
                                             dtype=torch.float32))
        return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))

    def __call__(self, params_grads):
        idx = [i for i, (p, g) in enumerate(params_grads)
               if g is not None and getattr(p, "need_clip", True)]
        if not idx:
            return list(params_grads)
        grads = [params_grads[i][1] for i in idx]
        gnorm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        out = list(params_grads)
        for (dtype, _), pos in _by_dtype(grads).items():
            scaled = torch._foreach_mul([grads[j] for j in pos],
                                        scale.to(dtype))
            for j, g in zip(pos, scaled):
                out[idx[j]] = (params_grads[idx[j]][0], g)
        return out

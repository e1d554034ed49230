"""Gradient clipping (counterpart of the reference's ``nn/clip.py``).

Each clip maps a list of ``(param, grad)`` pairs to a new list; the same
object serves the eager ``Optimizer.step()`` path and ``TrainStep``.  The
norms stay on the device: no host read."""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, None if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, None))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm: float, group_name: str = "default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads):
        sq = [torch.sum(torch.square(g.float())) for g in grads
              if g is not None]
        if not sq:
            return torch.zeros(())
        return torch.sqrt(sum(sq))

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "need_clip", True)]
        if not grads:
            return list(params_grads)
        gnorm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        return [(p, g) if g is None or not getattr(p, "need_clip", True)
                else (p, g * scale.to(g.dtype)) for p, g in params_grads]

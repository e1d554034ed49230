"""Weight-decay regularizers (counterpart of the reference's
``regularizer.py``): applied by the optimizers as
``grad += coeff * f(param)``."""
from __future__ import annotations

import torch


class WeightDecayRegularizer:
    def __init__(self, coeff: float = 0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self) -> float:
        return self._coeff

    def __call__(self, param, grad):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __call__(self, param, grad):
        return grad + self._coeff * param


class L1Decay(WeightDecayRegularizer):
    def __call__(self, param, grad):
        return grad + self._coeff * torch.sign(param)

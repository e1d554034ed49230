"""LR schedulers (counterpart of the reference's ``optimizer/lr.py``;
Paddle's ``python/paddle/optimizer/lr.py``): pure Python, copied so the
port imports nothing of the reference.
"""
from __future__ import annotations

import math
from typing import List, Optional


class LRScheduler:
    """Base class (lr.py:37): stateful step counter, state_dict round-trip."""

    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1, verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self) -> float:
        return self.last_lr

    def step(self, epoch: Optional[int] = None) -> None:
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print("Epoch {}: {} set learning rate to {}.".format(self.last_epoch, type(self).__name__, self.last_lr))

    def get_lr(self) -> float:
        raise NotImplementedError

    _state_keys = ["last_epoch", "last_lr"]

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._state_keys}

    def set_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            if hasattr(self, k):
                setattr(self, k, v)

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    """lr.py:203 — lr = lr0 * d_model^-0.5 * min(n^-0.5, n * warmup^-1.5)."""

    def __init__(self, d_model: int, warmup_steps: int, learning_rate: float = 1.0, last_epoch: int = -1, verbose: bool = False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        n = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(n ** -0.5, n * (self.warmup_steps ** -1.5))


class PiecewiseDecay(LRScheduler):
    """lr.py:296."""

    def __init__(self, boundaries: List[int], values: List[float], last_epoch: int = -1, verbose: bool = False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self) -> float:
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    """lr.py:387 — lr = lr0 * exp(-gamma * epoch)."""

    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    """lr.py:466 — lr = lr0 / (1 + gamma * epoch)."""

    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    """lr.py:547."""

    def __init__(self, learning_rate: float, decay_steps: int, end_lr: float = 0.0001,
                 power: float = 1.0, cycle: bool = False, last_epoch: int = -1, verbose: bool = False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / float(self.decay_steps)) or 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, self.decay_steps)
        return (self.base_lr - self.end_lr) * ((1 - float(step) / float(decay_steps)) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    """lr.py:667 — linear ramp into an inner schedule (or constant)."""

    def __init__(self, learning_rate, warmup_steps: int, start_lr: float, end_lr: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.lr_scheduler = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate if isinstance(learning_rate, float) else float(end_lr)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self) -> float:
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / float(self.warmup_steps) + self.start_lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
            return self.lr_scheduler()
        return self.base_lr

    def state_dict(self) -> dict:
        sd = super().state_dict()
        if self.lr_scheduler is not None:
            sd["LinearWarmup_LR"] = self.lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state: dict) -> None:
        inner = state.pop("LinearWarmup_LR", None)
        if inner is not None and self.lr_scheduler is not None:
            self.lr_scheduler.set_state_dict(inner)
        super().set_state_dict(state)


class ExponentialDecay(LRScheduler):
    """lr.py:804 — lr = lr0 * gamma^epoch."""

    def __init__(self, learning_rate: float, gamma: float, last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    """lr.py:884."""

    def __init__(self, learning_rate: float, milestones: List[int], gamma: float = 0.1,
                 last_epoch: int = -1, verbose: bool = False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    """lr.py:994."""

    def __init__(self, learning_rate: float, step_size: int, gamma: float = 0.1,
                 last_epoch: int = -1, verbose: bool = False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    """lr.py:1095."""

    def __init__(self, learning_rate: float, lr_lambda, last_epoch: int = -1, verbose: bool = False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceOnPlateau(LRScheduler):
    """lr.py:1183 — metric-driven; step(metric) instead of step()."""

    def __init__(self, learning_rate: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0, epsilon: float = 1e-8, verbose: bool = False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.verbose = verbose
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.best = None
        self.cooldown_counter = 0
        self.num_bad_epochs = 0

    _state_keys = ["last_epoch", "last_lr", "best", "cooldown_counter", "num_bad_epochs"]

    def _is_better(self, current, best) -> bool:
        if best is None:
            return True
        if self.threshold_mode == "rel":
            delta = self.threshold * abs(best)
        else:
            delta = self.threshold
        return current < best - delta if self.mode == "min" else current > best + delta

    def step(self, metrics=None, epoch=None) -> None:
        if metrics is None:
            return
        current = float(metrics)
        self.last_epoch += 1
        if self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    print("Epoch {}: ReduceOnPlateau set learning rate to {}.".format(self.last_epoch, new_lr))
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def get_lr(self) -> float:
        return self.last_lr


class CosineAnnealingDecay(LRScheduler):
    """lr.py:1393."""

    def __init__(self, learning_rate: float, T_max: int, eta_min: float = 0.0,
                 last_epoch: int = -1, verbose: bool = False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)
        ) / 2


class OneCycleLR(LRScheduler):
    """paddle 2.x incubate scheduler; included for completeness."""

    def __init__(self, max_learning_rate: float, total_steps: int, divide_factor: float = 25.0,
                 end_learning_rate: float = 1e-4, phase_pct: float = 0.3,
                 anneal_strategy: str = "cos", last_epoch: int = -1, verbose: bool = False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.up_steps = int(total_steps * phase_pct)
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self) -> float:
        step = min(self.last_epoch, self.total_steps)
        if step <= self.up_steps and self.up_steps > 0:
            pct = step / self.up_steps
            return self.initial_lr + (self.max_lr - self.initial_lr) * (1 - math.cos(math.pi * pct)) / 2
        down = self.total_steps - self.up_steps
        pct = (step - self.up_steps) / max(down, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * (1 + math.cos(math.pi * pct)) / 2

"""Seeds and generator states (counterpart of the reference's
``core/random.py``).

The reference keeps paddle's stateful seed API over explicit JAX keys: a
process-wide generator folds a counter into its root key, and jitted code
installs a traced key (``rng_guard``).  Torch's generators are stateful
already, so the port's facade stands over them: ``seed(value)`` seeds the
CPU generator and every CUDA generator (``torch.manual_seed``), random ops
draw from the generator of their device, and a captured step draws from
the CUDA generator the capture registered (``jit/train_step.py``), a fresh
draw each replay.  ``rng_guard``, ``next_key``, ``split_key`` and
``replay_counter`` exist for explicit, traced keys and have no
counterpart here.

The draws are torch's: a seed gives the same draws as that seed gave
before, and a restored state replays the draws that followed it; they are
not the reference's JAX streams.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state"]


class Generator:
    """The process-wide generators behind one seed: torch's default CPU
    generator and every CUDA generator."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._lock = threading.Lock()

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._seed = int(seed)
            torch.manual_seed(self._seed)  # the CPU and every CUDA generator
        return self

    def initial_seed(self) -> int:
        return self._seed

    def get_state(self) -> dict:
        """The seed and every generator's state (copies)."""
        return {"seed": self._seed, "cpu": get_rng_state(),
                "cuda": get_cuda_rng_state()}

    def set_state(self, state: dict) -> None:
        with self._lock:
            self._seed = int(state["seed"])
            set_rng_state(state["cpu"])
            set_cuda_rng_state(state["cuda"])


default_generator = Generator(0)


def seed(value: int) -> Generator:
    """paddle.seed: seed the CPU generator and every CUDA generator."""
    return default_generator.manual_seed(value)


def get_rng_state() -> torch.Tensor:
    """The CPU generator's state (a uint8 tensor)."""
    return torch.get_rng_state()


def set_rng_state(state) -> None:
    torch.set_rng_state(state)


def get_cuda_rng_state() -> list:
    """Every CUDA generator's state, one per card; empty without a
    card."""
    return torch.cuda.get_rng_state_all() if torch.cuda.is_available() \
        else []


def set_cuda_rng_state(state) -> None:
    if state:
        torch.cuda.set_rng_state_all(state)

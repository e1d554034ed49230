"""What every zoo constructor shares: the device and the seeded
generator its weights are drawn from, and the refusal of
``pretrained=True``."""
from __future__ import annotations

import torch

from ...core.device import resolve_device


def weight_kw(device=None, seed: int = 0) -> dict:
    """``device=`` (None: ``cuda``, which raises without a card) and a
    ``generator=`` seeded with ``seed``, for the layers' draws in
    construction order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return dict(device=dev, generator=gen)


def refuse_pretrained(pretrained: bool) -> None:
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled; load a checkpoint with "
            "load_state_dict (or convert.load_reference_params) instead")

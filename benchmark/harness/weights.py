"""Weights made from the seed on the device, one generator call a group
of leaves (the embeddings, each layer, the final norm and head), in the
float32 they are served in.  The program and the reference are handed
the same values."""
from __future__ import annotations

import zlib
from typing import Dict, Iterator, List

import numpy as np
import torch

from reference import leaf_specs


def derive_seed(seed: int, key: str) -> int:
    """A 63-bit seed from the run's seed and a name (stable across
    processes, unlike ``hash``)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, zlib.crc32(
        key.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def groups(cfg: dict) -> List[str]:
    out: List[str] = []
    for _, _, _, g in leaf_specs(cfg):
        if g not in out:
            out.append(g)
    return out


def make_group(cfg: dict, seed: int, group: str,
               device) -> Dict[str, torch.Tensor]:
    """The float32 leaves of ``group``: normal leaves from one
    ``torch.randn`` of the group's size on ``device`` (std
    ``init_std``), norms' weights 1 and biases 0."""
    specs = [s for s in leaf_specs(cfg) if s[3] == group]
    sizes = [int(np.prod(shape)) for _, shape, init, _ in specs
             if init == "normal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights/" + group))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32).mul_(cfg["init_std"])
    out, at = {}, 0
    for name, shape, init, _ in specs:
        if init == "normal":
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].view(shape)
            at += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def iter_groups(cfg: dict, seed: int, device) -> Iterator[dict]:
    for g in groups(cfg):
        yield make_group(cfg, seed, g, device)


def make_all(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, each its own contiguous float32 tensor."""
    out = {}
    for part in iter_groups(cfg, seed, device):
        out.update({n: t.clone() for n, t in part.items()})
    return out


@torch.no_grad()
def load_into(named_params, cfg: dict, seed: int) -> None:
    """Copy the seed's weights into the program's parameters, group by
    group; the names and shapes must be the reference's."""
    params = dict(named_params)
    want = {name: shape for name, shape, _, _ in leaf_specs(cfg)}
    got = {n: tuple(p.shape) for n, p in params.items()}
    if got != want:
        raise RuntimeError(
            "the program's parameters differ from the reference's: "
            "missing %s, unexpected %s, shapes %s" % (
                sorted(set(want) - set(got))[:5],
                sorted(set(got) - set(want))[:5],
                [(n, got[n], want[n]) for n in want
                 if n in got and got[n] != tuple(want[n])][:5]))
    device = next(iter(params.values())).device
    for part in iter_groups(cfg, seed, device):
        for name, value in part.items():
            params[name].copy_(value)

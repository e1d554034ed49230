"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes the cell's inputs from the seed.

Every seed gets the same sizes: lengths are the quantiles of their
distributions at evenly spaced probabilities, one set a block of
``block`` requests, shuffled within the block by the seed; the token
ids, and the open loop's arrival times, are drawn from the seed.  Mix
kinds:

- ``open_loop``: requests due at Poisson arrival times (exponential gaps
  at ``rate_per_s`` drawn from the seed), log-normal prompt and output
  lengths, unique prompts;
- ``closed_loop``: ``clients`` callers, each sending its next request
  when its last one finished; each prompt one of ``prefixes`` shared
  prefixes plus a unique tail, uniform tail and output lengths.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List

import numpy as np

from harness.weights import derive_seed


def rng_for(seed: int, key: str) -> np.random.Generator:
    return np.random.default_rng(derive_seed(seed, key))


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` values of ``dist`` at the probabilities (j + 0.5) / n:
    ``{"lognormal": {"median", "sigma"}}``, ``{"uniform": [lo, hi]}`` or
    ``{"exponential": mean}``, rounded and cut to ``[min, max]`` where
    given (integers unless ``"float": true``)."""
    p = (np.arange(n) + 0.5) / n
    if "lognormal" in dist:
        d = dist["lognormal"]
        z = np.array([NormalDist().inv_cdf(float(x)) for x in p])
        v = d["median"] * np.exp(d["sigma"] * z)
    elif "uniform" in dist:
        lo, hi = dist["uniform"]
        v = lo + p * (hi + 1 - lo) - 0.5
    else:
        v = -dist["exponential"] * np.log1p(-p)
    if dist.get("float"):
        return v
    v = np.clip(np.rint(v), dist.get("min", -math.inf),
                dist.get("max", math.inf))
    return v.astype(np.int64)


def stratified(dist: dict, count: int, block: int,
               rng: np.random.Generator) -> np.ndarray:
    """``count`` draws: the block's quantile set shuffled afresh a block."""
    q = quantiles(dist, block)
    out = [q[rng.permutation(block)] for _ in range(-(-count // block))]
    return np.concatenate(out)[:count]


class Zipf:
    """Ids in [lo, hi) with P(rank k) proportional to k^-a, the ranks
    scattered over the ids by a permutation fixed by ``perm_seed``."""

    def __init__(self, a: float, lo: int, hi: int, perm_seed: int = 0):
        w = 1.0 / np.arange(1, hi - lo + 1, dtype=np.float64) ** a
        self.cdf = np.cumsum(w / w.sum())
        self.cdf[-1] = 1.0
        self.ids = lo + np.random.default_rng(perm_seed).permutation(hi - lo)

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return self.ids[np.searchsorted(self.cdf, rng.random(n),
                                        side="right")]


# -- serving -----------------------------------------------------------------

class Request:
    __slots__ = ("rid", "due", "prompt", "max_new", "group")

    def __init__(self, rid, due, prompt, max_new, group=-1):
        self.rid, self.due, self.prompt = rid, due, prompt
        self.max_new, self.group = max_new, group


def open_loop(mix: dict, seed: int, horizon_s: float) -> List[Request]:
    """Requests due from 0 to ``horizon_s`` s, in due order: Poisson
    arrivals at ``rate_per_s`` (independent exponential gaps drawn from
    the seed, so bursts come where the seed puts them), prompt and output
    lengths from their quantile sets, one set a block of ``block``
    requests in the seed's order, and unique prompts of Zipf ids."""
    rate, block = mix["rate_per_s"], mix["block"]
    gap_rng = rng_for(seed, "open_loop/arrivals")
    due = []
    t = gap_rng.exponential(1.0 / rate)
    while t <= horizon_s:
        due.append(t)
        t += gap_rng.exponential(1.0 / rate)
    size_rng = rng_for(seed, "open_loop/sizes")
    prompts = stratified(mix["prompt_len"], len(due), block, size_rng)
    outs = stratified(mix["output_len"], len(due), block, size_rng)
    rng = rng_for(seed, "open_loop")
    zipf = Zipf(mix["zipf_a"], 0, mix["vocab"], mix.get("perm_seed", 0))
    return [Request(i, float(d), zipf.draw(rng, int(prompts[i])),
                    int(outs[i])) for i, d in enumerate(due)]


class ClosedLoop:
    """The closed loop's requests, in the order clients take them."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.block = mix, mix["block"]
        self.rng = rng_for(seed, "closed_loop")
        self.zipf = Zipf(mix["zipf_a"], 0, mix["vocab"],
                         mix.get("perm_seed", 0))
        self.prefixes = [self.zipf.draw(self.rng, mix["prefix_len"])
                         for _ in range(mix["prefixes"])]
        self._pending: List[Request] = []
        self._made = 0

    def _refill(self):
        b, k = self.block, self.mix["prefixes"]
        groups = np.arange(b) % k
        groups = groups[self.rng.permutation(b)]
        tails = stratified(self.mix["tail_len"], b, b, self.rng)
        outs = stratified(self.mix["output_len"], b, b, self.rng)
        for j in range(b):
            prompt = np.concatenate([self.prefixes[groups[j]],
                                     self.zipf.draw(self.rng, int(tails[j]))])
            self._pending.append(Request(self._made, 0.0, prompt,
                                         int(outs[j]), int(groups[j])))
            self._made += 1

    def next(self) -> Request:
        if not self._pending:
            self._refill()
        return self._pending.pop(0)

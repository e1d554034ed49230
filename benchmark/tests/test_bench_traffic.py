"""The generator: the same seed gives the same inputs; another seed gives
the same sizes a block, other ids and other Poisson arrival times."""
import numpy as np
import pytest

from harness import traffic
from tiny import tiny_cell


def _cell(name):
    return tiny_cell(name)["mix"]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_open_loop_poisson_arrivals_by_seed(seed):
    mix = _cell("gpt3-1.3b.serve-chat")
    a = traffic.open_loop(mix, seed, 600.0)
    b = traffic.open_loop(mix, seed, 600.0)
    assert [(r.due, r.max_new, len(r.prompt)) for r in a] == \
        [(r.due, r.max_new, len(r.prompt)) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    other = traffic.open_loop(mix, seed + 1, 600.0)
    assert [r.due for r in a[:20]] != [r.due for r in other[:20]]
    assert not all(np.array_equal(x.prompt, y.prompt)
                   for x, y in zip(a, other))
    n = mix["block"]
    for reqs in (a, other):
        assert sorted(len(r.prompt) for r in reqs[:n]) == \
            sorted(len(r.prompt) for r in a[n:2 * n])
    dues = np.array([r.due for r in a])
    assert (np.diff(dues) > 0).all() and 0.0 < dues[0] and dues[-1] <= 600
    gaps = np.diff(np.concatenate([[0.0], dues]))
    rate = mix["rate_per_s"]
    assert abs(len(a) / 600.0 - rate) < 4 * (rate / 600.0) ** 0.5
    # exponential gaps: their spread equals their mean, and the counts of
    # one-second bins spread as a Poisson count does (variance = mean)
    assert 0.85 < gaps.std() / gaps.mean() < 1.15
    counts = np.bincount(dues.astype(int), minlength=600)
    assert 0.7 < counts.var() / counts.mean() < 1.3


def test_closed_loop_shares_prefixes():
    mix = _cell("gpt3-1.3b.serve-fewshot-batch")
    loop = traffic.ClosedLoop(mix, 5)
    reqs = [loop.next() for _ in range(2 * mix["block"])]
    for r in reqs:
        assert np.array_equal(r.prompt[:mix["prefix_len"]],
                              loop.prefixes[r.group])
    groups = [r.group for r in reqs[:mix["block"]]]
    assert sorted(set(groups)) == list(range(mix["prefixes"]))
    again = traffic.ClosedLoop(mix, 5)
    assert all(np.array_equal(r.prompt, again.next().prompt) for r in reqs)

"""``distribution`` of the port against the reference's on the same
parameters: ``log_prob``/``probs``/``entropy``/``kl_divergence`` within
1e-5 relative (1e-6 absolute), and samples held by their moments (the
draws are torch's generators, not the reference's JAX streams): the mean
within 4 standard errors and the variance within 5% over 200000 draws;
``seed`` reproduces a draw.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import distribution as rd

from paddle_tpu_torch import distribution as pd

TOL = dict(rtol=1e-5, atol=1e-6)


def _v(t):
    return np.asarray(t.value) if hasattr(t, "value") else t.numpy()


def _pairs():
    rng = np.random.RandomState(0)
    loc = rng.randn(3).astype(np.float32)
    scale = (rng.rand(3) + 0.5).astype(np.float32)
    loc2 = rng.randn(3).astype(np.float32)
    scale2 = (rng.rand(3) + 0.5).astype(np.float32)
    logits = rng.randn(2, 5).astype(np.float32)
    logits2 = rng.randn(2, 5).astype(np.float32)
    t = torch.from_numpy
    return {
        "uniform": (pd.Uniform(t(loc - 1), t(loc + scale)),
                    rd.Uniform(loc - 1, loc + scale),
                    rng.randn(3).astype(np.float32), None),
        "normal": (pd.Normal(t(loc), t(scale)), rd.Normal(loc, scale),
                   rng.randn(3).astype(np.float32),
                   (pd.Normal(t(loc2), t(scale2)), rd.Normal(loc2, scale2))),
        "categorical": (pd.Categorical(t(logits)), rd.Categorical(logits),
                        np.array([1, 4], np.int64),
                        (pd.Categorical(t(logits2)),
                         rd.Categorical(logits2))),
        "mvn_diag": (pd.MultivariateNormalDiag(t(loc), t(np.diag(scale))),
                     rd.MultivariateNormalDiag(loc, np.diag(scale)),
                     rng.randn(3).astype(np.float32),
                     (pd.MultivariateNormalDiag(t(loc2),
                                                t(np.diag(scale2))),
                      rd.MultivariateNormalDiag(loc2, np.diag(scale2)))),
    }


@pytest.mark.parametrize("name", ["uniform", "normal", "categorical",
                                  "mvn_diag"])
def test_densities_entropy_and_kl_match_reference(name):
    port, ref, value, other = _pairs()[name]
    v_port = torch.from_numpy(value)
    for fn in ("log_prob", "probs"):
        np.testing.assert_allclose(_v(getattr(port, fn)(v_port)),
                                   _v(getattr(ref, fn)(value)), **TOL)
    np.testing.assert_allclose(_v(port.entropy()), _v(ref.entropy()), **TOL)
    if other is not None:
        np.testing.assert_allclose(_v(port.kl_divergence(other[0])),
                                   _v(ref.kl_divergence(other[1])), **TOL)


def _moments(x, mean, var):
    n = x.shape[0]
    se = np.sqrt(var / n)
    assert np.all(np.abs(x.mean(0) - mean) <= 4 * se + 1e-12)
    np.testing.assert_allclose(x.var(0), var, rtol=0.05)


def test_samples_have_the_distributions_moments():
    n = 200000
    loc = np.array([0.5, -1.0], np.float32)
    scale = np.array([2.0, 0.5], np.float32)
    t = torch.from_numpy
    x = pd.Normal(t(loc), t(scale)).sample([n], seed=3).numpy()
    assert x.shape == (n, 2)
    _moments(x, loc, scale ** 2)
    u = pd.Uniform(t(loc), t(loc + scale)).sample([n], seed=4).numpy()
    _moments(u, loc + scale / 2, scale ** 2 / 12)
    mv = pd.MultivariateNormalDiag(t(loc), t(np.diag(scale))).sample(
        [n], seed=5).numpy()
    _moments(mv, loc, scale ** 2)
    logits = np.log(np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]],
                             np.float32))
    c = pd.Categorical(t(logits)).sample([n], seed=6).numpy()
    assert c.shape == (n, 2)
    for row in range(2):
        freq = np.bincount(c[:, row], minlength=3) / n
        np.testing.assert_allclose(freq, np.exp(logits[row]), atol=0.005)
    ids = pd.sampling_id(t(np.exp(logits)), seed=7)
    assert ids.dtype == torch.int64 and ids.shape == (2,)
    a = pd.Normal(t(loc), t(scale)).sample([4], seed=9)
    b = pd.Normal(t(loc), t(scale)).sample([4], seed=9)
    assert torch.equal(a, b)

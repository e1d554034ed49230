"""``incubate.asp`` of the port against the reference's on the CPU: the
n:m masks equal the reference's ``compute_nm_mask`` (the same numpy
ranking), pruning skips the excluded layers (named by ``param_name``)
and the non-divisible ones, and a decorated optimizer keeps the 2:4
pattern through its eager ``step()`` in both packages.

Under the compiled or captured ``TrainStep`` (``Model.fit``) the
reference LOSES the pattern: its wrapper hands ``_functional_step`` to
the inner optimizer, which updates the pruned weights (shown below).
The port re-applies the masks there too, as ASP documents: a deliberate
difference (ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.incubate import asp as rasp

import paddle_tpu_torch as ptt
from paddle_tpu_torch import load_reference_params
from paddle_tpu_torch.incubate import asp as pasp


@pytest.fixture(autouse=True)
def _clean_masks():
    for mod in (pasp, rasp):
        mod.reset_excluded_layers()
        mod._masks.clear()
    yield
    for mod in (pasp, rasp):
        mod.reset_excluded_layers()
        mod._masks.clear()


@pytest.mark.parametrize("shape,axis,n,m", [((16, 12), 0, 2, 4),
                                            ((8, 8, 3, 3), 1, 2, 4),
                                            ((24, 5), 0, 1, 8)])
def test_masks_equal_the_reference(shape, axis, n, m):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w[0, :] = 0.5  # ties inside groups
    got = pasp.compute_nm_mask(torch.from_numpy(w), n, m, axis=axis)
    want = rasp.compute_nm_mask(w, n, m, axis=axis)
    np.testing.assert_array_equal(got, want)
    assert pasp.check_sparsity(w * got, n, m, axis=axis)
    assert not pasp.check_sparsity(w, n, m, axis=axis)


def _pair(seed=0):
    pt.seed(seed)

    def build(nn):
        return nn.Sequential(nn.Linear(16, 32), nn.ReLU(),
                             nn.Linear(32, 8), nn.ReLU(), nn.Linear(8, 3))

    ref, port = build(pt.nn), build(ptt.nn)
    load_reference_params(port, {k: np.asarray(p.value)
                                 for k, p in ref.named_parameters()})
    return ref, port


def test_prune_model_with_excluded_layers_matches_reference():
    ref, port = _pair()
    rasp.set_excluded_layers([ref[2].weight.name])
    pasp.set_excluded_layers([port[2].weight.param_name])
    want = rasp.prune_model(ref)
    got = pasp.prune_model(port)
    # layer 0 pruned; layer 2 excluded; layer 4 (in 8) pruned
    assert len(got) == len(want) == 2
    for (gk, g), (wk, w) in zip(got.items(), want.items()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port[0].weight.detach().numpy(),
                                  np.asarray(ref[0].weight.value))
    assert pasp.check_sparsity(port[0].weight)
    assert not pasp.check_sparsity(port[2].weight)


def _batches():
    rng = np.random.RandomState(1)
    return (rng.randn(64, 16).astype(np.float32),
            rng.randint(0, 3, 64).astype(np.int64))


def test_eager_step_keeps_the_pattern_in_both():
    ref, port = _pair()
    rasp.prune_model(ref)
    pasp.prune_model(port)
    ropt = rasp.decorate(pt.optimizer.Adam(0.01,
                                           parameters=ref.parameters()))
    popt = pasp.decorate(ptt.optimizer.Adam(0.01,
                                            parameters=port.parameters()))
    x, y = _batches()
    for i in range(3):
        loss = pt.nn.functional.cross_entropy(ref(pt.to_tensor(x)),
                                              pt.to_tensor(y))
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        out = port(torch.from_numpy(x))
        ptt.nn.functional.cross_entropy(out, torch.from_numpy(y)).backward()
        popt.step()
        popt.clear_grad()
    assert rasp.check_sparsity(np.asarray(ref[0].weight.value))
    assert pasp.check_sparsity(port[0].weight)
    np.testing.assert_allclose(port[0].weight.detach().numpy(),
                               np.asarray(ref[0].weight.value), rtol=1e-4,
                               atol=1e-6)


def test_fit_keeps_the_pattern_where_the_reference_loses_it():
    ref, port = _pair()
    rasp.prune_model(ref)
    pasp.prune_model(port)
    x, y = _batches()
    rm = pt.Model(ref)
    rm.prepare(rasp.decorate(pt.optimizer.Adam(
        0.01, parameters=ref.parameters())), pt.nn.CrossEntropyLoss())
    rm.fit((x, y), batch_size=16, verbose=0, shuffle=False)
    pm = ptt.Model(port, device="cpu")
    pm.prepare(pasp.decorate(ptt.optimizer.Adam(
        0.01, parameters=port.parameters())), ptt.nn.CrossEntropyLoss())
    pm.fit((x, y), batch_size=16, verbose=0, shuffle=False)
    # the reference: _functional_step reaches the inner optimizer
    assert not rasp.check_sparsity(np.asarray(ref[0].weight.value))
    assert pasp.check_sparsity(port[0].weight)
    assert pasp.check_sparsity(port[4].weight)

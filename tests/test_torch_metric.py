"""``metric`` of the port against the reference's on the same arrays:
``Accuracy`` (top-1 and top-k, a [N, 1] label), ``Precision``,
``Recall``, ``Auc`` (scores and [N, 2] probabilities) over several
``update`` calls, and the functional ``accuracy`` with ties (both rank a
tie to the lower index).  Values equal (the same numpy arithmetic;
``accuracy`` within 1e-7).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt

from paddle_tpu_torch import metric as pm


def _batches(n_batches=3, n=40, classes=7, seed=0):
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        yield (rng.randn(n, classes).astype(np.float32),
               rng.randint(0, classes, (n, 1)).astype(np.int64))


@pytest.mark.parametrize("topk", [1, (1, 3, 5)])
def test_accuracy_matches_reference(topk):
    got, want = pm.Accuracy(topk=topk), pt.metric.Accuracy(topk=topk)
    for pred, label in _batches():
        r1 = got.update(got.compute(torch.from_numpy(pred),
                                    torch.from_numpy(label)))
        r2 = want.update(want.compute(pt.to_tensor(pred),
                                      pt.to_tensor(label)))
        assert r1 == r2
    assert got.accumulate() == want.accumulate()
    assert got.name() == want.name()
    got.reset()
    assert got.accumulate() == 0.0 or got.accumulate() == [0.0] * 3


def test_precision_recall_auc_match_reference():
    rng = np.random.RandomState(1)
    pairs = [(pm.Precision(), pt.metric.Precision()),
             (pm.Recall(), pt.metric.Recall()),
             (pm.Auc(), pt.metric.Auc()),
             (pm.Auc(num_thresholds=255), pt.metric.Auc(num_thresholds=255))]
    for _ in range(3):
        scores = rng.rand(64).astype(np.float32)
        labels = rng.randint(0, 2, 64).astype(np.int64)
        probs = np.stack([1 - scores, scores], axis=1)
        for i, (got, want) in enumerate(pairs):
            p = probs if i == 2 else scores
            got.update(torch.from_numpy(p), torch.from_numpy(labels))
            want.update(pt.to_tensor(p), pt.to_tensor(labels))
    for got, want in pairs:
        assert got.accumulate() == want.accumulate()
        assert got.name() == want.name()
    assert 0.3 < pairs[2][0].accumulate() < 0.7


def test_functional_accuracy_ranks_ties_to_the_lower_index():
    pred = np.array([[0.5, 0.5, 0.1], [0.2, 0.9, 0.9], [1.0, 1.0, 1.0],
                     [0.0, 0.3, 0.3]], np.float32)
    label = np.array([1, 2, 0, 2], np.int64)
    for k in (1, 2):
        got = float(pm.accuracy(torch.from_numpy(pred),
                                torch.from_numpy(label), k=k))
        want = float(np.asarray(pt.metric.accuracy(
            pt.to_tensor(pred), pt.to_tensor(label), k=k).value))
        assert abs(got - want) <= 1e-7
    assert float(pm.accuracy(torch.from_numpy(pred),
                             torch.from_numpy(label), k=1)) == 0.25

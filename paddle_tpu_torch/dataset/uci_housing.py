"""Legacy UCI housing readers (``paddle.dataset.uci_housing``).

Reference: ``python/paddle/dataset/uci_housing.py:69-135``. Samples are
(13 mean-centered range-normalized float features, [price]); the split is
the reference's first-80%/last-20% cut with normalization statistics from
the FULL file. Place ``housing.data`` in ``DATA_HOME/uci_housing/``.
Deprecated in favor of ``paddle_tpu_torch.text.datasets.UCIHousing``.
"""
from __future__ import annotations

import numpy as np

from . import common

__all__ = []

_cache = {}


def load_data(filename, feature_num=14, ratio=0.8):
    if "train" in _cache:
        return
    data = np.fromfile(filename, sep=" ")
    data = data.reshape(data.shape[0] // feature_num, feature_num)
    maximums, minimums = data.max(axis=0), data.min(axis=0)
    avgs = data.mean(axis=0)
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    _cache["train"], _cache["test"] = data[:offset], data[offset:]


def feature_range(maximums, minimums):
    # the reference plots the ranges with matplotlib (uci_housing.py:48);
    # here it just returns them
    return list(zip(minimums, maximums))


def _split(mode):
    load_data(common.local_path("uci_housing", "housing.data"))

    def reader():
        for d in _cache[mode]:
            yield d[:-1], d[-1:]

    return reader


def train():
    """Reader creator over the normalized 80% train cut."""
    return _split("train")


def test():
    """Reader creator over the normalized 20% test cut."""
    return _split("test")


def fetch():
    common.local_path("uci_housing", "housing.data")

"""Legacy CIFAR readers (``paddle.dataset.cifar``).

Reference: ``python/paddle/dataset/cifar.py:49-165``. Samples are
(flattened 3072 float32 pixels in [0, 1], int label). Deprecated in
favor of ``paddle_tpu_torch.vision.datasets.Cifar10/Cifar100`` (whose tar
parser this delegates to); archives go in ``DATA_HOME/cifar/`` as
``cifar-10-python.tar.gz`` / ``cifar-100-python.tar.gz``.
"""
from __future__ import annotations

from . import common

__all__ = []


def _reader(kind, mode, cycle=False):
    from ..vision import datasets as vd

    cls = vd.Cifar10 if kind == 10 else vd.Cifar100
    path = common.local_path(
        "cifar", "cifar-%d-python.tar.gz" % kind)

    def reader():
        ds = cls(data_file=path, mode=mode)
        while True:
            # ds.data is the raw [N, 3, 32, 32] uint8 tensor; the legacy
            # sample is the CHW-ordered 3072-row (R then G then B planes),
            # NOT the HWC image __getitem__ serves to transforms
            for raw, label in zip(ds.data, ds.labels):
                yield raw.reshape(-1).astype("float32") / 255.0, int(label)
            if not cycle:
                break

    return reader


def train10(cycle=False):
    """CIFAR-10 train reader creator ([0, 1] pixels, label in [0, 9])."""
    return _reader(10, "train", cycle)


def test10(cycle=False):
    """CIFAR-10 test reader creator."""
    return _reader(10, "test", cycle)


def train100():
    """CIFAR-100 train reader creator (label in [0, 99])."""
    return _reader(100, "train")


def test100():
    """CIFAR-100 test reader creator."""
    return _reader(100, "test")


def fetch():
    common.local_path("cifar", "cifar-10-python.tar.gz")
    common.local_path("cifar", "cifar-100-python.tar.gz")

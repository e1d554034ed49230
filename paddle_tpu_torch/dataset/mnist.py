"""Legacy MNIST readers (``paddle.dataset.mnist``).

Reference: ``python/paddle/dataset/mnist.py:43-140``. Samples are
(flattened 784 float32 pixels in [-1, 1], int label). Deprecated in
favor of ``paddle_tpu_torch.vision.datasets.MNIST`` (whose IDX parser this
delegates to); archives go in ``DATA_HOME/mnist/`` under their standard
names (``train-images-idx3-ubyte.gz`` etc.).
"""
from __future__ import annotations

import numpy as np

from . import common

__all__ = []

_FILES = {
    "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
    "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
}


def reader_creator(image_filename, label_filename, buffer_size=100):
    from ..vision.datasets import _read_idx_images, _read_idx_labels

    def reader():
        images = _read_idx_images(image_filename)
        labels = _read_idx_labels(label_filename)
        flat = images.reshape(len(images), -1).astype("float32")
        flat = flat / 255.0 * 2.0 - 1.0
        for img, label in zip(flat, labels):
            yield img, int(label)

    return reader


def _split(mode):
    img, lab = _FILES[mode]
    return reader_creator(common.local_path("mnist", img),
                          common.local_path("mnist", lab))


def train():
    """Reader creator over the training split ([-1, 1] pixels, int label)."""
    return _split("train")


def test():
    """Reader creator over the test split ([-1, 1] pixels, int label)."""
    return _split("test")


def fetch():
    for img, lab in _FILES.values():
        common.local_path("mnist", img)
        common.local_path("mnist", lab)

"""Legacy VOC2012 segmentation readers (``paddle.dataset.voc2012``).

Reference: ``python/paddle/dataset/voc2012.py:44-110`` — note its split
quirk is intentional: ``train()`` reads the 2913-image trainval list,
``test()`` the 1464-image train list, ``val()`` the val list. Delegates
to ``paddle_tpu_torch.vision.datasets.VOC2012`` (which keeps the same mapping).
Place ``VOCtrainval_11-May-2012.tar`` in ``DATA_HOME/voc2012/``.
"""
from __future__ import annotations

import numpy as np

from . import common

__all__ = []


def _reader(mode):
    from ..vision.datasets import VOC2012

    path = common.local_path("voc2012", "VOCtrainval_11-May-2012.tar")

    def reader():
        ds = VOC2012(data_file=path, mode=mode)
        for img, label in ds:
            yield np.asarray(img), np.asarray(label)

    return reader


def train():
    """Reader over the 2913-image trainval list (HWC uint8, label mask)."""
    return _reader("train")


def test():
    """Reader over the 1464-image train list (the reference's mapping)."""
    return _reader("test")


def val():
    """Reader over the 1449-image val list."""
    return _reader("valid")


def fetch():
    common.local_path("voc2012", "VOCtrainval_11-May-2012.tar")

"""Legacy Flowers-102 readers (``paddle.dataset.flowers``).

Reference: ``python/paddle/dataset/flowers.py:85-240``. Delegates to
``paddle_tpu_torch.vision.datasets.Flowers``; the legacy mapper/xmap options
are honored via ``paddle_tpu_torch.reader`` decorators. Conventional files in
``DATA_HOME/flowers/``: ``102flowers.tgz``, ``imagelabels.mat``,
``setid.mat``.
"""
from __future__ import annotations

import numpy as np

from . import common
from .. import reader as reader_mod

__all__ = []


def default_mapper(is_train, sample):
    """The reference resizes short side to 256 then crops 224 (random for
    train, center for test) via its image module; same here."""
    from . import image

    img, label = sample
    img = image.simple_transform(np.asarray(img), 256, 224, is_train)
    return img.flatten().astype("float32"), label


train_mapper = lambda sample: default_mapper(True, sample)  # noqa: E731
test_mapper = lambda sample: default_mapper(False, sample)  # noqa: E731


def reader_creator(data_file, label_file, setid_file, dataset_name,
                   mapper, buffered_size=1024, use_xmap=True, cycle=False):
    from ..vision.datasets import Flowers

    mode = {"trnid": "train", "tstid": "test", "valid": "valid"}[dataset_name]

    def base():
        ds = Flowers(data_file=data_file, label_file=label_file,
                     setid_file=setid_file, mode=mode)
        while True:
            for img, label in ds:
                yield np.asarray(img), int(label)
            if not cycle:
                break

    if mapper is None:
        return base
    if use_xmap:
        return reader_mod.xmap_readers(mapper, base, 4, buffered_size)
    return reader_mod.map_readers(mapper, base)


def _files():
    return (common.local_path("flowers", "102flowers.tgz"),
            common.local_path("flowers", "imagelabels.mat"),
            common.local_path("flowers", "setid.mat"))


def train(mapper=train_mapper, buffered_size=1024, use_xmap=True,
          cycle=False):
    """Train reader creator (flattened transformed pixels, label)."""
    d, l, s = _files()
    return reader_creator(d, l, s, "trnid", mapper, buffered_size, use_xmap,
                          cycle)


def test(mapper=test_mapper, buffered_size=1024, use_xmap=True, cycle=False):
    """Test reader creator."""
    d, l, s = _files()
    return reader_creator(d, l, s, "tstid", mapper, buffered_size, use_xmap,
                          cycle)


def valid(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    """Validation reader creator."""
    d, l, s = _files()
    return reader_creator(d, l, s, "valid", mapper, buffered_size, use_xmap)


def fetch():
    _files()

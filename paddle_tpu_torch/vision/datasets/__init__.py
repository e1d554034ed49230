"""``paddle_tpu_torch.vision.datasets`` — standard vision datasets.

A copy of the reference's ``vision/datasets/`` (paddle's
``python/paddle/vision/datasets/``: mnist.py, cifar.py).
This build has no network egress, so ``download=True`` raises with
instructions; local files parse with the standard formats (IDX for MNIST,
the python-pickle batches for CIFAR).
"""
from __future__ import annotations

import gzip
import os
import pickle
import tarfile
from typing import Callable, Optional

import numpy as np

from ...core.errors import InvalidArgumentError
from ...io import Dataset

__all__ = [
    "MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers", "VOC2012",
    "DatasetFolder", "ImageFolder",
]


def _no_download(name: str):
    raise InvalidArgumentError(
        "%s: download=True is unavailable in this no-egress build; place the "
        "standard files locally and pass image_path/label_path (MNIST) or "
        "data_file (CIFAR)" % name)


def _read_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    if magic != 2051:
        raise InvalidArgumentError("bad IDX image magic %d in %s" % (magic, path))
    n = int.from_bytes(data[4:8], "big")
    rows = int.from_bytes(data[8:12], "big")
    cols = int.from_bytes(data[12:16], "big")
    return np.frombuffer(data, np.uint8, offset=16).reshape(n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    if magic != 2049:
        raise InvalidArgumentError("bad IDX label magic %d in %s" % (magic, path))
    return np.frombuffer(data, np.uint8, offset=8)


class MNIST(Dataset):
    """vision/datasets/mnist.py parity (IDX file format)."""

    NAME = "MNIST"

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 backend: str = "cv2"):
        if image_path is None or label_path is None:
            if download:
                _no_download(self.NAME)
            raise InvalidArgumentError(
                "%s needs image_path= and label_path= (no-egress build)"
                % self.NAME)
        self.mode = mode
        self.transform = transform
        self.images = _read_idx_images(image_path)
        self.labels = _read_idx_labels(label_path)
        if len(self.images) != len(self.labels):
            raise InvalidArgumentError(
                "image/label count mismatch: %d vs %d"
                % (len(self.images), len(self.labels)))

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = np.asarray([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class FashionMNIST(MNIST):
    NAME = "FashionMNIST"


class _CifarBase(Dataset):
    """vision/datasets/cifar.py parity (tar.gz of pickle batches)."""

    NAME = "Cifar"
    _train_members: tuple = ()
    _test_members: tuple = ()
    _label_key = b"labels"

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 backend: str = "cv2"):
        if data_file is None:
            if download:
                _no_download(self.NAME)
            raise InvalidArgumentError(
                "%s needs data_file= (no-egress build)" % self.NAME)
        if mode not in ("train", "test"):
            raise InvalidArgumentError(
                "%s mode must be 'train' or 'test', got %r" % (self.NAME, mode))
        self.mode = mode
        self.transform = transform
        members = self._train_members if mode == "train" else self._test_members
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tar:
            names = {os.path.basename(m.name): m for m in tar.getmembers()}
            for want in members:
                if want not in names:
                    raise InvalidArgumentError(
                        "%s member %r missing from %s" % (self.NAME, want, data_file))
                batch = pickle.loads(tar.extractfile(names[want]).read(),
                                     encoding="bytes")
                images.append(np.asarray(batch[b"data"], np.uint8))
                labels.extend(batch[self._label_key])
        self.data = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        img = self.data[idx].transpose(1, 2, 0)  # HWC for transforms
        label = np.asarray([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class Cifar10(_CifarBase):
    NAME = "Cifar10"
    _train_members = tuple("data_batch_%d" % i for i in range(1, 6))
    _test_members = ("test_batch",)
    _label_key = b"labels"


class Cifar100(_CifarBase):
    NAME = "Cifar100"
    _train_members = ("train",)
    _test_members = ("test",)
    _label_key = b"fine_labels"


from .flowers import Flowers  # noqa: E402,F401
from .folder import DatasetFolder, ImageFolder  # noqa: E402,F401
from .voc2012 import VOC2012  # noqa: E402,F401

"""Flowers-102 dataset (reference: python/paddle/vision/datasets/flowers.py).

Reads images straight out of the tgz member stream instead of extracting
the archive to disk (the reference unpacks 330MB next to the tarball);
labels/split indices come from the standard scipy ``.mat`` files.
"""
from __future__ import annotations

import io
import tarfile
from typing import Callable, Optional

import numpy as np

from ...core.errors import InvalidArgumentError
from ...io import Dataset

__all__ = ["Flowers"]

# reference flowers.py:37: tstid is the (larger) train split's flag upstream
MODE_FLAG_MAP = {"train": "tstid", "test": "trnid", "valid": "valid"}


class Flowers(Dataset):
    """flowers.py:77 parity: (image HWC uint8, label int64[1]) pairs."""

    def __init__(self, data_file: Optional[str] = None,
                 label_file: Optional[str] = None,
                 setid_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None,
                 download: bool = False, backend: str = "cv2"):
        if mode.lower() not in MODE_FLAG_MAP:
            raise InvalidArgumentError(
                "mode must be one of %s, got %r"
                % (sorted(MODE_FLAG_MAP), mode))
        if not (data_file and label_file and setid_file):
            raise InvalidArgumentError(
                "Flowers needs data_file=, label_file= and setid_file= "
                "(no-egress build: download=True unavailable)")
        self.transform = transform
        self.mode = mode.lower()

        import scipy.io as scio

        self.labels = scio.loadmat(label_file)["labels"][0]
        self.indexes = scio.loadmat(setid_file)[MODE_FLAG_MAP[self.mode]][0]
        self._data_file = data_file
        self._tar_cache = None  # (pid, TarFile, members) — see _archive
        with tarfile.open(data_file) as tar:
            self._names = set(m.name for m in tar.getmembers())

    def _archive(self):
        """Per-process tar handle: forked DataLoader workers must not share
        one file descriptor's offset (reads would interleave)."""
        import os

        pid = os.getpid()
        if self._tar_cache is None or self._tar_cache[0] != pid:
            tar = tarfile.open(self._data_file)
            self._tar_cache = (pid, tar, {m.name: m for m in tar.getmembers()})
        return self._tar_cache[1], self._tar_cache[2]

    def __getitem__(self, idx: int):
        index = int(self.indexes[idx])
        label = np.array([self.labels[index - 1]], dtype="int64")
        name = "jpg/image_%05d.jpg" % index
        if name not in self._names:
            raise InvalidArgumentError(
                "member %s missing from flowers archive" % name)
        from PIL import Image

        tar, members = self._archive()
        raw = tar.extractfile(members[name]).read()
        image = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        if self.transform is not None:
            image = self.transform(image)
        return image, label

    def __len__(self):
        return len(self.indexes)

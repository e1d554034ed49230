"""VOC2012 segmentation dataset (reference:
python/paddle/vision/datasets/voc2012.py).

Streams (image, segmentation-mask) pairs from the VOCtrainval tar without
extracting it; masks keep their palette indices as uint8 class ids.
"""
from __future__ import annotations

import io
import tarfile
from typing import Callable, Optional

import numpy as np

from ...core.errors import InvalidArgumentError
from ...io import Dataset

__all__ = ["VOC2012"]

SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
# Reference voc2012.py:85 maps train->trainval (2913 imgs), test->train,
# valid->val; matching it exactly so ported code sees the same splits.
MODE_FLAG_MAP = {"train": "trainval", "test": "train", "valid": "val"}


class VOC2012(Dataset):
    """voc2012.py:89 parity: (image HWC uint8, mask HW uint8) pairs."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform: Optional[Callable] = None,
                 download: bool = False, backend: str = "cv2"):
        if mode.lower() not in MODE_FLAG_MAP:
            raise InvalidArgumentError(
                "mode must be one of %s, got %r"
                % (sorted(MODE_FLAG_MAP), mode))
        if not data_file:
            raise InvalidArgumentError(
                "VOC2012 needs data_file= (no-egress build: download=True "
                "unavailable)")
        self.transform = transform
        self.flag = MODE_FLAG_MAP[mode.lower()]
        self._data_file = data_file
        self._tar_cache = None  # (pid, TarFile, members) — see _archive
        set_name = SET_FILE.format(self.flag)
        with tarfile.open(data_file) as tar:
            members = {m.name: m for m in tar.getmembers()}
            if set_name not in members:
                raise InvalidArgumentError(
                    "split file %s missing from archive" % set_name)
            names = tar.extractfile(members[set_name]).read()
        self.data = []
        self.labels = []
        for line in names.decode("utf-8").splitlines():
            line = line.strip()
            if line:
                self.data.append(DATA_FILE.format(line))
                self.labels.append(LABEL_FILE.format(line))

    def _archive(self):
        """Per-process tar handle: forked DataLoader workers must not share
        one file descriptor's offset (reads would interleave)."""
        import os

        pid = os.getpid()
        if self._tar_cache is None or self._tar_cache[0] != pid:
            tar = tarfile.open(self._data_file)
            self._tar_cache = (pid, tar, {m.name: m for m in tar.getmembers()})
        return self._tar_cache[1], self._tar_cache[2]

    def _read_image(self, name: str, mode: Optional[str] = None):
        from PIL import Image

        tar, members = self._archive()
        raw = tar.extractfile(members[name]).read()
        img = Image.open(io.BytesIO(raw))
        if mode is not None:
            img = img.convert(mode)
        return np.asarray(img)

    def __getitem__(self, idx: int):
        image = self._read_image(self.data[idx], "RGB")
        label = self._read_image(self.labels[idx])  # palette ids as classes
        if self.transform is not None:
            image = self.transform(image)
        return image, label

    def __len__(self):
        return len(self.data)

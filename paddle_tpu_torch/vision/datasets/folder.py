"""Directory-tree datasets (a copy of the reference's
``vision/datasets/folder.py``; paddle's ``vision/datasets/folder.py``
— ``DatasetFolder:65``, ``ImageFolder:222``).

Images decode to HWC uint8 numpy arrays (the transforms' native layout)
rather than PIL handles: ``vision.transforms`` works on numpy arrays.
``.npy`` files are accepted alongside the standard image extensions so
synthetic datasets can be laid out without an image codec.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ...core.errors import InvalidArgumentError
from ...io import Dataset

__all__ = ["DatasetFolder", "ImageFolder", "has_valid_extension",
           "make_dataset", "default_loader"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp", ".npy")


def has_valid_extension(filename: str, extensions: Sequence[str]) -> bool:
    """folder.py:26 parity."""
    if not isinstance(extensions, (list, tuple)):
        raise InvalidArgumentError("`extensions` must be list or tuple")
    return filename.lower().endswith(tuple(x.lower() for x in extensions))


def default_loader(path: str) -> np.ndarray:
    """Decode one sample file to an HWC uint8 array (npy passes through)."""
    if path.lower().endswith(".npy"):
        return np.load(path)
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def make_dataset(directory: str, class_to_idx: dict, extensions=None,
                 is_valid_file: Optional[Callable] = None
                 ) -> List[Tuple[str, int]]:
    """folder.py:42 parity: walk class subdirs, collect (path, class_idx)."""
    directory = os.path.expanduser(directory)
    if (extensions is None) == (is_valid_file is None):
        raise InvalidArgumentError(
            "pass exactly one of extensions= / is_valid_file=")
    if extensions is not None:
        def is_valid_file(x):
            return has_valid_extension(x, extensions)
    samples = []
    for target in sorted(class_to_idx):
        d = os.path.join(directory, target)
        if not os.path.isdir(d):
            continue
        for root, _, fnames in sorted(os.walk(d, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if is_valid_file(path):
                    samples.append((path, class_to_idx[target]))
    return samples


class DatasetFolder(Dataset):
    """folder.py:65 parity: root/class_x/sample.ext layout → (img, label)."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions=None, transform: Optional[Callable] = None,
                 is_valid_file: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.loader = loader or default_loader
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        classes, class_to_idx = self._find_classes(root)
        samples = make_dataset(root, class_to_idx, extensions, is_valid_file)
        if not samples:
            raise InvalidArgumentError(
                "found 0 files in subfolders of %s (extensions: %s)"
                % (root, extensions))
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [s[1] for s in samples]

    @staticmethod
    def _find_classes(directory: str):
        classes = sorted(e.name for e in os.scandir(directory) if e.is_dir())
        if not classes:
            raise InvalidArgumentError(
                "no class subdirectories under %s" % directory)
        return classes, {c: i for i, c in enumerate(classes)}

    def __getitem__(self, index: int):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """folder.py:222 parity: flat (recursive) image list → [img]."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions=None, transform: Optional[Callable] = None,
                 is_valid_file: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.loader = loader or default_loader
        if extensions is None and is_valid_file is None:
            extensions = IMG_EXTENSIONS
        if extensions is not None and is_valid_file is None:
            def is_valid_file(x):
                return has_valid_extension(x, extensions)
        samples = []
        for r, _, fnames in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(r, fname)
                if is_valid_file(path):
                    samples.append(path)
        if not samples:
            raise InvalidArgumentError("found 0 files under %s" % root)
        self.samples = samples

    def __getitem__(self, index: int):
        sample = self.loader(self.samples[index])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)

"""Shared plumbing for the legacy ``paddle.dataset`` namespace.

A copy of the reference's ``dataset/common.py`` (paddle's
``python/paddle/dataset/common.py:41-230``). The one semantic change: the
package fetches nothing, so ``download`` verifies a pre-placed file — every dataset documents the
conventional location under ``DATA_HOME`` where its standard archive
must be put (the same layout the reference's downloader produces).
"""
from __future__ import annotations

import glob
import hashlib
import os
import pickle

from ..core.errors import InvalidArgumentError

__all__ = []

# the root the datasets are looked up under; ``$PADDLE_DATA_HOME`` or this
# attribute redirects it
DATA_HOME = os.environ.get("PADDLE_DATA_HOME") or os.path.expanduser(
    os.path.join("~", ".cache", "paddle", "dataset"))


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Resolve the conventional local path for a dataset file.

    The reference fetches ``url`` into ``DATA_HOME/module_name`` and
    md5-verifies it (``common.py:62``). Zero-egress build: the file must
    already be there (md5 is checked when given); otherwise this raises
    with the exact path to place it at.
    """
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name if save_name else url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise InvalidArgumentError(
                "%s exists but fails md5 verification (want %s)"
                % (filename, md5sum))
        return filename
    raise InvalidArgumentError(
        "no-egress build cannot download %s; place the file at %s"
        % (url, filename))


def local_path(module_name, filename, hint=""):
    """``DATA_HOME/module_name/filename`` if present, else a helpful error."""
    path = os.path.join(DATA_HOME, module_name, filename)
    if os.path.exists(path):
        return path
    raise InvalidArgumentError(
        "paddle.dataset.%s: expected %s%s (no-egress build; place the "
        "standard archive there)" % (module_name, path,
                                     " — " + hint if hint else ""))


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Shard a reader's output into pickle files of ``line_count`` samples."""
    if not callable(reader):
        raise TypeError("reader should be callable")
    lines = []
    index = 0
    for item in reader():
        lines.append(item)
        if len(lines) >= line_count:
            with open(suffix % index, "wb") as f:
                dumper(lines, f)
            lines = []
            index += 1
    if lines:
        with open(suffix % index, "wb") as f:
            dumper(lines, f)
        index += 1
    return index


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Read this trainer's shard (round-robin by file) of pickled sample
    files produced by :func:`split`."""

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, fname in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(fname, "rb") as f:
                    for item in loader(f):
                        yield item

    return reader

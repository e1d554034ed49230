"""Pretrained-weight / archive path resolution (``paddle.utils.download``).

Reference: ``python/paddle/utils/download.py:66-265``. Zero-egress
build: instead of fetching, these resolve the CONVENTIONAL cache path
the reference's downloader would have produced (``~/.cache/paddle/hapi/
weights`` for weights) and, when the file is already there, md5-verify
and optionally decompress it exactly like the reference; a cache miss
raises with the precise path to place the file at.
"""
from __future__ import annotations

import hashlib
import os
import os.path as osp
import tarfile
import zipfile

from ..core.errors import InvalidArgumentError

__all__ = ["get_weights_path_from_url"]

# ``$PADDLE_WEIGHTS_HOME`` or this attribute redirects the weights cache
WEIGHTS_HOME = os.environ.get("PADDLE_WEIGHTS_HOME") or osp.expanduser(
    osp.join("~", ".cache", "paddle", "hapi", "weights"))


def is_url(path) -> bool:
    """True for http/https locations (``download.py:66``)."""
    return isinstance(path, str) and path.startswith(("http://", "https://"))


def _md5check(fullname, md5sum=None) -> bool:
    if md5sum is None:
        return True
    h = hashlib.md5()
    with open(fullname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == md5sum


def _extraction_plan(fullpath: str, names):
    """(target_root, extract_into) for an archive's contents.

    Single shared top-level directory (the reference's
    ``_is_a_single_dir`` case) → that directory, extracting beside the
    archive; anything else (flat files, multiple roots, ``./``-prefixed
    members) → a directory named after the archive stem, extracting INTO
    it — so the returned root is always a real extraction root, never
    the cache root or the archive itself."""
    parent = osp.dirname(fullpath)

    def _strip_dot_slash(n):
        # strip only literal leading "./" prefixes: lstrip("./") strips a
        # character SET and would mangle names like "..data/x"
        while n.startswith("./"):
            n = n[2:]
        return n

    clean = [s for s in (_strip_dot_slash(n) for n in names) if s]
    roots = {n.split("/")[0] for n in clean}
    if len(roots) == 1 and all("/" in n for n in clean):
        target = osp.join(parent, next(iter(roots)))
        return target, parent
    stem = osp.basename(fullpath)
    for suf in (".tar.gz", ".tgz", ".tar", ".zip", ".gz"):
        if stem.endswith(suf):
            stem = stem[:-len(suf)]
            break
    target = osp.join(parent, stem)
    return target, target


def _decompress(fullpath: str) -> str:
    """Unpack a tar/zip once; re-calls short-circuit when the extracted
    root already exists (the reference's run-once behavior)."""
    if tarfile.is_tarfile(fullpath):
        with tarfile.open(fullpath) as tf:
            target, into = _extraction_plan(fullpath, tf.getnames())
            if not osp.exists(target):
                tf.extractall(into, filter="data")
    elif zipfile.is_zipfile(fullpath):
        with zipfile.ZipFile(fullpath) as zf:
            target, into = _extraction_plan(fullpath, zf.namelist())
            if not osp.exists(target):
                zf.extractall(into)
    else:
        return fullpath
    return target


def get_path_from_url(url, root_dir, md5sum=None, check_exist=True,
                      decompress=True, method="get"):
    """Resolve ``url`` to its conventional path under ``root_dir``.

    The file must already be there (no-egress build); it is ALWAYS
    md5-verified when ``md5sum`` is given (``check_exist=False`` — the
    reference's force-redownload mode — cannot re-fetch here, so it
    degrades to the same verify), and tar/zip archives are decompressed
    once, matching ``download.py:121``'s post-download behavior.
    """
    if not is_url(url):
        raise InvalidArgumentError("downloading from %r: not a url" % url)
    fullpath = osp.join(root_dir, url.split("/")[-1])
    if not osp.exists(fullpath):
        raise InvalidArgumentError(
            "no-egress build cannot download %s; place the file at %s"
            % (url, fullpath))
    if not _md5check(fullpath, md5sum):
        raise InvalidArgumentError(
            "%s exists but fails md5 verification (want %s)"
            % (fullpath, md5sum))
    if decompress and (tarfile.is_tarfile(fullpath)
                       or zipfile.is_zipfile(fullpath)):
        fullpath = _decompress(fullpath)
    return fullpath


def get_weights_path_from_url(url, md5sum=None):
    """Conventional local path of a pretrained-weights url
    (``download.py:75``); the file must be pre-placed under
    ``~/.cache/paddle/hapi/weights``."""
    os.makedirs(WEIGHTS_HOME, exist_ok=True)
    return get_path_from_url(url, WEIGHTS_HOME, md5sum)

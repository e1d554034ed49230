"""Filesystem helpers (a copy of the reference's
``distributed/fleet/utils/fs.py``; paddle's fleet/utils/fs.py FS/LocalFS:119,
HDFSClient) and DistributedInfer.

LocalFS is a full implementation over the standard library; HDFSClient
keeps the API surface but raises on use (no Hadoop runtime here: point
checkpoints at local disk or a mounted path instead)."""
from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

from ....core.errors import InvalidArgumentError

__all__ = ["FS", "LocalFS", "HDFSClient", "DistributedInfer"]


class FS:
    """Abstract file-system interface (fs.py FS parity)."""

    def ls_dir(self, path):  # pragma: no cover - interface
        raise NotImplementedError

    def is_file(self, path):  # pragma: no cover - interface
        raise NotImplementedError

    def is_dir(self, path):  # pragma: no cover - interface
        raise NotImplementedError

    def is_exist(self, path):  # pragma: no cover - interface
        raise NotImplementedError


class LocalFS(FS):
    """fs.py:119 parity over the standard library."""

    def ls_dir(self, path: str) -> Tuple[List[str], List[str]]:
        """Returns (dirs, files) directly under ``path``."""
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for entry in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, entry))
             else files).append(entry)
        return dirs, files

    def list_dirs(self, path: str) -> List[str]:
        return self.ls_dir(path)[0]

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def rename(self, src: str, dst: str) -> None:
        os.rename(src, dst)

    mv = rename

    def delete(self, path: str) -> None:
        if self.is_dir(path):
            shutil.rmtree(path)
        elif self.is_file(path):
            os.remove(path)

    def need_upload_download(self) -> bool:
        return False

    def is_file(self, path: str) -> bool:
        return os.path.isfile(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def is_exist(self, path: str) -> bool:
        return os.path.exists(path)

    def touch(self, path: str, exist_ok: bool = True) -> None:
        if self.is_exist(path):
            if not exist_ok:
                raise InvalidArgumentError("%s already exists" % path)
            return
        with open(path, "a"):
            pass

    def cat(self, path: str) -> str:
        with open(path) as f:
            return f.read()


_HDFS_MSG = ("HDFSClient is unavailable (no Hadoop runtime); use "
             "LocalFS or a mounted object store path")


class HDFSClient(FS):
    """fs.py HDFSClient surface; no Hadoop runtime on this stack."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None,
                 time_out: int = 300000, sleep_inter: int = 1000):
        pass

    def _unavailable(self, *a, **k):
        raise InvalidArgumentError(_HDFS_MSG)

    # the full FS surface raises the explanatory error (including the
    # methods FS itself defines, which __getattr__ would never see)
    ls_dir = is_file = is_dir = is_exist = _unavailable
    list_dirs = mkdirs = rename = mv = delete = touch = cat = _unavailable
    upload = download = _unavailable

    def __getattr__(self, name):
        if name.startswith("_"):
            # dunder probes (deepcopy/pickle/hasattr) must miss normally
            raise AttributeError(name)
        return self._unavailable


class DistributedInfer:
    """fleet/utils DistributedInfer (single-controller form): the trained
    global-view model is the inference model, so this reduces to
    bookkeeping over the user's program."""

    def __init__(self, main_program=None, startup_program=None):
        self._main = main_program
        self._startup = startup_program

    def init_distributed_infer_env(self, exe, loss, role_maker=None,
                                   dirname=None):
        if dirname is not None:
            from .... import static

            static.load(self._main or static.default_main_program(),
                        dirname)

    def get_dist_infer_program(self):
        from .... import static

        prog = self._main or static.default_main_program()
        return prog.clone(for_test=True)

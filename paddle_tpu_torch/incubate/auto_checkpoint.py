"""Auto-checkpoint and resume across relaunches (counterpart of the
reference's ``incubate/auto_checkpoint.py``).

:class:`AutoCheckpoint` snapshots registered state (``name -> object``
with ``state_dict``/``set_state_dict``: layers, optimizers) every
``every_n_steps`` steps into a directory (``checkpoint_dir`` or
``$PADDLE_AUTO_CHECKPOINT_DIR``) through ``paddle.save``; a relaunched
run builds the same objects, constructs an ``AutoCheckpoint`` on the same
directory, which restores the newest complete snapshot, and continues
from ``start_step``.  :func:`train_epoch_range` is the epoch-grain
generator: it skips the epochs a previous run finished.

Each snapshot carries the random generators' states
(``get_rng_state``/``get_cuda_rng_state``: the CPU generator and each
card's seed and offset), so dropout after a resume draws what the
uninterrupted run drew.  Each rank marks its snapshot done with a file;
rank 0 publishes, by an atomically replaced marker, the newest serial
every rank finished, and keeps the last two snapshots, so a crash while
saving never destroys the only good one and a corrupt latest snapshot
falls back to the one before.  Ranks come from ``torch.distributed``
(rank 0 of 1 where it is not initialised).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Generator, Optional

from ..core.errors import InvalidArgumentError
from ..core.random import (get_cuda_rng_state, get_rng_state,
                           set_cuda_rng_state, set_rng_state)

__all__ = ["AutoCheckpoint", "train_epoch_range", "ENV_DIR"]

ENV_DIR = "PADDLE_AUTO_CHECKPOINT_DIR"


def _world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AutoCheckpoint:
    """Step- or epoch-grain snapshots of ``state`` in ``checkpoint_dir``
    (see the module's text); resumes on construction."""

    def __init__(self, state: Dict[str, object],
                 checkpoint_dir: Optional[str] = None,
                 name: str = "default", every_n_steps: int = 1):
        checkpoint_dir = checkpoint_dir or os.environ.get(ENV_DIR)
        if not checkpoint_dir:
            raise InvalidArgumentError(
                "AutoCheckpoint needs checkpoint_dir= or $%s" % ENV_DIR)
        if not state:
            raise InvalidArgumentError("state dict must not be empty")
        self.dir = checkpoint_dir
        self.name = name
        self.state = dict(state)
        self.every_n_steps = int(every_n_steps)
        os.makedirs(self.dir, exist_ok=True)
        self._resumed_meta = self._try_resume()

    def _marker_path(self) -> str:
        return os.path.join(self.dir, "%s.marker.json" % self.name)

    def _ckpt_path(self, serial: int) -> str:
        return os.path.join(self.dir, "%s.ckpt.%d" % (self.name, serial))

    def _done_path(self, serial: int, rank: int) -> str:
        return os.path.join(self.dir, "%s.ckpt.%d.rank%d.done"
                            % (self.name, serial, rank))

    def _full_serials(self, world: int):
        """The serials every rank has finished writing."""
        pat = re.compile(r"^%s\.ckpt\.(\d+)\.rank(\d+)\.done$"
                         % re.escape(self.name))
        ranks_by_serial: Dict[int, set] = {}
        for fn in os.listdir(self.dir):
            m = pat.match(fn)
            if m:
                ranks_by_serial.setdefault(int(m.group(1)), set()).add(
                    int(m.group(2)))
        return sorted(s for s, r in ranks_by_serial.items()
                      if len(r) >= world)

    def save(self, meta: Optional[dict] = None,
             serial: Optional[int] = None) -> None:
        """Snapshot every registered object and the generators."""
        from ..framework import io as fio

        prev = self._read_marker()
        serial = int(serial if serial is not None
                     else (prev or {}).get("serial", -1) + 1)
        payload = {k: obj.state_dict() for k, obj in self.state.items()}
        payload["__rng__"] = {"cpu": get_rng_state(),
                              "cuda": get_cuda_rng_state()}
        fio.save(payload, self._ckpt_path(serial))
        rank, world = _world()
        # the done-file carries this serial's meta, so the published
        # serial's meta survives a restart of rank 0
        with open(self._done_path(serial, rank), "w") as f:
            json.dump(meta or {}, f)
        if rank != 0:
            return
        full = self._full_serials(world)
        if not full:
            return
        publish = full[-1]
        if prev is not None and publish == prev.get("serial"):
            return
        try:
            with open(self._done_path(publish, 0)) as f:
                pub_meta = json.load(f)
        except Exception:
            pub_meta = meta or {}
        marker = {"serial": publish, "name": self.name, "meta": pub_meta,
                  "prev_serial": (prev or {}).get("serial"),
                  "prev_meta": (prev or {}).get("meta")}
        tmp = self._marker_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(marker, f)
        os.replace(tmp, self._marker_path())
        self._gc({publish, (prev or {}).get("serial")}, floor=publish)

    def _gc(self, keep, floor: int) -> None:
        """Remove snapshot files except ``keep`` and those newer than
        ``floor`` (another rank may still be writing them)."""
        prefix = "%s.ckpt." % self.name
        for fn in os.listdir(self.dir):
            if not fn.startswith(prefix):
                continue
            try:
                s = int(fn[len(prefix):].split(".")[0])
            except ValueError:
                continue
            if s not in keep and s < floor:
                try:
                    os.remove(os.path.join(self.dir, fn))
                except OSError:
                    pass

    def _read_marker(self) -> Optional[dict]:
        try:
            with open(self._marker_path()) as f:
                return json.load(f)
        except Exception:
            return None

    def _try_resume(self) -> Optional[dict]:
        from ..framework import io as fio

        marker = self._read_marker()
        if marker is None:
            return None
        candidates = [(marker.get("serial"), marker.get("meta")),
                      (marker.get("prev_serial"), marker.get("prev_meta"))]
        apply_errors = []
        for serial, ser_meta in candidates:
            if serial is None:
                continue
            try:
                payload = fio.load(self._ckpt_path(int(serial)))
            except Exception:
                continue  # a half-written latest: fall back
            try:
                rng = payload.pop("__rng__", None)
                for k, obj in self.state.items():
                    sd = payload[k]
                    if isinstance(sd, dict) and not sd:
                        continue  # saved before this object had state
                    obj.set_state_dict(sd)
                if rng is not None:
                    set_rng_state(rng["cpu"])
                    set_cuda_rng_state(rng["cuda"])
            except Exception as e:  # noqa: BLE001
                apply_errors.append("serial %s: %r" % (serial, e))
                continue
            meta = dict(ser_meta or {})
            meta["serial"] = int(serial)
            return meta
        if apply_errors:
            # a snapshot loaded but could not be applied: the state may be
            # half restored, so refuse to train on from it
            raise InvalidArgumentError(
                "auto-checkpoint resume failed to apply any snapshot "
                "(%s); clear %r or fix the state registration to match "
                "what was saved" % ("; ".join(apply_errors), self.dir))
        return None

    @property
    def resumed(self) -> bool:
        return self._resumed_meta is not None

    @property
    def meta(self) -> Optional[dict]:
        """The meta of the snapshot this run resumed from (or None)."""
        return self._resumed_meta

    @property
    def start_step(self) -> int:
        """The first step this run should execute (0 on a fresh start)."""
        if self._resumed_meta is None:
            return 0
        return int(self._resumed_meta.get("step", -1)) + 1

    def after_step(self, step: int, **extra_meta) -> None:
        """Call once a completed step; snapshots every ``every_n_steps``."""
        if (step + 1) % self.every_n_steps == 0:
            self.save(meta=dict(extra_meta, step=int(step)), serial=step)


def train_epoch_range(max_epoch_num: int, save_checkpoint_inter: int = 1,
                      state: Optional[Dict[str, object]] = None,
                      checkpoint_dir: Optional[str] = None,
                      name: str = "default") -> Generator[int, None, None]:
    """Epoch indices, snapshotting ``state`` every
    ``save_checkpoint_inter`` epochs (and after the last); a relaunched
    run skips the epochs already recorded."""
    if state is None:
        raise InvalidArgumentError(
            "train_epoch_range needs state= (dict of name -> "
            "state_dict/set_state_dict objects)")
    every = max(1, int(save_checkpoint_inter))
    acp = AutoCheckpoint(state, checkpoint_dir=checkpoint_dir, name=name,
                         every_n_steps=every)
    start = int(acp.meta.get("epoch", -1)) + 1 if acp.resumed else 0
    for epoch in range(start, int(max_epoch_num)):
        yield epoch
        if (epoch + 1) % every == 0 or epoch == int(max_epoch_num) - 1:
            acp.save(meta={"epoch": int(epoch)}, serial=epoch)

"""Elastic training: membership, fault detection, relaunch trigger (a
copy of the reference's ``distributed/fleet/elastic.py``; paddle's
``fleet/elastic.py:90``: etcd-backed registration, heartbeat leases, a
watch loop that triggers the relaunch).

Elasticity here is fault tolerance: detect a hung or dead rank and
relaunch the gang (the launcher's ``--max_restarts`` is the relaunch arm),
not parameter-server scale-in.  The store is a shared directory instead
of etcd: one registration file and one mtime heartbeat file per rank.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, List, Optional

__all__ = ["ElasticManager", "start_heartbeat"]


class ElasticManager:
    """File-backed membership + heartbeat watcher (elastic.py:90 analog)."""

    def __init__(self, store_dir: str, world_size: int,
                 heartbeat_timeout: float = 10.0):
        self.store_dir = store_dir
        self.world_size = int(world_size)
        self.timeout = float(heartbeat_timeout)
        os.makedirs(store_dir, exist_ok=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- rank side ------------------------------------------------------
    def _hb_path(self, rank: int) -> str:
        return os.path.join(self.store_dir, "rank%d.hb" % rank)

    def register(self, rank: int, endpoint: str = "") -> None:
        """Announce membership (np.pserver/np.trainers registration analog)."""
        with open(os.path.join(self.store_dir, "rank%d.json" % rank),
                  "w") as f:
            json.dump({"rank": rank, "endpoint": endpoint,
                       "pid": os.getpid()}, f)
        self.heartbeat(rank)

    def heartbeat(self, rank: int) -> None:
        with open(self._hb_path(rank), "w") as f:
            f.write(str(time.time()))

    # -- observer side --------------------------------------------------
    def registered_ranks(self) -> List[int]:
        out = []
        for name in os.listdir(self.store_dir):
            if name.endswith(".json") and name.startswith("rank"):
                out.append(int(name[4:-5]))
        return sorted(out)

    def alive_ranks(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        alive = []
        for rank in self.registered_ranks():
            try:
                age = now - os.path.getmtime(self._hb_path(rank))
            except OSError:
                continue
            if age <= self.timeout:
                alive.append(rank)
        return alive

    def faulted_ranks(self) -> List[int]:
        """Registered but heartbeat-stale — hung or dead."""
        alive = set(self.alive_ranks())
        return [r for r in self.registered_ranks() if r not in alive]

    def all_healthy(self) -> bool:
        return (len(self.registered_ranks()) == self.world_size
                and not self.faulted_ranks())

    def watch(self, on_fault: Callable[[List[int]], None],
              interval: float = 1.0, block: bool = False) -> None:
        """Watch loop (elastic.py watch analog): call ``on_fault(ranks)``
        when any registered rank's heartbeat goes stale.  ``block=False``
        runs in a daemon thread; ``stop()`` ends it."""

        def loop():
            while not self._stop.is_set():
                faults = self.faulted_ranks()
                if faults:
                    on_fault(faults)
                    return
                self._stop.wait(interval)

        if block:
            loop()
        else:
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def clear(self) -> None:
        for name in os.listdir(self.store_dir):
            if name.startswith("rank"):
                try:
                    os.remove(os.path.join(self.store_dir, name))
                except OSError:
                    pass


def start_heartbeat(manager: ElasticManager, rank: int,
                    interval: float = 2.0) -> threading.Event:
    """Rank-side heartbeat pump; returns the stop Event."""
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            manager.heartbeat(rank)
            stop.wait(interval)

    threading.Thread(target=pump, daemon=True).start()
    return stop

"""``paddle_tpu_torch.distributed.spawn``: in-Python multi-process launch
(counterpart of the reference's ``distributed/spawn.py``; paddle's
``python/paddle/distributed/spawn.py:333``).

Spawn N processes running ``func``, wire the trainer environment, join
with error propagation: a child's traceback is raised in the parent.  The
child contract is the launcher's: each child gets the PADDLE_TRAINER_*
environment and calls
:func:`paddle_tpu_torch.distributed.init_parallel_env` to rendezvous.

Uses the ``spawn`` start method, never ``fork``: a CUDA context does not
survive a fork.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
import traceback
from typing import Optional, Sequence

from .launch import _free_ports, build_child_env

__all__ = ["spawn", "ParallelContext"]


def _child_main(func, rank, args, env, err_queue):
    os.environ.update(env)
    try:
        func(*args)
    except Exception:
        err_queue.put((rank, traceback.format_exc()))
        sys.exit(1)


class ParallelContext:
    """Join handle for spawned trainers (spawn.py MultiprocessContext)."""

    def __init__(self, processes, err_queue):
        self.processes = processes
        self._err_queue = err_queue

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the gang, reacting to the FIRST failure: a child that
        dies before the rendezvous would otherwise leave its peers blocked
        inside ``init_process_group`` (reference spawn.py tears the
        rest down on first exit too)."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in self.processes]
            failed = [c for c in codes if c not in (0, None)]
            done = all(c is not None for c in codes)
            timed_out = deadline is not None and _time.monotonic() > deadline
            if failed or done or timed_out:
                break
            _time.sleep(0.05)
        if failed:
            for p in self.processes:
                if p.is_alive():
                    p.terminate()
            for p in self.processes:
                p.join(10)
            msgs = []
            while not self._err_queue.empty():
                rank, tb = self._err_queue.get()
                msgs.append("---- rank %d ----\n%s" % (rank, tb))
            raise RuntimeError(
                "%d spawned trainer(s) failed:\n%s"
                % (len(failed), "\n".join(msgs) or "(no traceback captured)"))
        return all(p.exitcode == 0 for p in self.processes)


def spawn(func, args: Sequence = (), nprocs: int = 1, join: bool = True,
          **options) -> ParallelContext:
    """Spawn ``nprocs`` trainer processes running ``func(*args)``.

    Each child sees PADDLE_TRAINER_ID/NUM/ENDPOINTS and should call
    ``init_parallel_env()`` (directly or via ``fleet.init``) to rendezvous.
    """
    if nprocs < 1:
        raise ValueError("nprocs must be >= 1, got %d" % nprocs)
    ctx = mp.get_context("spawn")
    err_queue = ctx.SimpleQueue()
    endpoints = ["127.0.0.1:%d" % p for p in _free_ports(nprocs)]
    processes = []
    for rank in range(nprocs):
        env = build_child_env(rank, nprocs, endpoints)
        p = ctx.Process(
            target=_child_main, args=(func, rank, args, env, err_queue))
        p.daemon = True
        p.start()
        processes.append(p)
    context = ParallelContext(processes, err_queue)
    if join:
        context.join()
    return context

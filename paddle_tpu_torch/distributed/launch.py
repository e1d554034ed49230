"""Multi-process launcher: ``python -m paddle_tpu_torch.distributed.launch``
(counterpart of the reference's ``distributed/launch.py``).

Paddle's ``fleet/launch.py:94,243`` (arguments, the cluster environment,
the child watch loop) and ``fleet/elastic.py:90`` (relaunch on failure).
The launcher writes the ``PADDLE_TRAINER_*`` environment that
:func:`~paddle_tpu_torch.distributed.init_parallel_env` reads; with more
than one trainer the children rendezvous through
``torch.distributed.init_process_group`` at rank 0's endpoint
(``PADDLE_MASTER``).

- No etcd: elastic membership is the launcher's own watch loop
  (``--max_restarts`` relaunches of the whole gang; ``--elastic_dir``
  kills the gang when a rank's heartbeat goes stale).
- No device selection flags: every child sees the host's cards.  NCCL
  refuses two ranks on one card, so a gang of several processes on a
  one-card machine runs on the CPU (gloo).
- Endpoints on one node are ports the kernel hands out (a bind to port
  0), so launchers running side by side never pick the same ones.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

__all__ = ["launch", "build_child_env", "main"]


def _free_ports(n: int) -> List[int]:
    """``n`` distinct free TCP ports for trainer endpoints, each one the
    kernel chose for a bind to port 0 (all held open until every one is
    chosen)."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(s)
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def build_child_env(rank: int, world_size: int, endpoints: List[str],
                    base_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The PADDLE_TRAINER_* contract (launch_utils.py get_cluster analog)."""
    env = dict(os.environ if base_env is None else base_env)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world_size),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        # the rendezvous: rank 0's endpoint
        "PADDLE_MASTER": endpoints[0],
    })
    # script-mode children get the launch cwd on sys.path (the launcher was
    # importable from here, so the framework is too — checkout workflows)
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (os.getcwd(), env.get("PYTHONPATH")) if x)
    return env


# the currently-running gang, for signal-time teardown (see main)
_live_gang: List = []


def _spawn_gang(args, endpoints: List[str], log_dir: Optional[str]):
    procs = []
    nproc = args.nproc_per_node
    for local_rank in range(nproc):
        rank = args.node_rank * nproc + local_rank
        env = build_child_env(rank, args.world_size, endpoints)
        if getattr(args, "auto_checkpoint_dir", None):
            env["PADDLE_AUTO_CHECKPOINT_DIR"] = args.auto_checkpoint_dir
        cmd = [sys.executable]
        if args.module:
            cmd.append("-m")
        cmd.append(args.training_script)
        cmd += args.training_script_args
        out = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, "workerlog.%d" % rank), "w")
        procs.append((rank, subprocess.Popen(
            cmd, env=env, stdout=out, stderr=subprocess.STDOUT if out else None),
            out))
    _live_gang[:] = procs
    return procs


def _kill_gang(procs) -> None:
    for _, p, _ in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + 10
    for _, p, _ in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
    for _, _, out in procs:
        if out:
            out.close()


def _watch_gang(procs) -> int:
    """Wait until all exit 0 (→0) or any fails (→its code, rest killed)."""
    while True:
        alive = False
        for rank, p, _ in procs:
            code = p.poll()
            if code is None:
                alive = True
            elif code != 0:
                sys.stderr.write(
                    "[launch] rank %d exited with code %d — terminating gang\n"
                    % (rank, code))
                _kill_gang(procs)
                return code
        if not alive:
            for _, _, out in procs:
                if out:
                    out.close()
            return 0
        time.sleep(0.2)


def launch(args) -> int:
    """Run the gang, relaunching up to ``max_restarts`` times on failure."""
    if args.nnodes > 1 and not args.trainer_endpoints:
        raise SystemExit(
            "--trainer_endpoints is required when --nnodes > 1 (every node "
            "must agree on the rank→endpoint map)")
    attempts = args.max_restarts + 1
    for attempt in range(attempts):
        endpoints = (args.trainer_endpoints.split(",")
                     if args.trainer_endpoints else
                     ["127.0.0.1:%d" % p
                      for p in _free_ports(args.world_size)])
        manager = None
        if args.elastic_dir:
            from .fleet.elastic import ElasticManager

            manager = ElasticManager(args.elastic_dir, args.world_size,
                                     heartbeat_timeout=args.elastic_timeout)
            # a relaunched gang must not be judged by the dead gang's stale
            # registrations (faulted_ranks only flags registered ranks)
            manager.clear()
        procs = _spawn_gang(args, endpoints, args.log_dir)
        if manager is not None:
            manager.watch(lambda faults: (
                sys.stderr.write("[launch.elastic] rank(s) %s heartbeat "
                                 "stale — killing gang\n" % faults),
                _kill_gang(procs)))
        code = _watch_gang(procs)
        if manager is not None:
            manager.stop()
        if code == 0:
            return 0
        if attempt + 1 < attempts:
            sys.stderr.write(
                "[launch.elastic] attempt %d/%d failed (code %d); "
                "relaunching gang\n" % (attempt + 1, attempts, code))
            time.sleep(args.restart_delay)
    return code


def _parse(argv):
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a multi-process (multi-host analog) training job")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--trainer_endpoints", type=str, default="",
                   help="comma list host:port; synthesized on one node")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--max_restarts", type=int, default=0,
                   help="elastic: relaunch the gang up to N times on failure")
    p.add_argument("--elastic_dir", type=str, default=None,
                   help="shared dir for heartbeat fault detection: a rank "
                        "whose heartbeat goes stale gets the gang killed "
                        "(then relaunched per --max_restarts)")
    p.add_argument("--elastic_timeout", type=float, default=10.0)
    p.add_argument("--restart_delay", type=float, default=1.0)
    p.add_argument("--auto_checkpoint_dir", type=str, default=None,
                   help="shared dir for incubate.auto_checkpoint snapshots: "
                        "exported as $PADDLE_AUTO_CHECKPOINT_DIR so a "
                        "relaunched gang (--max_restarts) resumes from the "
                        "last snapshot instead of restarting from scratch")
    p.add_argument("--module", action="store_true",
                   help="run training_script as a python module (-m)")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    args.world_size = args.nnodes * args.nproc_per_node
    return args


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    # SIGTERM/SIGINT (scheduler preemption, ^C) must tear the gang down —
    # a dead launcher must not orphan trainers holding ports and cards
    def _on_signal(signum, frame):
        _kill_gang(_live_gang)
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    code = launch(args)
    return code


if __name__ == "__main__":
    sys.exit(main())

"""The launcher, ``spawn``, the elastic heartbeats and the process-backed
world of the port, on CPU gangs over gloo (the reference's
``tests/test_launch.py``/``tests/test_elastic.py`` cases, ported): the
``PADDLE_TRAINER_*`` environment (held against the reference's), a
cross-process ``all_reduce`` and the other collectives, the gang killed
on a failure and relaunched, a stale heartbeat, ``spawn`` with its error
propagation, LocalSGD averaged across two processes and the auto-resume
loss continuity.

The trainers are ``tests/torch_launch_child.py``.  Endpoints are ports
the kernel hands out, so launchers running side by side (pytest-xdist)
never collide.  Values are exact: sums of small integers, the same
losses as hex floats.  The heartbeat case, the failure without restarts
and the auto-resume case are marked ``slow``, as in the reference (10-30
s of child processes each); the relaunch case holds the kill and the
relaunch unmarked.
"""
import json
import os
import re
import subprocess
import sys
import time

import pytest

from paddle_tpu_torch.distributed import launch as plaunch
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                         start_heartbeat)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_launch_child.py")
TIMEOUT = 240


def _env():
    env = {k: v for k, v in os.environ.items()
           if not (k.startswith("PADDLE_TRAINER") or k == "PADDLE_MASTER")}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(args, timeout=TIMEOUT):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"] + \
        args
    return subprocess.run(cmd, env=_env(), cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def _results(stdout):
    return sorted((json.loads(line.split(" ", 1)[1])
                   for line in stdout.splitlines()
                   if line.startswith("RESULT ")), key=lambda r: r["rank"])


def test_child_env_matches_the_reference():
    from paddle_tpu.distributed.launch import build_child_env as ref_env

    eps = ["h0:1", "h1:2", "h2:3"]
    for rank in range(3):
        got = plaunch.build_child_env(rank, 3, eps, base_env={"A": "1"})
        want = ref_env(rank, 3, eps, base_env={"A": "1"})
        assert got == want
    assert got["PADDLE_MASTER"] == "h0:1"
    assert got["PADDLE_CURRENT_ENDPOINT"] == "h2:3"


def test_free_ports_are_distinct_and_bindable():
    import socket

    ports = plaunch._free_ports(4)
    assert len(set(ports)) == 4
    for p in ports:
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))


def test_launch_parses_the_reference_flags(tmp_path):
    args = plaunch._parse([
        "--nproc_per_node", "2", "--max_restarts", "3", "--elastic_dir",
        str(tmp_path), "--elastic_timeout", "2.5", "--restart_delay", "0",
        "--auto_checkpoint_dir", str(tmp_path / "c"), "--log_dir",
        str(tmp_path / "logs"), "--module", "pkg.train", "--lr", "0.1"])
    assert (args.world_size, args.max_restarts, args.elastic_timeout,
            args.module, args.training_script,
            args.training_script_args) == (2, 3, 2.5, True, "pkg.train",
                                           ["--lr", "0.1"])
    with pytest.raises(SystemExit):
        plaunch.launch(plaunch._parse(["--nnodes", "2", "x.py"]))


def test_two_process_collectives_through_the_launcher(tmp_path):
    r = _launch(["--nproc_per_node", "2", "--log_dir", str(tmp_path / "log"),
                 CHILD, "collectives"])
    assert r.returncode == 0, r.stdout + r.stderr
    logs = "".join(open(tmp_path / "log" / ("workerlog.%d" % i)).read()
                   for i in range(2))
    res = _results(logs)
    assert [x["rank"] for x in res] == [0, 1], logs
    for x in res:
        assert x["world"] == 2 and x["env_rank"] == x["rank"]
        assert x["process_backed"] and x["group_rank"] == x["rank"]
        assert x["sum"] == [3.0] * 3
        assert x["avg"] == [1.5] * 2 and x["max"] == [2.0] * 2
        assert x["prod"] == [2.0] * 2
        assert x["numpy_sum"] == [1, 20]
        assert x["broadcast"] == [7.0, 7.0]
        assert x["gather"] == [[0, 0], [1, 2]]
        assert x["gather_stacked"] == [[0], [1]]
        assert x["subgroup"] == [2.0]
        assert x["alltoall"] == "refused"
        assert x["parallel_env"] == [x["rank"], 2]
        assert x["sampler"] == [[x["rank"] + 2 * i for i in (0, 1)],
                                [x["rank"] + 2 * i for i in (2, 3)],
                                [x["rank"] + 8]]
    assert res[0]["reduce"] == [3.0, 3.0] and res[1]["reduce"] == [2.0, 2.0]


def test_failure_kills_the_gang_and_the_relaunch_recovers(tmp_path):
    """Rank 1 exits on the first attempt while rank 0 waits in the
    rendezvous: the launcher kills rank 0, relaunches the gang, and the
    second attempt's collectives run."""
    sentinel = str(tmp_path / "failed_once")
    r = _launch(["--nproc_per_node", "2", "--max_restarts", "1",
                 "--restart_delay", "0", CHILD, "collectives",
                 "--fail-once", sentinel])
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(sentinel)
    assert "rank 1 exited with code 1" in r.stderr
    assert "terminating gang" in r.stderr
    assert "relaunching gang" in r.stderr
    assert [x["sum"] for x in _results(r.stdout)] == [[3.0] * 3] * 2


@pytest.mark.slow
def test_failure_without_restarts_fails_the_launch(tmp_path):
    r = _launch(["--nproc_per_node", "2", CHILD, "collectives",
                 "--fail-once", str(tmp_path / "s")])
    assert r.returncode == 1
    assert "terminating gang" in r.stderr
    assert "relaunching" not in r.stderr and "RESULT" not in r.stdout


def _spawn(code, timeout=TIMEOUT):
    return subprocess.run([sys.executable, "-c", code], env=_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_spawn_two_processes(tmp_path):
    r = _spawn("from torch_launch_child import check_world\n"
               "import paddle_tpu_torch.distributed as dist\n"
               "ctx = dist.spawn(check_world, args=(2, %r), nprocs=2)\n"
               "assert isinstance(ctx, dist.ParallelContext)\n"
               "print('SPAWN_OK', ctx.join())\n" % str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SPAWN_OK True" in r.stdout
    files = sorted(p.name for p in tmp_path.glob("rank*.ok"))
    assert files == ["rank0.ok", "rank1.ok"]
    eps = {(tmp_path / f).read_text() for f in files}
    assert len(eps) == 1 and len(eps.pop().split(",")) == 2


def test_spawn_raises_the_child_traceback(tmp_path):
    r = _spawn("from torch_launch_child import boom\n"
               "import paddle_tpu_torch.distributed as dist\n"
               "try:\n"
               "    dist.spawn(boom, args=(0, %r), nprocs=2)\n"
               "except RuntimeError as e:\n"
               "    assert 'intentional child failure' in str(e), e\n"
               "    assert 'Traceback' in str(e)\n"
               "    print('SPAWN_ERR_OK')\n"
               "try:\n"
               "    dist.spawn(boom, nprocs=0)\n"
               "except ValueError:\n"
               "    print('NPROCS_OK')\n" % str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "SPAWN_ERR_OK" in r.stdout and "NPROCS_OK" in r.stdout


def test_localsgd_averages_across_two_processes(tmp_path):
    r = _spawn("from torch_launch_child import localsgd_sync\n"
               "import paddle_tpu_torch.distributed as dist\n"
               "dist.spawn(localsgd_sync, args=(%r,), nprocs=2)\n"
               "print('LOCALSGD_OK')\n" % str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    got = [json.loads((tmp_path / ("w%d.json" % i)).read_text())
           for i in range(2)]
    assert got[0]["before"] == [[1.0, 1.0]] * 2
    assert got[1]["before"] == [[2.0, 2.0]] * 2
    for g in got:
        assert g["after"] == [[1.5, 1.5]] * 2 and g["bias"] == [5.0, 5.0]
        assert g["syncs"] == 1


def test_single_controller_world_is_unchanged(monkeypatch):
    """Without the launcher's environment (or with a world of one) the
    world group is the single controller's, rank 0."""
    import paddle_tpu_torch.distributed as dist

    dist.destroy_process_group()
    try:
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
        g = dist.init_parallel_env(device="cpu")
        assert not g.process_backed and dist.get_rank() == 0
        assert g.rank == 0 and dist.get_world_size() == 1
        dist.destroy_process_group()
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
        g = dist.init_parallel_env(world_size=2, device="cpu")
        assert not g.process_backed and g.nranks == 2
    finally:
        dist.destroy_process_group()


def test_a_card_gang_larger_than_the_cards_is_refused(monkeypatch):
    import torch

    from paddle_tpu_torch.distributed import collective

    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "127.0.0.1:1,127.0.0.1:2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(collective.UnavailableError, match="NCCL"):
        collective._init_process_world("cuda")


# -- elastic ------------------------------------------------------------------

def test_membership_and_heartbeats(tmp_path):
    m = ElasticManager(str(tmp_path), world_size=2, heartbeat_timeout=5.0)
    assert not m.all_healthy()
    m.register(0, "h0:1")
    m.register(1, "h1:2")
    assert m.registered_ranks() == [0, 1] and m.alive_ranks() == [0, 1]
    assert m.all_healthy() and m.faulted_ranks() == []
    with open(tmp_path / "rank0.json") as f:
        assert json.load(f)["endpoint"] == "h0:1"
    m.clear()
    assert m.registered_ranks() == []


def test_stale_heartbeat_detected(tmp_path):
    m = ElasticManager(str(tmp_path), world_size=2, heartbeat_timeout=0.2)
    m.register(0)
    m.register(1)
    old = time.time() - 60
    os.utime(tmp_path / "rank1.hb", (old, old))
    assert m.faulted_ranks() == [1] and not m.all_healthy()


def test_watch_triggers_on_fault(tmp_path):
    m = ElasticManager(str(tmp_path), world_size=1, heartbeat_timeout=0.2)
    m.register(0)
    seen = []
    m.watch(lambda faults: seen.append(faults), interval=0.05)
    stop = start_heartbeat(m, 0, interval=0.05)
    time.sleep(0.4)
    assert seen == []
    stop.set()
    deadline = time.time() + 5
    while not seen and time.time() < deadline:
        time.sleep(0.05)
    m.stop()
    assert seen == [[0]]


@pytest.mark.slow
def test_launcher_kills_the_gang_on_a_stale_heartbeat(tmp_path):
    t0 = time.time()
    r = _launch(["--nproc_per_node", "2", "--elastic_dir",
                 str(tmp_path / "store"), "--elastic_timeout", "1.0", CHILD,
                 "hang", str(tmp_path / "store")])
    assert r.returncode != 0
    assert "heartbeat stale" in r.stderr, r.stderr
    assert time.time() - t0 < 120


@pytest.mark.slow
def test_auto_resume_loss_continuity(tmp_path):
    """Rank 1 dies before step 5; the relaunched gang resumes from the
    last snapshot and every loss equals the uninterrupted run's."""
    def parse(path):
        out = {}
        with open(path) as f:
            for line in f:
                _, step, loss = line.split()
                out.setdefault(int(step), float.fromhex(loss))
        return out

    ref_log = str(tmp_path / "ref")
    r = _launch(["--nproc_per_node", "2", "--auto_checkpoint_dir",
                 str(tmp_path / "ref_ckpt"), CHILD, "acp", "--steps", "10",
                 "--log-file", ref_log])
    assert r.returncode == 0, r.stdout + r.stderr
    ref = parse(ref_log + ".rank0")
    assert sorted(ref) == list(range(10))
    log = str(tmp_path / "losses")
    sentinel = str(tmp_path / "died_once")
    r = _launch(["--nproc_per_node", "2", "--max_restarts", "1",
                 "--restart_delay", "0", "--auto_checkpoint_dir",
                 str(tmp_path / "ckpt"), CHILD, "acp", "--steps", "10",
                 "--fail-at", "5", "--fail-sentinel", sentinel,
                 "--log-file", log])
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(sentinel) and "relaunching gang" in r.stderr
    starts = [int(s) for s in re.findall(r"\bstart=(\d+)", r.stdout)]
    assert 0 in starts and any(s > 0 for s in starts), r.stdout
    got = parse(log + ".rank0")
    assert sorted(got) == list(range(10))
    assert [got[i] for i in range(10)] == [ref[i] for i in range(10)]

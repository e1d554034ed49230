"""Trainer processes for ``tests/test_torch_launch.py``: run under
``python -m paddle_tpu_torch.distributed.launch`` (``python
torch_launch_child.py MODE ...``), or as ``distributed.spawn`` targets
(the module-level functions).  Every gang runs on the CPU over gloo.

Modes:
- ``collectives [--fail-once SENTINEL]``: rendezvous, then every
  process-backed collective; prints ``RESULT <json>``.  With
  ``--fail-once``, rank 1 exits 1 on the first attempt while rank 0 waits
  in the rendezvous, so the launcher must kill rank 0.
- ``acp --steps N --log-file P [--fail-at K --fail-sentinel S]``: a tiny
  model trained under ``AutoCheckpoint`` in ``$PADDLE_AUTO_CHECKPOINT_DIR``;
  rank 1 dies before step K on the first attempt.  Losses go to
  ``P.rank<r>`` as ``STEP i <float.hex>`` lines.
- ``hang STORE``: registers with the elastic store and heartbeats; rank 1
  stops heartbeating (and hangs) after three beats.
"""
import json
import os
import sys
import time

import numpy as np


def _fail_once(sentinel):
    """Rank 1 exits on the first attempt (the sentinel marks it)."""
    if os.environ.get("PADDLE_TRAINER_ID") == "1" \
            and not os.path.exists(sentinel):
        with open(sentinel, "w") as f:
            f.write("failed once")
        sys.exit(1)


def collectives(fail_sentinel=None):
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.core.errors import UnimplementedError
    from paddle_tpu_torch.io import DistributedBatchSampler

    if fail_sentinel:
        _fail_once(fail_sentinel)
    world = dist.init_parallel_env(device="cpu")
    rank, n = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "world": n, "env_rank": int(
        os.environ["PADDLE_TRAINER_ID"]), "process_backed":
        world.process_backed, "group_rank": world.rank}
    t = torch.full((3,), float(rank + 1))
    dist.all_reduce(t)
    out["sum"] = t.tolist()
    for name, op in (("avg", dist.ReduceOp.AVG), ("max", dist.ReduceOp.MAX),
                     ("prod", dist.ReduceOp.PROD)):
        x = torch.full((2,), float(rank + 1))
        dist.all_reduce(x, op)
        out[name] = x.tolist()
    out["numpy_sum"] = dist.all_reduce(
        np.array([rank, 10], np.int64)).tolist()
    b = torch.full((2,), float(rank * 7))
    dist.broadcast(b, src=1)
    out["broadcast"] = b.tolist()
    parts = []
    dist.all_gather(parts, torch.tensor([rank, rank * 2]))
    out["gather"] = [p.tolist() for p in parts]
    out["gather_stacked"] = dist.all_gather(torch.tensor([rank])).tolist()
    r = torch.full((2,), float(rank + 1))
    dist.reduce(r, dst=0)
    out["reduce"] = r.tolist()
    sub = dist.new_group([0, 1])
    s = torch.ones(1)
    dist.all_reduce(s, group=sub)
    out["subgroup"] = s.tolist()
    dist.barrier()
    try:
        dist.alltoall(torch.ones(2, 2))
        out["alltoall"] = "ran"
    except UnimplementedError:
        out["alltoall"] = "refused"
    sampler = DistributedBatchSampler(list(range(10)), batch_size=2)
    out["sampler"] = [list(b) for b in sampler]
    out["parallel_env"] = [dist.ParallelEnv().rank,
                           dist.ParallelEnv().world_size]
    print("RESULT " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def acp(steps, log_file, fail_at=-1, fail_sentinel=""):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.incubate import AutoCheckpoint

    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    paddle.seed(1234)
    model = paddle.nn.Sequential(paddle.nn.Linear(8, 16, device="cpu"),
                                 paddle.nn.Tanh(),
                                 paddle.nn.Linear(16, 4, device="cpu"))
    opt = paddle.optimizer.Momentum(0.05, momentum=0.9,
                                    parameters=model.parameters())
    rng = np.random.RandomState(0)
    xs = rng.randn(steps, 16, 8).astype("float32")
    ys = rng.randint(0, 4, (steps, 16)).astype("int64")
    ckpt = AutoCheckpoint({"model": model, "opt": opt}, every_n_steps=1,
                          name="gangtest")
    start = ckpt.start_step
    print("ACP_START rank=%d start=%d" % (rank, start), flush=True)
    with open("%s.rank%d" % (log_file, rank), "a") as log:
        for step in range(start, steps):
            if rank == 1 and step == fail_at and fail_sentinel \
                    and not os.path.exists(fail_sentinel):
                with open(fail_sentinel, "w") as f:
                    f.write("died at %d" % step)
                os._exit(17)
            loss = paddle.nn.functional.cross_entropy(
                model(paddle.to_tensor(xs[step], place="cpu")),
                paddle.to_tensor(ys[step], place="cpu"))
            loss.backward()
            opt.step()
            opt.clear_grad()
            log.write("STEP %d %s\n" % (step, float(loss).hex()))
            log.flush()
            ckpt.after_step(step)
    dist.destroy_process_group()


def hang(store):
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    m = ElasticManager(store, 2, heartbeat_timeout=1.0)
    m.register(rank)
    for step in range(600):
        if rank == 1 and step == 3:
            time.sleep(600)  # hang without exiting
        m.heartbeat(rank)
        time.sleep(0.1)


# -- spawn targets (module level: the spawn method pickles them by name) ----

def check_world(expected, out_dir):
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env(device="cpu")
    assert dist.get_world_size() == expected
    rank = dist.get_rank()
    with open(os.path.join(out_dir, "rank%d.ok" % rank), "w") as f:
        f.write(os.environ["PADDLE_TRAINER_ENDPOINTS"])
    dist.destroy_process_group()


def boom(_unused, _out):
    raise RuntimeError("intentional child failure")


def localsgd_sync(out_dir):
    """Each rank diverges its weights; LocalSGD's sync makes the mean."""
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        LocalSGDOptimizer

    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    m = paddle.nn.Linear(2, 2, device="cpu")
    with torch.no_grad():
        m.weight.fill_(float(rank + 1))
        m.bias.fill_(float(10 * rank))
    opt = LocalSGDOptimizer(
        paddle.optimizer.SGD(0.0, parameters=m.parameters()), k_steps=2)
    loss = m(torch.ones(1, 2)).sum()
    loss.backward()
    opt.step()                      # 1 of 2: no sync yet
    before = m.weight.detach().clone()
    opt.step()                      # 2 of 2: the mean across processes
    with open(os.path.join(out_dir, "w%d.json" % rank), "w") as f:
        json.dump({"before": before.tolist(), "after":
                   m.weight.detach().tolist(), "bias": m.bias.tolist(),
                   "syncs": opt.syncs}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, rest = sys.argv[1], sys.argv[2:]
    if mode == "collectives":
        collectives(rest[rest.index("--fail-once") + 1]
                    if "--fail-once" in rest else None)
    elif mode == "acp":
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--steps", type=int, default=10)
        ap.add_argument("--fail-at", type=int, default=-1)
        ap.add_argument("--fail-sentinel", type=str, default="")
        ap.add_argument("--log-file", type=str, required=True)
        a = ap.parse_args(rest)
        acp(a.steps, a.log_file, a.fail_at, a.fail_sentinel)
    elif mode == "hang":
        hang(rest[0])
    else:
        raise SystemExit("unknown mode %r" % mode)

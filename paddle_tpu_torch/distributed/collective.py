"""Collective communication (counterpart of the reference's
``distributed/collective.py``).

The reference is single-controller: one program holds every rank, a
``Group`` names an axis of a device mesh, and an eager collective takes
the *stacked* global view -- axis 0 of the input is the rank axis
(``[nranks, ...]``) and the result is what every rank would hold.  The
port keeps that contract.  A ``Group`` is one axis of a logical mesh whose
ranks all sit on ONE device (``cuda:0``, or ``"cpu"`` when asked); a
collective is written out over the ranks' slices in rank order, sums in
float32 as ``qcollectives.row_parallel_linear`` does.  A group over
several distinct devices raises :class:`UnimplementedError`: a grid across
cards needs a transport between them, which is not ported.

A launched world is the one exception.  Under the launcher
(``distributed.launch``) or ``spawn``, with ``PADDLE_TRAINERS_NUM`` above 1
and no ``world_size`` given, :func:`init_parallel_env` rendezvouses the
processes through ``torch.distributed.init_process_group`` (gloo for CPU
children, NCCL where each child has its own card), as the reference
rendezvouses them through ``jax.distributed``.  The world group is then
process-backed: :func:`get_rank` is the process's rank, and
``all_reduce``, ``reduce``, ``broadcast``, ``all_gather`` and ``barrier``
take each process's own tensor and go through ``torch.distributed``.

The reference's *traced* form (a collective inside ``shard_map`` on the
per-rank shard) has no torch counterpart.  Where a layer needs a
collective in the middle of a per-rank body it writes the body over the
list of per-rank tensors and reduces with :func:`rank_sum` (the
tensor-, pipeline-, sequence- and expert-parallel layers of
``meta_parallel``).
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import (InvalidArgumentError, UnavailableError,
                           UnimplementedError)

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "destroy_process_group",
    "is_initialized", "init_parallel_env", "get_rank", "get_world_size",
    "broadcast", "all_reduce", "reduce", "all_gather", "scatter", "alltoall",
    "all_to_all", "send", "recv", "isend", "irecv", "barrier", "wait",
    "reduce_scatter", "stream", "p2p", "split", "get_split_layer",
    "rank_sum", "resolve_rank_devices",
]


class ReduceOp:
    """The reference's reduce operations."""

    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


def resolve_rank_devices(n: int, device=None, devices=None,
                         what: str = "the mesh") -> torch.device:
    """The one device ``n`` ranks sit on.  ``devices`` lists each rank's
    device; ``device`` names one for all; neither means ``cuda:0`` (which
    raises without a card).  Ranks on more than one distinct device raise
    :class:`UnimplementedError`."""
    if devices is None:
        devices = [device] * n
    devices = list(devices)
    if len(devices) < n:
        raise InvalidArgumentError(
            "%s has %d ranks but %d devices were given"
            % (what, n, len(devices)))
    devs = {torch.device("cuda" if d is None else d) for d in devices[:n]}
    devs = {torch.device(d.type, 0) if d.index is None else d for d in devs}
    if len(devs) > 1:
        raise UnimplementedError(
            "%s spans more than one device (%s): the port runs every rank "
            "of a mesh on one device, in rank order (devices=[\"cuda:0\"] "
            "* %d); a grid across cards needs a transport between them, "
            "which ROADMAP queue 1 item 6 lists as not yet ported"
            % (what, sorted(str(d) for d in devs), n))
    return resolve_device(devices[0] if n else None)


class Group:
    """A communicator: one axis of a logical mesh whose ranks all sit on
    ``device``.  ``ranks`` are global rank ids (the reference's
    bookkeeping); ``axis_name`` is the mesh axis."""

    _next_id = 0

    def __init__(self, ranks: Sequence[int], device, axis_name: str = "dp",
                 gid: Optional[int] = None, process_group=None,
                 rank: int = 0):
        self.ranks = list(ranks)
        self.device = torch.device(device)
        self.axis_name = axis_name
        # a launched world: the torch.distributed group (None: the default
        # one) whose processes are the ranks, and this process's rank
        self._pg = process_group
        self._rank = int(rank)
        self.process_backed = process_group is not None
        if gid is None:
            gid = Group._next_id
        Group._next_id = max(Group._next_id, gid) + 1
        self.id = gid

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def rank(self) -> int:
        # single controller: the controller is rank 0 of every group; a
        # launched world: this process's rank in the group
        return self._rank

    @property
    def process_group(self):
        return self._pg if self.process_backed else self

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return True

    def __repr__(self):
        return "Group(id=%d, axis=%r, nranks=%d, ranks=%s)" % (
            self.id, self.axis_name, self.nranks, self.ranks)


_group_map: dict = {}
_default_group: Optional[Group] = None


def _launched_world_size() -> int:
    """``PADDLE_TRAINERS_NUM`` from the launcher's environment (1 when
    unset)."""
    import os

    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or "1")


def _init_process_world(device) -> Group:
    """Rendezvous the launched processes (the reference's
    ``_bootstrap_multihost``): ``init_process_group`` at ``PADDLE_MASTER``
    from ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``; gloo on the CPU,
    NCCL on the card, where each rank of this node takes its own card."""
    import os

    import torch.distributed as tdist

    n = _launched_world_size()
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    endpoints = [e for e in os.environ.get(
        "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
    master = os.environ.get("PADDLE_MASTER") or endpoints[0]
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        here = endpoints[rank].rsplit(":", 1)[0] if endpoints else ""
        on_node = [i for i, e in enumerate(endpoints)
                   if e.rsplit(":", 1)[0] == here] or list(range(n))
        cards = torch.cuda.device_count()
        if len(on_node) > cards:
            raise UnavailableError(
                "%d launched ranks share this node's %d CUDA card(s); NCCL "
                "takes one rank a card -- launch fewer processes a node, or "
                "pass init_parallel_env(device=\"cpu\") to run the gang on "
                "the CPU over gloo" % (len(on_node), cards))
        dev = torch.device("cuda", on_node.index(rank) % cards)
        torch.cuda.set_device(dev)
        backend = "nccl"
    if not tdist.is_initialized():
        tdist.init_process_group(backend, init_method="tcp://" + master,
                                 world_size=n, rank=rank)
    return Group(list(range(n)), dev, "dp", gid=0,
                 process_group=tdist.group.WORLD, rank=rank)


def init_parallel_env(world_size: Optional[int] = None, device=None,
                      devices=None) -> Group:
    """The world group (the reference's ``init_parallel_env``): a logical
    mesh of ``world_size`` ranks (``len(devices)`` when given, else 1) on
    one device -- ``cuda:0`` unless ``device``/``devices`` say otherwise.
    Under the launcher (``PADDLE_TRAINERS_NUM`` above 1) with neither
    ``world_size`` nor ``devices`` given, the world is the launched
    processes, rendezvoused through ``torch.distributed`` on ``device``
    (the card unless it says ``"cpu"``).  A later call returns the group
    already made."""
    global _default_group
    if _default_group is None and world_size is None and devices is None \
            and _launched_world_size() > 1:
        _default_group = _init_process_world(device)
        _group_map[0] = _default_group
    if _default_group is None:
        n = int(world_size if world_size is not None
                else (len(devices) if devices is not None else 1))
        if n < 1:
            raise InvalidArgumentError(
                "init_parallel_env needs world_size >= 1, got %d" % n)
        dev = resolve_rank_devices(n, device, devices, "the world group")
        _default_group = Group(list(range(n)), dev, "dp", gid=0)
        _group_map[0] = _default_group
    return _default_group


def is_initialized() -> bool:
    return _default_group is not None


def destroy_process_group(group: Optional[Group] = None) -> None:
    global _default_group
    if group is None:
        if _default_group is not None and _default_group.process_backed:
            import torch.distributed as tdist

            tdist.destroy_process_group()
        _group_map.clear()
        _default_group = None
    else:
        _group_map.pop(group.id, None)
        if _default_group is group:
            _default_group = None


def _get_default_group() -> Group:
    return init_parallel_env()


def get_group(gid: int = 0) -> Optional[Group]:
    return _group_map.get(gid)


def get_rank(group: Optional[Group] = None) -> int:
    """The process's rank in a launched world (in ``group`` when it is one
    of its groups); 0 for the single controller, which holds every
    rank."""
    if group is not None and group.process_backed:
        return group.rank
    if _default_group is not None and _default_group.process_backed:
        return _default_group.rank
    return 0


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    return _get_default_group().nranks


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None) -> Group:
    """A group over a subset of the world's ranks, on the world's
    device."""
    world = _get_default_group()
    n = world.nranks
    if ranks is None:
        ranks = list(range(n))
    ranks = sorted(int(r) for r in ranks)
    if any(r < 0 or r >= n for r in ranks):
        raise InvalidArgumentError(
            "new_group ranks %s out of range [0, %d)" % (ranks, n))
    if world.process_backed:
        import torch.distributed as tdist

        # every process makes the group, members or not (torch's rule)
        pg = tdist.new_group(ranks)
        g = Group(ranks, world.device, "sub", process_group=pg,
                  rank=ranks.index(world.rank) if world.rank in ranks
                  else -1)
        _group_map[g.id] = g
        return g
    g = Group(ranks, world.device, "sub")
    _group_map[g.id] = g
    return g


# -- helpers ----------------------------------------------------------------

def _as_tensor(x, group: Group):
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x), device=group.device)


def _check_rank_axis(x, group: Group, api: str):
    if x.ndim == 0 or x.shape[0] != group.nranks:
        raise InvalidArgumentError(
            "%s (global view): the leading axis must be the rank axis of "
            "size %d, got shape %s" % (api, group.nranks, tuple(x.shape)))


def _root_index(rank: int, group: Group, api: str) -> int:
    idx = group.get_group_rank(rank)
    if idx < 0:
        raise InvalidArgumentError(
            "%s: root rank %d is not a member of %r" % (api, rank, group))
    return idx


def rank_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The sum of the ranks' tensors in rank order, accumulated in
    float32 (integers exactly) and returned in the first one's dtype.
    Differentiable: the body of every reduction a per-rank layer makes."""
    first = parts[0]
    if not (first.is_floating_point() or first.is_complex()):
        acc = first.to(torch.int64)
        for p in parts[1:]:
            acc = acc + p.to(torch.int64)
        return acc.to(first.dtype)
    wide = torch.float64 if first.dtype == torch.float64 else torch.float32
    acc = first.to(wide)
    for p in parts[1:]:
        acc = acc + p.to(wide)
    return acc.to(first.dtype)


def _reduce_ranks(x, op, n: int):
    """``[n, ...]`` reduced over axis 0 by ``op``: ``[...]``."""
    parts = [x[i] for i in range(n)]
    if op == ReduceOp.SUM:
        return rank_sum(parts)
    if op == ReduceOp.AVG:
        if not x.is_floating_point():
            return rank_sum(parts) // n
        wide = torch.float64 if x.dtype == torch.float64 else torch.float32
        return (rank_sum([p.to(wide) for p in parts]) / n).to(x.dtype)
    if op == ReduceOp.MAX:
        return x.amax(dim=0)
    if op == ReduceOp.MIN:
        return x.amin(dim=0)
    if op == ReduceOp.PROD:
        acc = parts[0]
        for p in parts[1:]:
            acc = acc * p
        return acc
    raise InvalidArgumentError("unknown ReduceOp %r" % (op,))


def _commit(tensor, out):
    """The paddle in-place contract: write ``out`` into ``tensor`` when
    it is a tensor that takes an in-place write, and return it."""
    if torch.is_tensor(tensor) and not tensor.requires_grad \
            and tensor.shape == out.shape:
        with torch.no_grad():
            tensor.copy_(out)
        return tensor
    return out


# -- a launched world: each process holds its own tensor --------------------

def _process_tensor(tensor, group: Group):
    """This process's tensor on the group's device: a tensor argument
    itself when it already lies there (the collective writes into it)."""
    if torch.is_tensor(tensor) and tensor.device == group.device:
        return tensor
    return torch.as_tensor(np.asarray(tensor) if not torch.is_tensor(tensor)
                           else tensor, device=group.device).clone()


def _dist_op(op):
    import torch.distributed as tdist

    table = {ReduceOp.SUM: tdist.ReduceOp.SUM, ReduceOp.AVG: tdist.ReduceOp.SUM,
             ReduceOp.MAX: tdist.ReduceOp.MAX, ReduceOp.MIN: tdist.ReduceOp.MIN,
             ReduceOp.PROD: tdist.ReduceOp.PRODUCT}
    if op not in table:
        raise InvalidArgumentError("unknown ReduceOp %r" % (op,))
    return table[op]


def _process_reduce(tensor, op, group: Group, dst: Optional[int]):
    """``all_reduce`` (``dst`` None) or ``reduce`` across the processes;
    AVG is a sum divided by the world, as gloo has no average."""
    import torch.distributed as tdist

    x = _process_tensor(tensor, group)
    if dst is None:
        tdist.all_reduce(x, op=_dist_op(op), group=group._pg)
    else:
        tdist.reduce(x, dst, op=_dist_op(op), group=group._pg)
    if op == ReduceOp.AVG and (dst is None or tdist.get_rank() == dst):
        with torch.no_grad():
            if x.is_floating_point():
                x.div_(group.nranks)
            else:
                x.floor_divide_(group.nranks)
    return _commit(tensor, x) if x is not tensor else tensor


def _process_only(api: str):
    raise UnimplementedError(
        "%s across launched processes is not ported: a process-backed "
        "world runs all_reduce, reduce, broadcast, all_gather and barrier"
        % api)


# -- collectives ------------------------------------------------------------

def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True, use_calc_stream: bool = False):
    """``[nranks, ...]`` in, ``[nranks, ...]`` out: every slot holds the
    reduction (written in place into a tensor, as paddle's).  In a
    launched world: this process's tensor in, the reduction over the
    processes out (in place)."""
    group = group or _get_default_group()
    if group.process_backed:
        return _process_reduce(tensor, op, group, None)
    x = _as_tensor(tensor, group)
    _check_rank_axis(x, group, "all_reduce")
    red = _reduce_ranks(x, op, group.nranks)
    return _commit(tensor, red.unsqueeze(0).expand_as(x).clone())


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM,
           group: Optional[Group] = None, sync_op: bool = True):
    """The reduction lands in ``dst``'s slot; the other ranks' slots keep
    their input (NCCL reduce leaves non-root buffers untouched)."""
    group = group or _get_default_group()
    if group.process_backed:
        _root_index(dst, group, "reduce")
        return _process_reduce(tensor, op, group, dst)
    x = _as_tensor(tensor, group)
    dst_local = _root_index(dst, group, "reduce")
    _check_rank_axis(x, group, "reduce")
    out = x.clone()
    out[dst_local] = _reduce_ranks(x, op, group.nranks)
    return _commit(tensor, out)


def all_gather(tensor_list: Optional[List], tensor=None,
               group: Optional[Group] = None, sync_op: bool = True):
    """Stacked ``[nranks, ...]`` in: the ranks' slices appended to
    ``tensor_list`` (every rank gathers the same set), or, called as
    ``all_gather(t)``, the stacked view itself."""
    if tensor is None:
        tensor, tensor_list = tensor_list, None
    group = group or _get_default_group()
    if group.process_backed:
        import torch.distributed as tdist

        x = _process_tensor(tensor, group)
        parts = [torch.empty_like(x) for _ in range(group.nranks)]
        tdist.all_gather(parts, x, group=group._pg)
        if tensor_list is not None:
            tensor_list.extend(parts)
            return tensor_list
        return torch.stack(parts)
    x = _as_tensor(tensor, group)
    _check_rank_axis(x, group, "all_gather")
    if tensor_list is not None:
        tensor_list.extend(x[i] for i in range(group.nranks))
        return tensor_list
    return x


def reduce_scatter(tensor, tensor_or_tensor_list=None, op=ReduceOp.SUM,
                   group: Optional[Group] = None, sync_op: bool = True):
    """Stacked ``[nranks, n*k, ...]`` in, ``[nranks, k, ...]`` out: rank
    i's slot holds the i-th chunk of the reduction.  The list form is the
    same global view as ``nranks`` per-rank tensors.  Called as
    ``reduce_scatter(out, in_)`` the result is written into ``out``."""
    out_slot, src = None, tensor
    if tensor_or_tensor_list is not None:
        out_slot, src = tensor, tensor_or_tensor_list
    group = group or _get_default_group()
    if group.process_backed:
        _process_only("reduce_scatter")
    n = group.nranks
    if isinstance(src, (list, tuple)):
        if len(src) != n:
            raise InvalidArgumentError(
                "reduce_scatter list form: need one tensor per rank (%d), "
                "got %d" % (n, len(src)))
        x = torch.stack([_as_tensor(t, group) for t in src])
    else:
        x = _as_tensor(src, group)
    _check_rank_axis(x, group, "reduce_scatter")
    if x.ndim < 2 or x.shape[1] % n:
        raise InvalidArgumentError(
            "reduce_scatter: the per-rank leading axis %s must divide by "
            "%d" % (tuple(x.shape[1:2]), n))
    red = _reduce_ranks(x, op, n)
    out = red.reshape((n, red.shape[0] // n) + tuple(red.shape[1:]))
    if out_slot is not None:
        return _commit(out_slot, out)
    return out


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True, use_calc_stream: bool = False):
    """Every slot of the stacked view becomes slot ``src``'s.  In a
    launched world: process ``src``'s tensor written into every
    process's."""
    group = group or _get_default_group()
    if group.process_backed:
        import torch.distributed as tdist

        x = _process_tensor(tensor, group)
        _root_index(src, group, "broadcast")
        tdist.broadcast(x, src, group=group._pg)
        return _commit(tensor, x) if x is not tensor else tensor
    x = _as_tensor(tensor, group)
    src_local = _root_index(src, group, "broadcast")
    _check_rank_axis(x, group, "broadcast")
    return _commit(tensor, x[src_local].unsqueeze(0).expand_as(x).clone())


def scatter(tensor, tensor_list=None, src: int = 0,
            group: Optional[Group] = None, sync_op: bool = True):
    """``tensor_list`` (the root's ``nranks`` chunks): rank i receives
    chunk i, returned stacked (written into ``tensor`` when its shape
    matches).  Without it, the stacked ``[nranks, n*k, ...]`` input:
    rank i receives the i-th chunk of slot ``src``."""
    group = group or _get_default_group()
    if group.process_backed:
        _process_only("scatter")
    n = group.nranks
    src_local = _root_index(src, group, "scatter")
    if tensor_list is not None:
        stacked = torch.stack([_as_tensor(t, group) for t in tensor_list])
        return _commit(tensor, stacked)
    x = _as_tensor(tensor, group)
    _check_rank_axis(x, group, "scatter")
    full = x[src_local]
    return full.reshape((n, full.shape[0] // n) + tuple(full.shape[1:]))


def alltoall(in_tensor_or_list, out_tensor_or_list=None,
             group: Optional[Group] = None, sync_op: bool = True):
    """Stacked ``[nranks, n*k, ...]`` in: chunk j of rank i's output is
    chunk i of rank j's input.  The list form is the same global view as
    ``nranks`` per-rank tensors, returning (and appending to
    ``out_tensor_or_list``) the per-rank results."""
    group = group or _get_default_group()
    if group.process_backed:
        _process_only("alltoall")
    n = group.nranks
    was_list = isinstance(in_tensor_or_list, (list, tuple))
    if was_list:
        if len(in_tensor_or_list) != n:
            raise InvalidArgumentError(
                "alltoall list form: need %d tensors, got %d"
                % (n, len(in_tensor_or_list)))
        x = torch.stack([_as_tensor(t, group) for t in in_tensor_or_list])
    else:
        x = _as_tensor(in_tensor_or_list, group)
    _check_rank_axis(x, group, "alltoall")
    if x.ndim < 2 or x.shape[1] % n:
        raise InvalidArgumentError(
            "alltoall: the per-rank leading axis %s must divide by %d"
            % (tuple(x.shape[1:2]), n))
    k = x.shape[1] // n
    rest = tuple(x.shape[2:])
    out = x.reshape((n, n, k) + rest).transpose(0, 1).reshape(x.shape)
    if was_list:
        outs = [out[i] for i in range(n)]
        if isinstance(out_tensor_or_list, list):
            out_tensor_or_list.extend(outs)
        return outs
    return out


all_to_all = alltoall


def send(tensor, dst: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    """Refused, as in the reference: a per-rank ``dst`` has no
    single-controller form (one program holds every rank).  Use
    ``distributed.p2p.send_next``/``send_prev``, the static shifts a
    pipeline schedule needs."""
    raise InvalidArgumentError(
        "send/recv with a per-rank dst is not expressible as one program "
        "under a single controller; use distributed.p2p.send_next/"
        "send_prev (a static shift over the group's ranks) -- the form "
        "pipeline schedules actually need")


def recv(tensor, src: int = 0, group: Optional[Group] = None,
         sync_op: bool = True):
    """See ``send``."""
    return send(tensor, src, group, sync_op)


def isend(tensor, dst: int = 0, group: Optional[Group] = None):
    return send(tensor, dst, group)


def irecv(tensor, src: int = 0, group: Optional[Group] = None):
    return recv(tensor, src, group)


class _P2P:
    """Static-shift point-to-point: ``send_next`` hands rank i's value to
    rank i+1 (mod n), ``send_prev`` to rank i-1, over the stacked view or
    a list of per-rank tensors (the reference's ``ppermute`` shifts)."""

    @staticmethod
    def _shift(x, group, step):
        group = group or _get_default_group()
        n = group.nranks
        if isinstance(x, (list, tuple)):
            if len(x) != n:
                raise InvalidArgumentError(
                    "p2p list form: need %d tensors, got %d" % (n, len(x)))
            return [x[(i - step) % n] for i in range(n)]
        x = _as_tensor(x, group)
        _check_rank_axis(x, group, "p2p")
        return torch.roll(x, step, dims=0)

    @staticmethod
    def send_next(x, group: Optional[Group] = None):
        return _P2P._shift(x, group, 1)

    @staticmethod
    def send_prev(x, group: Optional[Group] = None):
        return _P2P._shift(x, group, -1)


p2p = _P2P()


def barrier(group: Optional[Group] = None) -> None:
    """Block the host until the group's device has finished its work (in
    a launched world: until every process has reached the barrier)."""
    group = group or _get_default_group()
    if group.process_backed:
        import torch.distributed as tdist

        tdist.barrier(group=group._pg)
        return
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)


def wait(tensor, group: Optional[Group] = None,
         use_calc_stream: bool = True) -> None:
    """Block the host until ``tensor`` is computed."""
    if torch.is_tensor(tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


class stream:
    """``paddle.distributed.stream``: the stream-controlled variants are
    the plain collectives (the ranks share one device and one stream)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce = staticmethod(reduce)
    broadcast = staticmethod(broadcast)
    scatter = staticmethod(scatter)
    alltoall = staticmethod(alltoall)
    reduce_scatter = staticmethod(reduce_scatter)


_split_layers: dict = {}


def get_split_layer(name: str):
    """The parallel layer a named :func:`split` call created (its
    parameters feed an optimizer's list)."""
    if name not in _split_layers:
        raise InvalidArgumentError("no split layer named %r" % name)
    return _split_layers[name]


def split(x, size, operation: str, axis: int = 0, num_partitions: int = 1,
          gather_out: bool = True, weight_attr=None, bias_attr=None,
          name=None):
    """The reference's model-parallel linear/embedding in one call: builds
    the parallel layer over the active fleet's mp group and applies it.
    With ``name=`` the layer is made once and reused by every later call
    of that name (:func:`get_split_layer`); an unnamed call makes fresh
    weights each time, and warns."""
    from .meta_parallel.mp_layers import (ColumnParallelLinear,
                                          RowParallelLinear,
                                          VocabParallelEmbedding, _mp_group)

    group = _mp_group(None)
    if num_partitions != 1 and num_partitions != group.nranks:
        raise InvalidArgumentError(
            "num_partitions %d does not match the mp degree %d"
            % (num_partitions, group.nranks))
    if name is None:
        warnings.warn(
            "distributed.split without name= creates new weights on every "
            "call; pass name='...' to reuse one layer across steps",
            stacklevel=2)
    layer = _split_layers.get(name) if name is not None else None
    if layer is None:
        if operation == "embedding":
            layer = VocabParallelEmbedding(int(size[0]), int(size[1]),
                                           weight_attr=weight_attr,
                                           mp_group=group)
        elif operation != "linear":
            raise InvalidArgumentError(
                "split supports operation='linear' or 'embedding', got %r"
                % operation)
        elif axis == 1:
            layer = ColumnParallelLinear(int(size[0]), int(size[1]),
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out,
                                         mp_group=group)
        elif axis == 0:
            layer = RowParallelLinear(int(size[0]), int(size[1]),
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=False,
                                      mp_group=group)
        else:
            raise InvalidArgumentError("split axis must be 0 or 1")
        if name is not None:
            _split_layers[name] = layer
    return layer(x)

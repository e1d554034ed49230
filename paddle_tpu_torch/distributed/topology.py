"""The hybrid-parallel topology (counterpart of the reference's
``distributed/topology.py``).

``CommunicateTopology``'s rank maps (``get_rank``, ``get_coord``,
``get_axis_list``, ``get_comm_list``, ``get_rank_from_stage``) are
host-side arithmetic and are the reference's exactly.
``HybridCommunicateGroup`` builds the ``[dp, pp, sharding, mp]`` grid
(with ``sep`` and ``expert`` when their degrees exceed 1) as a logical
mesh whose ranks all sit on one device -- ``cuda:0`` unless
``device``/``devices`` say otherwise -- and hands out one ``Group`` per
axis.  A grid over more than one distinct device raises
``UnimplementedError``.
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Sequence

import torch

from ..core.errors import InvalidArgumentError
from .collective import Group, resolve_rank_devices

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode",
           "LogicalMesh"]


class ParallelMode:
    """The reference's ``ParallelMode``."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4  # sequence parallel


class CommunicateTopology:
    """Named-axis cartesian topology: rank r's coordinate is the r-th of
    ``itertools.product`` over the axes (the last axis fastest)."""

    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe",
                                                            "sharding",
                                                            "model"),
                 dims: Sequence[int] = (1, 1, 1, 1)):
        if len(hybrid_group_names) != len(dims):
            raise InvalidArgumentError(
                "topology names %r and dims %r must align"
                % (list(hybrid_group_names), list(dims)))
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = collections.namedtuple("Coordinate",
                                                 self._parallel_names)
        ranges = [range(d) for d in self._dims]
        all_coords = [self.coordinate(*c) for c in itertools.product(*ranges)]
        self._coord2rank = dict(zip(all_coords, range(len(all_coords))))
        self._rank2coord = dict(zip(self._coord2rank.values(),
                                    self._coord2rank.keys()))
        self._world_size = len(all_coords)

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **args) -> int:
        if len(args) != len(self._dims):
            raise InvalidArgumentError(
                "get_rank needs all axes %r, got %r"
                % (self._parallel_names, sorted(args)))
        return self._coord2rank[self.coordinate(**args)]

    def get_coord(self, rank: int):
        if rank not in self._rank2coord:
            raise InvalidArgumentError("rank %d out of range" % rank)
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """Every rank whose coordinate on ``axis_name`` is ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(self._coord2rank[c] for c in self._coord2rank
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The groups of ranks that communicate along ``axis_name``: one
        per assignment of the other axes."""
        axis = self._parallel_names.index(axis_name)
        other = [range(d) for i, d in enumerate(self._dims) if i != axis]
        comm_list = []
        for rest in itertools.product(*other):
            group = []
            for k in range(self._dims[axis]):
                coord = list(rest)
                coord.insert(axis, k)
                group.append(self._coord2rank[self.coordinate(*coord)])
            comm_list.append(group)
        return comm_list

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        """The rank at ``global_rank``'s coordinate with the given axes
        overridden."""
        coord = self.get_coord(global_rank)
        return self.get_rank(**coord._replace(**kwargs)._asdict())


# the mesh-axis name of each topology axis
_MESH_AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
              "model": "mp", "sep": "sep", "expert": "ep"}


class LogicalMesh:
    """The grid's shape by mesh-axis name (``shape["mp"]``, the
    reference's ``Mesh.shape``) and the one device its ranks sit on."""

    def __init__(self, axis_names: Sequence[str], dims: Sequence[int],
                 device):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(d) for d in dims)))
        self.device = torch.device(device)

    def __repr__(self):
        return "LogicalMesh(%s, device=%s)" % (self.shape, self.device)


class HybridCommunicateGroup:
    """Per-axis groups over the hybrid grid.  ``rank`` (0 by default: the
    controller) picks the coordinate the ``get_*_rank`` accessors and the
    groups' rank lists answer for; the grid's ranks sit on one device
    (``mesh.device``)."""

    def __init__(self, topology: CommunicateTopology, rank: int = 0,
                 devices=None, device=None):
        self._topo = topology
        self.global_rank = rank
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()

        def deg(name):
            return topology.get_dim(name) if name in names else 1

        self._dp_degree = deg("data")
        self._pp_degree = deg("pipe")
        self._sharding_degree = deg("sharding")
        self._mp_degree = deg("model")
        self._sep_degree = deg("sep")
        self._ep_degree = deg("expert")
        self.device = resolve_rank_devices(self.nranks, device, devices,
                                           "the hybrid grid")
        self.mesh = LogicalMesh([_MESH_AXIS.get(n, n) for n in names],
                                [topology.get_dim(n) for n in names],
                                self.device)
        coord = topology.get_coord(rank)
        self._dp_rank = getattr(coord, "data", 0)
        self._pp_rank = getattr(coord, "pipe", 0)
        self._sharding_rank = getattr(coord, "sharding", 0)
        self._mp_rank = getattr(coord, "model", 0)
        self._sep_rank = getattr(coord, "sep", 0)
        self._ep_rank = getattr(coord, "expert", 0)
        self._groups: Dict[str, Group] = {}

    def __repr__(self):
        return ("HybridCommunicateGroup(dp=%d, pp=%d, sharding=%d, mp=%d, "
                "sep=%d, ep=%d)" % (self._dp_degree, self._pp_degree,
                                    self._sharding_degree, self._mp_degree,
                                    self._sep_degree, self._ep_degree))

    def get_parallel_mode(self) -> int:
        """The dominant mode of this configuration (the reference's)."""
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._sep_degree > 1:
            return ParallelMode.SEGMENT_PARALLEL
        return ParallelMode.DATA_PARALLEL

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_global_rank(self) -> int:
        return self.global_rank

    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_data_parallel_rank(self) -> int:
        return self._dp_rank

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_model_parallel_rank(self) -> int:
        return self._mp_rank

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_stage_id(self) -> int:
        return self._pp_rank

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sharding_parallel_rank(self) -> int:
        return self._sharding_rank

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    def get_sep_parallel_rank(self) -> int:
        return self._sep_rank

    def get_expert_parallel_world_size(self) -> int:
        return self._ep_degree

    def get_expert_parallel_rank(self) -> int:
        return self._ep_rank

    def _axis_group(self, topo_axis: str) -> Group:
        """The group along ``topo_axis`` through this rank's coordinate
        (one object per axis, so ids stay stable)."""
        g = self._groups.get(topo_axis)
        if g is None:
            names = self._topo.get_hybrid_group_names()
            if topo_axis in names:
                lists = self._topo.get_comm_list(topo_axis)
                ranks = next((r for r in lists if self.global_rank in r),
                             lists[0])
            else:
                ranks = [self.global_rank]
            g = Group(ranks, self.device, _MESH_AXIS[topo_axis])
            self._groups[topo_axis] = g
        return g

    def get_data_parallel_group(self) -> Group:
        return self._axis_group("data")

    def get_model_parallel_group(self) -> Group:
        return self._axis_group("model")

    def get_pipe_parallel_group(self) -> Group:
        return self._axis_group("pipe")

    def get_sharding_parallel_group(self) -> Group:
        return self._axis_group("sharding")

    def get_sep_parallel_group(self) -> Group:
        return self._axis_group("sep")

    def get_expert_parallel_group(self) -> Group:
        return self._axis_group("expert")

    def get_p2p_next_rank(self) -> int:
        return self._topo.get_rank_from_stage(
            self.global_rank, pipe=(self._pp_rank + 1) % self._pp_degree)

    def get_p2p_prev_rank(self) -> int:
        return self._topo.get_rank_from_stage(
            self.global_rank, pipe=(self._pp_rank - 1) % self._pp_degree)

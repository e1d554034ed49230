"""``fleet``: the distributed facade (counterpart of the reference's
``distributed/fleet``).

``fleet.init(strategy=...)`` builds the ``HybridCommunicateGroup`` of the
strategy's ``hybrid_configs`` (dp, pp, sharding, mp, and sep and ep when
above 1) as one logical grid on one device -- ``cuda:0`` unless
``device="cpu"`` -- so a hybrid step is plain torch ops there and
captures as one CUDA graph.  ``distributed_model`` and
``distributed_optimizer`` wrap by the strategy as the reference's:
recompute of named sublayers, sequence parallelism over the ``sep``
group, ``PipelineParallel`` for a ``PipelineLayer``, ZeRO stage 3 or
``DataParallel`` for the model; lamb/lars, DGC, fp16 all-reduce, ZeRO
stage 2, local SGD and gradient merge for the optimizer, and AMP once
both are known.  ``compressed_train_step`` is the step whose gradient
communication is compressed (``distributed.CompressedAllReduceStep``).
``utils.recompute`` checkpoints activations.  Elastic training and the
parameter-server data generators are not ported.
"""
from __future__ import annotations

from typing import Optional

from ...core.errors import InvalidArgumentError
from ..collective import destroy_process_group, init_parallel_env
from ..topology import CommunicateTopology, HybridCommunicateGroup
from . import utils  # noqa: F401

__all__ = [
    "DistributedStrategy", "init", "fleet", "get_hybrid_communicate_group",
    "distributed_model", "distributed_optimizer", "worker_index",
    "worker_num", "is_first_worker", "barrier_worker", "Fleet", "Role",
    "RoleMakerBase", "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
    "UtilBase", "util",
]


class DistributedStrategy:
    """The strategy's knobs (the reference's): those with meaning on one
    card act, the rest are kept as set."""

    def __init__(self):
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.sharding = False
        self.sharding_configs = {}
        self.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sep_degree": 1, "ep_degree": 1}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1}
        self.sep_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.lamb = False
        self.lamb_configs = {}
        self.lars = False
        self.lars_configs = {}
        self.dgc = False
        self.dgc_configs = {}
        self.localsgd = False
        self.localsgd_configs = {}
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.nccl_comm_num = 1

    def __repr__(self):
        on = [k for k, v in vars(self).items() if isinstance(v, bool) and v]
        return "DistributedStrategy(%s, hybrid=%s)" % (
            ",".join(on) or "defaults", self.hybrid_configs)


class _Fleet:
    """The fleet singleton."""

    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._initialized = False
        self._model = None
        self._opt = None
        self._amp_applied = False

    def init(self, role_maker=None, is_collective: bool = True,
             strategy=None, device=None):
        """Build the hybrid grid of ``strategy.hybrid_configs`` on
        ``device`` (``cuda:0`` when None; raises without a card).  A
        grid of one rank is pure data parallelism over the world group's
        ranks."""
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        dims = [int(hc.get(k, 1) or 1) for k in
                ("dp_degree", "pp_degree", "sharding_degree", "mp_degree")]
        names = ["data", "pipe", "sharding", "model"]
        for key, name in (("sep_degree", "sep"), ("ep_degree", "expert")):
            deg = int(hc.get(key, 1) or 1)
            if deg > 1:
                names.append(name)
                dims.append(deg)
        prod = 1
        for d in dims:
            prod *= d
        if prod == 1:
            dims[0] = init_parallel_env(device=device).nranks
        else:
            destroy_process_group()
            init_parallel_env(world_size=prod, device=device)
        self._hcg = HybridCommunicateGroup(CommunicateTopology(names, dims),
                                           device=device)
        self._initialized = True
        self._model = None
        self._opt = None
        self._amp_applied = False
        return self

    @property
    def is_initialized(self) -> bool:
        return self._initialized

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        if self._hcg is None:
            raise InvalidArgumentError("call fleet.init() first")
        return self._hcg

    @property
    def strategy(self) -> DistributedStrategy:
        if self._strategy is None:
            raise InvalidArgumentError("call fleet.init() first")
        return self._strategy

    # one controller process holds every rank
    def worker_index(self) -> int:
        return 0

    def worker_num(self) -> int:
        return 1

    def is_first_worker(self) -> bool:
        return True

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def barrier_worker(self) -> None:
        from ..collective import barrier

        barrier()

    def _maybe_amp_decorate(self):
        """``amp.decorate`` once both the model and the optimizer are known
        (the innermost optimizer: the wrappers delegate its state)."""
        if not (self._strategy and self._strategy.amp):
            return
        if self._amp_applied or self._model is None or self._opt is None:
            return
        from ... import amp as _amp

        cfg = self._strategy.amp_configs or {}
        level = "O2" if cfg.get("use_pure_fp16") or cfg.get(
            "use_pure_bf16") else cfg.get("level", "O1")
        inner = self._opt
        while hasattr(inner, "_inner"):
            inner = inner._inner
        _amp.decorate(models=self._model, optimizers=inner, level=level,
                      dtype=cfg.get("dtype", "bfloat16"))
        self._amp_applied = True

    def _apply_recompute(self, model):
        """``recompute_configs["checkpoints"]``: wrap those sublayers'
        forwards in ``utils.recompute``."""
        from .utils import recompute

        names = (self._strategy.recompute_configs or {}).get(
            "checkpoints") or []
        wrapped = 0
        for name, sub in model.named_sublayers():
            if name in names and not getattr(sub, "_fleet_recompute", False):
                orig = sub.forward

                def ck_forward(*args, __orig=orig, **kw):
                    if kw:
                        return __orig(*args, **kw)
                    return recompute(__orig, *args)

                sub.forward = ck_forward
                sub._fleet_recompute = True
                wrapped += 1
        if names and not wrapped and not any(
                getattr(s, "_fleet_recompute", False)
                for _, s in model.named_sublayers()):
            raise InvalidArgumentError(
                "recompute_configs checkpoints %r match no sublayers of the "
                "model (available: %r)"
                % (names, [n for n, _ in model.named_sublayers()][:20]))
        return model

    def distributed_model(self, model):
        """Wrap ``model`` by the strategy: recompute, sequence parallelism
        over the sep group, ``PipelineParallel`` (a PipelineLayer at pp >
        1), ``GroupShardedParallel`` (sharding stage 3), else
        ``DataParallel`` when no other axis is split (mp is the parallel
        layers' own)."""
        from ..meta_parallel.pipeline_parallel import PipelineParallel
        from ..meta_parallel.pp_layers import PipelineLayer
        from ..meta_parallel.sharding_parallel import GroupShardedParallel
        from ..parallel import DataParallel

        hcg = self.get_hybrid_communicate_group()
        st = self.strategy
        if st.recompute:
            model = self._apply_recompute(model)
        if hcg.get_sep_parallel_world_size() > 1:
            if not hasattr(model, "enable_sequence_parallel"):
                raise InvalidArgumentError(
                    "hybrid_configs sep_degree > 1 but the model has no "
                    "enable_sequence_parallel hook: the sep axis would "
                    "waste %d-way ranks" % hcg.get_sep_parallel_world_size())
            if not getattr(model, "_sequence_parallel", False):
                cfg = getattr(st, "sep_configs", None) or {}
                model.enable_sequence_parallel(
                    hcg.get_sep_parallel_group(),
                    mode=cfg.get("mode", "ring"))
        out = model
        if isinstance(model, PipelineLayer) \
                and hcg.get_pipe_parallel_world_size() > 1:
            out = PipelineParallel(model, hcg=hcg, strategy=st)
        elif st.sharding and int((st.sharding_configs or {}).get(
                "stage", 2)) >= 3 \
                and hcg.get_sharding_parallel_world_size() > 1:
            out = GroupShardedParallel(
                model, group=hcg.get_sharding_parallel_group())
        elif (hcg.get_model_parallel_world_size() == 1
              and hcg.get_pipe_parallel_world_size() == 1
              and hcg.get_sharding_parallel_world_size() == 1):
            out = DataParallel(model, group=hcg.get_data_parallel_group())
        self._model = model
        self._maybe_amp_decorate()
        return out

    @staticmethod
    def _dgc_cfg(st):
        """``dgc_configs`` normalized (a per-epoch sparsity list takes its
        first entry; none is 0.999)."""
        cfg = getattr(st, "dgc_configs", None) or {}
        sp = cfg.get("sparsity")
        if isinstance(sp, (list, tuple)):
            sp = sp[0] if sp else None
        return dict(sparsity=0.999 if sp is None else float(sp),
                    momentum=float(cfg.get("momentum", 0.9)),
                    rampup_begin_step=int(cfg.get("rampup_begin_step", 0)))

    def distributed_optimizer(self, optimizer, strategy=None):
        """The strategy's optimizer stack: lamb/lars class swap, DGC and
        fp16 all-reduce gradient transforms, ZeRO stage 2, local SGD,
        gradient merge; AMP once the model is known too."""
        if strategy is not None:
            self._strategy = strategy
        st = self.strategy
        from ..meta_parallel.sharding_parallel import ShardingOptimizerStage2
        from .meta_optimizers import (DGCOptimizer, FP16AllreduceOptimizer,
                                      GradientMergeOptimizer,
                                      LocalSGDOptimizer, apply_lamb_lars)

        optimizer = apply_lamb_lars(optimizer, st)
        if getattr(st, "dgc", False):
            optimizer = DGCOptimizer(optimizer, **self._dgc_cfg(st))
        if getattr(st, "fp16_allreduce", False):
            optimizer = FP16AllreduceOptimizer(optimizer)
        if st.sharding:
            hcg = self.get_hybrid_communicate_group()
            if hcg.get_sharding_parallel_world_size() > 1:
                cfg = st.sharding_configs or {}
                optimizer = ShardingOptimizerStage2(
                    optimizer, group=hcg.get_sharding_parallel_group(),
                    offload=bool(cfg.get("offload", False)))
        if getattr(st, "localsgd", False):
            cfg = getattr(st, "localsgd_configs", None) or {}
            optimizer = LocalSGDOptimizer(optimizer,
                                          k_steps=int(cfg.get("k_steps", 1)))
        if st.gradient_merge:
            cfg = st.gradient_merge_configs or {}
            optimizer = GradientMergeOptimizer(
                optimizer, k_steps=int(cfg.get("k_steps", 1)),
                avg=bool(cfg.get("avg", True)))
        self._opt = optimizer
        self._maybe_amp_decorate()
        return optimizer

    def compressed_train_step(self, model, loss_fn, optimizer, **kw):
        """The data-parallel step whose gradient communication the
        strategy compresses: ``dgc`` (top-k exchange) or
        ``fp16_allreduce`` (a half-width sum), over the dp group."""
        from ..comm_hooks import CompressedAllReduceStep

        st = self.strategy
        group = self.get_hybrid_communicate_group().get_data_parallel_group()
        if getattr(st, "dgc", False):
            return CompressedAllReduceStep(model, loss_fn, optimizer,
                                           group=group, compression="dgc",
                                           **self._dgc_cfg(st), **kw)
        if getattr(st, "fp16_allreduce", False):
            return CompressedAllReduceStep(model, loss_fn, optimizer,
                                           group=group, compression="fp16",
                                           **kw)
        raise InvalidArgumentError(
            "compressed_train_step requires strategy.dgc or "
            "strategy.fp16_allreduce")


fleet = _Fleet()

init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker
get_hybrid_communicate_group = fleet.get_hybrid_communicate_group

Fleet = _Fleet


class Role:
    """The role maker's roles."""

    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    """Rank and role bookkeeping."""

    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_num = 1

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id

    def server_index(self) -> int:
        return self._current_id

    def worker_num(self) -> int:
        return self._worker_num

    def server_num(self) -> int:
        return 0

    def role_id(self) -> int:
        return self._current_id


class PaddleCloudRoleMaker(RoleMakerBase):
    """Cluster facts from the launcher's ``PADDLE_*`` environment."""

    def __init__(self, is_collective: bool = False, **kwargs):
        import os

        super().__init__()
        self._is_collective = is_collective
        self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in endpoints.split(",") if e]
        self._worker_num = max(len(self._worker_endpoints), 1)
        role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER

    def get_trainer_endpoints(self):
        return list(self._worker_endpoints)


class UserDefinedRoleMaker(RoleMakerBase):
    """An explicit topology."""

    def __init__(self, is_collective: bool = False, init_gloo: bool = False,
                 current_id: int = 0, role=Role.WORKER, worker_num: int = 1,
                 server_endpoints=None, **kwargs):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []


class UtilBase:
    """Small cross-worker utilities.  One controller process holds every
    rank, so a host value is already whole: ``all_reduce`` and
    ``all_gather`` over workers are the identity."""

    def all_reduce(self, input, mode: str = "sum",
                   comm_world: str = "worker"):
        import numpy as np

        if mode not in ("sum", "max", "min"):
            raise InvalidArgumentError(
                "all_reduce mode must be sum/max/min, got %r" % mode)
        if hasattr(input, "detach"):
            input = input.detach().cpu().numpy()
        return np.asarray(input)

    def barrier(self, comm_world: str = "worker"):
        from ..collective import barrier

        barrier()

    def all_gather(self, input, comm_world: str = "worker"):
        import numpy as np

        return [np.asarray(input)]

    def get_file_shard(self, files):
        """The worker's share of a sorted file list."""
        w, i = fleet.worker_num(), fleet.worker_index()
        files = sorted(files)
        per = (len(files) + w - 1) // w
        return files[i * per:(i + 1) * per]

    def print_on_rank(self, message: str, rank_id: int = 0):
        if fleet.worker_index() == rank_id:
            print(message)


util = UtilBase()

from . import elastic  # noqa: E402,F401
from ..ps_compat import (  # noqa: E402,F401
    MultiSlotDataGenerator, MultiSlotStringDataGenerator,
)

__all__ += ["elastic", "MultiSlotDataGenerator",
            "MultiSlotStringDataGenerator"]

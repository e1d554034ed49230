"""Distributed training and serving on one card (counterpart of the
reference's ``paddle_tpu.distributed``).

The reference is single-controller: one program holds every rank.  The
port keeps that, with every rank of a mesh on one device (``cuda:0``, or
``"cpu"`` when asked); a grid over several cards raises
``UnimplementedError`` (ROADMAP queue 1 item 6).

- ``collective``: ``Group`` (one axis of the logical mesh),
  ``init_parallel_env``/``new_group``, and the eager collectives over the
  stacked ``[nranks, ...]`` view (``all_reduce``, ``reduce``,
  ``all_gather``, ``reduce_scatter``, ``broadcast``, ``scatter``,
  ``alltoall``, ``p2p``, ``barrier``, ``wait``; ``send``/``recv`` refused
  as in the reference), sums in float32 in rank order; ``split``.
- ``topology``: ``CommunicateTopology``'s rank maps and the
  ``HybridCommunicateGroup`` of ``fleet.init``.
- ``parallel``: ``DataParallel``, ``ParallelEnv``; ``comm_hooks``: the
  data-parallel step with fp16 or DGC gradient communication.
- ``fleet``: strategies, ``distributed_model``/``distributed_optimizer``,
  the meta-optimizers, role makers, ``utils.recompute``.
- ``meta_parallel``: tensor-parallel layers, the pipeline, ZeRO,
  sequence parallelism (ring, Ulysses over K3), mixture-of-experts.
- ``qcollectives``, ``sharded``: the quantized model-parallel reductions
  and per-shard caches of the sharded decode step (``jit.mesh``).

- ``launch`` (``python -m paddle_tpu_torch.distributed.launch``) and
  ``spawn``: a gang of trainer processes with the ``PADDLE_TRAINER_*``
  environment, watched, killed on a failure and relaunched
  (``--max_restarts``; ``fleet.elastic``'s heartbeats); under them
  ``init_parallel_env()`` makes a process-backed world over
  ``torch.distributed`` (``collective``).
- ``ps_compat``: the parameter-server era's slot-file data generators and
  datasets as numpy batches; ``fleet.utils.fs``: ``LocalFS``.
"""
from . import qcollectives  # noqa: F401
from .qcollectives import (COLLECTIVE_QUANT_MODES,  # noqa: F401
                           COLLECTIVE_QUANT_SCALES, QUANT_BLOCK,
                           dequantize_int8, psum_wire_bytes, qall_gather,
                           qpsum, qpsum_wire_bytes, quantize_int8,
                           row_parallel_linear)
from .collective import (Group, ReduceOp, all_gather,  # noqa: F401
                         all_reduce, all_to_all, alltoall, barrier,
                         broadcast, destroy_process_group, get_group,
                         get_rank, get_world_size, init_parallel_env, irecv,
                         is_initialized, isend, new_group, p2p, recv, reduce,
                         reduce_scatter, scatter, send, split, stream, wait)
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, ParallelMode)
from . import fleet  # noqa: F401
from .parallel import (DataParallel, ParallelEnv, scale_loss,  # noqa: F401
                       shard_batch)
from . import meta_parallel  # noqa: F401
from .comm_hooks import CompressedAllReduceStep  # noqa: F401
from . import launch  # noqa: F401
from .ps_compat import (CountFilterEntry, InMemoryDataset,  # noqa: F401
                        ProbabilityEntry, QueueDataset)
from .spawn import ParallelContext, spawn  # noqa: F401

__all__ = [
    "split", "Group", "ReduceOp", "all_gather", "all_reduce", "all_to_all",
    "alltoall", "barrier", "broadcast", "destroy_process_group", "get_group",
    "get_rank", "get_world_size", "init_parallel_env", "irecv",
    "is_initialized", "isend", "new_group", "p2p", "recv", "reduce",
    "reduce_scatter", "scatter", "send", "stream", "wait", "DataParallel",
    "ParallelEnv", "scale_loss", "shard_batch", "CommunicateTopology",
    "HybridCommunicateGroup", "ParallelMode", "fleet",
    "CompressedAllReduceStep", "qcollectives", "COLLECTIVE_QUANT_MODES",
    "COLLECTIVE_QUANT_SCALES", "QUANT_BLOCK", "quantize_int8",
    "dequantize_int8", "qpsum", "qall_gather", "psum_wire_bytes",
    "qpsum_wire_bytes", "row_parallel_linear", "launch", "spawn",
    "ParallelContext", "InMemoryDataset", "QueueDataset", "CountFilterEntry",
    "ProbabilityEntry",
]

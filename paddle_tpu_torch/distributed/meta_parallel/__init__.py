"""Hybrid-parallel model layers (counterpart of the reference's
``distributed/meta_parallel``): tensor-parallel layers, the pipeline's
description, engine and train step, ZeRO sharding, sequence parallelism
and mixture-of-experts, each over a group whose ranks share one device.
"""
from .moe_layer import MoELayer, top2_gating  # noqa: F401
from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding, shard_linear)
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .sequence_parallel import (gather_sequence,  # noqa: F401
                                ring_attention, split_sequence,
                                ulysses_attention)
from .sharding_parallel import (GroupShardedParallel,  # noqa: F401
                                ShardingOptimizerStage2,
                                group_sharded_parallel)
from .spmd_pipeline import (PipelineTrainStep,  # noqa: F401
                            megatron_param_spec, partition_pipeline)

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelCrossEntropy", "LayerDesc", "SharedLayerDesc", "PipelineLayer",
    "PipelineParallel", "ring_attention", "ulysses_attention",
    "split_sequence", "gather_sequence", "ShardingOptimizerStage2",
    "GroupShardedParallel", "group_sharded_parallel", "MoELayer",
    "top2_gating",
]

"""Hybrid-parallel layer library (SURVEY §2.4): counterpart of
``paddle_tpu/parallel/``.  TP / SP = DTensor placements on 'mp'; EP = dense
GShard dispatch with the experts on 'ep'; ZeRO = placements on 'sharding';
PP = the SPMD ``mesh_ppermute`` schedule or the stage-partitioned container
(one process a stage rank); CP = ring or Ulysses attention over 'sep'."""
from .mp_layers import (VocabParallelEmbedding, ColumnParallelLinear,  # noqa: F401
                        RowParallelLinear, ParallelCrossEntropy,
                        RNGStatesTracker, get_rng_state_tracker,
                        model_parallel_random_seed)
from .sequence_parallel import (ColumnSequenceParallelLinear,  # noqa: F401
                                RowSequenceParallelLinear, AllGatherOp,
                                ReduceScatterOp,
                                mark_as_sequence_parallel_parameter,
                                register_sequence_parallel_allreduce_hooks)
from .moe import MoELayer, ExpertMLP, top2_gating  # noqa: F401
from .ring_attention import ring_flash_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
from .pipeline import pipeline_forward, pipeline_call  # noqa: F401
from .pipeline_layer import (PipelineLayer, LayerDesc, SharedLayerDesc,  # noqa: F401
                             PipelineParallel, PipelineParallelWithInterleave,
                             ZeroBubblePipelineParallel)
from .tensor_parallel import TensorParallel, SegmentParallel  # noqa: F401
from .sharding import (group_sharded_parallel, save_group_sharded_model,  # noqa: F401
                       DygraphShardingOptimizer, GroupShardedStage2,
                       GroupShardedStage3, GroupShardedOptimizerStage2,
                       shard_parameters, shard_accumulators)

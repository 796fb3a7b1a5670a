"""fleet.meta_parallel compat (reference: fleet/meta_parallel/__init__.py)."""
from ....parallel.pipeline_layer import (PipelineLayer, LayerDesc,  # noqa: F401
                                         SharedLayerDesc, PipelineParallel,
                                         PipelineParallelWithInterleave,
                                         ZeroBubblePipelineParallel)
from ....parallel.tensor_parallel import TensorParallel, SegmentParallel  # noqa: F401
from ....parallel.mp_layers import (VocabParallelEmbedding, ColumnParallelLinear,  # noqa: F401
                                    RowParallelLinear, ParallelCrossEntropy,
                                    get_rng_state_tracker)

"""paddle.nn.functional surface: counterpart of
``paddle_tpu/nn/functional/__init__.py`` (reference:
python/paddle/nn/functional/__init__.py), less the modules the port does
not have yet (``extras``, ``extra_losses``)."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .conv import (conv1d, conv2d, conv3d, conv1d_transpose, conv2d_transpose,  # noqa: F401
                   conv3d_transpose)
from .pooling import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import (scaled_dot_product_attention, flash_attention,  # noqa: F401
                        sequence_mask, paged_attention)
from .rope import fused_rotary_position_embedding  # noqa: F401

"""paddle.nn.functional surface: counterpart of
``paddle_tpu/nn/functional/__init__.py`` (reference:
python/paddle/nn/functional/__init__.py)."""
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
from .extra_losses import (poisson_nll_loss, gaussian_nll_loss,  # noqa: F401
                           soft_margin_loss, multi_label_soft_margin_loss,
                           multi_margin_loss,
                           triplet_margin_with_distance_loss, dice_loss,
                           log_loss, npair_loss, hsigmoid_loss,
                           margin_cross_entropy, ctc_loss, rnnt_loss,
                           adaptive_log_softmax_with_loss)
from .extras import (pairwise_distance, elu_, hardtanh_, leaky_relu_,  # noqa: F401
                     tanh_, thresholded_relu_, lp_pool1d, lp_pool2d,
                     fractional_max_pool2d, fractional_max_pool3d,
                     max_unpool3d, affine_grid, grid_sample, temporal_shift,
                     gather_tree, class_center_sample, flashmask_attention,
                     flash_attn_qkvpacked, flash_attn_varlen_qkvpacked,
                     sparse_attention)

"""paddle.nn surface: counterpart of ``paddle_tpu/nn/__init__.py``
(reference: python/paddle/nn/__init__.py): ``Layer`` and the layers of
``layer/``, the functionals, the initializers and ``ParamAttr``, gradient
clipping, ``utils``, and ``quant``, the weight-only functions serving
uses."""
from .layer import *  # noqa: F401,F403
from .layer.layers import Layer  # noqa: F401
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import quant  # noqa: F401
from .initializer import ParamAttr  # noqa: F401
from .clip import (ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm,  # noqa: F401
                   clip_grad_norm_, clip_grad_value_)
from . import utils  # noqa: F401

"""The ``nn`` pieces training needs: gradient clipping (``clip``) and the
attention and loss functionals (``functional``); and ``quant``, the
weight-only functions serving uses."""
from . import quant  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]

"""The ``nn`` pieces training needs: gradient clipping (``clip``) and the
attention and loss functionals (``functional``)."""
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]

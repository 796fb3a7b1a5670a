"""paddle.framework compat namespace: counterpart of
``paddle_tpu/framework/__init__.py``."""
from .io import save, load  # noqa: F401
from ..core.rng import seed  # noqa: F401
from ..core.dtype import set_default_dtype, get_default_dtype  # noqa: F401


def in_dynamic_mode():
    from ..core.dispatch import _state
    return _state.trace_ctx is None

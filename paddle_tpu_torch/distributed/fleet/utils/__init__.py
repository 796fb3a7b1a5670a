"""fleet.utils compat (reference: fleet/utils/__init__.py)."""
from ..recompute import recompute, recompute_sequential, recompute_hybrid  # noqa: F401
from ....parallel import sequence_parallel as sequence_parallel_utils  # noqa: F401
from . import timer_helper  # noqa: F401
from .timer_helper import get_timers, set_timers  # noqa: F401

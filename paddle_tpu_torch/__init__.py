"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The package mirrors ``paddle_tpu``'s layout path for path
(``paddle_tpu_torch/x/y.py`` is the counterpart of ``paddle_tpu/x/y.py``)
and imports neither JAX nor anything of ``paddle_tpu``.  Plain tensor code
is PyTorch; every Pallas kernel of the JAX package becomes a kernel written
by hand for ``sm_90a`` under ``csrc/``, built at first use by
:mod:`paddle_tpu_torch.ops._build`.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; see :func:`paddle_tpu_torch.device.resolve_device`.
"""
from .core.flags import get_flags, set_flags  # noqa: F401
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device", "set_flags", "get_flags"]

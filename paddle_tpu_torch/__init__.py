"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The package mirrors ``paddle_tpu``'s layout path for path
(``paddle_tpu_torch/x/y.py`` is the counterpart of ``paddle_tpu/x/y.py``)
and imports neither JAX nor anything of ``paddle_tpu``.  Plain tensor code
is PyTorch; every Pallas kernel of the JAX package becomes a kernel written
by hand for ``sm_90a`` under ``csrc/``, built at first use by
:mod:`paddle_tpu_torch.ops._build`.

The top level is the reference's Paddle surface for what is ported:
``Tensor`` over a ``torch.Tensor`` with torch's autograd as the tape
(``core``, ``autograd``), the dtypes, the place, the seed, and the ops of
``ops/{creation,math,manipulation,logic}.py``.  New tensors go to the card
unless ``set_device("cpu")`` was called (without CUDA they raise); entry
points take ``device=`` and default to the card, see
:func:`paddle_tpu_torch.device.resolve_device`.
"""
from __future__ import annotations

import importlib

# core types
from .core.tensor import Tensor, Parameter
from .core.dtype import (
    bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128, float8_e4m3fn, float8_e5m2,
    set_default_dtype, get_default_dtype,
)
from .core.device import (
    set_device, get_device, device_count, is_compiled_with_cuda,
    is_compiled_with_xpu, is_compiled_with_cinn, Place, resolve_device,
)
from .core.flags import set_flags, get_flags
from .version import __version__
from .core.rng import seed, get_rng_state, set_rng_state, Generator
from .core import enforce

# ops (flat namespace like paddle.*)
from .ops import *  # noqa: F401,F403
from .ops import creation as _creation

# autograd
from .autograd import no_grad, enable_grad, set_grad_enabled, is_grad_enabled, grad
from . import autograd

bool = bool_  # paddle.bool


def is_tensor(x):
    return isinstance(x, Tensor)


def tensor(data, dtype=None, place=None, stop_gradient=True):
    return _creation.to_tensor(data, dtype, place, stop_gradient)


def in_dynamic_mode():
    from .core.dispatch import _state
    return _state.trace_ctx is None


def in_dynamic_or_pir_mode():
    return True


def enable_static():  # static mode is to_static-based; kept for API compat
    pass


def disable_static():
    pass


def disable_signal_handler():
    pass


# Subpackages load lazily (PEP 562) so `import paddle_tpu_torch` stays light
# and the core never depends on higher layers.
_LAZY = {
    "nn", "optimizer", "amp", "io", "jit", "distributed", "device", "models",
    "inference", "quantization", "observability", "testing", "framework",
    "metric", "hapi",
}

_LAZY_ATTRS = {
    "save": ("paddle_tpu_torch.framework.io", "save"),
    "load": ("paddle_tpu_torch.framework.io", "load"),
    "Model": ("paddle_tpu_torch.hapi.model", "Model"),
    "summary": ("paddle_tpu_torch.hapi.model", "summary"),
    "flops": ("paddle_tpu_torch.hapi.model", "flops"),
    "CPUPlace": ("paddle_tpu_torch.core.device", "Place"),
    "get_default_generator": ("paddle_tpu_torch.core.rng", "default_generator"),
    "ParamAttr": ("paddle_tpu_torch.nn.initializer", "ParamAttr"),
    "linalg": ("paddle_tpu_torch.ops", "linalg"),
}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"paddle_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    if name in _LAZY_ATTRS:
        modname, attr = _LAZY_ATTRS[name]
        val = getattr(importlib.import_module(modname), attr)
        globals()[name] = val
        return val
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute {name!r}")


# ---- top-level compat surface (reference python/paddle/__init__.py) ---------
import math as _math  # noqa: E402

inf = float("inf")
nan = float("nan")
pi = _math.pi
e = _math.e
newaxis = None

from .framework.compat import (  # noqa: F401,E402
    dtype, iinfo, finfo, set_printoptions, CUDAPlace, CUDAPinnedPlace,
    get_cuda_rng_state, set_cuda_rng_state, to_dlpack, from_dlpack,
    LazyGuard, batch, check_shape, pstring, raw)

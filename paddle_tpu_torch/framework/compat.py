"""Top-level API compat pieces: counterpart of
``paddle_tpu/framework/compat.py`` (reference: python/paddle/__init__.py
exports — iinfo/finfo/dtype, dlpack interop, printoptions, CUDA place/rng,
the legacy `batch` reader decorator, LazyGuard).

On the port the dtypes are torch's (``torch.iinfo`` / ``torch.finfo``,
bfloat16 and float8 included), the CUDA places are the card's, the CUDA
RNG state is the port's generator on the card, and dlpack goes through
``torch.utils.dlpack``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core import dtype as dtypes
from ..core.device import Place


class dtype:
    """paddle.dtype — wraps a torch dtype with paddle naming
    (reference: the pybind DataType enum exposed as paddle.dtype)."""

    def __init__(self, d):
        self.torch = dtypes.convert_dtype(d)

    @property
    def name(self):
        return dtypes.dtype_name(self.torch)

    def __eq__(self, other):
        if isinstance(other, dtype):
            return self.torch == other.torch
        try:
            return self.torch == dtypes.convert_dtype(other)
        except (TypeError, ValueError, KeyError):
            return NotImplemented

    def __hash__(self):
        return hash(self.torch)

    def __repr__(self):
        return f"paddle.{self.name}"


class iinfo:
    """reference paddle.iinfo (pybind iinfo): integer type limits."""

    def __init__(self, d):
        d = dtypes.convert_dtype(d)
        info = torch.iinfo(d)
        self.min, self.max, self.bits = int(info.min), int(info.max), info.bits
        self.dtype = dtypes.dtype_name(d)

    def __repr__(self):
        return f"iinfo(min={self.min}, max={self.max}, bits={self.bits})"


class finfo:
    """reference paddle.finfo: floating type limits (bfloat16 aware)."""

    def __init__(self, d):
        d = dtypes.convert_dtype(d)
        info = torch.finfo(d)
        self.min = float(info.min)
        self.max = float(info.max)
        self.eps = float(info.eps)
        self.tiny = float(info.tiny)
        self.smallest_normal = self.tiny
        self.bits = info.bits
        self.dtype = dtypes.dtype_name(d)

    def __repr__(self):
        return (f"finfo(min={self.min}, max={self.max}, eps={self.eps}, "
                f"bits={self.bits})")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """reference paddle.set_printoptions — numpy drives Tensor repr here."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


# ---- CUDA places and RNG ---------------------------------------------------------
class CUDAPlace(Place):
    """The reference's GPU place: card ``device_id``."""

    def __init__(self, device_id=0):
        super().__init__(torch.device("cuda", int(device_id)))


class CUDAPinnedPlace(Place):
    """Pinned host memory: a host place (the staging area of copies to
    the card)."""

    def __init__(self):
        super().__init__(torch.device("cpu"))


def get_cuda_rng_state():
    """The port's generator state on each card (``[Tensor]``, one uint8
    state a card, as ``torch.cuda.get_rng_state_all`` lists them)."""
    from ..core.rng import default_generator
    gen = default_generator()
    return [Tensor(gen.generator(torch.device("cuda", i)).get_state())
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state):
    """Put back states from :func:`get_cuda_rng_state`."""
    from ..core.rng import default_generator
    gen = default_generator()
    for i, s in enumerate(state):
        buf = s._data if isinstance(s, Tensor) else torch.as_tensor(s)
        gen.generator(torch.device("cuda", i)).set_state(buf.cpu())


# ---- dlpack ------------------------------------------------------------------
def to_dlpack(x):
    """reference paddle.utils.dlpack.to_dlpack / paddle.to_dlpack."""
    from torch.utils.dlpack import to_dlpack as _to
    arr = x._data if isinstance(x, Tensor) else x
    return _to(arr.detach())


def from_dlpack(capsule):
    """Accepts any __dlpack__-capable object (numpy, torch, paddle
    Tensors) or a legacy raw capsule; the Tensor shares its memory."""
    if isinstance(capsule, Tensor):
        capsule = capsule._data
    return Tensor(torch.from_dlpack(capsule))


# ---- misc --------------------------------------------------------------------
class LazyGuard:
    """reference paddle.LazyGuard defers parameter materialization during
    Layer construction.  The port builds parameters where they are created
    (the current place), so the guard is a compat context manager with no
    extra effect."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """Legacy reader decorator (reference python/paddle/reader): turns a
    sample generator fn into a batch generator fn."""
    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def check_shape(shape):
    """reference paddle.static check_shape: validate a shape spec (ints, -1
    for inferred, None for dynamic)."""
    if isinstance(shape, (list, tuple)):
        for v in shape:
            if v is None:
                continue
            if not isinstance(v, (int, np.integer)):
                raise TypeError(f"shape entries must be int/None, got {v!r}")
            if v < -1:
                raise ValueError(f"shape entries must be >= -1, got {v}")
    elif not isinstance(shape, (int, np.integer)):
        raise TypeError(f"shape must be int or list/tuple, got {type(shape)}")
    return shape


class _UnsupportedDType:
    """Placeholder for the reference's prototype string dtypes (pstring/raw);
    using them raises instead of silently mis-typing."""

    def __init__(self, name):
        self._name = name

    def __repr__(self):
        return f"paddle.{self._name} (unsupported)"

    def __call__(self, *a, **k):
        raise TypeError(f"dtype {self._name!r} is not supported")


pstring = _UnsupportedDType("pstring")
raw = _UnsupportedDType("raw")

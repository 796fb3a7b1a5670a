"""paddle.save / paddle.load (reference: python/paddle/framework/io.py:773,1020):
counterpart of ``paddle_tpu/framework/io.py``.

Format: the reference's: ``_MAGIC`` then a pickle with Tensors
materialized as numpy arrays in ``(array, is_param, name)`` payloads.
Compatible surface: state_dicts, nested containers, plain Tensors,
optimizer state.

The card's machine has no ``ml_dtypes``, so numpy has no bfloat16 there.
The port writes a bfloat16 (or float8) tensor as its raw bits in a
``_HostArray`` tagged with the torch dtype, and reads the reference's
files through its own unpickler (``_Unpickler.find_class``): the
reference's payload class maps to the port's, and an ``ml_dtypes`` dtype
becomes a stand-in whose arrays arrive as their raw bits, viewed as the
torch dtype bit for bit.  Neither ``paddle_tpu`` nor ``ml_dtypes`` is
imported.  The port's files name the port's payload class, so the
reference does not read them.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.tensor import Tensor, Parameter
from ..core.device import current_device

_PROTO = 4
_MAGIC = b"PTPU1\n"

# ml_dtypes' names -> (torch dtype, the unsigned integer of its width)
_TAGGED = {"bfloat16": (torch.bfloat16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8)}
_BITS = {t: (name, u) for name, (t, u) in _TAGGED.items()}


class _TensorPayload:
    __slots__ = ("array", "is_param", "name")

    def __init__(self, array, is_param, name):
        self.array = array
        self.is_param = is_param
        self.name = name


class _HostArray(np.ndarray):
    """A numpy array that may hold the raw bits of a dtype numpy lacks
    here (``torch_dtype``, e.g. bfloat16); None for a plain array."""

    torch_dtype = None

    def __setstate__(self, state):
        # ndarray state: (version, shape, dtype, is_fortran, raw data)
        dt = state[2]
        if isinstance(dt, _MlDtype):
            self.torch_dtype, bits = _TAGGED[dt.name]
            state = state[:2] + (np.dtype(bits),) + state[3:]
        super().__setstate__(state)

    def __reduce__(self):
        if self.torch_dtype is None:
            return np.asarray, (self.view(np.ndarray),)
        return _tagged, (self.view(np.ndarray), _BITS[self.torch_dtype][0])


def _tagged(bits, name):
    """A ``_HostArray`` of the raw bits ``bits`` of ml_dtypes' ``name``."""
    a = np.ascontiguousarray(bits).view(_HostArray)
    a.torch_dtype = _TAGGED[name][0]
    return a


class _MlDtype:
    """Stands in for an ``ml_dtypes`` scalar type and for the numpy dtype
    made from it while a reference file is read."""

    def __init__(self, name):
        if name not in _TAGGED:
            raise pickle.UnpicklingError(
                f"ml_dtypes.{name} is not readable without ml_dtypes")
        self.name = name

    def __setstate__(self, state):
        pass


def _dtype(obj, *args):
    return obj if isinstance(obj, _MlDtype) else np.dtype(obj, *args)


def _reconstruct(cls, shape, dtype):
    return np.ndarray.__new__(_HostArray, shape, dtype)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's files and the port's without importing the
    reference's package or ``ml_dtypes``."""

    def find_class(self, module, name):
        if name == "_TensorPayload" and module in (
                "paddle_tpu.framework.io", __name__):
            return _TensorPayload
        if module == "ml_dtypes":
            return _MlDtype(name)
        if module == "numpy" and name == "dtype":
            return _dtype
        if name == "_reconstruct" and module in (
                "numpy.core.multiarray", "numpy._core.multiarray"):
            return _reconstruct
        if module.split(".")[0] == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"{module}.{name} belongs to the JAX package")
        if module.startswith(("numpy._core", "numpy.core")):
            # numpy 2 writes numpy._core, numpy 1 numpy.core: read either
            _, _, rest = module.partition("core")
            for pkg in ("numpy._core", "numpy.core"):
                try:
                    return super().find_class(pkg + rest, name)
                except (ImportError, AttributeError):
                    continue
        return super().find_class(module, name)


def _host(t):
    """A Tensor's value as a host array: bfloat16 and float8 as their raw
    bits in a tagged ``_HostArray``."""
    b = t._data.detach()
    if b.dtype in _BITS:
        name, bits = _BITS[b.dtype]
        signed = torch.int16 if bits is np.uint16 else torch.int8
        return _tagged(b.view(signed).cpu().numpy().view(bits), name)
    return b.cpu().resolve_conj().resolve_neg().numpy()


def _to_buf(a, torch_dtype=None):
    """A host array (tagged, or holding the raw bits of ``torch_dtype``, or
    plain) as a torch tensor on the current place, bit for bit."""
    td = torch_dtype or getattr(a, "torch_dtype", None)
    plain = np.asarray(a, order="C")
    if td is not None:
        signed = np.int16 if plain.dtype.itemsize == 2 else np.int8
        buf = torch.from_numpy(plain.view(signed)).view(td)
    else:
        buf = torch.from_numpy(plain)
    return buf.to(current_device())


def _numpy(a):
    """A loaded array for ``return_numpy``: numpy's own, with bfloat16 and
    float8 as float32 (numpy has no such dtype without ``ml_dtypes``)."""
    if getattr(a, "torch_dtype", None) is not None:
        return _to_buf(a).float().cpu().numpy()
    return a.view(np.ndarray) if isinstance(a, np.ndarray) else a


def _pack(obj):
    if isinstance(obj, Tensor):
        return _TensorPayload(_host(obj), isinstance(obj, Parameter), obj.name)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return _numpy(obj.array)
        t = Parameter(_to_buf(obj.array), name=obj.name) if obj.is_param \
            else Tensor(_to_buf(obj.array), name=obj.name)
        if obj.is_param:
            t.persistable = True
        return t
    if isinstance(obj, _HostArray):
        return _numpy(obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=_PROTO, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs):
    return_numpy = configs.get("return_numpy", False)
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            f.seek(0)  # tolerate plain-pickle files
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy)

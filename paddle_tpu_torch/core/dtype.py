"""Dtype system: counterpart of ``paddle_tpu/core/dtype.py``.

Paddle exposes a closed dtype enum (paddle/phi/common/data_type.h); here
dtypes ARE ``torch.dtype`` objects (``paddle_tpu_torch.bfloat16 is
torch.bfloat16``), under the Paddle string names ("float32", "bfloat16",
...) and the legacy VarType aliases.

The reference runs JAX with x64 off, so int64 / float64 / complex128
requests narrow to their 32-bit types (``convert_dtype``), and dispatch
narrows op outputs the same way; the visible dtypes of the two packages
then agree.  Ops that torch wants int64 indices for (gather,
take_along_axis, embedding lookups) widen inside the op.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "bfloat16": bfloat16,
    "float32": float32, "float64": float64, "complex64": complex64,
    "complex128": complex128, "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2,
    # paddle legacy VarType names
    "FP32": float32, "FP64": float64, "FP16": float16, "BF16": bfloat16,
    "INT32": int32, "INT64": int64, "BOOL": bool_,
}

# the narrowing the reference sees with JAX x64 off
NARROW = {int64: int32, float64: float32, complex128: complex64,
          torch.uint64: torch.uint32}

_FROM_NUMPY = {np.dtype(np.bool_): bool_, np.dtype(np.uint8): uint8,
               np.dtype(np.int8): int8, np.dtype(np.int16): int16,
               np.dtype(np.int32): int32, np.dtype(np.int64): int64,
               np.dtype(np.float16): float16, np.dtype(np.float32): float32,
               np.dtype(np.float64): float64,
               np.dtype(np.complex64): complex64,
               np.dtype(np.complex128): complex128,
               np.dtype(np.uint32): torch.uint32,
               np.dtype(np.uint64): torch.uint64}

_FLOATING = {float16, bfloat16, float32, float64, float8_e4m3fn, float8_e5m2}
_INTEGER = {uint8, int8, int16, int32, int64}


def _to_torch(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        if dtype.startswith("paddle."):
            return _to_torch(dtype[len("paddle."):])
    nd = np.dtype(dtype)
    # ml_dtypes' bfloat16 / float8 (the reference's) go by name
    return _FROM_NUMPY.get(nd) or _ALIASES[nd.name]


def convert_dtype(dtype):
    """Normalize any dtype spec (str, torch / numpy dtype, None) to a
    ``torch.dtype``, narrowing 64-bit requests to 32 bits as the reference
    does with JAX x64 off."""
    if dtype is None:
        return None
    d = _to_torch(dtype)
    return NARROW.get(d, d)


def dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return "bool" if dtype is bool_ else str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def is_floating_point(dtype) -> bool:
    return _to_torch(dtype) in _FLOATING


def is_integer(dtype) -> bool:
    d = _to_torch(dtype)
    return d in _INTEGER or d is bool_


def is_complex(dtype) -> bool:
    return _to_torch(dtype) in (complex64, complex128)


# Default dtype management (paddle.set_default_dtype analog;
# reference: python/paddle/base/framework.py get_default_dtype)
_default_dtype = float32


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if not is_floating_point(d):
        raise TypeError(f"set_default_dtype only supports floating dtypes, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype

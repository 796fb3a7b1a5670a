"""Weight-only quantized matmul: the CUDA kernel's wrapper and its plain
PyTorch twin.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py``.  K8
(``_kernel``): y = x @ dequant(W) * scale with W int8 ``[K, N]`` or int4
packed two to a byte ``[K / 2, N]`` (low nibble row 2i, high nibble row
2i + 1, sign-extended), the f32 per-column scale applied after the f32 sum,
y in x's dtype.  One CUDA source, ``csrc/quant_matmul.cu``, holds it (see
the note there for the grid, the split of K and what bounds it); the bf16
weight is never materialised.

The device alone decides the path: CPU tensors compute
:func:`quant_matmul_ref`; CUDA tensors launch the kernel or raise — on a
dtype, a device mix, a shape, or a failed build or launch — and never fall
back.  Launch counters, plain ints: ``quant_matmul.launches`` (int8) and
``quant_matmul.launches_int4``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["quant_matmul", "quant_matmul_ref", "supported", "unpack_int4",
           "BK", "BN"]

BK = 256
BN = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STRIP = 64            # columns of a CUDA block
_BLOCKS_PER_SM = 2     # split K until a call has this many blocks an SM
_lib = None
_sms = {}              # SM count by device index


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("quant_matmul")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib.quant_matmul.restype = ci
        lib.paddle_cuda_error_string.argtypes = [ci]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def supported(M, K, N, int4=False, bk=BK, bn=BN):
    """The reference's predicate: K and N divide the (256, 256) blocks."""
    return K % bk == 0 and N % bn == 0


def unpack_int4(qw):
    """Packed int4 ``[K / 2, N]`` -> int8 ``[K, N]``: row 2i from the low
    nibble, row 2i + 1 from the high one, both sign-extended."""
    lo = (qw << 4).to(torch.int8) >> 4
    hi = qw >> 4
    return torch.stack([lo, hi], dim=1).reshape(-1, qw.shape[-1])


def quant_matmul_ref(x, qw, scale, *, int4=False):
    """Plain PyTorch version of K8: the integer weight (unpacked for int4)
    in float32, which is exact, x in float32 @ W, times the float32
    scale, cast to x's dtype."""
    w = unpack_int4(qw) if int4 else qw
    y = (x.float() @ w.float()) * scale.float()[None, :]
    return y.to(x.dtype)


def _splits(M, K, N, sms):
    """Chunks of K for the CUDA grid: the smallest divisor of K / 256 that
    gives the call at least ``_BLOCKS_PER_SM`` blocks an SM, with (N / 64)
    x ceil(M / 16) blocks a chunk (see ``csrc/quant_matmul.cu``)."""
    tiles = (N // _STRIP) * -(-M // 16)
    want = -(-(_BLOCKS_PER_SM * sms) // tiles)
    steps = K // 256
    for s in range(max(1, min(want, steps)), steps + 1):
        if steps % s == 0:
            return s
    return steps


def _device_path(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x.device}")
    if x.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("quant_matmul: CUDA is not available to launch "
                           "the kernel")
    return x.device.type


def _check(x, qw, scale):
    for name, t in (("qw", qw), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_matmul takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if qw.dtype != torch.int8 or qw.dim() != 2:
        raise TypeError(f"quant_matmul takes an int8 [K, N] weight, got "
                        f"{qw.dtype} {tuple(qw.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (qw.shape[1],):
        raise TypeError(f"quant_matmul takes a float32 [N] scale, got "
                        f"{scale.dtype} {tuple(scale.shape)}")


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start, as the kernel reads
    it in 16-byte chunks (a copy only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def quant_matmul(x, qw, scale, *, int4=False):
    """x [M, K] float32 / bfloat16, qw int8 [K, N] (or packed [K // 2, N]
    for int4), scale float32 [N] -> y [M, N] in x's dtype.  CPU tensors
    take :func:`quant_matmul_ref`; CUDA tensors launch K8 or raise."""
    M, K = x.shape
    N = qw.shape[1]
    Kq = qw.shape[0] * (2 if int4 else 1)
    if Kq != K:
        raise ValueError(f"weight K {Kq} != x K {K}")
    if K % BK or N % BN:
        raise ValueError(f"shapes must divide blocks ({BK},{BN})")
    if _device_path(x) == "cpu":
        return quant_matmul_ref(x, qw, scale, int4=int4)
    _check(x, qw, scale)
    return _launch(_aligned(x), _aligned(qw), scale.contiguous(), int4)


def _launch(x, qw, scale, int4):
    """K8 on checked, aligned operands: y [M, N] in x's dtype."""
    M, K = x.shape
    N = qw.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    dev = x.device.index
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = _splits(M, K, N, _sms[dev])
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _kernel_lib().quant_matmul(
            x.data_ptr(), qw.data_ptr(), scale.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), M, K, N, splits,
            int(int4), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("quant_matmul kernel launch failed: "
                           + _kernel_lib().paddle_cuda_error_string(
                               err).decode())
    if int4:
        quant_matmul.launches_int4 += 1
    else:
        quant_matmul.launches += 1
    return y


quant_matmul.launches = 0
quant_matmul.launches_int4 = 0

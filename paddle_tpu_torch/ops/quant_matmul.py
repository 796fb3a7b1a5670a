"""Weight-only quantized matmul: the CUDA kernel's wrapper, its launch plan
and its plain PyTorch twin.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py``.  K8
(``_kernel``): y = x @ dequant(W) * scale with W int8 ``[K, N]`` or int4
packed two to a byte ``[K / 2, N]`` (low nibble row 2i, high nibble row
2i + 1, sign-extended), the f32 per-column scale applied after the f32 sum,
y in x's dtype.  One CUDA source, ``csrc/quant_matmul.cu``, holds it; the
kernel reads the stored weight as it is, and its bf16 copy is never
materialised.

At decode (M = 8) the kernel is bound by the weight's bytes, so its bf16
body keeps a deep ring of raw weight bytes in flight (one block an SM,
int4 in two pipelines), dequantizes in registers into the tensor cores' A
operand (the GEMM runs as y^T = W^T x^T, the batch as the MMA's n = 8), and
sums a split K inside the one launch: the blocks that share a column strip
form a cluster and add their partials through distributed shared memory
in rank order (see the note in the source).  :func:`launch_plan` picks the
plan a call launches with: of strips of 128 or 64 columns and K in
``splits`` parts (a divisor of K / 256, at most 8, the cluster), the plan
with the most blocks, at most one an SM, whose clusters the card holds all
at once (:func:`max_clusters` asks the runtime); batch tiles of 8 a block
(1, 2 or 4; beyond 32 rows M is tiled in the grid).  :func:`body_plan`
records each body's tiles and shared memory, and :func:`compiled_plan`
reads them back from the card's library.

The device alone decides the path: CPU tensors compute
:func:`quant_matmul_ref`; CUDA tensors launch the kernel or raise — on a
dtype, a device mix, a shape, or a failed build or launch — and never fall
back.  Launch counters, plain ints, one count a GEMM:
``quant_matmul.launches`` (int8) and ``quant_matmul.launches_int4``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _counts

__all__ = ["quant_matmul", "quant_matmul_ref", "supported", "unpack_int4",
           "launch_plan", "body_plan", "compiled_plan", "max_clusters", "BK",
           "BN"]

BK = 256
BN = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256          # threads a bf16 block
MAX_STAGES = 8         # ring stages a pipeline at most
SMEM_PER_BLOCK = 232448
MAX_SPLITS = 8         # chunks of K: the blocks of a cluster
_F32_STRIP = 64        # columns of an f32 block (one chunk of K)
_lib = None
_sms = {}              # SM count by device index
_clusters = {}         # (device, bn, int4, mt, splits) -> resident clusters
_plans = {}            # (device, M, K, N, int4) -> launch_plan's plan


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("quant_matmul")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul.argtypes = [vp] * 4 + [ci] * 8 + [vp]
        lib.quant_matmul.restype = ci
        lib.quant_matmul_plan.argtypes = [ci, ci, ci, vp]
        lib.quant_matmul_plan.restype = ci
        lib.quant_matmul_max_clusters.argtypes = [ci] * 4 + [vp]
        lib.quant_matmul_max_clusters.restype = ci
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


def launch_plan(M, K, N, sms, clusters):
    """The bf16 body's launch plan for y [M, N] = x [M, K] @ W on a card of
    ``sms`` SMs: (strip columns, splits of K, batch tiles of 8 a block).
    ``clusters(bn, mt, splits)`` is how many clusters of ``splits`` blocks
    the card holds at once.  A block takes an SM (see ``body_plan``), so the
    plan is the one with the most blocks, at most one an SM, whose clusters
    are all resident at once (no second wave); on a tie the wider strip (x
    read fewer times), then fewer splits.  Splits divide K / 256, up to
    ``MAX_SPLITS``; where no plan fits one wave (M past 32 rows at most
    shapes), strips of 128 and one split."""
    mt = 1 if M <= 8 else 2 if M <= 16 else 4
    mtiles = -(-M // (8 * mt))
    steps = K // 256
    best = (0, 128, 1)
    for bn in (128, 64):
        tiles = N // bn * mtiles
        for s in range(1, min(MAX_SPLITS, steps) + 1):
            if (steps % s == 0 and tiles * s <= sms
                    and (s == 1 or tiles <= clusters(bn, mt, s))
                    and tiles * s > best[0]):
                best = (tiles * s, bn, s)
    return best[1], best[2], mt


def body_plan(bn, int4, mt):
    """The bf16 body's tiles for strips of ``bn`` columns, int4 or int8
    weights and ``mt`` batch tiles, as ``Plan`` in the source sets them:
    k rows a ring stage (16 KB of weight bytes, 8 KB for int4 strips of
    64), its pipelines (two rings for int4, one for int8) and their stages
    (as many as the block's shared memory holds, up to 8, so one block
    takes an SM), threads, and the dynamic shared memory a block takes (the
    rings' stages with their x tiles, rows padded by 32 bytes; the
    epilogue's partials reuse them)."""
    ks = 128 if (not int4 and bn == 128) else 256
    pipes = 2 if int4 else 1
    stage = (ks // 2 if int4 else ks) * bn + 8 * mt * (2 * ks + 32)
    stages = min(MAX_STAGES, SMEM_PER_BLOCK // (pipes * stage))
    red = THREADS // 32 // (bn // 32) * 8 * mt * (bn + 4) * 4
    return {"bn": bn, "ks": ks, "pipes": pipes, "stages": stages,
            "threads": THREADS, "smem": max(pipes * stages * stage, red)}


def max_clusters(dev, bn, int4, mt, splits):
    """How many clusters of ``splits`` blocks of a bf16 body the card
    ``dev`` holds at once (``quant_matmul_max_clusters``), cached."""
    key = (dev, bn, bool(int4), mt, splits)
    if key not in _clusters:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _kernel_lib().quant_matmul_max_clusters(
                bn, int(int4), mt, splits, ctypes.byref(out))
        if err:
            raise RuntimeError("quant_matmul clusters: " + _kernel_lib()
                               .paddle_cuda_error_string(err).decode())
        _clusters[key] = out.value
    return _clusters[key]


def compiled_plan(bn, int4, mt):
    """:func:`body_plan` as the card's library compiled it
    (``quant_matmul_plan``), with the body's registers a thread, local
    (spill) bytes, static shared bytes and largest block."""
    out = (ctypes.c_int * 10)()
    err = _kernel_lib().quant_matmul_plan(bn, int(int4), mt, out)
    if err:
        raise RuntimeError("quant_matmul plan: " + _kernel_lib()
                           .paddle_cuda_error_string(err).decode())
    keys = ("bn", "ks", "pipes", "stages", "threads", "smem", "registers",
            "local_bytes", "static_smem", "max_threads")
    return dict(zip(keys, out))


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
    return _launch(_aligned(x), _aligned(qw), _aligned(scale), int4)


def _plan(dev, M, K, N, int4):
    """:func:`launch_plan` for the card ``dev``, cached by (device, M, K, N,
    int4): the search and its runtime queries run once a shape, so an
    eager call's host time stays low and a captured one queries nothing."""
    key = (dev, M, K, N, bool(int4))
    if key not in _plans:
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        _plans[key] = launch_plan(
            M, K, N, _sms[dev],
            lambda b, m, s: max_clusters(dev, b, int4, m, s))
    return _plans[key]


def _launch(x, qw, scale, int4):
    """K8 on checked, aligned operands: y [M, N] in x's dtype, one launch."""
    M, K = x.shape
    N = qw.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        bn, splits, mt = _F32_STRIP, 1, 1
    else:
        bn, splits, mt = _plan(x.device.index, M, K, N, int4)
    with torch.cuda.device(x.device):
        err = _kernel_lib().quant_matmul(
            x.data_ptr(), qw.data_ptr(), scale.data_ptr(), y.data_ptr(),
            M, K, N, bn, splits, mt, int(int4), _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("quant_matmul kernel launch failed: "
                           + _kernel_lib().paddle_cuda_error_string(
                               err).decode())
    if int4:
        _counts.count(quant_matmul, "launches_int4")
    else:
        _counts.count(quant_matmul, "launches")
    return y


quant_matmul.launches = 0
quant_matmul.launches_int4 = 0

# every launch counter of this module (see ``paged_attention``'s)
LAUNCH_COUNTERS = ((quant_matmul, "launches"),
                   (quant_matmul, "launches_int4"))

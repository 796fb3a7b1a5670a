"""Flash attention for training: the CUDA kernels' wrapper and their plain
PyTorch twins.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``.  One CUDA
source, ``csrc/flash_attention.cu``, holds the kernels of both of the
reference's paths (see the note there for the design, the fixed tiles and
what bounds them).  The default path:

- K1 (``_fwd_kernel``): the forward, O and the natural-log LSE;
- K2 (``_dq_kernel``): dQ, which also computes delta = rowsum(dO * O);
- K3 (``_dkv_kernel``): dK and dV, summed over each GQA group.

The layout-direct path (K4: ``_bshd_fwd_kernel``, ``_bshd_dq_kernel``,
``_bshd_dkv_kernel``), which the reference takes for MHA when
``FLAGS_flash_layout_direct`` is set and :func:`_bshd_config` finds tiles:
the same three bodies with K4's numerics (scores from the unscaled q times
the scale in f32, natural exp).  Its plain twins are :func:`bshd_fwd_ref`
and :func:`bshd_bwd_ref`.

:func:`flash_attention_bshd` takes ``[B, S, H, D]`` tensors, as the JAX
function does, picks the path as the reference does, and runs through a
:class:`torch.autograd.Function` whose forward launches the forward kernel
and whose backward launches the dQ then the dK / dV kernel.  The device
alone decides between kernel and twin: CPU tensors compute the plain
versions; CUDA tensors launch the kernels or raise — they never fall back.
Each kernel has its own launch counter, a plain int:
``flash_attention_bshd.launches_fwd`` (K1), ``.launches_dq`` (K2),
``.launches_dkv`` (K3), ``.launches_direct_fwd``, ``.launches_direct_dq``
and ``.launches_direct_dkv`` (K4).

The LSE is ``[B * H, Sq]`` float32 (the TPU kernels broadcast it over 128
lanes).  There is no block autotuning: the kernels use one tile choice per
head_dim, recorded in the source.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from ..core.flags import flag

__all__ = ["flash_attention_bshd", "flash_fwd_ref", "flash_bwd_ref",
           "bshd_fwd_ref", "bshd_bwd_ref", "supported", "BQ", "BK",
           "NEG_INF"]

BQ = 128
BK = 128
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = tuple(range(64, 513, 64))      # 64, 128, ..., 512
_B_BQ, _B_BK = 512, 512
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B H Hk Sq Sk D, scale, qscale, causal, dtype, direct, stream
        tail = [ci] * 6 + [cf, cf, ci, ci, ci, vp]
        lib.flash_fwd.argtypes = [vp] * 6 + tail
        lib.flash_bwd_dq.argtypes = [vp] * 9 + tail
        lib.flash_bwd_dkv.argtypes = [vp] * 9 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.restype = ci
        lib.paddle_cuda_error_string.argtypes = [ci]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_divisible(Sq, Sk, D, bq=None, bk=None):
    bq, bk = bq or BQ, bk or BK
    if Sq % bq != 0 or Sk % bk != 0:
        raise ValueError(
            f"flash attention requires seq lengths divisible by ({bq}, {bk}) "
            f"(got q {Sq}, kv {Sk}); pad or use the plain path")
    if D % 64 != 0:
        raise ValueError(f"flash attention requires head_dim % 64 == 0, got {D}")


def supported(q_shape, kv_shape=None, dtype=None) -> bool:
    """Single dispatch predicate for the kernel path ([B, S, H, D]
    layouts), the reference's: S % 128 == 0, head_dim % 64 == 0, H % Hk ==
    0.  The CUDA kernels are built for every head_dim % 64 == 0 up to 512;
    a CUDA tensor with a larger head_dim that passes here is refused by the
    wrapper before any launch."""
    B, S, H, D = q_shape
    ok = (S % BQ == 0) and (D % 64 == 0)
    if kv_shape is not None:
        Sk, Hk = kv_shape[1], kv_shape[2]
        ok = ok and (Sk % BK == 0) and (Hk > 0) and (H % Hk == 0)
    return ok


def _scale(D, scale):
    return scale if scale is not None else 1.0 / math.sqrt(D)


def _qscale(s):
    """scale * log2(e) as the float32 the reference multiplies q by."""
    return float(np.float32(s * LOG2E))


# ---------------------------------------------------------------- plain twins
def _scores(q, k, s, causal):
    """Log2-domain scores [B, Hk, rep, Sq, Sk] in float32 from q rounded
    after its pre-scale, as the kernels take it; NEG_INF above the
    diagonal when causal (row >= col visible)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    q2 = (q.float() * _qscale(s)).to(q.dtype).float()
    sc = torch.einsum("bqkrd,btkd->bkrqt", q2.reshape(B, Sq, Hk, H // Hk, D),
                      k.float())
    if causal:
        above = (torch.arange(Sk, device=q.device)[None, :]
                 > torch.arange(Sq, device=q.device)[:, None])
        sc = sc.masked_fill(above, NEG_INF)
    return sc


def flash_fwd_ref(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of K1: q [B, Sq, H, D], k / v [B, Sk, Hk, D]
    -> (o [B, Sq, H, D] in q's dtype, lse [B * H, Sq] float32).  The
    kernel's math without its blocking: log2-domain scores from q
    pre-scaled and rounded to its dtype, exp2, P rounded to v's dtype
    before P V, l clamped at 1e-30, natural-log LSE."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    sc = _scores(q, k, _scale(D, scale), causal)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp2(sc - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkrqt,btkd->bqkrd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = ((m + torch.log2(l)) * LN2).reshape(B * H, Sq)
    return o.reshape(B, Sq, H, D).to(q.dtype), lse


def flash_bwd_ref(q, k, v, o, lse, do, causal=True, scale=None):
    """Plain PyTorch version of K2 and K3: (dq, dk, dv) in q's / k's / v's
    dtypes.  P is recomputed from the LSE, delta = rowsum(dO * O), dS = P
    (dP - delta); P is rounded to dO's dtype before P^T dO and dS to k's
    (q's) dtype before dS K (dS^T q), as the kernels round them; dK uses the
    unscaled q."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    s = _scale(D, scale)
    sc = _scores(q, k, s, causal)
    p = torch.exp2(sc - (lse.reshape(B, Hk, rep, Sq, 1) * LOG2E))
    dof = do.float().reshape(B, Sq, Hk, rep, D)
    dp = torch.einsum("bqkrd,btkd->bkrqt", dof, v.float())
    delta = (dof * o.float().reshape(B, Sq, Hk, rep, D)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkrqt,btkd->bqkrd", ds.to(k.dtype).float(),
                      k.float()) * s
    dk = torch.einsum("bkrqt,bqkrd->btkd", ds.to(q.dtype).float(),
                      q.float().reshape(B, Sq, Hk, rep, D)) * s
    dv = torch.einsum("bkrqt,bqkrd->btkd", p.to(do.dtype).float(), dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _direct_scores(q, k, s, causal):
    """K4's scores [B, H, Sq, Sk] in float32: the unscaled q k^T of the
    dtype-rounded operands, times the scale in f32; NEG_INF above the
    diagonal when causal."""
    Sq, Sk = q.shape[1], k.shape[1]
    sc = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * s
    if causal:
        above = (torch.arange(Sk, device=q.device)[None, :]
                 > torch.arange(Sq, device=q.device)[:, None])
        sc = sc.masked_fill(above, NEG_INF)
    return sc


def bshd_fwd_ref(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of K4's forward (``_bshd_fwd_kernel``), MHA:
    q / k / v [B, S, H, D] -> (o in q's dtype, lse [B * H, Sq] float32).
    Scores from the unscaled q times the scale in f32, natural exp (the
    kernel computes it as exp2(x * log2 e), with the scale and log2 e
    folded into one f32 multiply), P rounded to v's dtype before P V, l
    clamped at 1e-30, natural-log LSE."""
    B, Sq, H, D = q.shape
    sc = _direct_scores(q, k, _scale(D, scale), causal)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqt,bthd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).reshape(B * H, Sq)
    return o.to(q.dtype), lse


def bshd_bwd_ref(q, k, v, o, lse, do, causal=True, scale=None):
    """Plain PyTorch version of K4's backward (``_bshd_dq_kernel`` and
    ``_bshd_dkv_kernel``): (dq, dk, dv) in q's / k's / v's dtypes.  P =
    exp(s - lse) from K4's scores, delta = rowsum(dO * O) in f32, dS = P
    (dP - delta); dQ = (dS rounded to k's dtype) K * scale, dK = (dS
    rounded to q's dtype)^T q * scale, dV = (P rounded to dO's dtype)^T dO,
    the scale applied in f32 after each product."""
    B, Sq, H, D = q.shape
    s = _scale(D, scale)
    sc = _direct_scores(q, k, s, causal)
    p = torch.exp(sc - lse.reshape(B, H, Sq, 1))
    dof = do.float()
    dp = torch.einsum("bqhd,bthd->bhqt", dof, v.float())
    delta = (dof * o.float()).sum(-1)                       # [B, Sq, H]
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqt,bthd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * s
    dk = torch.einsum("bhqt,bqhd->bthd", ds.to(q.dtype).float(),
                      q.float()) * s
    dv = torch.einsum("bhqt,bqhd->bthd", p.to(do.dtype).float(), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bshd_config(B, Sq, Sk, H, D, dtype):
    """The reference's ``_bshd_config``, a pure function of the shapes and
    the dtype's itemsize: (bq, bk, hb) for the layout-direct path, or None
    if it does not apply.  Here it decides the ROUTE only.  Its tiles are
    TPU VMEM blocks (a whole-H block must fit a 12 MiB VMEM estimate); they
    do not set the CUDA kernels' tiles, which are fixed per head_dim in
    ``csrc/flash_attention.cu``."""
    itemsize = dtype.itemsize
    for bq, bk in ((_B_BQ, _B_BK), (256, 512), (256, 256), (128, 256),
                   (128, 128)):
        if Sq % bq or Sk % bk:
            continue
        vmem = (2 * (2 * bq + 2 * bk) * H * D * itemsize
                + H * bq * (2 * 128 + D) * 4
                + int(1.5 * H * bq * bk * 4))
        if vmem <= 12 * 1024 * 1024:
            return bq, bk, H
    return None


# ------------------------------------------------------------------- kernels
def _strided(t):
    """``t`` as the bf16 kernels read it — unit last stride, 16-byte
    aligned base and strides — or a contiguous copy when it is not."""
    unit = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % unit == 0 for st in t.stride()[:-1])):
        return t
    return t.contiguous()


def _check(q, k, v):
    """Raise unless the kernels take q, k and v (``flash_attention_bshd``
    has checked the heads and the divisibility)."""
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}: the kernels "
                            "take one dtype")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Sq,H,D] and k / v [B,Sk,Hk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the flash attention kernels are instantiated for "
                         f"head_dim {_HEAD_DIMS}, not {D}")


def _strides(*ts):
    """The 15 (batch, row, head) strides of q, k, v, o, dO, as a C array
    (missing tensors give zeros)."""
    vals = []
    for t in ts + (None,) * (5 - len(ts)):
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (ctypes.c_longlong * 15)(*vals)


def _raise_on(err, what):
    if err:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           + _kernel_lib().paddle_cuda_error_string(
                               err).decode())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _sizes(q, k, causal, s):
    B, Sq, H, D = q.shape
    return (B, H, k.shape[2], Sq, k.shape[1], D, float(s), _qscale(s),
            int(causal), _DTYPES[q.dtype])


# The launchers take tensors that _check passed, as _strided gives them;
# `direct` selects K4's bodies (and counters) instead of K1-K3's.
def _launch_fwd(q, k, v, causal, s, direct=False):
    """K1 (K4-fwd): (o, lse)."""
    B, Sq, H, D = q.shape
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_lib().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _strides(q, k, v), *_sizes(q, k, causal, s),
            int(direct), _stream(q))
    _raise_on(err, "forward (K4)" if direct else "forward (K1)")
    if direct:
        flash_attention_bshd.launches_direct_fwd += 1
    else:
        flash_attention_bshd.launches_fwd += 1
    return o, lse


def _launch_dq(q, k, v, o, lse, do, causal, s, direct=False):
    """K2 (K4-dq): (dq, delta [B * H, Sq] float32), from the forward's o
    and lse."""
    B, Sq, H, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_lib().flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _strides(q, k, v, o, do), *_sizes(q, k, causal, s), int(direct),
            _stream(q))
    _raise_on(err, "dq (K4)" if direct else "dq (K2)")
    if direct:
        flash_attention_bshd.launches_direct_dq += 1
    else:
        flash_attention_bshd.launches_dq += 1
    return dq, delta


def _launch_dkv(q, k, v, o, lse, do, delta, causal, s, direct=False):
    """K3 (K4-dkv): (dk, dv), from the forward's lse and the dq kernel's
    delta."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel_lib().flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _strides(q, k, v, o, do), *_sizes(q, k, causal, s), int(direct),
            _stream(q))
    _raise_on(err, "dk/dv (K4)" if direct else "dk/dv (K3)")
    if direct:
        flash_attention_bshd.launches_direct_dkv += 1
    else:
        flash_attention_bshd.launches_dkv += 1
    return dk, dv


def _device_path(q, name):
    """'cpu' or 'cuda' for q's device; anything else, or a CUDA tensor
    without a card, is refused."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA is not available to launch the "
                           "kernels")
    return q.device.type


class _Flash(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (the reference's ``_flash3``
    custom_vjp), or with ``direct`` K4's three bodies (its ``_flash_bshd``
    custom_vjp); saves q, k, v, o and the LSE, as ``_flash3_fwd`` and
    ``_flash_bshd_fwd`` do."""

    @staticmethod
    def forward(ctx, q, k, v, causal, s, direct):
        if _device_path(q, "flash_attention_bshd") == "cpu":
            ref = bshd_fwd_ref if direct else flash_fwd_ref
            o, lse = ref(q, k, v, causal, s)
        else:
            _check(q, k, v)
            q, k, v = _strided(q), _strided(k), _strided(v)
            o, lse = _launch_fwd(q, k, v, causal, s, direct)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.direct = causal, s, direct
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        c, s, direct = ctx.causal, ctx.scale, ctx.direct
        if _device_path(q, "flash_attention_bshd") == "cpu":
            ref = bshd_bwd_ref if direct else flash_bwd_ref
            dq, dk, dv = ref(q, k, v, o, lse, do, c, s)
        else:
            if do.device != q.device or do.dtype != q.dtype \
                    or do.shape != q.shape:
                raise ValueError(f"do {do.dtype} {tuple(do.shape)} on "
                                 f"{do.device} does not match o")
            do = _strided(do)
            dq, delta = _launch_dq(q, k, v, o, lse, do, c, s, direct)
            dk, dv = _launch_dkv(q, k, v, o, lse, do, delta, c, s, direct)
        return dq, dk, dv, None, None, None


def flash_attention_bshd(q, k, v, causal=True, scale=None):
    """[B, S, H, D] flash attention with GQA (k / v [B, S, Hk, D], H % Hk
    == 0; K / V are never repeated).  Differentiable.  The path is the
    reference's: MHA with ``FLAGS_flash_layout_direct`` set and
    :func:`_bshd_config` not None takes K4, everything else K1-K3.  CPU
    tensors take the plain versions; CUDA tensors launch the kernels —
    float32 or bfloat16, S % 128 == 0, head_dim a multiple of 64 up to 512
    — or raise."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    if Hk == 0 or H % Hk != 0:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({Hk})")
    s = _scale(D, scale)
    direct = (H == Hk and flag("flash_layout_direct")
              and _bshd_config(B, Sq, k.shape[1], H, D, q.dtype) is not None)
    if not direct:
        _check_divisible(Sq, k.shape[1], D)
    return _Flash.apply(q, k, v, bool(causal), s, direct)


flash_attention_bshd.launches_fwd = 0
flash_attention_bshd.launches_dq = 0
flash_attention_bshd.launches_dkv = 0
flash_attention_bshd.launches_direct_fwd = 0
flash_attention_bshd.launches_direct_dq = 0
flash_attention_bshd.launches_direct_dkv = 0

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
the scale in f32, natural exp; the dK / dV body then scores each q tile
as it landed, with no second, scaled copy of it).  Its plain twins are
:func:`bshd_fwd_ref` and :func:`bshd_bwd_ref`.

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
head_dim, recorded in the source; the bf16 forward's (K1 and K4-fwd up to
head_dim 256: a producer warp's TMA ring feeding two wgmma consumer
warpgroups) is also recorded here, :data:`FWD_PLAN`, and
``flash_fwd_plan`` reports the compiled one on the card; so are the bf16
backward's up to head_dim 256, on the forward's skeleton (K2 and K3:
:data:`BWD_PLAN`; K4-dq and K4-dkv: :data:`BWD_PLAN_DIRECT`), reported by
``flash_bwd_plan``.  Above head_dim 256 and in float32 every path runs
the older bodies (``mma.sync``, CUDA cores).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build, _counts
from ..core.flags import flag

__all__ = ["flash_attention_bshd", "flash_fwd_ref", "flash_bwd_ref",
           "bshd_fwd_ref", "bshd_bwd_ref", "supported", "fwd_plan", "bwd_plan",
           "BQ", "BK", "NEG_INF", "FWD_PLAN", "BWD_PLAN", "BWD_PLAN_DIRECT"]

BQ = 128
BK = 128
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = tuple(range(64, 513, 64))      # 64, 128, ..., 512
_B_BQ, _B_BK = 512, 512
# The bf16 forward's tiles at head_dim <= 256 (``Sm90Fwd`` in the source):
# head_dim -> (q rows a block, keys a K / V tile, ring stages)
FWD_PLAN = {64: (128, 128, 3), 128: (128, 128, 3), 192: (128, 64, 3),
            256: (128, 64, 2)}
# The bf16 backward's at head_dim <= 256 (``Sm90Dq`` / ``Sm90Dkv``):
# head_dim -> ((K2: q rows a block, keys a K / V tile, ring stages),
#              (K3: q rows a ring stage, keys a block, ring stages, q2
#               buffers, split: the two consumer warpgroups hold dV and dK
#               of the same 64 keys instead of both of 64 keys each))
BWD_PLAN = {64: ((128, 128, 3), (64, 128, 3, 2, 0)),
            128: ((128, 64, 3), (64, 128, 3, 2, 0)),
            192: ((128, 64, 2), (64, 64, 2, 2, 1)),
            256: ((128, 32, 3), (64, 64, 2, 1, 1))}
# K4-dq / K4-dkv on the same bodies (``kDirect``): K2's and K3's tiles,
# but K4-dkv scores the ring's own q tiles, so it has no q2 buffers
BWD_PLAN_DIRECT = {D: (dq, dkv[:3] + (0,) + dkv[4:])
                   for D, (dq, dkv) in BWD_PLAN.items()}
SMEM_PER_BLOCK = 232448                     # what a Hopper block may use
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
        lib.flash_fwd_plan.argtypes = [ci, ci, vp]         # D, direct
        lib.flash_bwd_plan.argtypes = [ci, ci, ci, vp]     # D, dkv, direct
        for fn in (lib.flash_fwd_plan, lib.flash_bwd_plan):
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


def fwd_plan(D):
    """The bf16 forward's tile plan at head_dim ``D`` (64, 128, 192 or 256)
    as this module records it: q rows a block (two consumer warpgroups of
    64), keys a tile, ring stages, threads (and one producer warpgroup) and
    the dynamic shared memory a block takes: 1024 bytes to align the
    128-byte swizzle, the q tile, a K and a V tile a stage, 128 bytes of
    barriers."""
    bq, bk, stages = FWD_PLAN[D]
    return {"bq": bq, "bk": bk, "stages": stages, "threads": 384,
            "smem": 1024 + 2 * bq * D + stages * 2 * (2 * bk * D) + 128}


def compiled_fwd_plan(D, direct=False):
    """The same plan as the card's library compiled it
    (``flash_fwd_plan``), with the body's registers a thread at entry,
    local (spill) bytes, static shared bytes and largest block."""
    out = (ctypes.c_int * 9)()
    err = _kernel_lib().flash_fwd_plan(D, int(direct), out)
    _raise_on(err, "forward plan")
    keys = ("bq", "bk", "stages", "smem", "threads", "registers",
            "local_bytes", "static_smem", "max_threads")
    return dict(zip(keys, out))


def bwd_plan(D, direct=False):
    """The bf16 backward's tile plans at head_dim ``D`` (64, 128, 192 or
    256) as this module records them, ``{"dq": ..., "dkv": ...}``, of K2 /
    K3 or with ``direct`` of K4-dq / K4-dkv: q rows and keys of a tile (dq:
    128 q rows a block over a ring of K / V tiles; dkv: a block of keys
    over a ring of q / dO tiles with their LSE and delta rows), ring
    stages, dkv's q2 buffers (none for K4) and split, threads (two consumer
    warpgroups and one producer warpgroup) and the dynamic shared memory a
    block takes: 1024 bytes to align the 128-byte swizzle, the tiles, 128
    bytes of barriers."""
    (bq, bk, st), (kbq, kbk, kst, q2, split) = (
        BWD_PLAN_DIRECT if direct else BWD_PLAN)[D]
    return {"dq": {"bq": bq, "bk": bk, "stages": st, "threads": 384,
                   "smem": 1024 + 2 * (2 * bq * D) + st * 2 * (2 * bk * D)
                   + 128},
            "dkv": {"bq": kbq, "bk": kbk, "stages": kst, "q2": q2,
                    "split": split, "threads": 384,
                    "smem": 1024 + 2 * (2 * kbk * D)
                    + kst * (2 * (2 * kbq * D) + 2 * 4 * kbq)
                    + q2 * 2 * kbq * D + 128}}


def compiled_bwd_plan(D, direct=False):
    """The same plans as the card's library compiled them
    (``flash_bwd_plan``), each with the body's registers a thread at
    entry, local (spill) bytes, static shared bytes and largest block."""
    keys = ("bq", "bk", "stages", "q2", "split", "smem", "threads",
            "registers", "local_bytes", "static_smem", "max_threads")
    out = {}
    for i, role in enumerate(("dq", "dkv")):
        vals = (ctypes.c_int * 11)()
        _raise_on(_kernel_lib().flash_bwd_plan(D, i, int(direct), vals),
                  "backward plan")
        got = dict(zip(keys, vals))
        if role == "dq":
            del got["q2"], got["split"]
        out[role] = got
    return out


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
    """``t`` where the kernels can read it in place, else a contiguous
    copy.  In place needs a unit last stride and what a TMA tensor map
    needs of the rest (the bf16 forward reads q, k and v through one): a
    16-byte aligned base, and every other stride of a dimension longer
    than 1 a positive multiple of 16 bytes under 2**40 (the map never steps
    a dimension of size 1, and gets a legal stride for it).  A copy, never
    ``t.contiguous()``, which returns a contiguous tensor on a misaligned
    base as it is."""
    el = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or (0 < st * el < 2 ** 40 and st * el % 16 == 0)
                    for n, st in zip(t.shape[:-1], t.stride()[:-1]))):
        return t
    return t.clone(memory_format=torch.contiguous_format)


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
        _counts.count(flash_attention_bshd, "launches_direct_fwd")
    else:
        _counts.count(flash_attention_bshd, "launches_fwd")
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
        _counts.count(flash_attention_bshd, "launches_direct_dq")
    else:
        _counts.count(flash_attention_bshd, "launches_dq")
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
        _counts.count(flash_attention_bshd, "launches_direct_dkv")
    else:
        _counts.count(flash_attention_bshd, "launches_dkv")
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

# every launch counter of this module (see ``paged_attention``'s)
LAUNCH_COUNTERS = tuple(
    (flash_attention_bshd, f"launches_{kind}")
    for kind in ("fwd", "dq", "dkv", "direct_fwd", "direct_dq",
                 "direct_dkv"))

"""Paged (block) KV-cache decode attention: the CUDA kernel's wrapper and its
plain PyTorch twin.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py`` (``_kernel``,
the bf16/f32 path).  The kernel lives in ``csrc/paged_attention.cu``; see
the note there for its design and what bounds it.

The device alone decides the path: on CPU tensors :func:`paged_attention`
computes :func:`paged_attention_ref`; on CUDA tensors it launches the kernel
or raises — it never falls back.  ``paged_attention.launches`` counts kernel
launches (and nothing else), so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_ref", "NEG_INF"]

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_SMEM_LIMIT = 232_448          # bytes of shared memory one block may use
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_fwd.argtypes = [vp, vp, vp, vp, vp, vp,
                                            ci, ci, ci, ci, ci, ci, cf, ci, vp]
        lib.paged_attention_fwd.restype = ci
        lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci, ci]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paddle_cuda_error_string.argtypes = [ci]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k_pages, v_pages, block_tables, context_lens):
    """Raise unless the kernel takes these CUDA tensors as they are."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("expected q [B,H,D], pages [P,page,KVH,D], "
                         "block_tables [B,S]")
    B, H, D = q.shape
    _, _, KVH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q's head_dim "
                         f"{D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if H % KVH != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KVH}")
    if block_tables.shape[0] != B or tuple(context_lens.shape) != (B,):
        raise ValueError("block_tables / context_lens batch does not match q")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    scale=None):
    """Decode-step attention against a paged KV cache.

    q:               [B, H, D]             current-step queries
    k_pages/v_pages: [P, page_size, KVH, D]
    block_tables:    [B, S] int32          physical page per (sequence, slot)
    context_lens:    [B] int32             tokens in cache (incl. current)
    returns          [B, H, D] in q's dtype

    CPU tensors take :func:`paged_attention_ref`; CUDA tensors launch the
    kernel (float32 or bfloat16, head_dim 64 or 128, any page size, any
    H % KVH == 0) or raise."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens)
    B, H, D = q.shape
    _, page_size, KVH, _ = k_pages.shape
    S = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    lib = _kernel_lib()
    dt = _DTYPES[q.dtype]
    smem = lib.paged_attention_smem_bytes(H, KVH, D, dt)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"q-head group {H // KVH} needs {smem} bytes of "
                         f"shared memory (limit {_SMEM_LIMIT})")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            B, H, KVH, D, page_size, S, float(scale), dt, stream)
    if err:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.paddle_cuda_error_string(err).decode())
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, *,
                        scale=None):
    """Plain PyTorch version (gathers pages densely, f32 scores, NEG_INF
    mask, softmax, cast back to q's dtype) — the golden the kernel is held
    against, and the path CPU tensors take.  Out-of-range table entries are
    clamped, as JAX's gather clamps them, and V at masked positions is
    zeroed, so what pages past ctx hold never reaches the output."""
    B, H, D = q.shape
    P, page_size, KVH, _ = k_pages.shape
    S = block_tables.shape[1]
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    T = S * page_size
    bt = block_tables.long().clamp(0, P - 1)
    k = k_pages[bt].reshape(B, T, KVH, D).transpose(1, 2).float()
    v = v_pages[bt].reshape(B, T, KVH, D).transpose(1, 2).float()
    mask = (torch.arange(T, device=q.device)[None, :]
            < context_lens.to(q.device).long()[:, None])           # [B, T]
    # positions past ctx contribute nothing, whatever their pages hold
    v = v.masked_fill(~mask[:, None, :, None], 0.0)
    qh = q.reshape(B, KVH, G, D).float()
    sc = torch.einsum("bhgd,bhtd->bhgt", qh * scale, k)
    sc = torch.where(mask[:, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v)
    return out.reshape(B, H, D).to(q.dtype)

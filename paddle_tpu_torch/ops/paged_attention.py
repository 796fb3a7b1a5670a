"""Paged (block) KV-cache attention: the CUDA kernels' wrappers and their
plain PyTorch twins.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``.  One CUDA
source, ``csrc/paged_attention.cu``, holds one kernel body with four
instantiations (see the note there for the design and what bounds it):

- K5 (``_kernel``): :func:`paged_attention` with pages in q's dtype;
- K6 (``_kernel_q``): :func:`paged_attention` with int8 pages and scales;
- K7 (``_kernel_mq``): :func:`paged_attention_multiquery`;
- K7q (``_kernel_mq_q``): :func:`paged_attention_multiquery` with int8
  pages and scales.

The device alone decides the path: on CPU tensors the wrappers compute
their plain versions (:func:`paged_attention_ref`,
:func:`paged_attention_multiquery_ref`); on CUDA tensors they launch the
kernel or raise — they never fall back.  Each kernel body has its own
launch counter, a plain int that counts its launches and nothing else:
``paged_attention.launches`` (K5), ``paged_attention.launches_int8`` (K6),
``paged_attention_multiquery.launches`` (K7) and
``paged_attention_multiquery.launches_int8`` (K7q).

:func:`quantize_kv` is the reference's per-(row, kv head) symmetric int8
quantization, plain tensor code (the JAX package computes it outside any
kernel too).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_multiquery", "paged_attention_multiquery_ref",
           "quantize_kv", "NEG_INF"]

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
        lib.paged_attention_fwd.argtypes = [vp] * 8 + [ci] * 7 + [cf, ci, ci,
                                                                  vp]
        lib.paged_attention_fwd.restype = ci
        lib.paged_attention_smem_bytes.argtypes = [ci, ci, ci]
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paddle_cuda_error_string.argtypes = [ci]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def quantize_kv(x):
    """Per-(row, kv-head) symmetric int8 quantization of K/V rows
    [..., KVH, D] -> (int8 values, float32 scales [..., KVH]): the formula
    of the reference's ``quantize_kv``."""
    xf = x.float()
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def _check(q, k_pages, v_pages, block_tables, context_lens, k_scales=None,
           v_scales=None):
    """Raise unless the kernel takes these tensors as they are.  q is
    [B, H, D] (single query) or [B, Q, H, D] (multi-query)."""
    dev = q.device
    quant = k_scales is not None or v_scales is not None
    named = [("k_pages", k_pages), ("v_pages", v_pages),
             ("block_tables", block_tables), ("context_lens", context_lens)]
    if quant:
        if k_scales is None or v_scales is None:
            raise ValueError("int8 pages need both k_scales and v_scales")
        named += [("k_scales", k_scales), ("v_scales", v_scales)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"q, got {q.dtype}")
    page_dtype = torch.int8 if quant else q.dtype
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise TypeError(
            "int8 pages go with k_scales / v_scales, and pages without "
            f"scales share q's dtype: q {q.dtype}, pages {k_pages.dtype} / "
            f"{v_pages.dtype}, scales {'given' if quant else 'none'}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if q.dim() not in (3, 4) or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("expected q [B,H,D] or [B,Q,H,D], pages "
                         "[P,page,KVH,D], block_tables [B,S]")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    P, page, KVH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q's head_dim "
                         f"{D}")
    if quant:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != (P, page, KVH):
                raise ValueError(f"{name} shape {tuple(t.shape)} is not "
                                 f"[P, page, KVH] = {(P, page, KVH)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if H % KVH != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KVH}")
    if block_tables.shape[0] != B or tuple(context_lens.shape) != (B,):
        raise ValueError("block_tables / context_lens batch does not match q")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q, k_pages, v_pages, block_tables, context_lens, k_scales,
            v_scales, scale):
    """Check, then launch the kernel on q [B, Q, H, D]; returns out in q's
    shape and dtype."""
    _check(q, k_pages, v_pages, block_tables, context_lens, k_scales,
           v_scales)
    B, Q, H, D = q.shape
    _, page_size, KVH, _ = k_pages.shape
    S = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    quant = k_scales is not None
    lib = _kernel_lib()
    dt = _DTYPES[q.dtype]
    smem = lib.paged_attention_smem_bytes((H // KVH) * Q, D, dt)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{H // KVH} q heads per kv head x {Q} query rows "
                         f"need {smem} bytes of shared memory (limit "
                         f"{_SMEM_LIMIT})")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            B, Q, H, KVH, D, page_size, S, float(scale), dt, int(quant),
            stream)
    if err:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.paddle_cuda_error_string(err).decode())
    return out


def _on_cuda(q, name):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    k_scales=None, v_scales=None, scale=None):
    """Decode-step attention against a paged KV cache.

    q:                 [B, H, D]             current-step queries
    k_pages/v_pages:   [P, page_size, KVH, D] (int8 with scales)
    k_scales/v_scales: [P, page_size, KVH] float32 per-token-per-head
                       scales (int8 KV-cache mode)
    block_tables:      [B, S] int32          physical page per (seq, slot)
    context_lens:      [B] int32             tokens in cache (incl. current)
    returns            [B, H, D] in q's dtype

    CPU tensors take :func:`paged_attention_ref`; CUDA tensors launch K5
    (pages in q's dtype) or K6 (int8 pages) — float32 or bfloat16 q, head_dim
    64 or 128, any page size, any H % KVH == 0 — or raise."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, k_scales=k_scales,
                                   v_scales=v_scales, scale=scale)
    _on_cuda(q, "paged_attention")
    if q.dim() != 3:
        raise ValueError(f"paged_attention takes q [B, H, D], got "
                         f"{tuple(q.shape)}")
    out = _launch(q[:, None], k_pages, v_pages, block_tables, context_lens,
                  k_scales, v_scales, scale)[:, 0]
    if k_scales is None:
        paged_attention.launches += 1
    else:
        paged_attention.launches_int8 += 1
    return out


paged_attention.launches = 0
paged_attention.launches_int8 = 0


def paged_attention_multiquery(q, k_pages, v_pages, block_tables,
                               context_lens, *, k_scales=None, v_scales=None,
                               scale=None):
    """Verification attention: Q consecutive query positions per sequence
    against the paged KV cache (speculative decoding scores the pending
    token plus all drafts in ONE forward).

    q:             [B, Q, H, D]    row j sits at absolute position
                                   context_lens[b] - 1 + j
    context_lens:  [B] int32       cache tokens visible to row 0 (incl. its
                                   own just-written entry); row j's causal
                                   horizon is context_lens[b] + j, capped at
                                   the table's S * page tokens
    k_pages/v_pages/block_tables/k_scales/v_scales: as paged_attention
    returns        [B, Q, H, D] in q's dtype

    CPU tensors take :func:`paged_attention_multiquery_ref`; CUDA tensors
    launch K7 (pages in q's dtype) or K7q (int8 pages), which read q in
    place and stream each page once for all Q rows, or raise."""
    if q.device.type == "cpu":
        return paged_attention_multiquery_ref(
            q, k_pages, v_pages, block_tables, context_lens,
            k_scales=k_scales, v_scales=v_scales, scale=scale)
    _on_cuda(q, "paged_attention_multiquery")
    if q.dim() != 4:
        raise ValueError(f"paged_attention_multiquery takes q [B, Q, H, D], "
                         f"got {tuple(q.shape)}")
    out = _launch(q, k_pages, v_pages, block_tables, context_lens, k_scales,
                  v_scales, scale)
    if k_scales is None:
        paged_attention_multiquery.launches += 1
    else:
        paged_attention_multiquery.launches_int8 += 1
    return out


paged_attention_multiquery.launches = 0
paged_attention_multiquery.launches_int8 = 0


def _dense(pages, scales, idx):
    """Pages gathered by idx [B, S] into float32 [B, KVH, S*page, D],
    dequantized (in float32) when scales are given."""
    B, S = idx.shape
    _, page, KVH, D = pages.shape
    x = pages[idx].float()                               # [B, S, page, KVH, D]
    if scales is not None:
        x = x * scales[idx].float()[..., None]
    return x.reshape(B, S * page, KVH, D).transpose(1, 2)


def paged_attention_multiquery_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, *, k_scales=None,
                                   v_scales=None, scale=None):
    """Plain PyTorch version of the multi-query kernels (dense gather, f32
    scores, per-row causal horizon ctx + j, NEG_INF mask, softmax, cast back
    to q's dtype) — the golden K7 / K7q are held against, and the path CPU
    tensors take.  Int8 pages dequantize in float32, as the reference's jnp
    version does (the kernels round to q's dtype first, as the TPU kernels
    do).  Out-of-range table entries are clamped, as JAX's gather clamps
    them, and V at positions no row sees is zeroed, so what pages past the
    last row's horizon hold never reaches the output; a row that sees
    nothing returns 0, as the kernels' ``acc / max(l, 1e-30)`` does."""
    B, Q, H, D = q.shape
    P, page_size, KVH, _ = k_pages.shape
    S = block_tables.shape[1]
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    T = S * page_size
    idx = block_tables.long().clamp(0, P - 1)
    k = _dense(k_pages, k_scales, idx)
    v = _dense(v_pages, v_scales, idx)
    ctx = context_lens.to(q.device).long()
    mask = (torch.arange(T, device=q.device)[None, None, :]
            < (ctx[:, None] + torch.arange(Q, device=q.device))[:, :, None])
    v = v.masked_fill(~mask.any(1)[:, None, :, None], 0.0)   # [B, Q, T]
    qh = q.transpose(1, 2).reshape(B, KVH, G, Q, D).float()
    sc = torch.einsum("bhgqd,bhtd->bhgqt", qh * scale, k)
    vis = mask[:, None, None]
    sc = torch.where(vis, sc, torch.full((), NEG_INF, device=q.device))
    p = torch.where(vis, torch.softmax(sc, dim=-1), 0.0)
    out = torch.einsum("bhgqt,bhtd->bhgqd", p, v)
    return out.reshape(B, H, Q, D).transpose(1, 2).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, *,
                        k_scales=None, v_scales=None, scale=None):
    """Plain PyTorch version of K5 / K6: the multi-query version with one
    query row, whose horizon is ctx (capped at S * page)."""
    return paged_attention_multiquery_ref(
        q[:, None], k_pages, v_pages, block_tables, context_lens,
        k_scales=k_scales, v_scales=v_scales, scale=scale)[:, 0]

"""Paged (block) KV-cache attention: the CUDA kernels' wrappers and their
plain PyTorch twins.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``.  One CUDA
source, ``csrc/paged_attention.cu`` (see its note for the design and what
bounds it), holds the split-K body of all four kernels: K5 (``_kernel``)
and K6 (``_kernel_q``, int8 pages and scales) behind the single-query
wrapper :func:`paged_attention`, K7 (``_kernel_mq``) and K7q
(``_kernel_mq_q``) behind :func:`paged_attention_multiquery`.  Each call
makes two launches, the splits and then their combine, planned by
:func:`split_plan`.  Head dims: every multiple of 16 from 16 to 256.

The device alone decides the path: on CPU tensors the wrappers compute
their plain versions (:func:`paged_attention_ref`,
:func:`paged_attention_multiquery_ref`); on CUDA tensors they launch the
kernel or raise — they never fall back.  Each kernel has its own counter,
a plain int that counts the wrapper's calls that launched it and nothing
else: ``paged_attention.launches`` (K5), ``paged_attention.launches_int8``
(K6), ``paged_attention_multiquery.launches`` (K7) and
``paged_attention_multiquery.launches_int8`` (K7q).
:func:`paged_attention_multiquery_split_ref` is a plain version of the
kernels' split-K numerics, for tests.

:func:`quantize_kv` is the reference's per-(row, kv head) symmetric int8
quantization, plain tensor code (the JAX package computes it outside any
kernel too).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_ref",
           "paged_attention_multiquery", "paged_attention_multiquery_ref",
           "paged_attention_multiquery_split_ref", "split_plan",
           "quantize_kv", "NEG_INF"]

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = tuple(range(16, 257, 16))   # every multiple of 16 to 256
_SPLIT_TOKENS = 128            # the kernels' target split length
_TILE = 32                     # tokens a stage of their ring holds
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_fwd.argtypes = ([vp] * 9 + [ci] * 9
                                            + [cf, ci, ci, vp])
        lib.paged_attention_fwd.restype = ci
        lib.paddle_cuda_error_string.argtypes = [ci]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


SplitPlan = collections.namedtuple(
    "SplitPlan", "split n_splits rows row_groups threads grid "
                 "workspace_floats live_blocks")


def split_plan(B, Q, H, KVH, D, page_size, S, context_lens=None):
    """How :func:`paged_attention` (Q = 1) and
    :func:`paged_attention_multiquery` cut a call on the card, from the
    shapes alone (no device sync): ``split`` tokens a split, the smallest
    multiple of the page size and of the 32-token ring tile that is at
    least 128 tokens; ``n_splits`` = ceil(S * page / split) splits a
    sequence; R = (H / KVH) * Q rows a (sequence, kv head), at most 32 a
    block of 128 threads (bf16: one m16 tile where R <= 16, two above), so
    ``row_groups`` blocks cover R; the split launch's
    ``grid`` (n_splits, KVH, B * row_groups) and ``threads``; the f32
    workspace of the per-split (acc [R, D], m, l), ``workspace_floats``.
    With ``context_lens`` (host ints), ``live_blocks``: the blocks whose
    split starts before the last row's horizon min(ctx + Q - 1, S * page),
    and split 0 of a sequence no row sees (it writes the zeros); the rest
    exit before reading the table.  The CUDA source applies the same rule
    to the split, the grid and the threads."""
    unit = math.lcm(page_size, _TILE)
    split = unit * -(-_SPLIT_TOKENS // unit)
    n_splits = -(-(S * page_size) // split)
    R = (H // KVH) * Q
    row_groups, threads = -(-R // 32), 128
    live = None
    if context_lens is not None:
        t_cap = S * page_size
        live = KVH * row_groups * sum(
            max(1, -(-max(0, min(int(c) + Q - 1, t_cap)) // split))
            for c in context_lens)
    return SplitPlan(split, n_splits, R, row_groups, threads,
                     (n_splits, KVH, B * row_groups),
                     B * KVH * n_splits * R * (D + 2), live)


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
        raise ValueError(f"head_dim {D}: the kernels take multiples of 16 "
                         f"from 16 to 256")
    if H % KVH != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KVH}")
    if block_tables.shape[0] != B or tuple(context_lens.shape) != (B,):
        raise ValueError("block_tables / context_lens batch does not match q")
    for name, t in [("q", q)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# the engine repeats the same shapes every layer: plan each shape once
_plan = functools.lru_cache(maxsize=64)(split_plan)


def _launch(q, k_pages, v_pages, block_tables, context_lens, k_scales,
            v_scales, scale, workspace=None):
    """Check, then launch the split kernel and its combine on q [B, H, D]
    (K5 / K6: one query row a sequence) or [B, Q, H, D] (K7 / K7q);
    returns out in q's shape and dtype.  The f32 workspace
    (``split_plan(...).workspace_floats``) is allocated here unless given:
    a caller that pre-fills it can read which split blocks wrote it."""
    _check(q, k_pages, v_pages, block_tables, context_lens, k_scales,
           v_scales)
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    Q = q.shape[1] if q.dim() == 4 else 1
    _, page_size, KVH, _ = k_pages.shape
    S = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    quant = k_scales is not None
    lib = _kernel_lib()
    dt = _DTYPES[q.dtype]
    plan = _plan(B, Q, H, KVH, D, page_size, S)
    ws = workspace
    if ws is None:
        ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                         device=q.device)
    elif (ws.dtype != torch.float32 or ws.device != q.device
          or ws.numel() < plan.workspace_floats or not ws.is_contiguous()):
        raise ValueError(f"workspace must be {plan.workspace_floats} "
                         f"contiguous float32 on {q.device}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            block_tables.data_ptr(), context_lens.data_ptr(), ws.data_ptr(),
            out.data_ptr(), B, Q, H, KVH, D, page_size, S,
            plan.split, plan.n_splits, float(scale), dt, int(quant), stream)
    if err:
        raise RuntimeError("paged attention kernel launch failed: "
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
    (pages in q's dtype) or K6 (int8 pages) — float32 or bfloat16 q, any
    head_dim % 16 == 0 from 16 to 256, any page size, any H % KVH == 0 —
    split over the token range (:func:`split_plan`), or raise.  The
    counters count calls: one a call, for its two launches."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, k_scales=k_scales,
                                   v_scales=v_scales, scale=scale)
    _on_cuda(q, "paged_attention")
    if q.dim() != 3:
        raise ValueError(f"paged_attention takes q [B, H, D], got "
                         f"{tuple(q.shape)}")
    out = _launch(q, k_pages, v_pages, block_tables, context_lens, k_scales,
                  v_scales, scale)
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
    launch K7 (pages in q's dtype) or K7q (int8 pages) — float32 or
    bfloat16 q, any head_dim % 16 == 0 from 16 to 256, any page size, any
    H % KVH == 0 and any Q — which read q in place and stream each page once for all Q
    rows, split over the token range (:func:`split_plan`), or raise.  The
    counters count calls: one a call, for its two launches."""
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
    to q's dtype) — the golden K7 / K7q (and, through
    :func:`paged_attention_ref`, K5 / K6) are held against, and the path
    CPU tensors take.  Int8 pages dequantize in float32, as the reference's jnp
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


def paged_attention_multiquery_split_ref(q, k_pages, v_pages, block_tables,
                                         context_lens, *, split_tokens=None,
                                         k_scales=None, v_scales=None,
                                         scale=None):
    """Plain version of the kernels' split-K numerics (K5 / K6 at Q = 1),
    for tests: the table's
    S * page tokens cut into splits of ``split_tokens`` (None: one split);
    per split and row, f32 scores over the split's visible tokens, m = their
    max (NEG_INF if none), P = exp(s - m) rounded to the working dtype, l =
    sum(P) in f32, acc = P V in f32; then the splits combined in split order,
    out = sum(acc_s w_s) / max(sum(l_s w_s), 1e-30) with w_s = exp(m_s - M),
    M the largest m_s.  Int8 values are dequantized in f32 and rounded to
    q's dtype, as the kernels do.  V at positions no row sees is zeroed, so
    pages past the last row's horizon never reach the output."""
    B, Q, H, D = q.shape
    P, page_size, KVH, _ = k_pages.shape
    S = block_tables.shape[1]
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    T = S * page_size
    split = T if split_tokens is None else int(split_tokens)
    ns = -(-T // split)
    idx = block_tables.long().clamp(0, P - 1)
    k = _dense(k_pages, k_scales, idx)
    v = _dense(v_pages, v_scales, idx)
    wdt = q.dtype if k_scales is not None else v_pages.dtype
    if k_scales is not None:
        k, v = k.to(q.dtype).float(), v.to(q.dtype).float()
    ctx = context_lens.to(q.device).long()
    mask = (torch.arange(T, device=q.device)[None, None, :]
            < (ctx[:, None] + torch.arange(Q, device=q.device))[:, :, None])
    v = v.masked_fill(~mask.any(1)[:, None, :, None], 0.0)
    pad = ns * split - T
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    mask = torch.nn.functional.pad(mask, (0, pad))
    qh = q.transpose(1, 2).reshape(B, KVH, G, Q, D).float()
    sc = torch.einsum("bhgqd,bhtd->bhgqt", qh * scale, k)
    vis = mask[:, None, None].expand_as(sc)
    sc = torch.where(vis, sc, torch.full((), NEG_INF, device=q.device))
    sc, vis = (x.reshape(B, KVH, G, Q, ns, split) for x in (sc, vis))
    m = sc.amax(-1)                                   # [B, KVH, G, Q, ns]
    p = torch.where(vis, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bhgqst,bhstd->bhgqsd", p.to(wdt).float(),
                       v.reshape(B, KVH, ns, split, D))
    M = m.amax(-1)
    num = torch.zeros_like(acc[..., 0, :])
    den = torch.zeros_like(l[..., 0])
    for i in range(ns):                               # in split order
        w = torch.exp(m[..., i] - M)
        num = num + acc[..., i, :] * w[..., None]
        den = den + l[..., i] * w
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Q, D).transpose(1, 2).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens, *,
                        k_scales=None, v_scales=None, scale=None):
    """Plain PyTorch version of K5 / K6: the multi-query version with one
    query row, whose horizon is ctx (capped at S * page)."""
    return paged_attention_multiquery_ref(
        q[:, None], k_pages, v_pages, block_tables, context_lens,
        k_scales=k_scales, v_scales=v_scales, scale=scale)[:, 0]

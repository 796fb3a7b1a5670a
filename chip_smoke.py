#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: the card's name and power limit; every kernel under
   ``paddle_tpu_torch/csrc`` is built from the checkout (one nvcc each, in
   parallel) and the build time printed.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving engine gives it at Llama-3-8B width (H=32, KVH=8,
   D=128, page 16), in bfloat16 and float32; all four are one split-K
   body: K5 (paged attention) and K6 (its int8-page variant) at the
   decode and prefill-chunk shapes, K5 also with a row whose context runs
   past its block table, K7 and K7q (multi-query verify attention, bf16
   and int8 pages) at the verify shape and in ``MQ_CASES`` (split edges,
   context 0, 12 and 64 rows, head_dim 64), and all four at head_dim 16,
   80, 96 and 256 (``HEAD_DIM_CASES``); each case run twice and bitwise
   the same (in bf16 also each row against its own largest reference
   magnitude).  Each is then timed with CUDA events (L2 flushed before
   every launch) beside its plain version, one PyTorch call that computes
   the same function, and its bound; also with the card held in a spin
   before the start event (the device's span of the call, without host
   issue, beside SDPA's), by the profiler's device time of its two
   launches and by the host's time per call, piece by piece; its split
   blocks that pass the early exit are counted on the card.
   Then the flash-attention kernels of training,
   K1 (forward), K2 (dQ) and K3 (dK / dV), against their plain versions at
   the GPT-2 bench shape (B16 S1024 H12 D64, causal, bf16), the
   Llama-shaped one (B8 S1024 H16 KVH4 D128, GQA), head_dim 192, 256 and
   512, a non-causal case and six float32 cases (TF32 off); and K4, the
   layout-direct bodies of the ``FLAGS_flash_layout_direct`` path, against
   theirs at GPT-2's shape, MHA at head_dim 256 and 512, a non-causal case
   and three float32 cases.  Each is then timed at the GPT-2, head_dim-256
   and head_dim-512 shapes (K1-K3 also at the Llama one) beside its plain
   version, SDPA's forward / backward and its bound.  head_dim 320, 384 and
   512 run forward and backward through ``flash_attention_bshd`` on the
   card (K1-K3, and K4 with the flag), one launch each, held to the plain
   versions; 576 is refused before any launch.
3. engine: a float32 tiny Llama bridged from seeded numpy weights serves
   greedy requests on the card, each token checked against the dense
   reference, then again with int8 KV pages, with speculative decoding,
   with both (each token-identical to the plain engine of its KV dtype),
   and with the model drafting for itself, each launching its paged
   kernels; at head_dim 128, 16 (``LlamaConfig.tiny()``) and 64
   (``TINY_ENGINES``).  Then ``LLMEngine`` serves 8
   greedy requests at the full width of Llama-3-8B (random weights from a
   seeded generator on the card, 32 layers) through add_request / step /
   stream: first in float32, then in bfloat16 (profiled afterwards: a
   decode window's device busy ms and K5's share), then
   in bfloat16 with speculative decoding (K5 + K7; the model drafts for
   itself; a window of its verify steps profiled afterwards: device busy
   ms and K7's share), then with int8 pages and speculative decoding (K6 +
   K7q).  Every request must finish with 32
   tokens, each kernel's launch count, set to 0 just before an engine runs
   and read just after, must equal layers x the dispatches that reach it,
   and every token must match a teacher-forced dense reference (see
   ``GAP``; for int8 pages the reference's K and V pass through the same
   int8 quantization).
4. training, after the engines have freed their memory: a tiny float32
   GPT-2 bridged from seeded numpy weights takes two AdamW steps on the
   card (K1-K3) and on the CPU (their plain versions), held together; then
   GPT-2 124M in bf16 at ``bench.py``'s geometry (B16 S1024, AdamW 3e-4,
   global-norm clip 1.0, chunked bf16 loss) and a Llama-3-shaped model (4
   layers of width 2048, 16 q / 4 kv heads, B8 S1024) each take a checked
   first step (loss and block 0's attention gradients against the same
   model with the reference's dense attention) and timed steps on one
   repeated batch, with K1 = layers x forwards and K2 = K3 = layers x
   backwards, the loss falling; step ms, tokens/s, MFU, peak memory and a
   profiled step's device time are printed.  Between the two, the same
   GPT-2 from the same seed trains with ``FLAGS_flash_layout_direct`` set
   (K4's path), its first step held to the default path's, with K4's three
   bodies launched layers x steps times each and K1-K3 never.
5. weight-only, K8's path: Llama-3-8B's 224 projection weights (32
   layers, random bf16 from a seeded generator on the card) quantized to
   int8 and int4 through ``weight_quantize``; one decode step of linear
   layers (M = 8) through ``nn.quant.weight_only_linear``, K8 launched
   once a GEMM, each output against ``quant_matmul_ref``; M 1 and 300, one
   float32 case, a call needing a gradient (no launch), the memory a call
   allocates (less than its bf16 weight); the pass timed beside its bound,
   the dequant formulation, F.linear on dequantized bf16 weights, and the
   library's int8 call where it runs on CUDA.
6. the decode and verify windows' lines, the ``kernels`` JSON line (all
   twelve kernels, each launched on its path; K5-K7q with their design and
   split plan), the card line, and last the result line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
H, KVH, D, PAGE = 32, 8, 128, 16
TABLE_TOKENS = 1024                    # S * page of every kernel case
DECODE_CTX = [1, 16, 17, 600, 1024, 300, 1000, 800]
# K5 with a row whose context runs past its table (the kernel caps at
# S * page tokens, as the TPU grid (B, S) does)
CAPPED_CTX = [1100, 16, 17, 600, 1024, 300, 1000, 800]
PREFILL_ROWS, PREFILL_START = 32, 300
VERIFY_Q = 8                           # Kv rows of a max_draft=4 verify step
# row 0's contexts; 1020 + 7 runs past the table, as a padded verify row of
# the slot nearest max_len does
VERIFY_CTX = [1, 17, 600, 1020, 300, 1000, 64, 800]
# K7 / K7q's further cases, each held against the plain twin in bf16 and
# f32: (tag, row-0 contexts, Q, (H, KVH, D)).  split-edge: horizons that
# end on a 128-token split edge (121 + 7, 128 + 0, 250 + 6 = 256), a split
# that row 0 does not see and rows 1.. do (384), a sequence whose splits
# past the first no row sees (5); ctx0: sequences with context 0 (row 0
# sees nothing and returns 0); R12 and R64: G Q = 12 rows (not a multiple
# of 16) and 64 (two row groups); D64: head_dim 64.
MQ_CASES = [
    ("split-edge", [121, 128, 250, 384, 5, 1017, 255, 129], VERIFY_Q,
     (H, KVH, D)),
    ("ctx0", [0, 0, 1, 600, 0, 1000, 64, 800], VERIFY_Q, (H, KVH, D)),
    ("R12", VERIFY_CTX, 3, (H, KVH, D)),
    ("R64", VERIFY_CTX, 16, (H, KVH, D)),
    ("D64", VERIFY_CTX, VERIFY_Q, (16, 4, 64)),
]
# All four paged kernels at head dims beside the main path's 128, at its
# heads (32 q, 8 kv) and contexts (decode for K5 / K6, verify for K7 /
# K7q): 16 (LlamaConfig.tiny()), 80 and 96 (instantiated at 128 columns,
# the pad zero-filled) and 256
HEAD_DIM_CASES = (16, 80, 96, 256)
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
PROMPT_LENS = [17, 32, 64, 100, 255, 256, 400, 600]
NEW_TOKENS = 32
MAX_DRAFT = 4
# Teacher-forced check: at every position the dense reference must score the
# engine's token within GAP of its own best logit.  So where the
# reference's top-1/top-2 gap exceeds GAP the engine must have picked its
# argmax, and elsewhere it may pick any token that close to the best.  In
# float32 the engine's logits at full width sit within 1e-4 of the
# reference's on the H100, so F32_GAP has a 10x margin.  In bfloat16 the two
# paths round at different places (the kernel rounds P to bf16 before the PV
# product, the dense reference does not; matmuls of other shapes sum in
# other orders) and the difference grows through 32 layers of random
# weights: on the H100 the logits of the two paths differed by 0.055 on
# average and 0.39 at most, and one engine token was the reference's THIRD
# choice, 0.144 below its best, so "argmax or top 2" cannot be the rule.  A
# token flips when the errors of two logits differ by more than the gap
# between them: with errors of about 0.07 standard deviation, that
# difference has about 0.1, and GAP is about three of those.
F32_GAP = 1e-3
GAP = 0.3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


# the launch counters of each kernel: (module, function, attribute)
COUNTERS = {
    "K1": ("flash_attention", "flash_attention_bshd", "launches_fwd"),
    "K2": ("flash_attention", "flash_attention_bshd", "launches_dq"),
    "K3": ("flash_attention", "flash_attention_bshd", "launches_dkv"),
    "K4-fwd": ("flash_attention", "flash_attention_bshd",
               "launches_direct_fwd"),
    "K4-dq": ("flash_attention", "flash_attention_bshd",
              "launches_direct_dq"),
    "K4-dkv": ("flash_attention", "flash_attention_bshd",
               "launches_direct_dkv"),
    "K5": ("paged_attention", "paged_attention", "launches"),
    "K6": ("paged_attention", "paged_attention", "launches_int8"),
    "K7": ("paged_attention", "paged_attention_multiquery", "launches"),
    "K7q": ("paged_attention", "paged_attention_multiquery",
            "launches_int8"),
    "K8": ("quant_matmul", "quant_matmul", "launches"),
    "K8-int4": ("quant_matmul", "quant_matmul", "launches_int4"),
}
FLASH_COUNTERS = ("K1", "K2", "K3", "K4-fwd", "K4-dq", "K4-dkv")


def _counter(kern):
    import importlib
    mod, fn, attr = COUNTERS[kern]
    return getattr(importlib.import_module(f"paddle_tpu_torch.ops.{mod}"),
                   fn), attr


def launch_counts():
    """Every kernel's launch counter, by kernel name."""
    return {k: getattr(*_counter(k)) for k in COUNTERS}


def reset_launch_counts():
    for k in COUNTERS:
        setattr(*_counter(k), 0)


# ------------------------------------------------------------------ timing
class Timer:
    """Median time of fn over n launches by CUDA events, each after the L2
    cache is flushed (the engine reads each layer's pages cold).  ``ms``
    records the start event right after the flush, so where fn's host
    issue outlasts the flush, the time includes it; ``held_ms`` holds the
    card in a short spin after the flush, so that fn's launches are queued
    before the start event is reached and the time is the device's span of
    the call alone."""
    SPIN_CYCLES = 500_000          # about 0.25 ms at the H100's clock

    def __init__(self, dev):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn, n=30, warmup=3, spin=0):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(spin)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def held_ms(self, fn, n=30):
        return self.ms(fn, n, spin=self.SPIN_CYCLES)

    @staticmethod
    def host_us(fn, n=200):
        """Host time of one call of fn in microseconds: n calls issued back
        to back (the card's queue absorbs their launches), no sync inside."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    def device_ms(self, fn, match, n=20):
        """Device time per call of fn's kernels whose names contain one of
        ``match`` (torch.profiler, L2 flushed before each call)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and any(m in e.key for m in match)) / 1e3 / n


# --------------------------------------------------------- phase 2: kernels
class Case:
    """One kernel call as the engine makes it: q (``[B, H, D]``, or
    ``[B, Q, H, D]`` with ``q_len``), pages, block tables and context lens,
    and with ``quant`` int8 pages quantized from the random ones with their
    scales.  Each sequence owns its pages (or all rows share one table, as
    a prefill chunk's rows do); table entries past the last row's horizon
    hold out-of-range garbage that the kernel must never read."""

    def __init__(self, dtype, ctx, gen, dev, shared=False, q_len=None,
                 quant=False, heads=(H, KVH, D)):
        from paddle_tpu_torch.ops.paged_attention import quantize_kv
        self.dtype, self.ctx, self.shared = dtype, list(ctx), shared
        self.q_len, self.quant = q_len, quant
        self.heads = heads
        H, KVH, D = heads
        B = len(ctx)
        S = TABLE_TOKENS // PAGE
        n_seq = 1 if shared else B
        P = n_seq * S + 1
        qshape = (B, H, D) if q_len is None else (B, q_len, H, D)
        self.q = torch.randn(qshape, generator=gen, device=dev).to(dtype)
        kp = torch.randn(P, PAGE, KVH, D, generator=gen, device=dev)
        vp = torch.randn(P, PAGE, KVH, D, generator=gen, device=dev)
        perm = torch.randperm(P - 1, generator=gen, device=dev).to(
            torch.int32)
        tables = perm[: n_seq * S].view(n_seq, S)
        tables = tables.expand(B, S).clone() if shared else tables.clone()
        rows = q_len or 1
        for b, c in enumerate(ctx):
            tables[b, -(-(c + rows - 1) // PAGE):] = 1 << 30
        self.kw = {}
        if quant:
            kp, ks = quantize_kv(kp)
            vp, vs = quantize_kv(vp)
            self.kw = {"k_scales": ks, "v_scales": vs}
        else:
            kp, vp = kp.to(dtype), vp.to(dtype)
        self.args = (self.q, kp, vp, tables,
                     torch.tensor(ctx, dtype=torch.int32, device=dev))

    def run(self, fn):
        return fn(*self.args, **self.kw)

    def bound(self):
        """Least time for the work: bytes (q and out once, the K/V rows the
        rows see once — int8 rows with their f32 scale — the table entries
        used, the lengths) over the memory rate, or the flops (QK^T and PV,
        2 each per multiply-add, each row over its own horizon) over the
        peak for the type; the larger of the two.  Rows sharing one table
        (a prefill chunk) read its pages once."""
        H, KVH, D = self.heads
        el = self.q.element_size()
        rows = self.q_len or 1
        seen = [min(c + rows - 1, TABLE_TOKENS) for c in self.ctx]
        if self.shared:
            seen = [max(seen)]
        per_token = KVH * (D + 4 if self.quant else D * el)
        nbytes = (2 * self.q.numel() * el + 2 * sum(seen) * per_token
                  + sum(-(-t // PAGE) for t in seen) * 4 + len(self.ctx) * 4)
        flops = 4 * H * D * sum(min(c + j, TABLE_TOKENS)
                                for c in self.ctx for j in range(rows))
        peak = BF16_FLOPS if self.dtype == torch.bfloat16 else F32_FLOPS
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def library(self):
        """The library yardstick, never called by the port: SDPA with GQA
        on K/V already gathered dense (dequantized to q's dtype for int8
        pages, so it reads twice the int8 bytes), with a boolean mask per
        row.  Returns a callable and its output in q's layout."""
        q, kp, vp, tables, cl = self.args
        H, KVH, D = self.heads
        B, rows = len(self.ctx), self.q_len or 1
        T = min(max(self.ctx) + rows - 1, TABLE_TOKENS)
        safe = tables.clamp(max=kp.shape[0] - 1).long()

        def dense(pages, scales):
            x = pages[safe].float()
            if scales is not None:
                x = x * scales[safe][..., None]
            x = x.reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
            return x.to(self.dtype).contiguous()

        kd = dense(kp, self.kw.get("k_scales"))
        vd = dense(vp, self.kw.get("v_scales"))
        horizon = cl[:, None] + torch.arange(rows, device=cl.device)
        mask = (torch.arange(T, device=cl.device)[None, None, :]
                < horizon[:, :, None])[:, None]             # [B, 1, rows, T]
        qd = (q[:, :, None, :] if self.q_len is None
              else q.transpose(1, 2).contiguous())          # [B, H, rows, D]

        def fn():
            return torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask, enable_gqa=True)
        o = fn()
        o = o[:, :, 0] if self.q_len is None else o.transpose(1, 2)
        return fn, o


KERNELS = {
    # name: (kernel number, TPU kernel replaced, int8 pages, multi-query)
    "paged_attention": ("K5", "paddle_tpu/ops/pallas/paged_attention.py:30",
                        False, False),
    "paged_attention_int8": (
        "K6", "paddle_tpu/ops/pallas/paged_attention.py:78", True, False),
    "paged_attention_multiquery": (
        "K7", "paddle_tpu/ops/pallas/paged_attention.py:191", False, True),
    "paged_attention_multiquery_int8": (
        "K7q", "paddle_tpu/ops/pallas/paged_attention.py:201", True, True),
}
PAGED_DESIGN = ("split-K over the token range (flash-decoding): blocks of "
                "(split, kv head, sequence x up to 32 rows), a 3-stage "
                "cp.async ring of 32-token K/V tiles, mma.sync m16n8k16 for "
                "q K^T and P V (one m16 tile of rows where R <= 16, as at "
                "decode, two above; two warps a token group, each half of "
                "D), int8 dequantized in registers; a second launch "
                "combines the splits in order")
# the device kernels of all four (their split and combine launches)
SPLIT_KERNELS = ("paged_split", "paged_combine")


def live_blocks(c, plan):
    """The split blocks that passed the early exit, counted on the card:
    one call of the launcher on a workspace filled with NaN; every block
    that runs writes (m, l) for the first row of its row group, and the
    blocks that exit write nothing."""
    from paddle_tpu_torch.ops.paged_attention import _launch
    q, kp, vp, tables, cl = c.args
    ws = torch.full((plan.workspace_floats,), float("nan"),
                    device=q.device)
    _launch(q, kp, vp, tables, cl, c.kw.get("k_scales"),
            c.kw.get("v_scales"), None, workspace=ws)
    B, KVH_ = len(c.ctx), kp.shape[2]
    ml = ws[B * KVH_ * plan.n_splits * plan.rows * q.shape[-1]:]
    m = ml.view(B, KVH_, plan.n_splits, plan.rows, 2)[..., ::32, 0]
    return int((~torch.isnan(m)).sum())


def wrapper_host_us(c, kern):
    """Host microseconds of one call of the wrapper ``kern`` on the card,
    and of its pieces, each timed alone over many calls: the checks
    (``_check``), the cached plan, the two allocations (workspace and out),
    the ctypes call that makes both launches, and the whole wrapper."""
    from paddle_tpu_torch.ops import paged_attention as pa
    q, kp, vp, tables, cl = c.args
    ks, vs = c.kw.get("k_scales"), c.kw.get("v_scales")
    B, H_, D_ = q.shape[0], q.shape[-2], q.shape[-1]
    Q = q.shape[1] if q.dim() == 4 else 1
    _, page, KVH_, _ = kp.shape
    S = tables.shape[1]
    dt, quant = pa._DTYPES[q.dtype], int(ks is not None)
    plan = pa._plan(B, Q, H_, KVH_, D_, page, S)
    lib = pa._kernel_lib()
    ws = torch.empty(plan.workspace_floats, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() if t is not None else None
            for t in (q, kp, vp, ks, vs, tables, cl, ws, out)]

    def launch():
        lib.paged_attention_fwd(*ptrs, B, Q, H_, KVH_, D_, page, S,
                                plan.split, plan.n_splits, 1.0 / D_ ** 0.5,
                                dt, quant, stream)
    return {
        "check": Timer.host_us(lambda: pa._check(q, kp, vp, tables, cl, ks,
                                                 vs), 2000),
        "plan": Timer.host_us(lambda: pa._plan(B, Q, H_, KVH_, D_, page,
                                               S), 2000),
        "alloc": Timer.host_us(lambda: (
            torch.empty(plan.workspace_floats, device=q.device),
            torch.empty_like(q)), 2000),
        "ctypes_launch": Timer.host_us(launch),
        "call": Timer.host_us(lambda: c.run(kern)),
    }


def kernel_phase(dev, timer):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_multiquery,
        paged_attention_multiquery_ref, paged_attention_ref, split_plan)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernels: float32 matmuls and convolutions run without TF32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prefill_ctx = [PREFILL_START + i + 1 for i in range(PREFILL_ROWS)]
    single = (paged_attention, paged_attention_ref)
    multi = (paged_attention_multiquery, paged_attention_multiquery_ref)
    # (kernel name, case, context lens, one shared table, q_len)
    cases = [("paged_attention", "decode", DECODE_CTX, False, None),
             ("paged_attention", "prefill", prefill_ctx, True, None),
             ("paged_attention", "capped", CAPPED_CTX, False, None),
             ("paged_attention_int8", "decode", DECODE_CTX, False, None),
             ("paged_attention_int8", "prefill", prefill_ctx, True, None),
             ("paged_attention_multiquery", "verify", VERIFY_CTX, False,
              VERIFY_Q),
             ("paged_attention_multiquery_int8", "verify", VERIFY_CTX, False,
              VERIFY_Q)]
    cases += [(name, tag, ctx, False, q_len, heads)
              for tag, ctx, q_len, heads in MQ_CASES
              for name in ("paged_attention_multiquery",
                           "paged_attention_multiquery_int8")]
    cases += [(name, f"D{d}", VERIFY_CTX if mq else DECODE_CTX, False,
               VERIFY_Q if mq else None, (H, KVH, d))
              for d in HEAD_DIM_CASES
              for name, (_, _, _, mq) in KERNELS.items()]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, case, ctx, shared, q_len, *heads in cases:
            quant = KERNELS[name][2]
            kern, ref = multi if q_len else single
            c = Case(dtype, ctx, gen, dev, shared, q_len, quant,
                     *(heads or [(H, KVH, D)]))
            out = c.run(kern)
            # the split-K kernels combine in split order: run to run the
            # same bits
            same = torch.equal(out, c.run(kern))
            torch.cuda.synchronize()
            want = c.run(ref)
            diff = (out.float() - want.float()).abs()
            err = diff.max().item()
            # in bf16 also each row's error over its own largest reference
            # magnitude (long rows average to small outputs, so the absolute
            # bar alone would let their errors hide under the short rows')
            row_err = 0.0
            if dtype == torch.bfloat16:
                row_err = (diff.amax(-1) / want.float().abs().amax(-1)
                           .clamp_min(1e-30)).max().item()
            ok = (bool(torch.isfinite(out).all()) and err <= TOL[dtype]
                  and row_err <= TOL[dtype] and same)
            h_, kvh_, d_ = c.heads
            print(f"{name} {case} {str(dtype)[6:]} B={len(ctx)}"
                  f"{f' Q={q_len}' if q_len else ''} H={h_} KVH={kvh_} "
                  f"D={d_} max_abs_err={err:.3e}"
                  f"{f' max_row_rel_err={row_err:.3e}' if row_err else ''}"
                  f" tol={TOL[dtype]:.0e}{' deterministic' if same else ''} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"{name} {case} {dtype}: error {err} (per row "
                  f"{row_err}) over {TOL[dtype]}"
                  f"{'' if same else ', two runs differ'}")
            errs.setdefault((name, dtype), []).append(err)
            errs.setdefault((name, "row"), []).append(row_err)

    # timing at each kernel's main-path shape, in the engine's dtype
    dtype = torch.bfloat16
    lines, later = [], []
    for name, (num, replaces, quant, mq) in KERNELS.items():
        ctx, q_len = (VERIFY_CTX, VERIFY_Q) if mq else (DECODE_CTX, None)
        kern, ref = multi if mq else single
        c = Case(dtype, ctx, gen, dev, q_len=q_len, quant=quant)
        out = c.run(kern)
        lib_fn, lib_out = c.library()
        lib_err = (lib_out.float() - out.float()).abs().max().item()
        check(lib_err <= TOL[dtype],
              f"{name}: library yardstick disagrees by {lib_err}")
        kernel_ms = timer.ms(lambda: c.run(kern))
        plain_ms = timer.ms(lambda: c.run(ref))
        library_ms = timer.ms(lib_fn)
        bound_ms, bound_by = c.bound()
        shape = (f"{'verify' if mq else 'decode'} bf16 B={len(ctx)}"
                 f"{f' Q={q_len}' if mq else ''} H={H} KVH={KVH} D={D} "
                 f"page={PAGE} ctx={ctx}{' int8 pages' if quant else ''}")
        print(f"{name} ({num}) {shape}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
        line = {
            "name": name, "kernel": num, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": replaces,
            "launches": None,
            "max_abs_err": max(errs[(name, torch.bfloat16)]),
            "max_row_rel_err": max(errs[(name, "row")]),
            "tolerance": TOL[torch.bfloat16],
            "max_abs_err_f32": max(errs[(name, torch.float32)]),
            "tolerance_f32": TOL[torch.float32],
            "head_dims_checked": sorted({D, 64, *HEAD_DIM_CASES}
                                        if mq else {D, *HEAD_DIM_CASES}),
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": ("SDPA with enable_gqa on K/V gathered dense"
                        + (" and dequantized to bf16 (reads twice the int8 "
                           "bytes)" if quant else "")
                        + (", boolean mask per row" if mq else "")),
            "shape": shape,
        }
        later.append((line, c, kern, lib_fn))
        if not quant and not mq:
            # K5 at the prefill-chunk shape too: 32 rows share one table
            pre = Case(dtype, prefill_ctx, gen, dev, shared=True)
            line["prefill_ms"] = timer.ms(lambda: pre.run(kern))
            line["prefill_plain_ms"] = timer.ms(lambda: pre.run(ref))
            line["prefill_bound_ms"] = pre.bound()[0]
            pre_fn, pre_out = pre.library()
            pre_err = (pre_out.float() - pre.run(kern).float()).abs().max()
            check(pre_err.item() <= TOL[dtype], f"{name} prefill: library "
                  f"yardstick disagrees by {pre_err.item()}")
            line["prefill_library_ms"] = timer.ms(pre_fn)
            print(f"{name} ({num}) prefill bf16 B={PREFILL_ROWS} ctx="
                  f"{prefill_ctx[0]}..{prefill_ctx[-1]} (one shared table): "
                  f"kernel {line['prefill_ms']:.4f} ms, plain "
                  f"{line['prefill_plain_ms']:.4f} ms, library "
                  f"{line['prefill_library_ms']:.4f} ms, bound "
                  f"{line['prefill_bound_ms']:.4f} ms", flush=True)
        lines.append(line)
    # further readings, after every kernel's event time above: a profiler
    # session or a host loop may leave the host slower for a while, and an
    # event time taken then would count it
    for line, c, kern, lib_fn in later:
        # the plan at this shape, the split blocks that passed the early
        # exit (read back from the workspace), and three more readings of
        # the kernel beside SDPA: the event time with the card held (the
        # device's span of the call), the profiler's device time of its two
        # launches, and the host's time per call, piece by piece
        plan = split_plan(len(c.ctx), c.q_len or 1, H, KVH, D, PAGE,
                          TABLE_TOKENS // PAGE, context_lens=c.ctx)
        live = live_blocks(c, plan)
        check(live == plan.live_blocks,
              f"{line['kernel']}: {live} split blocks wrote the workspace, "
              f"the plan has {plan.live_blocks}")
        line["design"] = PAGED_DESIGN
        line["splits"] = {
            "split_tokens": plan.split, "n_splits": plan.n_splits,
            "rows": plan.rows, "grid": list(plan.grid),
            "threads": plan.threads, "live_blocks": live,
            "workspace_bytes": 4 * plan.workspace_floats}
        line["held_ms"] = timer.held_ms(lambda: c.run(kern))
        line["library_held_ms"] = timer.held_ms(lib_fn)
        line["host_us"] = wrapper_host_us(c, kern)
        line["library_host_us"] = timer.host_us(lib_fn)
    for line, c, kern, _ in later:         # the profiler last
        line["device_ms"] = timer.device_ms(lambda: c.run(kern),
                                            SPLIT_KERNELS)
        print(f"{line['name']} ({line['kernel']}): "
              f"{line['splits']['live_blocks']} split blocks passed the "
              f"early exit (measured; the plan's count) of grid "
              f"{tuple(line['splits']['grid'])}, "
              f"{line['splits']['split_tokens']}-token splits; held "
              f"{line['held_ms']:.4f} ms, device time of its two "
              f"launches {line['device_ms']:.4f} ms (profiler), library "
              f"held {line['library_held_ms']:.4f} ms; host us a call "
              f"{ {k: round(v, 2) for k, v in line['host_us'].items()} }"
              f", library {line['library_host_us']:.2f}", flush=True)
    return lines


# ---------------------------------------------------- phase 2b: flash kernels
_FA = "paddle_tpu/ops/pallas/flash_attention.py"
# (name, kernel, role, layout-direct, TPU kernel replaced)
FLASH_KERNELS = [
    ("flash_attention_fwd", "K1", "fwd", False, f"{_FA}:34"),
    ("flash_attention_bwd_dq", "K2", "dq", False, f"{_FA}:161"),
    ("flash_attention_bwd_dkv", "K3", "dkv", False, f"{_FA}:220"),
    ("flash_attention_direct_fwd", "K4-fwd", "fwd", True, f"{_FA}:459"),
    ("flash_attention_direct_dq", "K4-dq", "dq", True, f"{_FA}:565"),
    ("flash_attention_direct_dkv", "K4-dkv", "dkv", True, f"{_FA}:624"),
]
ROLE_KERNEL = {(role, direct): kern
               for _, kern, role, direct, _ in FLASH_KERNELS}
# (tag, B, S, H, KVH, D, causal, dtype): K1-K3 at the two training shapes,
# head_dim 192, 256 and 512 (the column-chunked bodies), one non-causal
# case, and float32 (TF32 off)
FLASH_CASES = [
    ("gpt2", 16, 1024, 12, 12, 64, True, torch.bfloat16),
    ("llama", 8, 1024, 16, 4, 128, True, torch.bfloat16),
    ("d192", 4, 1024, 8, 8, 192, True, torch.bfloat16),
    ("d256", 4, 1024, 8, 4, 256, True, torch.bfloat16),
    ("d512", 4, 1024, 8, 4, 512, True, torch.bfloat16),
    ("non-causal", 4, 512, 12, 4, 64, False, torch.bfloat16),
    ("f32 mha", 1, 256, 2, 2, 128, True, torch.float32),
    ("f32 gqa", 1, 256, 4, 1, 64, True, torch.float32),
    ("f32 d192", 1, 256, 2, 2, 192, True, torch.float32),
    ("f32 d256", 1, 256, 4, 2, 256, True, torch.float32),
    ("f32 d320", 1, 256, 4, 2, 320, True, torch.float32),
    ("f32 d512", 1, 256, 2, 2, 512, False, torch.float32),
]
# K4 (MHA only): GPT-2's shape, head_dim 256 and 512, non-causal, float32
K4_CASES = [
    ("gpt2", 16, 1024, 12, 12, 64, True, torch.bfloat16),
    ("d256", 4, 1024, 8, 8, 256, True, torch.bfloat16),
    ("d512", 4, 1024, 8, 8, 512, True, torch.bfloat16),
    ("non-causal", 4, 512, 12, 12, 64, False, torch.bfloat16),
    ("f32 d64", 1, 256, 2, 2, 64, True, torch.float32),
    ("f32 d256", 1, 256, 2, 2, 256, True, torch.float32),
    ("f32 d512", 1, 256, 2, 2, 512, True, torch.float32),
]
FLASH_TIMED = {False: ("gpt2", "llama", "d256", "d512"),
               True: ("gpt2", "d256", "d512")}
# forward (o and lse, absolute) and gradient tolerances, those of
# tests/test_pallas_kernels.py: float32 absolute; bf16 gradients at 2e-2 of
# the largest reference magnitude (they scale with the inputs)
FLASH_TOL = {torch.float32: (2e-5, 5e-4), torch.bfloat16: (2e-2, 2e-2)}


@contextlib.contextmanager
def layout_direct(on):
    """FLAGS_flash_layout_direct set to ``on`` through the port's
    set_flags, restored afterwards."""
    import paddle_tpu_torch as pt
    saved = pt.get_flags("flash_layout_direct")
    pt.set_flags({"flash_layout_direct": on})
    try:
        yield
    finally:
        pt.set_flags(saved)


class FlashCase:
    """One attention problem: q / dO [B, S, H, D], k / v [B, S, KVH, D],
    standard-normal from the seeded generator; ``direct`` for K4's
    bodies and twins (the layout-direct path) instead of K1-K3's."""

    def __init__(self, tag, B, S, H, KVH_, D_, causal, dtype, gen, dev,
                 direct=False):
        self.tag, self.causal, self.dtype = tag, causal, dtype
        self.direct = direct
        self.shape = (B, S, H, KVH_, D_)
        self.q, self.do = (torch.randn(B, S, H, D_, generator=gen,
                                       device=dev).to(dtype) for _ in "qd")
        self.k, self.v = (torch.randn(B, S, KVH_, D_, generator=gen,
                                      device=dev).to(dtype) for _ in "kv")
        self.scale = D_ ** -0.5

    def refs(self):
        from paddle_tpu_torch.ops import flash_attention as fa
        return ((fa.bshd_fwd_ref, fa.bshd_bwd_ref) if self.direct else
                (fa.flash_fwd_ref, fa.flash_bwd_ref))

    def describe(self):
        B, S, H, KVH_, D_ = self.shape
        return (f"{self.tag} {str(self.dtype)[6:]} B={B} S={S} H={H} "
                f"KVH={KVH_} D={D_} causal={self.causal}")

    def check(self):
        """Kernels against their plain versions, the forward's through
        ``flash_attention_bshd`` and its autograd (with the flag set for
        K4, which must then launch K4's bodies and no others); returns the
        errors of o (and the LSE), dq and dk / dv by kernel, gradients
        relative to the largest reference magnitude in bf16."""
        from paddle_tpu_torch.ops import flash_attention as fa
        q, k, v, do = self.q, self.k, self.v, self.do
        fwd_ref, bwd_ref = self.refs()
        o_ref, lse_ref = fwd_ref(q, k, v, self.causal)
        g_ref = bwd_ref(q, k, v, o_ref, lse_ref, do, self.causal)
        _, lse = fa._launch_fwd(q, k, v, self.causal, self.scale, self.direct)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with layout_direct(self.direct):
            before = launch_counts()
            o = fa.flash_attention_bshd(*leaves, causal=self.causal)
            o.backward(do)
            after = launch_counts()
        torch.cuda.synchronize()
        ran = {n: after[n] - before[n] for n in FLASH_COUNTERS}
        kern = {role: ROLE_KERNEL[(role, self.direct)]
                for role in ("fwd", "dq", "dkv")}
        check(ran == {n: int(n in kern.values()) for n in FLASH_COUNTERS},
              f"flash {self.describe()}: launched {ran}, expected one each "
              f"of {sorted(kern.values())}")
        f_tol, g_tol = FLASH_TOL[self.dtype]

        def err(a, b, grad):
            e = (a.float() - b.float()).abs().max().item()
            if grad and self.dtype == torch.bfloat16:
                e /= b.float().abs().max().item()
            return e
        errs = {kern["fwd"]: max(err(o, o_ref, False),
                                 err(lse, lse_ref, False)),
                kern["dq"]: err(leaves[0].grad, g_ref[0], True),
                kern["dkv"]: max(err(leaves[1].grad, g_ref[1], True),
                                 err(leaves[2].grad, g_ref[2], True))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in [o, lse] + [x.grad for x in leaves])
        for name, e in errs.items():
            fwd = name == kern["fwd"]
            tol = f_tol if fwd else g_tol
            ok = finite and e <= tol
            print(f"flash {name} {self.describe()}: err {e:.3e}"
                  f"{' (of max)' if not fwd and self.dtype == torch.bfloat16 else ''} "
                  f"tol {tol:.0e} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"flash {name} {self.describe()}: error {e} over {tol}")
        return errs

    def bound(self, role):
        """Least time (ms) and what sets it: the bytes of each input read
        once and each output written once over the memory rate, or the
        flops of the causal (or full) score pairs over the peak for the
        type; the larger of the two.  fwd: q k^T and P V (4 D flops a
        pair); dq: q k^T, dO v^T, dS k (6 D); dkv: q k^T, dO v^T, P^T dO,
        dS^T q (8 D).  The dq body writes delta, the dkv body reads it
        instead of o (K4 as K2 / K3)."""
        B, S, H, KVH_, D_ = self.shape
        el = self.q.element_size()
        pairs = B * H * (S * (S + 1) // 2 if self.causal else S * S)
        qb, kvb, rowb = B * S * H * D_ * el, B * S * KVH_ * D_ * el, B * H * S * 4
        flops, nbytes = {
            "fwd": (4 * D_ * pairs, 2 * qb + 2 * kvb + rowb),
            "dq": (6 * D_ * pairs, 4 * qb + 2 * kvb + 2 * rowb),
            "dkv": (8 * D_ * pairs, 2 * qb + 4 * kvb + 2 * rowb)}[role]
        peak = BF16_FLOPS if self.dtype == torch.bfloat16 else F32_FLOPS
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def times(self, timer):
        """Device ms of each kernel (by role), the plain forward and
        backward, and SDPA's forward and backward (the library yardstick,
        never called by the port), after checking SDPA agrees with the
        forward kernel."""
        from paddle_tpu_torch.ops import flash_attention as fa
        q, k, v, do, c, s, d = (self.q, self.k, self.v, self.do, self.causal,
                                self.scale, self.direct)
        fwd_ref, bwd_ref = self.refs()
        o, lse = fa._launch_fwd(q, k, v, c, s, d)
        _, delta = fa._launch_dq(q, k, v, o, lse, do, c, s, d)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=c, enable_gqa=True)
        lib_o = sdpa()
        lib_err = (lib_o.transpose(1, 2).float() - o.float()).abs().max()
        check(lib_err.item() <= FLASH_TOL[self.dtype][0],
              f"flash {self.tag}: SDPA disagrees with the forward kernel by "
              f"{lib_err.item()}")
        return {
            "fwd": timer.ms(lambda: fa._launch_fwd(q, k, v, c, s, d)),
            "dq": timer.ms(lambda: fa._launch_dq(q, k, v, o, lse, do, c, s,
                                                 d)),
            "dkv": timer.ms(lambda: fa._launch_dkv(q, k, v, o, lse, do, delta,
                                                   c, s, d)),
            "plain_fwd": timer.ms(lambda: fwd_ref(q, k, v, c), n=5),
            "plain_bwd": timer.ms(lambda: bwd_ref(q, k, v, o, lse, do, c),
                                  n=5),
            "library_fwd": timer.ms(sdpa),
            "library_bwd": timer.ms(lambda: torch.autograd.grad(
                lib_o, (qt, kt, vt), dot, retain_graph=True)),
        }


def flash_kernel_phase(dev, timer):
    """K1-K3 against their plain versions in every case of FLASH_CASES and
    K4 in every case of K4_CASES, then timed at the FLASH_TIMED shapes.
    Returns the six kernels' lines (launches filled in by the training
    phase)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, timed = {}, {}
    for direct, cases in ((False, FLASH_CASES), (True, K4_CASES)):
        for case in cases:
            c = FlashCase(*case, gen, dev, direct=direct)
            for kern, e in c.check().items():
                errs.setdefault((kern, c.dtype), []).append(e)
            if c.tag in FLASH_TIMED[direct]:
                timed[(direct, c.tag)] = (c.shape, c.bound, c.times(timer))
            del c
            torch.cuda.empty_cache()
    lines = []
    for name, kern, role, direct, replaces in FLASH_KERNELS:
        row = {}
        for tag in FLASH_TIMED[direct]:
            shape, bound, t = timed[(direct, tag)]
            fwd = role == "fwd"
            plain = t["plain_fwd" if fwd else "plain_bwd"]
            lib = t["library_fwd" if fwd else "library_bwd"]
            bound_ms, bound_by = bound(role)
            row[tag] = dict(ms=t[role], plain_ms=plain, library_ms=lib,
                            bound_ms=bound_ms, bound_by=bound_by)
            B, S, H, KVH_, D_ = shape
            print(f"{name} ({kern}) {tag} bf16 B={B} S={S} H={H} KVH={KVH_} "
                  f"D={D_} causal: kernel {t[role]:.4f} ms, plain {plain:.4f} "
                  f"ms{'' if fwd else ' (dq + dk/dv together)'}, "
                  f"library {lib:.4f} ms "
                  f"({'SDPA forward' if fwd else 'SDPA backward, dq + dk/dv together'}), "
                  f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        g = row.pop("gpt2")
        fwd = role == "fwd"
        plain = ("bshd_fwd_ref" if direct else "flash_fwd_ref") if fwd else (
            f"{'bshd' if direct else 'flash'}_bwd_ref (dq, dk, dv together)")
        lines.append({
            "name": name, "kernel": kern, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(errs[(kern, torch.bfloat16)]),
            "tolerance": FLASH_TOL[torch.bfloat16][not fwd],
            "max_abs_err_f32": max(errs[(kern, torch.float32)]),
            "tolerance_f32": FLASH_TOL[torch.float32][not fwd],
            "error_of": ("o and lse, absolute" if fwd else
                         "gradients; bf16 relative to the largest reference "
                         "magnitude, f32 absolute"),
            "ms": g["ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": g["library_ms"],
            "library": ("SDPA forward" if fwd else
                        "SDPA backward (dq, dk, dv together)"),
            "plain": plain,
            "shape": "GPT-2 bench: bf16 B=16 S=1024 H=12 D=64 causal",
            **row,
        })
    return lines


WIDE_HEAD_DIMS = (320, 384, 512)


def head_dim_phase(dev):
    """Head dims above 256 run on the card through ``flash_attention_bshd``
    as in the reference: at 320, 384 and 512 a forward and backward launch
    K1, K2 and K3 once each (and, with ``FLAGS_flash_layout_direct`` and
    MHA, K4's three bodies once each), held against their plain versions
    (``FlashCase.check``); 576 also passes ``supported()``, but the kernels
    stop at 512, so the card's tensors are refused there, with no launch,
    and never run some other way."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for d in WIDE_HEAD_DIMS:
        for direct, kvh in ((False, 2), (True, 4)):
            FlashCase(f"d{d}", 1, 256, 4, kvh, d, True, torch.bfloat16, gen,
                      dev, direct=direct).check()
    q = torch.zeros(1, 128, 2, 576, dtype=torch.bfloat16, device=dev)
    check(fa.supported(q.shape, q.shape), "supported() refuses head_dim 576")
    before = launch_counts()
    try:
        fa.flash_attention_bshd(q, q, q)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and launch_counts() == before,
          "flash_attention_bshd at head_dim 576 was not refused on the card")
    print(f"flash head_dim {', '.join(map(str, WIDE_HEAD_DIMS))} on the "
          f"card: K1, K2, K3 and K4's bodies launched once each a call and "
          f"held to their plain versions; head_dim 576: refused ({refused})",
          flush=True)


# ---------------------------------------------------------- phase 3: engine
def teacher_forced_check(model, prompt, out, gap, dev, kv_int8=False):
    """Engine tokens against the dense reference fed the prompt and the
    engine's own tokens: at every position the reference must score the
    engine's token within ``gap`` of its best, so where the reference's
    top-1/top-2 gap exceeds ``gap`` the engine must have picked its argmax.
    Returns counts: positions whose reference top-1/top-2 gap is at most
    ``gap`` (where either choice is allowed), engine tokens that are not the
    reference's argmax, engine tokens outside the reference's top 2; and
    the largest shortfall below the reference's best."""
    ids = torch.as_tensor(np.concatenate([prompt, out[:-1]]),
                          device=dev)[None].long()
    logits = model.forward_ref(ids, kv_int8=kv_int8)[0, len(prompt) - 1:]
    check(bool(torch.isfinite(logits).all()), "reference logits not finite")
    top2 = logits.topk(2, dim=-1)
    best, arg = top2.values[:, 0], top2.indices[:, 0]
    mine = logits.gather(1, torch.as_tensor(out, device=dev)[:, None].long())
    short = (best - mine[:, 0]).tolist()
    for j, (tok, sh) in enumerate(zip(out, short)):
        check(sh <= gap, f"token {j}: engine {tok} scores {sh:.4f} below the "
              f"reference's argmax {arg[j].item()} (allowed {gap})")
    close = int(((top2.values[:, 0] - top2.values[:, 1]) <= gap).sum())
    flips = sum(1 for tok, a in zip(out, arg.tolist()) if tok != a)
    past2 = sum(1 for tok, two in zip(out, top2.indices.tolist())
                if tok not in two)
    return np.array([close, flips, past2]), max(short)


# The tiny float32 engines: LlamaConfig.tiny() overrides (hidden, q heads,
# kv heads, FFN) for head_dim 128, 16 (LlamaConfig.tiny() itself, the
# engine tests' width) and 64
TINY_ENGINES = ((256, 2, 1, 512), (64, 4, 2, 128), (256, 4, 2, 512))


def tiny_f32_engine(dev, hidden=256, heads=2, kv_heads=1, ffn=512):
    """A 2-layer float32 Llama from seeded numpy weights, bridged through
    llama_from_numpy, served on the card and checked token by token; then
    the same requests with int8 pages, speculative decoding, both, and the
    model as its own draft model, each token-identical to the plain engine
    of its KV dtype."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SpecConfig
    from paddle_tpu_torch.models.convert import llama_from_numpy
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=hidden, num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           intermediate_size=ffn)
    d = hidden // heads
    rng = np.random.RandomState(SEED)
    state = {}
    shapes = _jax_shapes(LlamaForCausalLM(cfg, device="cpu"))
    for name, shape in shapes.items():
        state[name] = (1.0 + 0.1 * rng.randn(*shape) if name.endswith(
            "norm.weight") else 0.08 * rng.randn(*shape)).astype(np.float32)
    model = llama_from_numpy(state, cfg, device=dev)
    pattern = list(rng.randint(0, cfg.vocab_size, 6))
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 16, 21)]
    prompts.append(np.asarray(pattern * 3))      # something to draft from

    def serve(kernels, **kw):
        """Serve the prompts; check that the kernels named (and no other
        paged kernel) launched on the card."""
        eng = LLMEngine(model, device=dev, max_batch=2, max_len=64,
                        page_size=8, prefill_chunk=8, **kw)
        before = launch_counts()
        rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        eng.run_until_done()
        after = launch_counts()
        ran = {k for k in ("K5", "K6", "K7", "K7q") if after[k] > before[k]}
        check(ran == set(kernels), f"tiny f32 D={d} {kw}: launched "
              f"{sorted(ran)}, expected {kernels}")
        return eng, rids, [list(eng.result(r)) for r in rids]

    eng, rids, base = serve(["K5"])
    counts, worst = check_all(model, prompts, eng, rids, F32_GAP, dev)
    print(f"engine tiny f32 D={d} (llama_from_numpy, hidden {hidden}, "
          f"{heads}q/{kv_heads}kv heads): {len(rids)} requests "
          f"token-checked: {describe(counts, worst, F32_GAP)}", flush=True)
    eng, rids, base8 = serve(["K6"], kv_cache_dtype="int8")
    counts, worst = check_all(model, prompts, eng, rids, F32_GAP, dev,
                              kv_int8=True)
    print(f"engine tiny f32 D={d} int8 pages: {len(rids)} requests "
          f"token-checked against the int8 dense reference: "
          f"{describe(counts, worst, F32_GAP)}", flush=True)
    for tag, kernels, kw, want in (
            ("spec", ["K5", "K7"],
             dict(spec_decode=SpecConfig(max_draft=MAX_DRAFT)), base),
            ("int8 + spec", ["K6", "K7q"],
             dict(kv_cache_dtype="int8",
                  spec_decode=SpecConfig(max_draft=MAX_DRAFT)), base8),
            ("self-draft", ["K5", "K7"], dict(spec_decode=SpecConfig(
                max_draft=3, draft_model=model)), base)):
        eng, _, got = serve(kernels, **kw)
        st = eng.spec_stats()
        check(got == want, f"tiny f32 D={d} {tag}: tokens differ from the "
              f"engine without speculation")
        check(st["verify_dispatches"] > 0,
              f"tiny f32 D={d} {tag}: no verify step")
        print(f"engine tiny f32 D={d} {tag}: token-identical to spec off; "
              f"{st['proposed']} drafts proposed, acceptance "
              f"{st['acceptance_rate']:.3f}, {st['tokens_per_step']:.2f} "
              f"tokens per verify step", flush=True)
        if tag == "self-draft":
            check(st["acceptance_rate"] == 1.0,
                  f"self-draft acceptance {st['acceptance_rate']} != 1")


def check_all(model, prompts, eng, rids, gap, dev, kv_int8=False):
    counts, worst = np.zeros(3, int), 0.0
    for p, rid in zip(prompts, rids):
        c, w = teacher_forced_check(model, p, list(eng.result(rid)), gap, dev,
                                    kv_int8)
        counts, worst = counts + c, max(worst, w)
    return counts, worst


def describe(counts, worst, gap):
    close, flips, past2 = counts.tolist()
    return (f"{close} positions with the reference's top-1/top-2 gap under "
            f"{gap}, {flips} tokens off the reference's argmax ({past2} "
            f"outside its top 2), largest shortfall {worst:.4f} (allowed "
            f"{gap})")


def _jax_shapes(model):
    """``model``'s parameter names and shapes as the JAX package stores
    them: Linear weights [in, out], the transpose of torch's."""
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return {n: tuple(p.shape)[::-1] if n in linear else tuple(p.shape)
            for n, p in model.named_parameters()}


def full_width_model(dtype, dev):
    """Llama-3-8B at full width and depth with random weights drawn from a
    seeded generator on the card."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=dtype, generator=gen)
    torch.cuda.synchronize()
    print(f"model {str(dtype)[6:]}: Llama-3-8B width (vocab "
          f"{cfg.vocab_size}, hidden {cfg.hidden_size}, "
          f"{cfg.num_hidden_layers} layers, {cfg.num_attention_heads}q/"
          f"{cfg.num_key_value_heads}kv heads, ffn {cfg.intermediate_size}) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    return model


def serve_full_width(model, tag, gap, dev, profile=False, spec=False,
                     kv_cache_dtype="auto"):
    """Serve the 8 requests at Llama-3-8B width through add_request / step
    / stream, with every kernel's launch count set to 0 just before and
    read just after; check every request and token.  ``spec``: with
    speculative decoding, max_draft 4, the model drafting for itself
    through ``generate`` (see :func:`engine_phase` for why not n-gram
    drafts).  With ``profile``, then profile the same engine
    (:func:`profile_engine`, or :func:`profile_verify` with ``spec``).  The
    engine is freed before returning."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.serving import (LLMEngine, RequestStatus,
                                                    SpecConfig)
    cfg = model.config
    eng = LLMEngine(model, device=dev, max_batch=8, max_len=1024,
                    page_size=PAGE, prefill_chunk=32,
                    kv_cache_dtype=kv_cache_dtype,
                    spec_decode=(SpecConfig(max_draft=MAX_DRAFT,
                                            draft_model=model) if spec
                                 else None))
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    steps = []            # (seconds, kind, tokens emitted)
    step = eng.step

    def timed_step():
        pf, vf = eng.prefill_dispatches, eng.spec_dispatches
        emitted = eng.spec_emitted
        a = time.perf_counter()
        served = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - a
        if eng.prefill_dispatches != pf:
            steps.append((dt, "prefill", 0))
        elif eng.spec_dispatches != vf:
            steps.append((dt, "verify", eng.spec_emitted - emitted))
        else:
            steps.append((dt, "decode", served))
        return served

    eng.step = timed_step
    drafting = []                  # seconds in the proposer, per call
    if spec:
        propose = eng._proposer.propose

        def timed_propose(tokens, k):
            a = time.perf_counter()
            out = propose(tokens, k)
            torch.cuda.synchronize()
            drafting.append(time.perf_counter() - a)
            return out

        eng._proposer.propose = timed_propose
    torch.cuda.reset_peak_memory_stats()
    obs.enable()
    try:
        reset_launch_counts()
        t_start = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        streamed = list(eng.stream(rids[0]))
        while any(not eng.status(r).terminal for r in rids):
            eng.step()
        wall = time.perf_counter() - t_start
        launches = launch_counts()
        snap = eng.metrics()
    finally:
        obs.disable()

    def dispatches(kind):
        return int(sum(s["value"] for s in
                       snap["serving_dispatches_total"]["series"]
                       if s["labels"].get("kind") == kind))

    n_prefill, n_decode = dispatches("prefill"), dispatches("decode")
    n_verify = dispatches("verify")
    L = cfg.num_hidden_layers
    quant = kv_cache_dtype == "int8"
    single, multi = ("K6", "K7q") if quant else ("K5", "K7")
    check(n_prefill == eng.prefill_dispatches,
          f"prefill dispatch count {n_prefill} != "
          f"{eng.prefill_dispatches}")
    check(n_verify == eng.spec_dispatches,
          f"verify dispatch count {n_verify} != {eng.spec_dispatches}")
    # decode_block 1: one forward a dispatch
    expected = {k: 0 for k in launches}
    expected[single] = L * (n_prefill + n_decode)
    expected[multi] = L * n_verify
    print(f"engine {tag}: {n_prefill} prefill + {n_decode} decode + "
          f"{n_verify} verify dispatches, launches {launches} (expected "
          f"{expected})", flush=True)
    check(launches == expected, f"launches {launches} != {expected}")
    check(launches[single] > 0, f"the main path never launched {single}")
    if spec:
        st = eng.spec_stats()
        check(st["proposed"] > 0 and st["verify_dispatches"] > 0,
              f"engine {tag}: nothing was drafted and verified ({st})")
        check(launches[multi] > 0, f"the main path never launched {multi}")
        print(f"engine {tag}: {st['proposed']} drafts proposed, "
              f"{st['accepted']} accepted (acceptance "
              f"{st['acceptance_rate']:.3f}), {st['tokens_per_step']:.2f} "
              f"tokens per verify step over all slots; drafting took "
              f"{sum(drafting):.2f} s in {len(drafting)} generate calls",
              flush=True)
    for rid in rids:
        check(eng.status(rid) == RequestStatus.FINISHED,
              f"request {rid} ended {eng.status(rid)}")
        check(len(eng.result(rid)) == NEW_TOKENS,
              f"request {rid} has {len(eng.result(rid))} tokens")
    check(streamed == list(eng.result(rids[0])),
          "streamed tokens differ from the result")

    counts, worst = check_all(model, prompts, eng, rids, gap, dev, quant)
    print(f"engine {tag}: all {len(rids)} requests FINISHED with "
          f"{NEW_TOKENS} tokens; teacher-forced check of "
          f"{NEW_TOKENS * len(rids)} tokens"
          f"{' (int8 dense reference)' if quant else ''} passed: "
          f"{describe(counts, worst, gap)}", flush=True)

    def rate(kind):
        secs = sum(s for s, k, _ in steps if k == kind)
        toks = sum(n for _, k, n in steps if k == kind)
        return (toks / secs if secs else None), secs, sum(
            1 for _, k, _ in steps if k == kind)

    ttft = sorted(eng.ttft(r) for r in rids)
    window = None
    if profile:
        eng.step = step
        if spec:
            eng._proposer.propose = propose
            window = profile_verify(eng, prompts, tag)
        else:
            window = profile_engine(eng, prompts, tag)
    res = {
        "ttft_p50_s": float(np.median(ttft)),
        "ttft_max_s": ttft[-1],
        "decode_tok_s": rate("decode")[0],
        "decode_step_ms": (1e3 * rate("decode")[1] / rate("decode")[2]
                           if rate("decode")[2] else None),
        "verify_tok_s": rate("verify")[0],
        "verify_step_ms": (1e3 * rate("verify")[1] / rate("verify")[2]
                           if rate("verify")[2] else None),
        # a verify step's time without its drafting (the proposer runs
        # inside the step)
        "verify_only_ms": (1e3 * (rate("verify")[1] - sum(drafting))
                           / rate("verify")[2] if rate("verify")[2]
                           else None),
        "draft_s": sum(drafting),
        "prefill_tok_s": sum(PROMPT_LENS) / rate("prefill")[1],
        "wall_s": wall,
        "dispatches": {"prefill": n_prefill, "decode": n_decode,
                       "verify": n_verify},
        "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "argmax_flips": int(counts[1]),
        "worst_shortfall": worst,
        "window": window,
    }
    # the timing wrappers tie the engine into reference cycles: collect
    # them, or the next engine's peak memory counts this one's buffers
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def profile_window(eng, tag, kind, n_steps, cpu=True):
    """``n_steps`` engine steps under ``torch.profiler``: prints the wall
    time, the device's busy share (kernel time over wall, which the
    profiler's own host cost lowers) and the kernels that take the most
    device time; returns (wall ms, busy ms, [(kernel, count, ms)]).
    ``cpu=False`` traces the device alone (no host ops to record and sort:
    far cheaper for steps that run many small ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pf0 = eng.prefill_dispatches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: the CPU ops that launched them carry the same time
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(ms for _, _, ms in rows)
    print(f"profile {tag} {kind}: {n_steps} steps "
          f"({eng.prefill_dispatches - pf0} prefill dispatches) in "
          f"{wall * 1e3:.1f} ms (profiled), device busy {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}%)", flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"profile {tag} {kind}:   {ms:9.3f} ms "
              f"{100 * ms / busy:5.1f}%  x{count:<5d} {key[:90]}")
    return wall * 1e3, busy, rows


def profile_engine(eng, prompts, tag, n_steps=8):
    """Where a step's time goes: the prompts served again, with
    ``profile_window`` over their first ``n_steps`` prefill chunks and over
    ``n_steps`` decode steps at full batch.  Returns the decode window's
    wall ms, device busy ms and K5 / K6's device ms (their split and
    combine kernels: a decode step launches no other paged kernel)."""
    rids = [eng.add_request(p, max_new_tokens=2 * n_steps) for p in prompts]
    profile_window(eng, tag, "prefill", n_steps)
    while any(not eng._lookup(r).out for r in rids):   # until all decode
        eng.step()
    batch = sum(not eng.status(r).terminal for r in rids)
    wall, busy, rows = profile_window(eng, tag, "decode", n_steps)
    k5 = sum(ms for key, _, ms in rows
             if any(m in key for m in SPLIT_KERNELS))
    print(f"profile {tag} decode: K5 {k5:.3f} ms of device busy "
          f"{busy:.1f} ms ({100 * k5 / busy:.2f}%)", flush=True)
    check(k5 > 0, f"profile {tag}: the decode window ran no K5")
    eng.run_until_done()
    return {"wall_ms": wall, "busy_ms": busy, "kernel_ms": k5,
            "steps": n_steps, "batch": batch}


def profile_verify(eng, prompts, tag, n_steps=2):
    """The speculative engine's verify steps: the prompts served again,
    each for as many tokens as its first plus ``n_steps`` verify steps
    emit at most (so the batch stays full), until every request decodes;
    then ``profile_window`` over ``n_steps`` steps at full batch (each
    drafts with the model and verifies in one forward), tracing the device
    alone; the requests are left unfinished and go with the engine.
    Returns the window's wall ms, device busy ms, K7 / K7q's device ms
    (their split and combine kernels: the window's steps verify, and a
    verify step launches no other paged kernel), verify dispatches, the
    batch and the seconds the whole re-serve took."""
    t0 = time.perf_counter()
    tokens = 1 + n_steps * (MAX_DRAFT + 1)
    rids = [eng.add_request(p, max_new_tokens=tokens) for p in prompts]
    while any(not eng._lookup(r).out for r in rids):
        eng.step()
    batch = sum(not eng.status(r).terminal for r in rids)
    v0 = eng.spec_dispatches
    wall, busy, rows = profile_window(eng, tag, "verify", n_steps,
                                      cpu=False)
    k7 = sum(ms for key, _, ms in rows
             if any(m in key for m in SPLIT_KERNELS))
    verify = eng.spec_dispatches - v0
    secs = time.perf_counter() - t0
    print(f"profile {tag} verify: batch {batch}, the re-serve and its "
          f"window took {secs:.1f} s", flush=True)
    check(verify > 0 and k7 > 0,
          f"profile {tag}: the window ran {verify} verify dispatches and "
          f"{k7} ms of K7")
    return {"wall_ms": wall, "busy_ms": busy, "kernel_ms": k7,
            "verify_dispatches": verify, "steps": n_steps, "batch": batch,
            "cost_s": secs}


def engine_line(tag, e2e, card):
    def f(x, spec):
        return "n/a" if x is None else format(x, spec)
    print(f"engine {tag}: ttft_p50 {e2e['ttft_p50_s']:.4f} s, ttft_max "
          f"{e2e['ttft_max_s']:.4f} s, decode "
          f"{f(e2e['decode_tok_s'], '.1f')} tok/s "
          f"({f(e2e['decode_step_ms'], '.2f')} ms a step), verify "
          f"{f(e2e['verify_tok_s'], '.1f')} tok/s "
          f"({f(e2e['verify_step_ms'], '.2f')} ms a step, "
          f"{f(e2e['verify_only_ms'], '.2f')} ms without drafting), prefill "
          f"{e2e['prefill_tok_s']:.1f} tok/s, wall {e2e['wall_s']:.2f} s, "
          f"peak memory {e2e['peak_mem_gib']:.1f} GiB, batch 8, on {card}",
          flush=True)


def engine_phase(dev, card):
    """The float32 checks first (tiny bridged model with every option, then
    full width, both held to the dense reference almost exactly); then the
    bfloat16 engines at full width on one model: the default path (K5,
    profiled: a decode window, device busy and K5's share), speculative
    decoding (K5 + K7, a window of its verify steps
    profiled), and int8 pages with speculative decoding (K6 + K7q).
    Returns each kernel's launches on the run of its path, and the verify
    window."""
    for kw in TINY_ENGINES:
        tiny_f32_engine(dev, *kw)
    model = full_width_model(torch.float32, dev)
    engine_line("f32", serve_full_width(model, "f32", F32_GAP, dev), card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = full_width_model(torch.bfloat16, dev)
    # The spec engines draft with the model itself (greedy ``generate``),
    # not with n-grams: the n-gram proposer drafts only when a request's
    # newest token already occurs in its history, and at this width random
    # weights emit tokens that do not recur (on the H100, 256 distinct
    # tokens out of the bf16 engine's 256, and one verify step in a whole
    # n-gram run), so n-gram drafts would leave K7 / K7q to chance.
    runs = {}
    for tag, kw in (("bf16", dict(profile=True)),
                    ("bf16 spec", dict(spec=True, profile=True)),
                    ("bf16 int8 spec", dict(spec=True,
                                            kv_cache_dtype="int8"))):
        runs[tag] = serve_full_width(model, tag, GAP, dev, **kw)
        engine_line(tag, runs[tag], card)
    launches = {"K5": runs["bf16"]["launches"]["K5"],
                "K7": runs["bf16 spec"]["launches"]["K7"],
                "K6": runs["bf16 int8 spec"]["launches"]["K6"],
                "K7q": runs["bf16 int8 spec"]["launches"]["K7q"]}
    return launches, {"decode": runs["bf16"]["window"],
                      "verify": runs["bf16 spec"]["window"]}


# -------------------------------------------------------- phase 4: training
TRAIN_TIMED = 6          # timed steps after the checked first one
TRAIN_TIMED_DIRECT = 3   # the same, on the layout-direct (K4) path
TINY_LR = 1e-3
# bf16 agreement of the flash path with the same model on the dense
# reference attention: the first loss within 2e-2 (absolute); the Llama
# logits and each checked gradient within 5e-2 of their largest element.
# The kernels round P and dS to bf16 as the TPU kernels do, where the dense
# path keeps float32, and every bf16 op downstream then rounds differently;
# dQ is a sum whose terms cancel (each row of dS sums to zero), so its
# relative error exceeds bf16's 2**-8.  On the H100 the first run measured
# 1.0-1.9 % of the largest element for the gradients and 1.5 % for the
# logits, where 2e-2 left too thin a margin.
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 5e-2


def gpt2_bench_config():
    """GPT-2 124M as ``bench.py`` trains it on the chip: dropout off, the
    loss in one chunk of B * S = 16384 tokens, not recomputed, bf16 logits
    (``_tune_loss_cfg`` at B16 S1024)."""
    from paddle_tpu_torch.models.gpt2 import GPT2Config
    return GPT2Config.gpt2_small(
        hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
        loss_chunk_size=16384, loss_recompute=False,
        loss_logits_dtype="bfloat16"), 16, 1024


def llama_bench_config():
    """``bench.py`` ``_llama_child``'s Llama-3-shaped geometry: head_dim 128,
    GQA 4:1, SwiGLU, tied vocab, 4 layers, B8 S1024."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=7168, num_hidden_layers=4,
                       num_attention_heads=16, num_key_value_heads=4,
                       max_position_embeddings=1024,
                       tie_word_embeddings=True), 8, 1024


@contextlib.contextmanager
def dense_attention():
    """The models attend through the reference's dense path (``_sdpa_ref``,
    float32 softmax) instead of the flash kernels: the same model, the
    check the flash path is held against."""
    from paddle_tpu_torch.models import gpt2, llama
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    saved = gpt2.scaled_dot_product_attention, llama.flash_attention
    gpt2.scaled_dot_product_attention = (
        lambda q, k, v, is_causal=False, **kw: _sdpa_ref(q, k, v,
                                                          causal=is_causal))
    llama.flash_attention = (
        lambda q, k, v, causal=False, **kw: (_sdpa_ref(q, k, v,
                                                       causal=causal), None))
    try:
        yield
    finally:
        gpt2.scaled_dot_product_attention, llama.flash_attention = saved


def train_step(model, opt, x, y):
    _, loss = model(x, labels=y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def tiny_f32_training(dev):
    """A 2-layer float32 GPT-2 (head_dim 64, S 128) bridged from seeded
    numpy weights takes two AdamW + ClipGradByGlobalNorm(1.0) steps on the
    card (K1-K3) and on the CPU (their plain versions).  Tolerances, those
    of the CPU test against JAX (sums in other orders): the loss at 2e-5
    relative, every gradient at 5e-4, parameters at rtol 2e-4 / atol 1e-5,
    or within 2 lr where a gradient element was ever under 1e-4 of its
    tensor's largest (Adam's first update is about lr * sign(g))."""
    from paddle_tpu_torch.models.convert import gpt2_from_numpy
    from paddle_tpu_torch.models.gpt2 import GPT2Config, GPT2ForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPT2Config(vocab_size=256, hidden_size=128, num_layers=2,
                     num_heads=2, max_position_embeddings=128,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    rng = np.random.RandomState(SEED)
    state = {}
    shapes = _jax_shapes(GPT2ForCausalLM(cfg, device="cpu"))
    for name, shape in shapes.items():
        if ".ln" in name and name.endswith("weight"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith("bias"):
            a = 0.02 * rng.randn(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        state[name] = a.astype(np.float32)
    ids = rng.randint(0, cfg.vocab_size, (2, 129))
    runs = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = gpt2_from_numpy(state, cfg, device=d)
        opt = AdamW(learning_rate=TINY_LR, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
        x = torch.as_tensor(ids[:, :-1], device=d)
        y = torch.as_tensor(ids[:, 1:], device=d)
        runs[where] = (model, opt, x, y)
    small = {n: None for n, _ in runs["cpu"][0].named_parameters()}
    reset_launch_counts()
    for step in range(2):
        out = {}
        for d, (model, opt, x, y) in runs.items():
            _, loss = model(x, labels=y)
            loss.backward()
            out[d] = (loss.item(), {n: p.grad.detach().cpu().clone()
                                    for n, p in model.named_parameters()})
        (lc, gc_), (lg, gg) = out["cpu"], out["card"]
        check(abs(lg - lc) <= 2e-5 * abs(lc),
              f"tiny f32 step {step}: loss {lg} on the card, {lc} on the CPU")
        worst_g = max((gg[n] - gc_[n]).abs().max().item() for n in gc_)
        check(worst_g <= 5e-4, f"tiny f32 step {step}: gradient error "
              f"{worst_g} over 5e-4")
        for n, g in gc_.items():
            s = g.abs() < 1e-4 * g.abs().max()
            small[n] = s if small[n] is None else small[n] | s
        for model, opt, _, _ in runs.values():
            opt.step()
            opt.clear_grad()
        worst_p = 0.0
        params = dict(runs["card"][0].named_parameters())
        for n, pc in runs["cpu"][0].named_parameters():
            pg = params[n].detach().cpu()
            diff = (pg - pc.detach()).abs()
            ok = (diff <= 1e-5 + 2e-4 * pc.detach().abs()) | (
                small[n] & (diff <= 2 * TINY_LR))
            check(bool(ok.all()), f"tiny f32 step {step}: parameter {n} off "
                  f"by {diff.max().item()}")
            worst_p = max(worst_p, diff.max().item())
        print(f"train tiny f32 (gpt2_from_numpy, 2 layers, D=64, S=128, "
              f"B=2) step {step}: loss card {lg:.6f} cpu {lc:.6f}, largest "
              f"gradient error {worst_g:.2e} (tol 5e-4), largest parameter "
              f"difference {worst_p:.2e} after AdamW", flush=True)
    launches = launch_counts()
    want = {"K1": 4, "K2": 4, "K3": 4}          # 2 layers x 2 steps
    check({k: launches[k] for k in want} == want,
          f"tiny f32: launches {launches}, expected {want}")


def new_adamw(model):
    """``bench.py``'s optimizer: AdamW(3e-4, weight decay 0.01) with
    ClipGradByGlobalNorm(1.0)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=3e-4, weight_decay=0.01,
                 parameters=model.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))


def reference_run(model, x, y, steps, names, dense=True):
    """``steps`` AdamW steps of the model through the dense reference
    attention (``dense``) or through the default flash path (K1-K3,
    FLAGS_flash_layout_direct off), from its current weights, which are put
    back afterwards.  Returns the losses and the first step's gradients of
    ``names``.  Only the first step is held to a tolerance: bf16 runs drift
    apart step by step, so the later losses are printed beside the checked
    run's."""
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = new_adamw(model)
    params = dict(model.named_parameters())
    losses = []
    reset_launch_counts()
    with dense_attention() if dense else layout_direct(False):
        for _ in range(steps):
            _, loss = model(x, labels=y)
            loss.backward()
            if not losses:
                grads = {n: params[n].grad.float().clone() for n in names}
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
    launched = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    path = () if dense else ("K1", "K2", "K3")
    check(all((launched[k] > 0) == (k in path) for k in FLASH_COUNTERS),
          f"the {'dense' if dense else 'default flash'} reference launched "
          f"{launched}")
    model.load_state_dict(saved)
    del opt, saved
    gc.collect()
    torch.cuda.empty_cache()
    return losses, grads


def profile_step(model, opt, x, y, tag, kernels=("K1", "K2", "K3")):
    """One more step under torch.profiler: the device's busy share (kernel
    time over the profiled wall) and the kernels that take the most device
    time, with the flash kernels' share (``kernels``: the forward, dq and
    dk / dv bodies the path runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, x, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(ms for _, _, ms in rows)
    share = {k: sum(ms for key, _, ms in rows if pat in key)
             for k, pat in zip(kernels, ("fwd_bf16", "dq_bf16", "dkv_bf16"))}
    pct = (lambda ms: 100 * ms / busy) if busy else (lambda ms: 0.0)
    print(f"profile train {tag}: 1 step in {wall:.1f} ms (profiled), device "
          f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%); "
          + ", ".join(f"{k} {ms:.2f} ms ({pct(ms):.1f}%)"
                      for k, ms in share.items()), flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
        print(f"profile train {tag}:   {ms:9.3f} ms {pct(ms):5.1f}%  "
              f"x{count:<5d} {key[:90]}")


def train_bench(tag, model, batch, seq, layers, hidden, checked, card,
                direct=False, timed=TRAIN_TIMED):
    """The main path: a checked first step, then ``timed`` timed steps, on
    one repeated batch of random token ids (``np.random.RandomState(0)``,
    as ``bench.py``), with every launch count set to 0 just before and read
    just after; then one profiled step.  The default path (K1-K3) is held
    to the model with dense attention; with ``direct``, the whole run has
    FLAGS_flash_layout_direct set (K4) and is held to the default path from
    the same weights and batch.  Returns the launches."""
    vocab = model.config.vocab_size
    ids = np.random.RandomState(0).randint(0, vocab, (batch, seq + 1))
    dev = model.device
    x = torch.as_tensor(ids[:, :-1], device=dev)
    y = torch.as_tensor(ids[:, 1:], device=dev)
    ref_name = "the default path (K1-K3)" if direct else "dense attention"
    ref_losses, ref_grads = reference_run(
        model, x, y, 1 if direct else 1 + timed, checked, dense=not direct)
    ref_loss = ref_losses[0]
    kernels = ("K4-fwd", "K4-dq", "K4-dkv") if direct else ("K1", "K2", "K3")
    opt = new_adamw(model)
    with layout_direct(direct):
        torch.cuda.synchronize()
        reset_launch_counts()
        _, loss = model(x, labels=y)
        loss.backward()
        params = dict(model.named_parameters())
        first = loss.item()
        check(abs(first - ref_loss) <= TRAIN_LOSS_TOL,
              f"train {tag}: first loss {first} vs {ref_name} {ref_loss}")
        for n, g in ref_grads.items():
            got = params[n].grad.float()
            err = (got - g).abs().max().item() / g.abs().max().item()
            rel = ((got - g).norm() / g.norm()).item()
            check(bool(torch.isfinite(got).all()) and err <= TRAIN_GRAD_TOL,
                  f"train {tag}: gradient of {n} off by {err} of its largest")
            print(f"train {tag}: {n} gradient vs {ref_name}: largest error "
                  f"{err:.3e} of the largest element (tol {TRAIN_GRAD_TOL}), "
                  f"relative norm error {rel:.3e}", flush=True)
        opt.step()
        opt.clear_grad()
        losses, times = [first], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(train_step(model, opt, x, y).item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = 1 + timed
        want = {k: layers * steps if k in kernels else 0
                for k in FLASH_COUNTERS}
        got = {k: launches[k] for k in FLASH_COUNTERS}
        print(f"train {tag}: losses {[round(v, 4) for v in losses]}; first "
              f"loss {first:.4f} vs {ref_name} {ref_loss:.4f} (tol "
              f"{TRAIN_LOSS_TOL}); flash launches {got} (expected {want}: "
              f"{layers} layers x {steps} forwards / backwards)", flush=True)
        if not direct:
            print(f"train {tag}: the same steps with dense attention: losses "
                  f"{[round(v, 4) for v in ref_losses]}", flush=True)
        check(all(np.isfinite(losses)), f"train {tag}: a loss is not finite")
        check(losses[-1] < losses[0], f"train {tag}: the loss did not fall "
              f"({losses[0]} -> {losses[-1]})")
        check(got == want, f"train {tag}: launches {got}, expected {want}")
        step_s = float(np.median(times))
        n_params = sum(p.numel() for p in model.parameters())
        flops_per_token = 6 * n_params + 12 * layers * hidden * seq
        tok_s = batch * seq / step_s
        print(f"train {tag}: median step {step_s * 1e3:.2f} ms over "
              f"{timed} steps, {tok_s:.0f} tokens/s, MFU "
              f"{tok_s * flops_per_token / BF16_FLOPS:.4f} ({n_params} "
              f"parameters, {flops_per_token} flops a token, vs 989 TFLOP/s "
              f"bf16 dense), peak memory {peak:.2f} GiB, batch {batch} x "
              f"{seq}, on {card}", flush=True)
        profile_step(model, opt, x, y, tag, kernels)
    return launches


def training_phase(dev, card):
    """Tiny f32 agreement, then GPT-2 124M in bf16 on the default path and
    with FLAGS_flash_layout_direct, and the Llama-3-shaped model in bf16
    (each model freed before the next).  Returns K1-K3's launches on the
    default GPT-2 run and K4's on the layout-direct one."""
    from paddle_tpu_torch.models.gpt2 import GPT2ForCausalLM
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    # the serving models die with the engines' reference cycles: collect
    # them, or the training peaks count their weights
    gc.collect()
    torch.cuda.empty_cache()
    tiny_f32_training(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg, batch, seq = gpt2_bench_config()
    model = GPT2ForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                            generator=gen)
    gpt2 = train_bench("gpt2-124m bf16", model, batch, seq, cfg.num_layers,
                       cfg.hidden_size, ["gpt2.blocks.0.attn.qkv.weight",
                                         "gpt2.blocks.0.attn.proj.weight"],
                       card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # K4's path: the same model from the same seed, with
    # FLAGS_flash_layout_direct set, held to the default path
    model = GPT2ForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                            generator=torch.Generator(device=dev).manual_seed(
                                SEED))
    direct = train_bench("gpt2-124m bf16 layout-direct", model, batch, seq,
                         cfg.num_layers, cfg.hidden_size,
                         ["gpt2.blocks.0.attn.qkv.weight",
                          "gpt2.blocks.0.attn.proj.weight"], card,
                         direct=True, timed=TRAIN_TIMED_DIRECT)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq = llama_bench_config()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=gen)
    ids = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, seq)), device=dev)
    # the dense reference forward (float32 head) against the flash path's
    # logits, before any step
    with torch.no_grad():
        want = model.forward_ref(ids)
        got = model(ids).float()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    check(bool(torch.isfinite(got).all()) and err <= TRAIN_GRAD_TOL * top,
          f"train llama: forward logits off forward_ref by {err}")
    print(f"train llama: forward logits (bf16, flash path) vs forward_ref "
          f"(float32 head and softmax), B=2: largest error {err:.4f}, "
          f"{err / top:.3e} of the largest logit (tol {TRAIN_GRAD_TOL})",
          flush=True)
    del want, got
    train_bench("llama3-shaped bf16", model, batch, seq,
                cfg.num_hidden_layers, cfg.hidden_size,
                ["llama.layers.0.self_attn.q_proj.weight",
                 "llama.layers.0.self_attn.o_proj.weight"], card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {**{k: gpt2[k] for k in ("K1", "K2", "K3")},
            **{k: direct[k] for k in ("K4-fwd", "K4-dq", "K4-dkv")}}


# --------------------------------------------------- phase 5: weight-only
# Llama-3-8B's seven projections of a layer, (name, in_features K,
# out_features N), as weight_only_linear stores them: [K, N]
LLAMA_PROJ = [("q", 4096, 4096), ("k", 4096, 1024), ("v", 4096, 1024),
              ("o", 4096, 4096), ("gate", 4096, 14336), ("up", 4096, 14336),
              ("down", 14336, 4096)]
WO_LAYERS = 32
WO_M = 8                 # decode batch
WO_PASSES = 5            # timed passes, median
# K8 against quant_matmul_ref: bf16 at 2e-2 of the largest reference
# magnitude, the bar of tests/test_quantization.py's kernel test (both sum
# in f32; they differ by the order of the sum and one bf16 rounding of
# y); f32 at 1e-5 of it (full f32 on both sides, sums in other orders).
WO_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / want.float().abs().max().item())


def _timed(fn, n=WO_PASSES, kernels=None):
    """Times of ``fn``, a pass over distinct weights whose bytes exceed the
    50 MB L2 (so no flush is needed): ``wall``, the median of ``n``
    synchronised runs between CUDA events, host issue included; and
    ``device``, the median over three runs under torch.profiler of the
    device time of its kernels (those whose names contain one of
    ``kernels``, or all), which leaves out the host's launch gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    walls, devs = [], []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        devs.append(sum(
            e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and (kernels is None or any(k in e.key for k in kernels))))
    return {"wall": float(np.median(walls)), "device": float(np.median(devs))}


def _gemm_bound(shapes, wbytes_per_el, el=2):
    """Least time (ms) of GEMMs y [M, N] = x [M, K] @ W: each input read
    once (x, W at ``wbytes_per_el`` bytes a weight, the f32 scale) and y
    written once, over the memory rate, or 2 M K N flops over the bf16
    peak; the larger, and which."""
    nbytes = sum(WO_M * K * el + K * N * wbytes_per_el + 4 * N + WO_M * N * el
                 for K, N in shapes)
    flops = sum(2 * WO_M * K * N for K, N in shapes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def weight_only_phase(dev, card):
    """K8's path: Llama-3-8B's 224 projection weights (32 layers), drawn in
    bf16 from a seeded generator on the card one layer at a time and
    quantized through the port's ``weight_quantize`` to int8 and to int4;
    one decode step's worth of ``nn.quant.weight_only_linear`` at M = 8
    under ``no_grad``, in int8 and in int4, with the launch counts set to
    0 just before and read just after each pass; every output against
    ``quant_matmul_ref``.  Then M = 1 and 300, one f32 shape, a call that
    needs a gradient (the dequant formulation, no launch), and the memory
    a call allocates.  Times: the pass, the dequant formulation over the
    same pass, F.linear on dequantized bf16 weights, the library's int8
    call where it runs on CUDA, the plain twin, and K8 per projection
    shape.  Returns the kernels' lines and launches."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.nn import quant
    from paddle_tpu_torch.ops import quant_matmul as qm
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    weights = {"int8": [], "int4": []}    # [(K, N, qw, scale)] in pass order
    for _ in range(WO_LAYERS):
        for _, K, N in LLAMA_PROJ:
            w = torch.randn(K, N, generator=gen, device=dev,
                            dtype=torch.bfloat16) * 0.02
            for algo in ("int8", "int4"):
                q, s = quant.weight_quantize(w, algo=f"weight_only_{algo}")
                weights[algo].append((K, N, q, s))
            del w
    torch.cuda.synchronize()
    wbytes = {a: sum(q.numel() for _, _, q, _ in ws)
              for a, ws in weights.items()}
    print(f"weight-only: Llama-3-8B's {len(weights['int8'])} projection "
          f"weights ({WO_LAYERS} layers) drawn in bf16 and quantized in "
          f"{time.perf_counter() - t0:.1f} s: int8 {wbytes['int8'] / 1e9:.2f} "
          f"GB, int4 {wbytes['int4'] / 1e9:.2f} GB", flush=True)
    xs = {K: torch.randn(WO_M, K, generator=gen, device=dev).to(torch.bfloat16)
          for K in {K for _, K, _ in LLAMA_PROJ}}

    def run_pass(algo, out=None):
        for K, N, q, s in weights[algo]:
            y = quant.weight_only_linear(xs[K], q, weight_scale=s,
                                         weight_dtype=algo)
            if out is not None:
                out.append(y)

    lines, launches = [], {}
    for algo, kern in (("int8", "K8"), ("int4", "K8-int4")):
        int4 = algo == "int4"
        outs = []
        with torch.no_grad():
            reset_launch_counts()
            run_pass(algo, outs)
            got = launch_counts()
        torch.cuda.synchronize()
        launches[kern] = got[kern]
        want = {k: len(weights[algo]) if k == kern else 0 for k in COUNTERS}
        check(got == want, f"weight-only {algo} pass: launches {got}, "
              f"expected {want}")
        worst = 0.0
        for (K, N, q, s), y in zip(weights[algo], outs):
            e = _rel_err(y, qm.quant_matmul_ref(xs[K], q, s, int4=int4))
            check(bool(torch.isfinite(y).all()) and y.shape == (WO_M, N)
                  and e <= WO_TOL[torch.bfloat16],
                  f"weight-only {algo} {K}x{N}: error {e} of the largest")
            worst = max(worst, e)
        del outs
        errs = {f"bf16 M={WO_M} pass": worst}
        # M 1 and 300 at one shape, and one f32 shape
        K, N, q, s = weights[algo][0]
        for M, dt in ((1, torch.bfloat16), (300, torch.bfloat16),
                      (WO_M, torch.float32)):
            x = torch.randn(M, K, generator=gen, device=dev).to(dt)
            e = _rel_err(qm.quant_matmul(x, q, s, int4=int4),
                         qm.quant_matmul_ref(x, q, s, int4=int4))
            check(e <= WO_TOL[dt], f"weight-only {algo} M={M} {dt}: error "
                  f"{e} over {WO_TOL[dt]}")
            errs[f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M}"] = e
        print(f"weight-only {algo} ({kern}): {got[kern]} launches over "
              f"{len(weights[algo])} GEMMs; errors of the largest reference "
              f"magnitude " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol bf16 {WO_TOL[torch.bfloat16]:.0e}, f32 "
              f"{WO_TOL[torch.float32]:.0e})", flush=True)
        # a call that needs a gradient takes the dequant formulation
        xg = xs[K].clone().requires_grad_()
        before = launch_counts()
        y = quant.weight_only_linear(xg, q, weight_scale=s, weight_dtype=algo)
        w_deq = qm.unpack_int4(q) if int4 else q
        e = _rel_err(y, (xg @ w_deq.to(xg.dtype)) * s.to(xg.dtype))
        check(launch_counts() == before and y.requires_grad
              and e <= WO_TOL[torch.bfloat16],
              f"weight-only {algo}: a call needing a gradient launched K8 or "
              f"left the dequant formulation")
        # the largest weight: what a K8 call allocates beside its output
        K, N, q, s = max(weights[algo], key=lambda t: t[0] * t[1])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            y = quant.weight_only_linear(xs[K], q, weight_scale=s,
                                         weight_dtype=algo)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        check(rise < K * N * 2, f"weight-only {algo}: a {K}x{N} call "
              f"allocated {rise} bytes, as much as its bf16 weight")
        print(f"weight-only {algo}: a {K}x{N} K8 call allocated {rise} bytes "
              f"at its peak (its bf16 weight would need {K * N * 2}); a call "
              f"needing a gradient took the dequant formulation with no "
              f"launch", flush=True)
        del y, xg, w_deq

        # times: the pass and its alternatives, over the same distinct
        # weights (more bytes than the L2 holds)
        k8 = ("qmm", "reduce_splits")
        with torch.no_grad():
            t = _timed(lambda: run_pass(algo), kernels=k8)
            set_flags({"weight_only_use_kernel": False})
            try:
                dequant = _timed(lambda: run_pass(algo))
            finally:
                set_flags({"weight_only_use_kernel": True})
            plain = _timed(lambda: [
                qm.quant_matmul_ref(xs[K], q, s, int4=int4)
                for K, N, q, s in weights[algo]], n=3)
            per_shape = {}
            for name, K, N in LLAMA_PROJ:
                mine = [(q, s) for k_, n_, q, s in weights[algo]
                        if (k_, n_) == (K, N)]
                ts = _timed(lambda: [qm.quant_matmul(xs[K], q, s, int4=int4)
                                     for q, s in mine], kernels=k8)
                per_shape[f"{name} {K}x{N}"] = {
                    "ms": ts["device"] / len(mine),
                    "wall_ms": ts["wall"] / len(mine),
                    "bound_ms": _gemm_bound([(K, N)], 0.5 if int4 else 1)[0]}
        shapes = [(K, N) for K, N, _, _ in weights[algo]]
        bound_ms, bound_by = _gemm_bound(shapes, 0.5 if int4 else 1)
        lib, lib_note, lib_err = (_int4pack if int4 else _int8pack)(
            weights[algo], xs)
        lib_ms = None if lib is None else lib["device"]
        lines.append({
            "name": f"quant_matmul_{algo}", "kernel": kern, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:32",
            "launches": None,
            "max_abs_err": max(v for k, v in errs.items()
                               if k.startswith("bf16")),
            "tolerance": WO_TOL[torch.bfloat16],
            "max_abs_err_f32": errs[f"f32 M={WO_M}"],
            "tolerance_f32": WO_TOL[torch.float32],
            "error_of": "y, relative to the largest reference magnitude",
            "ms": t["device"], "plain_ms": plain["device"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": lib_note, "library_err": lib_err,
            "plain": "quant_matmul_ref over the same pass",
            "times_are": ("device time of the pass's kernels (torch.profiler); "
                          "*_wall_ms: the synchronised pass, host issue "
                          "included"),
            "wall_ms": t["wall"], "plain_wall_ms": plain["wall"],
            "library_wall_ms": None if lib is None else lib["wall"],
            "dequant_ms": dequant["device"], "dequant_wall_ms": dequant["wall"],
            "shape": (f"one decode step of Llama-3-8B's linear layers: "
                      f"{len(shapes)} GEMMs (32 layers x q, k, v, o, gate, "
                      f"up, down) at M={WO_M}, bf16 x, {algo} weights "
                      f"{wbytes[algo]} bytes"),
            "per_shape": per_shape,
        })
        print(f"weight-only {algo} ({kern}) pass of {len(shapes)} GEMMs at "
              f"M={WO_M}, device time (wall, host issue included): kernel "
              f"{t['device']:.4f} ms ({t['wall']:.4f}), bound {bound_ms:.4f} "
              f"ms ({bound_by}), dequant formulation {dequant['device']:.4f} "
              f"ms ({dequant['wall']:.4f}), plain {plain['device']:.4f} ms "
              f"({plain['wall']:.4f}), library "
              + ("n/a" if lib is None else
                 f"{lib['device']:.4f} ms ({lib['wall']:.4f}), error "
                 f"{lib_err:.2e} of the largest")
              + f" ({lib_note}); per projection, device (wall) a call: "
              + ", ".join(f"{k} {v['ms']:.4f} ({v['wall_ms']:.4f}) ms, bound "
                          f"{v['bound_ms']:.4f}" for k, v in per_shape.items())
              + f"; on {card}", flush=True)
        torch.cuda.empty_cache()

    # F.linear on the same weights dequantized to bf16 (14 GB), layer by
    # layer as the pass goes, timed over the whole pass
    with torch.no_grad():
        dense = [(K, quant.weight_dequantize(q, s, algo="weight_only_int8",
                                             out_dtype="bfloat16").t())
                 for K, N, q, s in weights["int8"]]
        lin = _timed(lambda: [torch.nn.functional.linear(xs[K], w)
                              for K, w in dense])
    del dense
    lin_bound = _gemm_bound([(K, N) for K, N, _, _ in weights["int8"]], 2)[0]
    print(f"weight-only: F.linear on the bf16-dequantized weights, the same "
          f"pass: device {lin['device']:.4f} ms (wall {lin['wall']:.4f}), "
          f"bound {lin_bound:.4f} ms (bytes)", flush=True)
    for line in lines:
        line["bf16_linear_ms"] = lin["device"]
        line["bf16_linear_wall_ms"] = lin["wall"]
        line["bf16_linear_bound_ms"] = lin_bound
    del weights, xs
    gc.collect()
    torch.cuda.empty_cache()
    return lines, launches


def _library_pass(name, weights, xs, pack, call, int4):
    """Times one PyTorch call that computes K8's function over the same
    pass: ``pack`` repacks each (K, N, qw, scale) once, outside the timing,
    and ``call(x, packed)`` computes y.  Its first weight's y is held
    against ``quant_matmul_ref`` at the bf16 bar.  Returns (``_timed``'s
    dict, a note, the error), or (None, why it does not run here, None)."""
    from paddle_tpu_torch.ops.quant_matmul import quant_matmul_ref
    op = getattr(torch, name, None)
    if op is None:
        return None, f"torch.{name}: absent in this torch", None
    K, N, q, s = weights[0]
    try:
        y = call(op, xs[K], pack(K, N, q, s))
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, (f"torch.{name} does not run on CUDA here: "
                      f"{str(e).splitlines()[0][:120]}"), None
    err = _rel_err(y, quant_matmul_ref(xs[K], q, s, int4=int4))
    check(err <= WO_TOL[torch.bfloat16], f"torch.{name}: error {err} of the "
          f"largest against quant_matmul_ref, repacked wrongly")
    packed = [(K, pack(K, N, q, s)) for K, N, q, s in weights]
    return (_timed(lambda: [call(op, xs[K], p) for K, p in packed]),
            f"torch.{name} on the same weights repacked, the same pass", err)


def _int8pack(weights, xs):
    """``torch._weight_int8pack_mm``: x @ W^T * scale with W int8 [N, K]
    and the scale in x's dtype (rounded to bf16)."""
    return _library_pass(
        "_weight_int8pack_mm", weights, xs,
        lambda K, N, q, s: (q.t().contiguous(), s.to(torch.bfloat16)),
        lambda op, x, p: op(x, *p), int4=False)


INT4_GROUP = 256   # rows a scale group covers in the int4pack layout


def _int4pack(weights, xs):
    """``torch._weight_int4pack_mm`` (tinygemm): x @ ((u - 8) * scale +
    zero) with u uint4 in its own tiled layout and a (scale, zero) pair per
    group of rows and column.  K8's int4 function, once each signed nibble
    q is stored as u = q + 8 (two to a byte of the [N, K / 2] input to
    ``torch._convert_weight_to_int4pack``, the even row in the high
    nibble), every group's scale is the column's (rounded to bf16) and
    every zero is 0."""
    from paddle_tpu_torch.ops.quant_matmul import unpack_int4

    def pack(K, N, q, s):
        u = unpack_int4(q).t().to(torch.int32) + 8               # [N, K]
        u8 = (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8).contiguous()
        sz = torch.stack([s.to(torch.bfloat16).expand(K // INT4_GROUP, N),
                          torch.zeros(K // INT4_GROUP, N, device=s.device,
                                      dtype=torch.bfloat16)], -1)
        return torch._convert_weight_to_int4pack(u8, 8), sz.contiguous()

    return _library_pass(
        "_weight_int4pack_mm", weights, xs, pack,
        lambda op, x, p: op(x, p[0], INT4_GROUP, p[1]), int4=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    t_run = time.perf_counter()

    def mark(phase):
        print(f"time: {phase} done at {time.perf_counter() - t_run:.1f} s",
              flush=True)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)
    secs = _build.build_all()
    print(f"build: {', '.join(_build.sources())} in {secs:.1f} s", flush=True)
    for src, log in _build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"build {src}: {line.strip()}")

    mark("build")
    timer = Timer(dev)
    kernels = kernel_phase(dev, timer)
    mark("paged kernels")
    kernels += flash_kernel_phase(dev, timer)
    mark("flash kernels")
    head_dim_phase(dev)
    mark("head dims")
    del timer
    torch.cuda.empty_cache()
    launches, windows = engine_phase(dev, card)
    mark("engines")
    launches.update(training_phase(dev, card))
    mark("training")
    wo_lines, wo_launches = weight_only_phase(dev, card)
    mark("weight-only")
    kernels += wo_lines
    launches.update(wo_launches)
    for k in kernels:
        k["launches"] = launches[k["kernel"]]
        check(k["launches"] > 0, f"{k['kernel']} never launched on its path")
    check(sorted(k["kernel"] for k in kernels) == sorted(COUNTERS),
          f"the kernels line lists {[k['kernel'] for k in kernels]}")
    w = windows["decode"]
    print(f"decode window (bf16 engine, Llama-3-8B width, batch "
          f"{w['batch']}): {w['steps']} steps, wall {w['wall_ms']:.1f} ms "
          f"(profiled), device busy {w['busy_ms']:.1f} ms, K5 "
          f"{w['kernel_ms']:.3f} ms ({100 * w['kernel_ms'] / w['busy_ms']:.2f}"
          f"% of busy), on {card}")
    w = windows["verify"]
    print(f"verify window (bf16 spec engine, Llama-3-8B width, batch "
          f"{w['batch']}): "
          f"{w['steps']} steps, {w['verify_dispatches']} verify dispatches, "
          f"wall {w['wall_ms']:.1f} ms (profiled), device busy "
          f"{w['busy_ms']:.1f} ms, K7 {w['kernel_ms']:.3f} ms "
          f"({100 * w['kernel_ms'] / w['busy_ms']:.2f}% of busy); the "
          f"re-serve and its window took {w['cost_s']:.1f} s, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    # one card: the run uses cuda:0 and nothing else
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

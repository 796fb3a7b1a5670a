#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: the card's name and power limit; every kernel under
   ``paddle_tpu_torch/csrc`` is built from the checkout (one nvcc each, in
   parallel) and the build time printed.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving engine gives it at Llama-3-8B width (H=32, KVH=8,
   D=128, page 16), in bfloat16 and float32: K5 (paged attention) and K6
   (its int8-page variant) at the decode and prefill-chunk shapes, K5 also
   with a row whose context runs past its block table, K7 and K7q
   (multi-query verify attention, bf16 and int8 pages) at the verify shape.
   Each is then timed with CUDA events (L2 flushed before every launch)
   beside its plain version, one PyTorch call that computes the same
   function, and its bound.
3. engine: a float32 tiny Llama bridged from seeded numpy weights serves
   greedy requests on the card, each token checked against the dense
   reference, then again with int8 KV pages, with speculative decoding,
   with both (each token-identical to the plain engine of its KV dtype),
   and with the model drafting for itself.  Then ``LLMEngine`` serves 8
   greedy requests at the full width of Llama-3-8B (random weights from a
   seeded generator on the card, 32 layers) through add_request / step /
   stream: first in float32, then in bfloat16 (profiled afterwards), then
   in bfloat16 with speculative decoding (K5 + K7; the model drafts for
   itself), then with int8 pages and speculative decoding (K6 + K7q).  Every request must finish with 32
   tokens, each kernel's launch count, set to 0 just before an engine runs
   and read just after, must equal layers x the dispatches that reach it,
   and every token must match a teacher-forced dense reference (see
   ``GAP``; for int8 pages the reference's K and V pass through the same
   int8 quantization).
4. the ``kernels`` JSON line, the card line, and last the result line.
"""
from __future__ import annotations

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


def launch_counts():
    """Every kernel's launch counter, by kernel name."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_multiquery)
    return {"K5": paged_attention.launches,
            "K6": paged_attention.launches_int8,
            "K7": paged_attention_multiquery.launches,
            "K7q": paged_attention_multiquery.launches_int8}


def reset_launch_counts():
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_multiquery)
    paged_attention.launches = paged_attention.launches_int8 = 0
    paged_attention_multiquery.launches = 0
    paged_attention_multiquery.launches_int8 = 0


# ------------------------------------------------------------------ timing
class Timer:
    """Median device time of fn over n launches, each after the L2 cache is
    flushed (the engine reads each layer's pages cold)."""

    def __init__(self, dev):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn, n=30, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


# --------------------------------------------------------- phase 2: kernels
class Case:
    """One kernel call as the engine makes it: q (``[B, H, D]``, or
    ``[B, Q, H, D]`` with ``q_len``), pages, block tables and context lens,
    and with ``quant`` int8 pages quantized from the random ones with their
    scales.  Each sequence owns its pages (or all rows share one table, as
    a prefill chunk's rows do); table entries past the last row's horizon
    hold out-of-range garbage that the kernel must never read."""

    def __init__(self, dtype, ctx, gen, dev, shared=False, q_len=None,
                 quant=False):
        from paddle_tpu_torch.ops.paged_attention import quantize_kv
        self.dtype, self.ctx, self.shared = dtype, list(ctx), shared
        self.q_len, self.quant = q_len, quant
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


def kernel_phase(dev, timer):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_multiquery,
        paged_attention_multiquery_ref, paged_attention_ref)
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
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, case, ctx, shared, q_len in cases:
            quant = KERNELS[name][2]
            kern, ref = multi if q_len else single
            c = Case(dtype, ctx, gen, dev, shared, q_len, quant)
            out = c.run(kern)
            torch.cuda.synchronize()
            want = c.run(ref)
            err = (out.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
            print(f"{name} {case} {str(dtype)[6:]} B={len(ctx)}"
                  f"{f' Q={q_len}' if q_len else ''} max_abs_err={err:.3e} "
                  f"tol={TOL[dtype]:.0e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"{name} {case} {dtype}: error {err} over "
                  f"{TOL[dtype]}")
            errs.setdefault((name, dtype), []).append(err)

    # timing at each kernel's main-path shape, in the engine's dtype
    dtype = torch.bfloat16
    lines = []
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
            "tolerance": TOL[torch.bfloat16],
            "max_abs_err_f32": max(errs[(name, torch.float32)]),
            "tolerance_f32": TOL[torch.float32],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": ("SDPA with enable_gqa on K/V gathered dense"
                        + (" and dequantized to bf16 (reads twice the int8 "
                           "bytes)" if quant else "")
                        + (", boolean mask per row" if mq else "")),
            "shape": shape,
        }
        if not quant and not mq:
            # K5 at the prefill-chunk shape too: 32 rows share one table
            pre = Case(dtype, prefill_ctx, gen, dev, shared=True)
            line["prefill_ms"] = timer.ms(lambda: pre.run(kern))
            line["prefill_plain_ms"] = timer.ms(lambda: pre.run(ref))
            line["prefill_bound_ms"] = pre.bound()[0]
            print(f"{name} ({num}) prefill bf16 B={PREFILL_ROWS} ctx="
                  f"{prefill_ctx[0]}..{prefill_ctx[-1]} (one shared table): "
                  f"kernel {line['prefill_ms']:.4f} ms, plain "
                  f"{line['prefill_plain_ms']:.4f} ms, bound "
                  f"{line['prefill_bound_ms']:.4f} ms", flush=True)
        lines.append(line)
    return lines


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


def tiny_f32_engine(dev):
    """A 2-layer float32 Llama from seeded numpy weights, bridged through
    llama_from_numpy, served on the card and checked token by token; then
    the same requests with int8 pages, speculative decoding, both, and the
    model as its own draft model, each token-identical to the plain engine
    of its KV dtype."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SpecConfig
    from paddle_tpu_torch.models.convert import llama_from_numpy
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, intermediate_size=512)
    rng = np.random.RandomState(SEED)
    state = {}
    for name, shape in _jax_shapes(cfg).items():
        state[name] = (1.0 + 0.1 * rng.randn(*shape) if name.endswith(
            "norm.weight") else 0.08 * rng.randn(*shape)).astype(np.float32)
    model = llama_from_numpy(state, cfg, device=dev)
    pattern = list(rng.randint(0, cfg.vocab_size, 6))
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 16, 21)]
    prompts.append(np.asarray(pattern * 3))      # something to draft from

    def serve(**kw):
        eng = LLMEngine(model, device=dev, max_batch=2, max_len=64,
                        page_size=8, prefill_chunk=8, **kw)
        rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        eng.run_until_done()
        return eng, rids, [list(eng.result(r)) for r in rids]

    eng, rids, base = serve()
    counts, worst = check_all(model, prompts, eng, rids, F32_GAP, dev)
    print(f"engine tiny f32 (llama_from_numpy, D=128): {len(rids)} requests "
          f"token-checked: {describe(counts, worst, F32_GAP)}", flush=True)
    eng, rids, base8 = serve(kv_cache_dtype="int8")
    counts, worst = check_all(model, prompts, eng, rids, F32_GAP, dev,
                              kv_int8=True)
    print(f"engine tiny f32 int8 pages: {len(rids)} requests token-checked "
          f"against the int8 dense reference: "
          f"{describe(counts, worst, F32_GAP)}", flush=True)
    for tag, kw, want in (
            ("spec", dict(spec_decode=SpecConfig(max_draft=MAX_DRAFT)), base),
            ("int8 + spec", dict(kv_cache_dtype="int8",
                                 spec_decode=SpecConfig(max_draft=MAX_DRAFT)),
             base8),
            ("self-draft", dict(spec_decode=SpecConfig(
                max_draft=3, draft_model=model)), base)):
        eng, _, got = serve(**kw)
        st = eng.spec_stats()
        check(got == want, f"tiny f32 {tag}: tokens differ from the engine "
              f"without speculation")
        check(st["verify_dispatches"] > 0, f"tiny f32 {tag}: no verify step")
        print(f"engine tiny f32 {tag}: token-identical to spec off; "
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


def _jax_shapes(cfg):
    """State-dict names and shapes as the JAX package stores them (Linear
    weights [in, out])."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    d = h // nh
    shapes = {"llama.embed_tokens.weight": (v, h), "llama.norm.weight": (h,),
              "lm_head.weight": (h, v)}
    for i in range(cfg.num_hidden_layers):
        p = f"llama.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "post_attention_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (h, nh * d),
            p + "self_attn.k_proj.weight": (h, kvh * d),
            p + "self_attn.v_proj.weight": (h, kvh * d),
            p + "self_attn.o_proj.weight": (nh * d, h),
            p + "mlp.gate_proj.weight": (h, m),
            p + "mlp.up_proj.weight": (h, m),
            p + "mlp.down_proj.weight": (m, h)})
    return shapes


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
    (:func:`profile_engine`).  The engine is freed before returning."""
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
    if profile:
        eng.step = step
        profile_engine(eng, prompts, tag)
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
    }
    # the timing wrappers tie the engine into reference cycles: collect
    # them, or the next engine's peak memory counts this one's buffers
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def profile_engine(eng, prompts, tag, n_steps=8):
    """Where a step's time goes: the prompts served again, with
    ``torch.profiler`` over their first ``n_steps`` prefill chunks and over
    ``n_steps`` decode steps at full batch.  Prints each window's wall time,
    the device's busy share (kernel time over wall, which the profiler's
    own host cost lowers) and the kernels that take the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rids = [eng.add_request(p, max_new_tokens=2 * n_steps) for p in prompts]

    def window(kind):
        pf0 = eng.prefill_dispatches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels only: the CPU ops that launched them carry the same time
        rows = [(e.key, e.count, e.self_device_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
        busy = sum(ms for _, _, ms in rows)
        print(f"profile {tag} {kind}: {n_steps} steps "
              f"({eng.prefill_dispatches - pf0} prefill dispatches) in "
              f"{wall * 1e3:.1f} ms (profiled), device busy {busy:.1f} ms "
              f"({100 * busy / (wall * 1e3):.1f}%)", flush=True)
        for key, count, ms in sorted(rows, key=lambda r: -r[2])[:12]:
            print(f"profile {tag} {kind}:   {ms:9.3f} ms "
                  f"{100 * ms / busy:5.1f}%  x{count:<5d} {key[:90]}")

    window("prefill")
    while any(not eng._lookup(r).out for r in rids):   # until all decode
        eng.step()
    window("decode")
    eng.run_until_done()


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
    profiled), speculative decoding (K5 + K7), and int8 pages with
    speculative decoding (K6 + K7q).  Returns each kernel's launches on the
    run of its path."""
    tiny_f32_engine(dev)
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
                    ("bf16 spec", dict(spec=True)),
                    ("bf16 int8 spec", dict(spec=True,
                                            kv_cache_dtype="int8"))):
        runs[tag] = serve_full_width(model, tag, GAP, dev, **kw)
        engine_line(tag, runs[tag], card)
    return {"K5": runs["bf16"]["launches"]["K5"],
            "K7": runs["bf16 spec"]["launches"]["K7"],
            "K6": runs["bf16 int8 spec"]["launches"]["K6"],
            "K7q": runs["bf16 int8 spec"]["launches"]["K7q"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
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

    timer = Timer(dev)
    kernels = kernel_phase(dev, timer)
    del timer
    torch.cuda.empty_cache()
    launches = engine_phase(dev, card)
    for k in kernels:
        k["launches"] = launches[k["kernel"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    # one card: the run uses cuda:0 and nothing else
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

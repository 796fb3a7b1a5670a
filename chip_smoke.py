#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: the card's name and power limit; every kernel under
   ``paddle_tpu_torch/csrc`` is built from the checkout (one nvcc each, in
   parallel) and the build time printed.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving engine gives it at Llama-3-8B width (H=32, KVH=8,
   D=128, page 16), in bfloat16 and float32, then timed with CUDA events
   (L2 flushed before every launch) beside its plain version, the one
   PyTorch call that computes the same function, and its bound.
3. engine: a float32 tiny Llama bridged from seeded numpy weights serves
   greedy requests on the card, each token checked against the dense
   reference; then ``LLMEngine`` serves 8 greedy requests at the full width
   of Llama-3-8B (random weights from a seeded generator on the card, 32
   layers) through add_request / step / stream, first in float32, then in
   bfloat16, the main path whose launches and times are reported.  Every
   request must finish with 32 tokens, the kernel launch count must equal
   layers x forward dispatches, and every token must match a teacher-forced
   dense reference (see ``GAP``).  The bfloat16 engine then serves the
   prompts again under ``torch.profiler``, which prints where a prefill and
   a decode step's device time goes.
4. the ``kernels`` JSON line, the card line, and last the result line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
H, KVH, D, PAGE = 32, 8, 128, 16
DECODE_CTX = [1, 16, 17, 600, 1024, 300, 1000, 800]
PREFILL_ROWS, PREFILL_START = 32, 300
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
PROMPT_LENS = [17, 32, 64, 100, 255, 256, 400, 600]
NEW_TOKENS = 32
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
def paged_inputs(dtype, ctx, shared_table, gen, dev):
    """q, pages, block tables and context lens as the engine builds them:
    each sequence owns its pages (or all rows share one table, as a prefill
    chunk's rows do); table entries past ceil(ctx/page) hold out-of-range
    garbage that the kernel must never read."""
    B = len(ctx)
    S = 1024 // PAGE
    n_seq = 1 if shared_table else B
    P = n_seq * S + 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, PAGE, KVH, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, PAGE, KVH, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev).to(torch.int32)
    tables = perm[: n_seq * S].view(n_seq, S)
    tables = tables.expand(B, S).clone() if shared_table else tables.clone()
    cl = torch.tensor(ctx, dtype=torch.int32, device=dev)
    for b, c in enumerate(ctx):
        tables[b, -(-c // PAGE):] = 1 << 30
    return q, kp, vp, tables, cl


def paged_bound(q, ctx, dtype, shared=False):
    """Least time for the work: bytes (q and out once, the valid K/V rows
    once, the table entries used, the lengths) over the memory rate, or
    the flops (QK^T and PV, 2 each per multiply-add) over the peak for the
    type; the larger of the two.  ``shared``: all rows read one sequence's
    pages (a prefill chunk), which then count once."""
    B = len(ctx)
    el = q.element_size()
    seqs = [max(ctx)] if shared else ctx
    nbytes = (2 * q.numel() * el + 2 * sum(seqs) * KVH * D * el
              + sum(-(-c // PAGE) for c in seqs) * 4 + B * 4)
    flops = 4 * sum(ctx) * H * D
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(dev, timer):
    from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                      paged_attention_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernels: float32 matmuls and convolutions run without TF32")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    prefill_ctx = [PREFILL_START + i + 1 for i in range(PREFILL_ROWS)]
    for dtype in (torch.bfloat16, torch.float32):
        for case, ctx, shared in (("decode", DECODE_CTX, False),
                                  ("prefill", prefill_ctx, True)):
            args = paged_inputs(dtype, ctx, shared, gen, dev)
            out = paged_attention(*args)
            torch.cuda.synchronize()
            ref = paged_attention_ref(*args)
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
            print(f"paged_attention {case} {str(dtype)[6:]} B={len(ctx)} "
                  f"max_abs_err={err:.3e} tol={TOL[dtype]:.0e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"paged_attention {case} {dtype}: error {err} "
                  f"over {TOL[dtype]}")
            errs[(case, dtype)] = err

    # timing at the decode shape, in the engine's dtype
    dtype = torch.bfloat16
    q, kp, vp, tables, cl = paged_inputs(dtype, DECODE_CTX, False, gen, dev)
    kernel_ms = timer.ms(lambda: paged_attention(q, kp, vp, tables, cl))
    plain_ms = timer.ms(lambda: paged_attention_ref(q, kp, vp, tables, cl))
    # the library yardstick: SDPA on K/V already gathered dense, with the
    # context lengths as a boolean mask (never called by the port)
    T = max(DECODE_CTX)
    safe = tables.clamp(max=kp.shape[0] - 1).long()
    kd = kp[safe].reshape(len(DECODE_CTX), -1, KVH, D)[:, :T].transpose(1, 2)
    vd = vp[safe].reshape(len(DECODE_CTX), -1, KVH, D)[:, :T].transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < cl[:, None])[:, None,
                                                                 None, :]
    qd = q[:, :, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True)[:, :, 0]
    check((lib.float() - paged_attention(q, kp, vp, tables, cl).float())
          .abs().max().item() <= TOL[dtype], "library yardstick disagrees")
    library_ms = timer.ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(
                              qd, kd, vd, attn_mask=mask, enable_gqa=True))
    bound_ms, bound_by = paged_bound(q, DECODE_CTX, dtype)
    print(f"paged_attention decode bf16 B={len(DECODE_CTX)} "
          f"sum(ctx)={sum(DECODE_CTX)}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    # and at the prefill shape: 32 rows of one sequence share its pages
    pre = paged_inputs(dtype, prefill_ctx, True, gen, dev)
    pre_ms = timer.ms(lambda: paged_attention(*pre))
    pre_plain_ms = timer.ms(lambda: paged_attention_ref(*pre))
    pre_bound_ms, pre_by = paged_bound(pre[0], prefill_ctx, dtype, True)
    print(f"paged_attention prefill bf16 B={PREFILL_ROWS} ctx="
          f"{prefill_ctx[0]}..{prefill_ctx[-1]} (one shared table): kernel "
          f"{pre_ms:.4f} ms, plain {pre_plain_ms:.4f} ms, bound "
          f"{pre_bound_ms:.4f} ms ({pre_by})", flush=True)
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/paged_attention.py:30",
        "launches": None,
        "max_abs_err": max(errs[(c, torch.bfloat16)]
                           for c in ("decode", "prefill")),
        "tolerance": TOL[torch.bfloat16],
        "max_abs_err_f32": max(errs[(c, torch.float32)]
                               for c in ("decode", "prefill")),
        "tolerance_f32": TOL[torch.float32],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": (f"decode bf16 B={len(DECODE_CTX)} H={H} KVH={KVH} D={D} "
                  f"page={PAGE} ctx={DECODE_CTX}"),
        "prefill_ms": pre_ms,
        "prefill_plain_ms": pre_plain_ms,
        "prefill_bound_ms": pre_bound_ms,
    }


# ---------------------------------------------------------- phase 3: engine
def teacher_forced_check(model, prompt, out, gap, dev):
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
    logits = model.forward_ref(ids)[0, len(prompt) - 1:]
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
    llama_from_numpy, served on the card and checked token by token."""
    from paddle_tpu_torch.inference.serving import LLMEngine
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
    eng = LLMEngine(model, device=dev, max_batch=2, max_len=64, page_size=8,
                    prefill_chunk=8)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 16, 21)]
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    eng.run_until_done()
    counts, worst = check_all(model, prompts, eng, rids, F32_GAP, dev)
    print(f"engine tiny f32 (llama_from_numpy, D=128): {len(rids)} requests "
          f"token-checked: {describe(counts, worst, F32_GAP)}", flush=True)


def check_all(model, prompts, eng, rids, gap, dev):
    counts, worst = np.zeros(3, int), 0.0
    for p, rid in zip(prompts, rids):
        c, w = teacher_forced_check(model, p, list(eng.result(rid)), gap, dev)
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


def serve_full_width(dtype, gap, dev, profile=False):
    """Serve the 8 requests at Llama-3-8B width in ``dtype`` through
    add_request / step / stream, with the kernel's launch count set to 0
    just before and read just after; check every request and token.  With
    ``profile``, then profile the same engine (:func:`profile_engine`)."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.serving import LLMEngine, RequestStatus
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    cfg = LlamaConfig.llama3_8b()
    tag = str(dtype)[6:]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = LlamaForCausalLM(cfg, device=dev, dtype=dtype, generator=gen)
    eng = LLMEngine(model, device=dev, max_batch=8, max_len=1024,
                    page_size=PAGE, prefill_chunk=32)
    torch.cuda.synchronize()
    print(f"engine {tag}: Llama-3-8B width (vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads}q/{cfg.num_key_value_heads}kv heads, "
          f"ffn {cfg.intermediate_size}) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    steps = []                     # (seconds, was a prefill, slots served)
    step = eng.step

    def timed_step():
        before = eng.prefill_dispatches
        a = time.perf_counter()
        served = step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - a,
                      eng.prefill_dispatches != before, served))
        return served

    eng.step = timed_step
    torch.cuda.reset_peak_memory_stats()
    obs.enable()
    try:
        paged_attention.launches = 0
        t_start = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        streamed = list(eng.stream(rids[0]))
        while any(not eng.status(r).terminal for r in rids):
            eng.step()
        wall = time.perf_counter() - t_start
        launches = paged_attention.launches
        snap = eng.metrics()
    finally:
        obs.disable()

    def dispatches(kind):
        return int(sum(s["value"] for s in
                       snap["serving_dispatches_total"]["series"]
                       if s["labels"].get("kind") == kind))

    n_prefill, n_decode = dispatches("prefill"), dispatches("decode")
    L = cfg.num_hidden_layers
    check(n_prefill == eng.prefill_dispatches,
          f"prefill dispatch count {n_prefill} != "
          f"{eng.prefill_dispatches}")
    expected = L * (n_prefill + n_decode)     # decode_block 1: one step each
    print(f"engine {tag}: {n_prefill} prefill + {n_decode} decode "
          f"dispatches, paged_attention launches {launches} (expected {L} x "
          f"{n_prefill + n_decode} = {expected})", flush=True)
    check(launches == expected, f"launches {launches} != {expected}")
    check(launches > 0, "the main path never launched the kernel")
    for rid in rids:
        check(eng.status(rid) == RequestStatus.FINISHED,
              f"request {rid} ended {eng.status(rid)}")
        check(len(eng.result(rid)) == NEW_TOKENS,
              f"request {rid} has {len(eng.result(rid))} tokens")
    check(streamed == list(eng.result(rids[0])),
          "streamed tokens differ from the result")

    counts, worst = check_all(model, prompts, eng, rids, gap, dev)
    print(f"engine {tag}: all {len(rids)} requests FINISHED with "
          f"{NEW_TOKENS} tokens; teacher-forced check of "
          f"{NEW_TOKENS * len(rids)} tokens passed: "
          f"{describe(counts, worst, gap)}", flush=True)

    prefill_s = sum(s for s, pf, _ in steps if pf)
    decode_s = sum(s for s, pf, _ in steps if not pf)
    decode_tok = sum(n for _, pf, n in steps if not pf)
    ttft = sorted(eng.ttft(r) for r in rids)
    if profile:
        eng.step = step
        profile_engine(eng, prompts, tag)
    return {
        "ttft_p50_s": float(np.median(ttft)),
        "ttft_max_s": ttft[-1],
        "decode_tok_s": decode_tok / decode_s,
        "prefill_tok_s": sum(PROMPT_LENS) / prefill_s,
        "wall_s": wall,
        "prefill_dispatches": n_prefill,
        "decode_dispatches": n_decode,
        "launches": launches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "argmax_flips": int(counts[1]),
        "worst_shortfall": worst,
    }


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


def engine_phase(dev):
    """The float32 checks first (tiny bridged model, then full width, both
    held to the dense reference almost exactly); then the main path, the
    bfloat16 engine at full width, whose launches and times are reported,
    then profiled."""
    tiny_f32_engine(dev)
    serve_full_width(torch.float32, F32_GAP, dev)
    torch.cuda.empty_cache()
    return serve_full_width(torch.bfloat16, GAP, dev, profile=True)


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
            if "registers" in line or "spill" in line:
                print(f"build {src}: {line.strip()}")

    timer = Timer(dev)
    kernel = kernel_phase(dev, timer)
    e2e = engine_phase(dev)
    kernel["launches"] = e2e["launches"]
    print(f"engine: ttft_p50 {e2e['ttft_p50_s']:.4f} s, ttft_max "
          f"{e2e['ttft_max_s']:.4f} s, decode {e2e['decode_tok_s']:.1f} "
          f"tok/s (batch 8), prefill {e2e['prefill_tok_s']:.1f} tok/s, "
          f"wall {e2e['wall_s']:.2f} s, peak memory "
          f"{e2e['peak_mem_gib']:.1f} GiB on {card}", flush=True)
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

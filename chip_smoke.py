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
   Then the flash-attention kernels of training: first the bf16 tile
   plans at head_dim 64-256 (the forward K1 / K4-fwd, the backward K2 /
   K3 and K4-dq / K4-dkv) as the card's library compiled them, held to
   the ones ``ops/flash_attention.py`` records (no spills, no setmaxnreg
   ignored; each body's ptxas report printed); then K1
   (forward), K2 (dQ) and K3 (dK / dV) against their plain versions at
   the GPT-2 bench shape (B16 S1024 H12 D64, causal, bf16), the
   Llama-shaped one (B8 S1024 H16 KVH4 D128, GQA), head_dim 192, 256 and
   512, two non-causal cases (one at ERNIE 3.0 base's B16 S512 H12 D64),
   S 128 and 384, Sk != Sq, GQA 8:1, q / k / v as
   views of one fused projection, and six float32 cases (TF32 off); and
   K4, the layout-direct bodies of the ``FLAGS_flash_layout_direct``
   path, against theirs at GPT-2's shape, MHA at head_dim 128, 192, 256
   and 512, a non-causal case, Sk != Sq, S 128 and 384, fused views and
   three float32 cases; every case run twice and bitwise the same.  Each
   is then timed at the GPT-2, MHA head_dim-192, head_dim-256 and
   head_dim-512 shapes (K1-K3 also at the Llama one and ERNIE's,
   non-causal, K4 at MHA head_dim 128) beside its plain version, SDPA's forward / backward and its
   bound: ``ms``, ``held_ms``,
   profiler device time, host microseconds a call, TFLOP/s and share of
   the bound, SDPA's on the same readings.  head_dim 320, 384 and 512
   run forward and backward through ``flash_attention_bshd`` on the
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
   int8 quantization).  Every engine runs on CUDA graphs: each runner
   program (decode, prefill, verify) is captured at its first dispatch and
   replayed after, as is the drafter's ``generate`` decode step; each
   engine prints its programs' captures, replays and eager dispatches
   (eager must be 0: every request is greedy), and steps that captured a
   program are kept out of the rates.  On the bf16 engines, a decode
   block, a prefill chunk and a verify step are replayed beside the same
   body run eagerly on the same inputs and cache (tokens identical, logits
   within the bf16 bar); the profiled windows print the paged kernel's
   launches as the profiler saw them beside layers x steps.
4. front door, the serving front door and fleet (``paddle_tpu_torch.
   inference.frontend``): K5 launched from a fresh thread against its
   plain version; a native ``TCPStore`` master; the tiny float32 Llama
   behind a two-replica SSE gateway (token-exact with one direct engine)
   and behind a fleet of two thread-hosted workers on the durable gateway,
   one killed mid-stream (its streams resumed token-exact); then
   Llama-3-8B in bf16 behind the in-process gateway: two ``LLMEngine``s on
   one model, each with its own step thread, a prefix-affinity
   ``ReplicaSet``, eight concurrent ``http_completion`` SSE clients (the
   engine phase's prompts, 32 tokens each) and a shared-prefix pair whose
   second request must be routed by affinity to the first's replica and
   hit its two cached pages; every stream FINISHED with 32 tokens, equal
   to the serving engine's ``result()`` and within ``GAP`` of the dense
   reference; both replicas captured their programs (captures take turns
   on the card: the time one waited is printed), 0 eager, and K5's
   launches = layers x dispatches on each replica and in all; TTFT and
   tokens/s beside the direct bf16 engine's.  Then the fleet: two
   ``WorkerSupervisor``s each spawn ``python -m paddle_tpu_torch.
   inference.frontend.worker --engine-spec chip_smoke.py:make_engine``
   (the same seeded Llama-3-8B bf16 engine), a ``FleetReplicaSet`` behind
   the durable (journaled) gateway, the same eight prompts over HTTP, and
   a SIGKILL of the worker serving the most streams once each of them has
   ``FLEET_KILL_AT`` tokens: every stream must end with exactly 32 tokens
   at SSE indices 0-31 (no gap, no duplicate, the tokens sent before the
   kill kept), the killed worker's streams resumed on the survivor, the
   worker respawned by its supervisor and rejoined through membership
   under epoch 2; then, the workers stopped, the dense reference built
   here from the same seed checks every stream within ``GAP``.  Each
   worker's memory, the time from the kill to the resumed streams' first
   token and to the rejoin are printed.
5. disaggregation, ``DisaggEngine`` (prefill and decode engines with
   KV-page handoff between their pools): tiny float32 pools at head_dim
   128, 16 and 64, each token-exact with the tiny colocated engine of the
   same options, with speculative decoding on the decode side (K5 + K7),
   int8 pages with it (K6 + K7q), fixed-seed sampling, transient
   ``serving.kv_handoff`` faults retried, one poisoned handoff
   quarantining only its request, a cancel in the handoff queue releasing
   its pages, and a thread-hosted prefill worker over RPC; then
   Llama-3-8B bf16 in the engine phase's geometry through pools of 1:1
   (pipelined hop, prefix caching on the prefill side and the shared-
   prefix pair), 1:1 (blocking hop), 2:1, 1:2 and 2:2, every request
   token-exact with the direct bf16 engine, one handoff each, the pools'
   combined page audit clean, and on each engine 0 eager dispatches and
   K5 = layers x its dispatches (prefill engines only prefill, decode
   engines only decode); TTFT, decode-only rounds, queue wait, transfer
   and overlap seconds and peak memory a pool.  Then ``bench.py``'s mixed
   trace (6 short requests decoding while three 600-token prompts arrive
   at steps 2, 6 and 10) colocated, through a 1:1 pool with the blocking
   hop and a 2:1 pool with the pipelined one, warmed first: the short
   requests' inter-token gaps and TTFT, tokens equal three ways.  Last a
   worker process with ``--role prefill`` (``make_engine``) leased into a
   native ``TCPStore``, handed by ``FleetReplicaSet.prefill_tiers`` to a
   pool whose decode engine runs here: the eight requests token-exact,
   the worker's page audit folded in, the bytes and seconds of each pull;
   the worker stopped, the card's memory must come back.
6. training, after the engines have freed their memory: a tiny float32
   GPT-2 bridged from seeded numpy weights takes two AdamW steps on the
   card (K1-K3) and on the CPU (their plain versions), held together; then
   GPT-2 124M in bf16 at ``bench.py``'s geometry (B16 S1024, AdamW 3e-4,
   global-norm clip 1.0, chunked bf16 loss) and a Llama-3-shaped model (4
   layers of width 2048, 16 q / 4 kv heads, B8 S1024) each take a checked
   first step (loss and block 0's attention gradients against the same
   model with the reference's dense attention) and timed steps on one
   repeated batch, with K1 = layers x forwards and K2 = K3 = layers x
   backwards, the loss falling; step ms, tokens/s, MFU, peak memory and a
   profiled step's device time are printed, with each flash kernel's
   launches as the profiler counts them beside its launch counter's.
   Between the two, the same
   GPT-2 from the same seed trains with ``FLAGS_flash_layout_direct`` set
   (K4's path), its first step held to the default path's, with K4's three
   bodies launched layers x steps times each and K1-K3 never.
   Then the spine: the same GPT-2 124M (bf16, B16 S1024) written in the
   Paddle Tensor API (``spine_gpt2_loss``: ``Tensor`` ops through
   ``apply_op``, the Tensor-level ``scaled_dot_product_attention``, torch's
   autograd as the tape) over the seeded model's weights as
   ``Parameter``s: three plain SGD steps with in-place Tensor ops under
   ``no_grad``, the first held to the torch.nn model's flash step (loss and
   every gradient at the training bar), the loss falling, K1-K3 launched
   12 x 3 times and K4 never; one step with ``FLAGS_flash_layout_direct``
   (K4-fwd / dq / dkv 12 each); ``paddle.grad`` leaving every ``.grad``
   alone, a hook on an attention output doubling its upstream gradient, a
   ``stop_gradient`` weight getting none, a ``PyLayer`` GELU matching its
   plain twin; the step's wall against the torch.nn eager step, apply_op
   dispatches a step and host microseconds each, a small add against
   ``torch.add``, peak memory, and a profiled step of each (device busy,
   the top kernels).  Then the layer phase (the reference's GPT-2 on
   ``nn.Layer`` with Paddle AdamW + clip, held to the torch.nn model), and
   the capture phase (``capture_phase``): the same ``Layer`` GPT-2 124M
   (bf16, B16 S1024, the torch.nn model's weights) with bench.py's
   ``train_step`` under ``paddle.jit.to_static``, one CUDA graph a step:
   spied, captured and replayed beside an eager twin taking the same steps
   from the same weights (losses and every parameter at the bf16 bar;
   K1-K3 launched layers x replays and K4 never, through the replay tally;
   no Python body and 0 apply_op dispatches in a replay; step ms, tokens/s,
   MFU, capture seconds, peak memory and a profiled replay beside the eager
   Layer and torch.nn AdamW steps); the same with
   ``FLAGS_flash_layout_direct`` (K4 only); ``paddle.jit.scan_steps`` at
   K = 1 and 6 timed by bench.py's differential; a guarded and broken step
   (a loss guard, a ``float(loss)`` metric through the echo pass, one
   forced guard flip rolled back from the snapshot) against its eager
   twin; and the float32 model under ``amp.auto_cast("O1")`` with a
   ``GradScaler`` and after ``amp.decorate(level="O2")``, each captured and
   held to its eager twin with K1-K3 launched, and one step's
   ``low_precision_op_list``.  Then ERNIE 3.0 base (``ernie_phase``:
   ernie-3.0-base-zh's geometry, bf16, seeded weights, masked-LM on one B16
   S512 batch with the same AdamW + clip): the first step's loss, every
   gradient and every parameter after it held to the same model with the
   flash route off, K1 = K2 = K3 = 12 x steps non-causally and K4 never,
   the loss falling, step ms, tokens/s, MFU, dispatches, peak memory and a
   profiled step; the step captured and replayed bitwise equal to an
   eager twin (K1-K3 through the replay tally, 0 dispatches, no Python
   body); a padded ``ErnieForSequenceClassification`` eval forward (pad
   ids move nothing, no K1 launch); a conv / pool stem in float32 held to
   the CPU; and the Layer GPT-2 124M's ``generate`` in float32 (greedy
   token-exact with the ``torch.nn`` model, K1 launched 12 times, top-k
   sampling repeatable and inside the top k).  Then the reference's Llama
   on ``nn.Layer`` (``llama_layer_phase``): ``bench.py``'s
   ``_llama_child`` (``paddle.seed(0)``, the Llama-3-shaped
   ``LlamaForCausalLM`` in bf16, AdamW + clip, B8 S1024), its first step
   held to the ``torch.nn`` twin from the same weights (loss, every
   gradient, every parameter after the step), ``jit.scan_steps`` at K = 1
   and 6 captured and held to an eager ``Layer`` twin taking the same
   steps, K1 = K2 = K3 = 4 x steps through the replay tally, the step
   timed by bench.py's differential beside the eager ``Layer`` and
   ``torch.nn`` steps, one replay profiled; ``generate`` at Llama-3-8B
   width (bf16 weights handed to the twin on the card, B4 prompts of 128 +
   32 greedy tokens, three runs: the Python body runs only in the spies
   and captures, tokens equal across runs, each teacher-forced within
   ``GAP`` against the twin's ``forward_ref``) and in float32 at 2 layers
   (token-exact with the twin's ``generate``); then, in float32 against
   the same calls on the CPU, a 2-layer bidirectional ``LSTM`` and
   ``GRU``, ``ctc_loss`` and ``grid_sample``, and ``flash_attn_qkvpacked``
   at GPT-2's shape in bf16 (K1, K2, K3 once each, bitwise
   ``flash_attention``).  Then the training workflow around quantization
   (``workflow_phase``): one epoch of a seeded shuffled order through the
   native ``DataLoader`` (``dataloader.cc``), forked Python workers and
   the synchronous path, batch for batch equal, each engine's batches/s;
   ERNIE 3.0 base as a 2-class ``ErnieForSequenceClassification`` (bf16)
   fine-tuned through ``paddle.Model.fit`` (40 steps, B32 S128, AdamW +
   clip, ``Accuracy``, ``ModelCheckpoint``) on the native loader: the
   first batch bitwise a bare ``Layer`` step, K1 = K2 = K3 = 12 x steps,
   the loss falling, step ms, tokens/s, MFU, ``hapi``'s cost over the
   bare step, a profiled step; the checkpoint's bytes, save and load
   seconds, a fresh ``Model`` loaded from it evaluating and stepping
   bitwise the saved one; PTQ (absmax activations, per-channel weights)
   to 74 int8 ``QuantizedLinearInfer`` layers, its accuracy beside the
   float model's, logits within the reference's 5 % bar, the int8 state
   dict round-tripped bitwise, Hist / KL thresholds of a real activation
   equal to the same numpy run on its CPU copy; GPT-2 124M's QAT step
   (48 ``QuantedLinear``) captured by ``to_static`` and bitwise its eager
   twin over 6 steps, the 48 EMA scales included, its replays timed and
   profiled beside the float captured step of the same run, K1-K3 12 a
   replay, converted to 48 int8 layers within the bar.
7. weight-only, K8's path: Llama-3-8B's 224 projection weights (32
   layers, random bf16 from a seeded generator on the card) quantized to
   int8 and int4 through ``weight_quantize``; one decode step of linear
   layers (M = 8) through ``nn.quant.weight_only_linear``, K8 launched
   once a GEMM (K8's kernel alone, 224 launches, in a profiled pass run
   in a fresh process first), each output against
   ``quant_matmul_ref`` and bitwise the same in a second pass; the pass
   captured into a CUDA graph and replayed (224 launches counted, outputs
   bitwise the eager pass's, its wall beside the eager one's); the bf16
   bodies' compiled plans (no spills) and each projection's launch plan
   (strip, splits = cluster size); M 1, 13 and 300 and a float32 case at
   K 4096 and 14336, and the smallest shape (256 x 256), each twice and
   bitwise equal; a call needing a gradient (no launch), the memory a call
   allocates (less than its bf16 weight); the pass timed beside its bound,
   the host's time a call, the dequant formulation, F.linear on
   dequantized bf16 weights, and the library's int8 / int4 calls.
8. the decode and verify windows' lines, the ``kernels`` JSON line (all
   twelve kernels, each launched on its path, with their design and tile,
   split or launch plan), the card line, and last the result line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

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

    def device_ms(self, fn, match=None, n=20, exclude=()):
        """Device time per call of fn's kernels whose names contain one of
        ``match`` (every kernel where it is None) and none of ``exclude``
        (torch.profiler, L2 flushed before each call)."""
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
                   and (match is None or any(m in e.key for m in match))
                   and not any(x in e.key for x in exclude)) / 1e3 / n


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
# (tag, B, S, H, KVH, D, causal, dtype[, options]): K1-K3 at the two
# training shapes, head_dim 192, 256 and 512 (the column-chunked bodies),
# two non-causal cases (one GQA, and ERNIE 3.0 base's training shape, B16
# S512 H12 D64), and float32 (TF32 off).  For the forward's ring and
# tensor maps (D <= 256 in bf16): S 128 (one q tile, one diagonal k tile),
# S 384 (three q tiles), Sk != Sq without the mask, GQA 8:1 (at S 384 a
# K3 ring crosses from head to head with a ragged causal q range) and q, k
# and v as views of one [B, S, 3, H, D] projection (row stride 3 H D).
# Options: Sk (keys, when not S), fused (the views).
FLASH_CASES = [
    ("gpt2", 16, 1024, 12, 12, 64, True, torch.bfloat16),
    ("llama", 8, 1024, 16, 4, 128, True, torch.bfloat16),
    ("d192", 4, 1024, 8, 8, 192, True, torch.bfloat16),
    ("d256", 4, 1024, 8, 4, 256, True, torch.bfloat16),
    ("d512", 4, 1024, 8, 4, 512, True, torch.bfloat16),
    ("non-causal", 4, 512, 12, 4, 64, False, torch.bfloat16),
    ("ernie", 16, 512, 12, 12, 64, False, torch.bfloat16),
    ("s128", 4, 128, 12, 12, 64, True, torch.bfloat16),
    ("s384", 2, 384, 8, 4, 128, True, torch.bfloat16),
    ("sk768", 2, 256, 8, 4, 64, False, torch.bfloat16, {"Sk": 768}),
    ("gqa8", 2, 1024, 32, 4, 128, True, torch.bfloat16),
    ("gqa8 s384", 2, 384, 32, 4, 128, True, torch.bfloat16),
    ("fused-qkv", 4, 512, 12, 12, 64, True, torch.bfloat16,
     {"fused": True}),
    ("f32 mha", 1, 256, 2, 2, 128, True, torch.float32),
    ("f32 gqa", 1, 256, 4, 1, 64, True, torch.float32),
    ("f32 d192", 1, 256, 2, 2, 192, True, torch.float32),
    ("f32 d256", 1, 256, 4, 2, 256, True, torch.float32),
    ("f32 d320", 1, 256, 4, 2, 320, True, torch.float32),
    ("f32 d512", 1, 256, 2, 2, 512, False, torch.float32),
]
# K4 (MHA only): GPT-2's shape, head_dim 128, 192, 256 and 512,
# non-causal, Sk != Sq without the mask, S 128 and 384, fused-qkv views,
# float32
K4_CASES = [
    ("gpt2", 16, 1024, 12, 12, 64, True, torch.bfloat16),
    ("d128", 4, 1024, 8, 8, 128, True, torch.bfloat16),
    ("d192", 4, 1024, 8, 8, 192, True, torch.bfloat16),
    ("d256", 4, 1024, 8, 8, 256, True, torch.bfloat16),
    ("d512", 4, 1024, 8, 8, 512, True, torch.bfloat16),
    ("non-causal", 4, 512, 12, 12, 64, False, torch.bfloat16),
    ("sk768", 2, 256, 8, 8, 64, False, torch.bfloat16, {"Sk": 768}),
    ("s128", 4, 128, 12, 12, 256, True, torch.bfloat16),
    ("s384", 2, 384, 8, 8, 192, True, torch.bfloat16),
    ("fused-qkv", 4, 512, 12, 12, 64, True, torch.bfloat16,
     {"fused": True}),
    ("f32 d64", 1, 256, 2, 2, 64, True, torch.float32),
    ("f32 d256", 1, 256, 2, 2, 256, True, torch.float32),
    ("f32 d512", 1, 256, 2, 2, 512, True, torch.float32),
]
# GPT-2's shape and head_dim 192 (MHA) are timed on both paths: K2 / K3
# against K4 on the same shapes
FLASH_TIMED = {False: ("gpt2", "llama", "d192", "d256", "d512", "ernie"),
               True: ("gpt2", "d128", "d192", "d256", "d512")}
# the device kernels of each role's bodies (every width and both paths)
FLASH_BODIES = {"fwd": ("fwd_bf16",), "dq": ("dq_bf16",),
                "dkv": ("dkv_bf16",)}
FWD_DESIGN = ("up to head_dim 256 in bf16: a persistent grid (one block of "
              "384 threads an SM) over 128-row q tiles, head by head, in "
              "snake rounds; one producer thread's TMA ring of K / V tiles "
              "(4-D tensor maps over the tensors' own strides, 128-byte "
              "swizzle) under full / empty mbarriers; two consumer "
              "warpgroups of 64 rows: wgmma S = q K^T (both from shared "
              "memory) and O += P V (P from registers, V MN-major), the "
              "softmax of tile j under P V of tile j - 1, the two "
              "warpgroups ping-ponging their products; setmaxnreg 232 / 40. "
              "Above 256: the mma.sync body")
BWD_DESIGN = ("up to head_dim 256 in bf16, on the forward's skeleton: "
              "persistent grids of 384-thread blocks in head-major snake "
              "rounds, one producer thread's TMA ring under full / empty "
              "mbarriers, two consumer warpgroups on wgmma (K2's taking "
              "turns), setmaxnreg 232 / 40.  K2 (dq_bf16_sm90): items of 128 "
              "q rows; "
              "q and dO an item, K / V tiles in the ring; each warpgroup "
              "computes delta for its 64 rows, scales q in place, then per "
              "k tile S = q2 K^T and dP = dO V^T (both from shared memory) "
              "issued with dQ += dS K of the tile before (dS from registers, "
              "K read MN-major).  K3 (dkv_bf16_sm90): items of keys; K / V "
              "an item, then q, dO, LSE and delta rows of each q tile of the "
              "GQA group's heads in the ring; three producer warps write q2 "
              "= q * scale * log2 e into a q2 buffer; S^T = K q2^T, dP^T = V "
              "dO^T, then dV += P^T dO and dK += dS^T q (dO and q MN-major), "
              "dK and dV summed over the group in registers, no atomics; "
              "above head_dim 128 warpgroup 0 holds dV and warpgroup 1 dK of "
              "the same 64 keys, each computing S^T.  K4-dq / K4-dkv: the "
              "same two bodies with K4's numerics (kDirect): q is not scaled, "
              "each score of the raw q K^T is multiplied by scale * log2 e in "
              "f32, and K4-dkv takes S^T = K q^T from the ring stage's own q "
              "tile, with no q2 buffer or writer warps.  Head_dim 320-512 and "
              "f32: the mma.sync and CUDA-core bodies")
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
    """One attention problem: q / dO [B, S, H, D], k / v [B, Sk, KVH, D]
    (Sk = S unless given), standard-normal from the seeded generator; with
    ``fused``, q, k and v are views of one [B, S, 3, H, D] tensor (KVH =
    H); ``direct`` for K4's bodies and twins (the layout-direct path)
    instead of K1-K3's."""

    def __init__(self, tag, B, S, H, KVH_, D_, causal, dtype, gen, dev,
                 direct=False, Sk=None, fused=False):
        self.tag, self.causal, self.dtype = tag, causal, dtype
        self.direct, self.fused = direct, fused
        Sk = Sk or S
        self.shape = (B, S, H, KVH_, D_)
        self.Sk = Sk
        self.qkv = None
        if fused:
            self.qkv = torch.randn(B, S, 3, H, D_, generator=gen,
                                   device=dev).to(dtype)
            self.q, self.k, self.v = self.qkv.unbind(2)
        else:
            self.q = torch.randn(B, S, H, D_, generator=gen,
                                 device=dev).to(dtype)
            self.k, self.v = (torch.randn(B, Sk, KVH_, D_, generator=gen,
                                          device=dev).to(dtype)
                              for _ in "kv")
        self.do = torch.randn(B, S, H, D_, generator=gen,
                              device=dev).to(dtype)
        self.scale = D_ ** -0.5

    def refs(self):
        from paddle_tpu_torch.ops import flash_attention as fa
        return ((fa.bshd_fwd_ref, fa.bshd_bwd_ref) if self.direct else
                (fa.flash_fwd_ref, fa.flash_bwd_ref))

    def describe(self):
        B, S, H, KVH_, D_ = self.shape
        views = " (q, k, v: views of one [B, S, 3, H, D])"
        return (f"{self.tag} {str(self.dtype)[6:]} B={B} S={S}"
                f"{f' Sk={self.Sk}' if self.Sk != S else ''} H={H} "
                f"KVH={KVH_} D={D_} causal={self.causal}"
                f"{views if self.fused else ''}")

    def _run(self):
        """One forward and backward through ``flash_attention_bshd`` (the
        flag set for K4): o, the three gradients, the LSE of a direct
        forward launch and the launches each kernel made."""
        from paddle_tpu_torch.ops import flash_attention as fa
        if self.fused:
            leaf = self.qkv.clone().requires_grad_()
            ins = leaf.unbind(2)
        else:
            ins = [t.clone().requires_grad_() for t in (self.q, self.k,
                                                        self.v)]
        with layout_direct(self.direct):
            before = launch_counts()
            o = fa.flash_attention_bshd(*ins, causal=self.causal)
            o.backward(self.do)
            after = launch_counts()
        grads = leaf.grad.unbind(2) if self.fused else [x.grad for x in ins]
        _, lse = fa._launch_fwd(self.q, self.k, self.v, self.causal,
                                self.scale, self.direct)
        torch.cuda.synchronize()
        return (o, lse, grads,
                {n: after[n] - before[n] for n in FLASH_COUNTERS})

    def check(self):
        """Kernels against their plain versions, the forward's through
        ``flash_attention_bshd`` and its autograd (with the flag set for
        K4, which must then launch K4's bodies and no others), run twice
        and bitwise the same; returns the errors of o (and the LSE), dq and
        dk / dv by kernel, gradients relative to the largest reference
        magnitude in bf16."""
        q, k, v, do = self.q, self.k, self.v, self.do
        fwd_ref, bwd_ref = self.refs()
        o_ref, lse_ref = fwd_ref(q, k, v, self.causal)
        g_ref = bwd_ref(q, k, v, o_ref, lse_ref, do, self.causal)
        o, lse, grads, ran = self._run()
        o2, lse2, grads2, _ = self._run()
        same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        kern = {role: ROLE_KERNEL[(role, self.direct)]
                for role in ("fwd", "dq", "dkv")}
        check(ran == {n: int(n in kern.values()) for n in FLASH_COUNTERS},
              f"flash {self.describe()}: launched {ran}, expected one each "
              f"of {sorted(kern.values())}")
        check(same, f"flash {self.describe()}: two runs differ")
        f_tol, g_tol = FLASH_TOL[self.dtype]

        def err(a, b, grad):
            e = (a.float() - b.float()).abs().max().item()
            if grad and self.dtype == torch.bfloat16:
                e /= b.float().abs().max().item()
            return e
        errs = {kern["fwd"]: max(err(o, o_ref, False),
                                 err(lse, lse_ref, False)),
                kern["dq"]: err(grads[0], g_ref[0], True),
                kern["dkv"]: max(err(grads[1], g_ref[1], True),
                                 err(grads[2], g_ref[2], True))}
        finite = all(bool(torch.isfinite(t).all())
                     for t in [o, lse, *grads])
        for name, e in errs.items():
            fwd = name == kern["fwd"]
            tol = f_tol if fwd else g_tol
            ok = finite and e <= tol
            print(f"flash {name} {self.describe()}: err {e:.3e}"
                  f"{' (of max)' if not fwd and self.dtype == torch.bfloat16 else ''} "
                  f"tol {tol:.0e}, run twice: bitwise equal "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"flash {self.describe()}: {name} error {e} over {tol}")
        return errs

    def work(self, role):
        """(flops, bytes) of a role: the flops of the causal (or full)
        score pairs, fwd: q k^T and P V (4 D a pair); dq: q k^T, dO v^T,
        dS k (6 D); dkv: q k^T, dO v^T, P^T dO, dS^T q (8 D); the bytes of
        each input read once and each output written once (the dq body
        writes delta, the dkv body reads it instead of o; K4 as K2 /
        K3)."""
        B, S, H, KVH_, D_ = self.shape
        el = self.q.element_size()
        pairs = B * H * (S * (S + 1) // 2 if self.causal else S * self.Sk)
        qb, kvb = B * S * H * D_ * el, B * self.Sk * KVH_ * D_ * el
        rowb = B * H * S * 4
        return {"fwd": (4 * D_ * pairs, 2 * qb + 2 * kvb + rowb),
                "dq": (6 * D_ * pairs, 4 * qb + 2 * kvb + 2 * rowb),
                "dkv": (8 * D_ * pairs, 2 * qb + 4 * kvb + 2 * rowb)}[role]

    def bound(self, role):
        """Least time (ms) and what sets it: the bytes over the memory
        rate, or the flops over the peak for the type; the larger."""
        flops, nbytes = self.work(role)
        peak = BF16_FLOPS if self.dtype == torch.bfloat16 else F32_FLOPS
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def times(self, timer):
        """Each kernel (by role), the plain forward and backward, and
        SDPA's forward and backward (the library yardstick, never called by
        the port), after checking SDPA agrees with the forward kernel:
        ``ms`` (events after an L2 flush) of all; then for the kernels and
        SDPA ``held_ms`` (the card held, so the device's span), the
        profiler's device time (``device_ms``) and the host's microseconds
        a call (``host_us``), after every event time."""
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
        fns = {
            "fwd": lambda: fa._launch_fwd(q, k, v, c, s, d),
            "dq": lambda: fa._launch_dq(q, k, v, o, lse, do, c, s, d),
            "dkv": lambda: fa._launch_dkv(q, k, v, o, lse, do, delta, c, s,
                                          d),
            "library_fwd": sdpa,
            "library_bwd": lambda: torch.autograd.grad(
                lib_o, (qt, kt, vt), dot, retain_graph=True),
        }
        t = {name: timer.ms(fn) for name, fn in fns.items()}
        t["plain_fwd"] = timer.ms(lambda: fwd_ref(q, k, v, c), n=5)
        t["plain_bwd"] = timer.ms(lambda: bwd_ref(q, k, v, o, lse, do, c),
                                  n=5)
        for name, fn in fns.items():
            t[f"{name}_held"] = timer.held_ms(fn)
            t[f"{name}_host_us"] = timer.host_us(fn)
        for name, fn in fns.items():        # the profiler last
            t[f"{name}_device"] = timer.device_ms(
                fn, FLASH_BODIES.get(name), exclude=("FillFunctor",))
        return t


def _ptxas_bodies(log, name):
    """{(D, direct): (registers, spill line, serialized)} of the kernel
    ``name`` from nvcc's -Xptxas -v report (a body without the ``direct``
    parameter counts as not direct); ``serialized``: ptxas warned that the
    body's wgmma instructions are serialized (C7520)."""
    import re
    out, lines = {}, log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(rf"Compiling entry function '(\S*{name}ILi(\d+)E"
                      rf"(?:Lb(\d)E)?\S*)'", line)
        if not m:
            continue
        regs = spill = None
        for nxt in lines[i + 1:i + 8]:
            if "Compiling entry function" in nxt:
                break
            spill = spill or (nxt.strip() if "spill" in nxt else None)
            r = re.search(r"Used (\d+) registers", nxt)
            regs = regs or (int(r.group(1)) if r else None)
        serialized = any("C7520" in x and m.group(1) in x for x in lines)
        out[(int(m.group(2)), bool(int(m.group(3) or 0)))] = (regs, spill,
                                                              serialized)
    return out


def _ptxas_report(ptxas, key, log):
    regs, spill, serialized = ptxas.get(key, (None, None, False))
    if spill:
        return (f"registers {regs}, {spill}"
                + ("; wgmma serialized (C7520)" if serialized else ""))
    return ("no report" if log else
            "not in this process (library from the build cache)")


def fwd_plan_check():
    """The bf16 forward's tile plan at every head_dim it takes, as the
    card's library compiled it (``flash_fwd_plan``), against the one
    ``ops/flash_attention.py`` records; no local memory (spills), and no
    setmaxnreg ignored by ptxas.  Prints each body's ptxas report; returns
    the plan at GPT-2's head_dim 64."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    log = _build.LOGS.get("flash_attention", "")
    if log:
        check("C7508" not in log and "setmaxnreg ignored" not in log,
              "ptxas ignored setmaxnreg in flash_attention.cu")
    ptxas = _ptxas_bodies(log, "fwd_bf16_sm90")
    plans = {}
    for D in sorted(fa.FWD_PLAN):
        want = fa.fwd_plan(D)
        check(want["smem"] <= fa.SMEM_PER_BLOCK,
              f"the forward's plan at D={D} takes {want['smem']} bytes")
        for direct in (False, True):
            got = fa.compiled_fwd_plan(D, direct)
            check(all(got[k] == v for k, v in want.items()),
                  f"forward plan D={D} direct={direct}: compiled {got}, "
                  f"recorded {want}")
            check(got["local_bytes"] == 0,
                  f"forward D={D} direct={direct} uses {got['local_bytes']} "
                  f"bytes of local memory (spills)")
            report = _ptxas_report(ptxas, (D, direct), log)
            print(f"flash forward fwd_bf16_sm90<{D}, {str(direct).lower()}> "
                  f"({'K4-fwd' if direct else 'K1'}): BQ {got['bq']} x BK "
                  f"{got['bk']}, {got['stages']} stages, {got['threads']} "
                  f"threads, dynamic shared memory {got['smem']} of "
                  f"{fa.SMEM_PER_BLOCK} bytes, static {got['static_smem']}; "
                  f"registers {got['registers']} a thread at entry "
                  f"(setmaxnreg: consumers 232, producer 40), local "
                  f"{got['local_bytes']} bytes; ptxas: {report}", flush=True)
            plans[(D, direct)] = got
    return plans[(64, False)]


def bwd_plan_check():
    """The bf16 backward's tile plans (K2 / K4-dq: dq_bf16_sm90, K3 /
    K4-dkv: dkv_bf16_sm90, the K4 bodies with ``direct``) at every
    head_dim they take, as the card's library compiled them
    (``flash_bwd_plan``), against the ones ``ops/flash_attention.py``
    records (K4-dkv with no q2 buffer); no local memory (spills), and no
    setmaxnreg ignored by ptxas.  Prints each body's ptxas report; returns
    the plans at GPT-2's head_dim 64, by ``direct``."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    log = _build.LOGS.get("flash_attention", "")
    if log:
        check("C7508" not in log and "setmaxnreg ignored" not in log,
              "ptxas ignored setmaxnreg in flash_attention.cu")
    ptxas = {body: _ptxas_bodies(log, body)
             for body in ("dq_bf16_sm90", "dkv_bf16_sm90")}
    plans = {}
    for D in sorted(fa.BWD_PLAN):
        for direct in (False, True):
            want = fa.bwd_plan(D, direct)
            got = fa.compiled_bwd_plan(D, direct)
            for role, body in (("dq", "dq_bf16_sm90"),
                               ("dkv", "dkv_bf16_sm90")):
                kern = ROLE_KERNEL[(role, direct)]
                w, g = want[role], got[role]
                check(w["smem"] <= fa.SMEM_PER_BLOCK,
                      f"the {kern} plan at D={D} takes {w['smem']} bytes")
                check(all(g[k] == v for k, v in w.items()),
                      f"{kern} plan D={D}: compiled {g}, recorded {w}")
                check(g["local_bytes"] == 0,
                      f"{kern} D={D} uses {g['local_bytes']} bytes of local "
                      f"memory (spills)")
                report = _ptxas_report(ptxas[body], (D, direct), log)
                tiles = (f"{g['bq']} q rows x {g['bk']} keys a k tile" if
                         role == "dq" else
                         f"{g['bk']} keys x {g['bq']} q rows a q tile, "
                         f"{g['q2']} q2 buffers, "
                         f"{'split dV / dK' if g['split'] else 'dK and dV'} "
                         f"a warpgroup")
                print(f"flash backward {body}<{D}, {str(direct).lower()}> "
                      f"({kern}): {tiles}, {g['stages']} stages, "
                      f"{g['threads']} threads, dynamic shared memory "
                      f"{g['smem']} of {fa.SMEM_PER_BLOCK} bytes, static "
                      f"{g['static_smem']}; registers {g['registers']} a "
                      f"thread at entry (setmaxnreg: consumers 232, producer "
                      f"40), local {g['local_bytes']} bytes; ptxas: {report}",
                      flush=True)
            plans[(D, direct)] = got
    return {direct: plans[(64, direct)] for direct in (False, True)}


def flash_kernel_phase(dev, timer):
    """The forward's plan, then K1-K3 against their plain versions in every
    case of FLASH_CASES and K4 in every case of K4_CASES, then timed at the
    FLASH_TIMED shapes.  Returns the six kernels' lines (launches filled in
    by the training phase)."""
    plan = fwd_plan_check()
    bplan = bwd_plan_check()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs, timed = {}, {}
    for direct, cases in ((False, FLASH_CASES), (True, K4_CASES)):
        for case in cases:
            c = FlashCase(*case[:8], gen, dev, direct=direct,
                          **(case[8] if len(case) > 8 else {}))
            for kern, e in c.check().items():
                errs.setdefault((kern, c.dtype), []).append(e)
            if c.tag in FLASH_TIMED[direct]:
                timed[(direct, c.tag)] = (c, c.times(timer))
            else:
                del c
            torch.cuda.empty_cache()
    lines = []
    for name, kern, role, direct, replaces in FLASH_KERNELS:
        row = {}
        fwd = role == "fwd"
        lib = "library_fwd" if fwd else "library_bwd"
        for tag in FLASH_TIMED[direct]:
            c, t = timed[(direct, tag)]
            bound_ms, bound_by = c.bound(role)
            flops = c.work(role)[0]
            r = dict(ms=t[role], held_ms=t[f"{role}_held"],
                     device_ms=t[f"{role}_device"],
                     host_us=t[f"{role}_host_us"],
                     tflops=flops / t[f"{role}_held"] / 1e9,
                     bound_share=bound_ms / t[f"{role}_held"],
                     plain_ms=t["plain_fwd" if fwd else "plain_bwd"],
                     library_ms=t[lib], library_held_ms=t[f"{lib}_held"],
                     library_device_ms=t[f"{lib}_device"],
                     library_host_us=t[f"{lib}_host_us"],
                     bound_ms=bound_ms, bound_by=bound_by)
            if fwd:
                r["library_tflops"] = flops / t[f"{lib}_held"] / 1e9
            row[tag] = r
            B, S, H, KVH_, D_ = c.shape
            print(f"{name} ({kern}) {tag} bf16 B={B} S={S} H={H} KVH={KVH_} "
                  f"D={D_} {'causal' if c.causal else 'non-causal'}: kernel {r['ms']:.4f} ms, held "
                  f"{r['held_ms']:.4f}, device {r['device_ms']:.4f} "
                  f"(profiler), host {r['host_us']:.2f} us a call, "
                  f"{r['tflops']:.1f} TFLOP/s (held), "
                  f"{100 * r['bound_share']:.1f}% of the bound "
                  f"{bound_ms:.4f} ms ({bound_by}); plain "
                  f"{r['plain_ms']:.4f} ms{'' if fwd else ' (dq + dk/dv together)'}; "
                  f"{'SDPA forward' if fwd else 'SDPA backward (dq, dk, dv together)'} "
                  f"{r['library_ms']:.4f} ms, held {r['library_held_ms']:.4f}"
                  f", device {r['library_device_ms']:.4f}, host "
                  f"{r['library_host_us']:.2f} us"
                  + (f", {r['library_tflops']:.1f} TFLOP/s" if fwd else ""),
                  flush=True)
        g = row.pop("gpt2")
        plain = ("bshd_fwd_ref" if direct else "flash_fwd_ref") if fwd else (
            f"{'bshd' if direct else 'flash'}_bwd_ref (dq, dk, dv together)")
        line = {
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
            **g,
            "library": ("SDPA forward" if fwd else
                        "SDPA backward (dq, dk, dv together)"),
            "plain": plain,
            "shape": "GPT-2 bench: bf16 B=16 S=1024 H=12 D=64 causal",
            "readings": ("ms: events after an L2 flush; held_ms: the same "
                         "with the card held in a spin first (the device's "
                         "span); device_ms: profiler kernel time (SDPA: every "
                         "kernel but the flush's fill); host_us: host time a "
                         "call; tflops and bound_share from held_ms"),
            **row,
        }
        if fwd:
            line["design"] = FWD_DESIGN
            line["plan"] = {k: plan[k] for k in ("bq", "bk", "stages",
                                                 "smem", "threads",
                                                 "registers")}
        else:
            line["design"] = BWD_DESIGN
            line["plan"] = {k: v for k, v in bplan[direct][role].items()
                            if k not in ("local_bytes", "static_smem",
                                         "max_threads")}
        lines.append(line)
    timed.clear()
    torch.cuda.empty_cache()
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


def tiny_f32_model(dev, hidden=256, heads=2, kv_heads=1, ffn=512):
    """A 2-layer float32 Llama from seeded numpy weights, bridged through
    llama_from_numpy; returns the model and the generator that drew its
    weights (prompts come from it next)."""
    from paddle_tpu_torch.models.convert import llama_from_numpy
    from paddle_tpu_torch.models.llama_module import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=hidden, num_attention_heads=heads,
                           num_key_value_heads=kv_heads,
                           intermediate_size=ffn)
    rng = np.random.RandomState(SEED)
    state = {}
    shapes = _jax_shapes(LlamaForCausalLM(cfg, device="cpu"))
    for name, shape in shapes.items():
        state[name] = (1.0 + 0.1 * rng.randn(*shape) if name.endswith(
            "norm.weight") else 0.08 * rng.randn(*shape)).astype(np.float32)
    return llama_from_numpy(state, cfg, device=dev), rng


def tiny_prompts(rng, vocab):
    """The tiny engines' four prompts, drawn from ``rng`` after the
    weights: 5, 16 and 21 random tokens, and a 6-token pattern three times
    (something for the n-gram proposer to draft from)."""
    pattern = list(rng.randint(0, vocab, 6))
    prompts = [rng.randint(0, vocab, n) for n in (5, 16, 21)]
    return prompts + [np.asarray(pattern * 3)]


def tiny_f32_engine(dev, hidden=256, heads=2, kv_heads=1, ffn=512):
    """The tiny float32 Llama (:func:`tiny_f32_model`) served on the card
    and checked token by token; then the same requests with int8 pages,
    speculative decoding, both, and the model as its own draft model, each
    token-identical to the plain engine of its KV dtype."""
    from paddle_tpu_torch.inference.serving import LLMEngine, SpecConfig
    model, rng = tiny_f32_model(dev, hidden, heads, kv_heads, ffn)
    d = hidden // heads
    prompts = tiny_prompts(rng, model.config.vocab_size)

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
        # a failed dispatch (a capture that raised) is retried by the
        # engine's step isolation and would pass unseen
        check(eng.step_failures == 0, f"tiny f32 D={d} {kw}: "
              f"{eng.step_failures} steps failed")
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
    from paddle_tpu_torch.models.llama_module import LlamaConfig, LlamaForCausalLM
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
    steps = []            # (seconds, kind, tokens emitted, drafting seconds)
    drafting = []                  # seconds in the proposer, per call
    step = eng.step
    gen0 = program_totals(None, model)

    def timed_step():
        pf, vf = eng.prefill_dispatches, eng.spec_dispatches
        emitted = eng.spec_emitted
        caps = program_totals(eng, model)["captures"]
        prefilled = sum(r.pos for r in eng.sched.slots if r is not None)
        d0 = sum(drafting)
        a = time.perf_counter()
        served = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - a
        # a step that captured a program (the runner's or the drafter's)
        # is kept out of the steady-state rates and reported on its own
        tail = (" capture" if program_totals(eng, model)["captures"] != caps
                else "")
        drafted = sum(drafting) - d0
        if eng.prefill_dispatches != pf:
            steps.append((dt, "prefill" + tail, sum(
                r.pos for r in eng.sched.slots if r is not None) - prefilled,
                drafted))
        elif eng.spec_dispatches != vf:
            steps.append((dt, "verify" + tail, eng.spec_emitted - emitted,
                          drafted))
        else:
            steps.append((dt, "decode" + tail, served, drafted))
        return served

    eng.step = timed_step
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
    progs = eng.runner.program_stats()
    totals = program_totals(eng, None)
    gen = {k: v - gen0[k] for k, v in program_totals(None, model).items()}
    print(f"engine {tag}: runner programs "
          + ", ".join(f"{name} {st['captures']} captured in "
                      f"{st['capture_s']:.2f} s, {st['replays']} replays, "
                      f"{st['eager']} eager, launches a replay "
                      f"{st['launches_a_replay']}"
                      for name, st in progs.items())
          + f"; generate's decode steps (the drafter) {gen['captures']} "
          f"captured in {gen['capture_s']:.2f} s, {gen['replays']} replays, "
          f"{gen['eager']} eager", flush=True)
    # every request is greedy: each dispatch is a graph replay but the
    # capturing one of each program
    check(totals["eager"] == 0 and gen["eager"] == 0,
          f"engine {tag}: {totals['eager']} eager dispatches and "
          f"{gen['eager']} eager generate steps, all requests greedy")
    check(totals["replays"] + totals["captures"]
          == n_prefill + n_decode + n_verify,
          f"engine {tag}: {totals} program runs for "
          f"{n_prefill + n_decode + n_verify} dispatches")
    check(totals["replays"] > 0, f"engine {tag}: no program replayed")
    check(eng.step_failures == 0,
          f"engine {tag}: {eng.step_failures} steps failed")
    if spec:
        check(gen["replays"] > 0,
              f"engine {tag}: the drafter's generate replayed no decode step")
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
        secs = sum(s for s, k, _, _ in steps if k == kind)
        toks = sum(n for _, k, n, _ in steps if k == kind)
        return (toks / secs if secs else None), secs, sum(
            1 for _, k, _, _ in steps if k == kind)

    ttft = sorted(eng.ttft(r) for r in rids)
    captured = [s for s, k, _, _ in steps if k.endswith("capture")]
    # the drafting of the verify steps that captured no program
    draft_steady = [d for _, k, _, d in steps if k == "verify"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    agree = None
    window = None
    if profile:
        eng.step = step
        if spec:
            eng._proposer.propose = propose
            agree = graph_against_eager(eng, tag, ("verify",))
            window = profile_verify(eng, prompts, tag)
        else:
            agree = graph_against_eager(eng, tag, ("decode", "prefill"))
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
        "verify_only_ms": (1e3 * (rate("verify")[1] - sum(draft_steady))
                           / rate("verify")[2] if rate("verify")[2]
                           else None),
        "draft_s": sum(drafting),
        "draft_step_s": (sum(draft_steady) / len(draft_steady)
                         if draft_steady else None),
        "capture_steps": len(captured),
        "capture_step_s": sum(captured),
        "capture_s": totals["capture_s"] + gen["capture_s"],
        "programs": progs, "generate_programs": gen,
        "graph_against_eager": agree,
        "prefill_tok_s": rate("prefill")[0],
        "wall_s": wall,
        "dispatches": {"prefill": n_prefill, "decode": n_decode,
                       "verify": n_verify},
        "launches": launches,
        "peak_mem_gib": peak,
        "outputs": [[int(t) for t in eng.result(r)] for r in rids],
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


def program_totals(eng, model):
    """Captures, replays, eager runs and capture seconds summed over the
    engine's runner programs and the model's stored ``generate`` states
    (either may be None)."""
    stats = list(eng.runner.program_stats().values()) if eng else []
    if model is not None:
        stats += [e["step"].stats() for e in model._gen_states.values()]
    return {k: sum(st[k] for st in stats)
            for k in ("captures", "replays", "eager", "capture_s")}


def graph_against_eager(eng, tag, kinds):
    """The engine's captured programs against their own bodies run
    eagerly, on the engine's buffers: for each of ``kinds`` (the decode
    block, the prefill chunk, the verify step with the most rows), with
    the inputs its last dispatch left in its buffers, replay the graph,
    then put the cache back as it was before the replay and run the same
    body uncaptured on copies of the same inputs.  The tokens must be
    identical and the logits within the bf16 bar of the largest; prints
    whether they are bitwise equal."""
    r = eng.runner
    progs = {"decode": r._decode_programs.get(1),
             "prefill": r._prefill_program,
             "verify": (r._verify_programs[max(r._verify_programs)]
                        if r._verify_programs else None)}
    out = {}
    for kind in kinds:
        prog = progs[kind]
        check(prog is not None and prog.graph is not None,
              f"engine {tag}: no captured {kind} program")
        inputs = {n: b.clone() for n, b in prog.buffers.items()}
        saved = tuple(a.clone() for a in r.cache)
        with torch.no_grad():
            replay = prog.run(inputs)
            after = tuple(a.clone() for a in r.cache)
            r.load_cache(saved)
            eager = prog.run_eager(inputs)
        torch.cuda.synchronize()
        err = _rel_err(replay[1], eager[1])
        res = {"program": prog.name, "tokens_equal": torch.equal(
                   replay[0], eager[0]),
               "logits_err": err, "logits_bitwise": torch.equal(
                   replay[1], eager[1]),
               # the trash page aside: rows that write no live page all
               # land there, and which of them wins is not defined
               "cache_bitwise": all(
                   torch.equal(a[:, :r.trash_page], b[:, :r.trash_page])
                   for a, b in zip(after, r.cache))}
        print(f"engine {tag}: {prog.name} replayed against its body run "
              f"eagerly on the same inputs and cache: tokens "
              f"{'identical' if res['tokens_equal'] else 'DIFFER'}, logits "
              f"within {err:.2e} of the largest (tol "
              f"{TOL[torch.bfloat16]:.0e}), bitwise equal: logits "
              f"{res['logits_bitwise']}, cache {res['cache_bitwise']}",
              flush=True)
        check(res["tokens_equal"] and err <= TOL[torch.bfloat16],
              f"engine {tag}: {prog.name} replay and eager body disagree "
              f"({res})")
        out[kind] = res
        del saved, after
    return out


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
    replays = program_totals(eng, None)["replays"]
    wall, busy, rows = profile_window(eng, tag, "decode", n_steps)
    k5 = sum(ms for key, _, ms in rows
             if any(m in key for m in SPLIT_KERNELS))
    seen = sum(n for key, n, _ in rows if SPLIT_KERNELS[0] in key)
    L = eng.runner.cfg.num_hidden_layers
    replays = program_totals(eng, None)["replays"] - replays
    print(f"profile {tag} decode: K5 {k5:.3f} ms of device busy "
          f"{busy:.1f} ms ({100 * k5 / busy:.2f}%); the profiler saw "
          f"{seen} of K5's split launches, layers x steps = "
          f"{L * n_steps}; {replays} graph replays in the window",
          flush=True)
    check(k5 > 0 and seen > 0, f"profile {tag}: the decode window ran no "
          f"K5 that the profiler saw ({seen} launches, {k5} ms)")
    check(replays == n_steps, f"profile {tag}: {replays} replays in "
          f"{n_steps} decode steps")
    eng.run_until_done()
    return {"wall_ms": wall, "busy_ms": busy, "kernel_ms": k5,
            "steps": n_steps, "batch": batch, "launches_seen": seen,
            "launches_expected": L * n_steps}


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
    seen = sum(n for key, n, _ in rows if SPLIT_KERNELS[0] in key)
    verify = eng.spec_dispatches - v0
    L = eng.runner.cfg.num_hidden_layers
    secs = time.perf_counter() - t0
    print(f"profile {tag} verify: batch {batch}, the re-serve and its "
          f"window took {secs:.1f} s; the profiler saw {seen} of K7's split "
          f"launches, layers x verify dispatches = {L * verify}", flush=True)
    check(verify > 0 and k7 > 0 and seen > 0,
          f"profile {tag}: the window ran {verify} verify dispatches and "
          f"{k7} ms of K7 over {seen} launches the profiler saw")
    return {"wall_ms": wall, "busy_ms": busy, "kernel_ms": k7,
            "verify_dispatches": verify, "steps": n_steps, "batch": batch,
            "cost_s": secs, "launches_seen": seen,
            "launches_expected": L * verify}


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
          f"{f(e2e['prefill_tok_s'], '.1f')} tok/s, drafting "
          f"{e2e['draft_s']:.2f} s ({f(e2e['draft_step_s'], '.4f')} s a "
          f"verify step), {e2e['capture_steps']} steps that captured a "
          f"program ({e2e['capture_step_s']:.2f} s, kept out of the rates; "
          f"capture {e2e['capture_s']:.2f} s), wall {e2e['wall_s']:.2f} s, "
          f"peak memory {e2e['peak_mem_gib']:.2f} GiB, batch 8, on {card}",
          flush=True)


def engine_phase(dev, card):
    """The float32 checks first (tiny bridged model with every option, then
    full width, both held to the dense reference almost exactly); then the
    bfloat16 engines at full width on one model: the default path (K5,
    profiled: a decode window, device busy and K5's share), speculative
    decoding (K5 + K7, a window of its verify steps
    profiled), and int8 pages with speculative decoding (K6 + K7q).
    Returns each kernel's launches on the run of its path, the decode and
    verify windows, and the bf16 engine's run (for the front door's
    rates)."""
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
                      "verify": runs["bf16 spec"]["window"]}, runs["bf16"]


# ------------------------------------------------------ phase: front door
ROOT = Path(__file__).resolve().parent
FLEET_TTL = 3.0              # lease TTL of the fleet's workers, seconds
FLEET_KILL_AT = 8            # SIGKILL once every stream has this many tokens
WORKER_READY_S = 300         # a worker's start, model and engine included
# the fleet workers' engine factory (``--engine-spec``)
FLEET_ENGINE_SPEC = f"{ROOT / 'chip_smoke.py'}:make_engine"


def front_door_engine(model, dev):
    """The engine phase's bf16 settings with prefix caching on: the router
    routes by the engine's cached prompt pages."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    return LLMEngine(model, device=dev, max_batch=8, max_len=1024,
                     page_size=PAGE, prefill_chunk=32, prefix_cache=True)


def make_engine():
    """Engine factory of the fleet's worker processes
    (``--engine-spec chip_smoke.py:make_engine``): the seeded Llama-3-8B
    bf16 model on the card behind :func:`front_door_engine`.  Its
    ``health`` also reports the process's device memory."""
    dev = torch.device("cuda", 0)
    eng = front_door_engine(full_width_model(torch.bfloat16, dev), dev)
    health = eng.health

    def health_with_memory():
        h = health()
        h["mem_gib"] = torch.cuda.memory_allocated(dev) / 2 ** 30
        h["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        h["reserved_gib"] = torch.cuda.memory_reserved(dev) / 2 ** 30
        return h

    eng.health = health_with_memory
    return eng


def sse_stream(url, prompt, n, key=None, on_token=None):
    """One streamed ``POST /v1/completions``; returns the tokens with their
    SSE indices and arrival times, and the final event's status and
    replica.  ``key``: the durable gateway's ``Idempotency-Key``."""
    import urllib.request
    headers = {"Content-Type": "application/json"}
    if key is not None:
        headers["Idempotency-Key"] = key
    req = urllib.request.Request(
        url + "/v1/completions", method="POST", headers=headers,
        data=json.dumps({"prompt": [int(t) for t in prompt],
                         "max_tokens": int(n), "stream": True}).encode())
    out = {"tokens": [], "index": [], "times": [], "status": None,
           "replica": None, "t0": time.perf_counter()}
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            evt = json.loads(line[len("data: "):])
            if "token" in evt:
                out["tokens"].append(int(evt["token"]))
                out["index"].append(int(evt["index"]))
                out["times"].append(time.perf_counter())
                if on_token is not None:
                    on_token(len(out["tokens"]))
            else:
                out["status"] = evt.get("status")
                out["replica"] = evt.get("replica")
    return out


def run_clients(fn, args, timeout=900):
    """``fn(*a)`` for each ``a`` of ``args``, each in a thread of its own;
    returns the results in order, or raises with every client's error."""
    results, errors = [None] * len(args), []

    def client(i):
        try:
            results[i] = fn(*args[i])
        except Exception as e:  # every client's error is reported
            errors.append(f"client {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    check(not any(t.is_alive() for t in threads),
          f"clients still running after {timeout} s")
    check(not errors, "; ".join(errors))
    return results


def fresh_thread_launch(dev):
    """K5 launched from a thread that made no CUDA call before (as a
    replica's step thread or a worker's RPC thread is), held to its plain
    version at the decode shape."""
    from paddle_tpu_torch.ops.paged_attention import (paged_attention,
                                                      paged_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, S = 8, 8
    q = torch.randn(B, H, D, device=dev, dtype=torch.bfloat16, generator=gen)
    kp, vp = (torch.randn(B * S + 1, PAGE, KVH, D, device=dev,
                          dtype=torch.bfloat16, generator=gen)
              for _ in range(2))
    tables = torch.arange(1, B * S + 1, device=dev,
                          dtype=torch.int32).view(B, S)
    lens = torch.tensor([1, 17, 33, 64, 100, 127, 128, 77], device=dev,
                        dtype=torch.int32)
    want = paged_attention_ref(q, kp, vp, tables, lens)
    box = {}

    def launch():
        try:
            box["out"] = paged_attention(q, kp, vp, tables, lens)
            torch.cuda.synchronize(dev)
        except Exception as e:  # reported below
            box["error"] = e

    t = threading.Thread(target=launch)
    t.start()
    t.join(timeout=120)
    check("out" in box, f"K5 from a fresh thread: {box.get('error')!r}")
    err = (box["out"].float() - want.float()).abs().max().item()
    bar = TOL[torch.bfloat16] * want.float().abs().max().item()
    check(err <= bar, f"K5 from a fresh thread: error {err} > {bar}")
    print(f"front door: K5 launched from a fresh thread (no CUDA call "
          f"before it) agrees with its plain version, max |err| {err:.2e} "
          f"(bar {bar:.2e})", flush=True)


def engine_results(eng):
    """{prompt: output tokens} of every request the engine finished."""
    return {tuple(r.prompt0): [int(t) for t in eng.result(rid)]
            for rid, r in eng.sched.finished.items()}


def _dispatches(eng):
    """The engine's prefill, decode and verify dispatches, from its
    registry series (observability on)."""
    snap = eng.metrics()
    return {kind: int(sum(s["value"] for s in
                          snap["serving_dispatches_total"]["series"]
                          if s["labels"].get("kind") == kind))
            for kind in ("prefill", "decode", "verify")}


def replica_identity(tag, name, eng, L):
    """One in-process replica's programs: captured, 0 eager, and its K5
    launches (each program's runs times the launches a replay makes) =
    layers x its prefill + decode dispatches.  Returns its dispatches and
    a printable line."""
    n = _dispatches(eng)
    progs = eng.runner.program_stats()
    totals = program_totals(eng, None)
    k5 = sum((st["captures"] + st["replays"])
             * st["launches_a_replay"].get("paged_attention.launches", 0)
             for st in progs.values())
    check(totals["captures"] > 0, f"{tag} {name}: no program captured")
    check(eng.step_failures == 0,
          f"{tag} {name}: {eng.step_failures} steps failed")
    check(totals["eager"] == 0,
          f"{tag} {name}: {totals['eager']} eager dispatches, all greedy")
    check(totals["captures"] + totals["replays"]
          == n["prefill"] + n["decode"] + n["verify"],
          f"{tag} {name}: {totals} program runs for {n} dispatches")
    check(k5 == L * (n["prefill"] + n["decode"]),
          f"{tag} {name}: K5 {k5} launches != {L} x {n}")
    wait = sum(st["capture_wait_s"] for st in progs.values())
    line = (f"{tag} {name}: {n['prefill']} prefill + {n['decode']} decode "
            f"dispatches, {totals['captures']} programs captured in "
            f"{totals['capture_s']:.2f} s ({wait:.2f} s waiting for the "
            f"other replica's capture), {totals['replays']} replays, "
            f"{totals['eager']} eager, {len(eng.sched.finished)} requests "
            f"served, K5 {k5} launches = {L} x "
            f"{n['prefill'] + n['decode']}")
    return n["prefill"] + n["decode"], line


def gateway_phase(dev, card, direct):
    """Llama-3-8B bf16 behind the in-process front door: two engines on
    one model, each with its own step thread, a prefix-affinity
    ``ReplicaSet`` and the SSE gateway; the engine phase's eight prompts
    from eight concurrent ``http_completion`` clients, then two requests
    sharing a two-page prefix, the second sent once the first has its
    first token.  ``direct``: the direct bf16 engine's run, for the
    rates."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.frontend import (PrefixAffinityRouter,
                                                     ReplicaSet,
                                                     http_completion,
                                                     start_gateway)
    model = full_width_model(torch.bfloat16, dev)
    cfg = model.config
    L = cfg.num_hidden_layers
    engines = {"r0": front_door_engine(model, dev),
               "r1": front_door_engine(model, dev)}
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    shared = list(rng.randint(0, cfg.vocab_size, 2 * PAGE))
    pair = [shared + list(rng.randint(0, cfg.vocab_size, n)) for n in (5, 9)]
    torch.cuda.reset_peak_memory_stats()
    obs.enable()
    rs = ReplicaSet(list(engines.items()),
                    router=PrefixAffinityRouter(page_size=PAGE))
    gw = start_gateway(rs, port=0)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        streams = run_clients(
            lambda p: http_completion(gw.url, [int(t) for t in p],
                                      max_tokens=NEW_TOKENS, stream=True,
                                      timeout=600),
            [(p,) for p in prompts])
        wall = time.perf_counter() - t0
        first_token = threading.Event()
        holder = {}

        def first():
            holder["out"] = sse_stream(gw.url, pair[0], NEW_TOKENS,
                                       on_token=lambda n: first_token.set())

        t = threading.Thread(target=first)
        t.start()
        check(first_token.wait(300), "the shared-prefix pair's first "
              "request never streamed a token")
        hits0 = {n: e.prefix_cache_stats()["hits"]
                 for n, e in engines.items()}
        routed0 = obs.snapshot(prefix="frontend_routed")
        second = sse_stream(gw.url, pair[1], NEW_TOKENS)
        t.join(timeout=300)
        check("out" in holder, "the pair's first request did not finish")
        hits = {n: e.prefix_cache_stats()["hits"] - hits0[n]
                for n, e in engines.items()}
        routed = obs.snapshot(prefix="frontend_routed")
        launches = launch_counts()
        ids = [replica_identity("gateway", n, e, L)
               for n, e in engines.items()]
    finally:
        gw.close()
        rs.close()
        obs.disable()
    first_out = holder["out"]

    def affinity(snap):
        fam = snap.get("frontend_routed_total", {"series": []})
        return {s["labels"]["replica"]: s["value"] for s in fam["series"]
                if s["labels"].get("reason") == "affinity"}

    a0, a1 = affinity(routed0), affinity(routed)
    to = first_out["replica"]
    check(second["replica"] == to, f"the pair's second request went to "
          f"{second['replica']}, the first to {to}")
    check(a1.get(to, 0) - a0.get(to, 0) == 1,
          f"the second request was not routed by affinity ({a0} -> {a1})")
    check(hits[to] >= 2, f"the second request hit {hits[to]} cached pages "
          f"on {to}, its prefix is two")
    results = {}
    for e in engines.values():
        results.update(engine_results(e))
    outs = [s["tokens"] for s in streams] + [first_out["tokens"],
                                             second["tokens"]]
    finals = [s["status"] for s in streams] + [first_out["status"],
                                               second["status"]]
    all_prompts = [list(map(int, p)) for p in prompts] + pair
    for i, (p, out, status) in enumerate(zip(all_prompts, outs, finals)):
        check(status == "finished", f"gateway stream {i} ended {status}")
        check(len(out) == NEW_TOKENS, f"gateway stream {i}: {len(out)} "
              f"tokens")
        check(out == results.get(tuple(p)), f"gateway stream {i}: the SSE "
              f"tokens differ from the serving engine's result()")
    for line in (line for _, line in ids):
        print(line, flush=True)
    total = sum(n for n, _ in ids)
    expected = {k: 0 for k in launches}
    expected["K5"] = L * total
    check(launches == expected, f"gateway launches {launches} != "
          f"{expected} (layers x both replicas' dispatches)")
    counts, worst = np.zeros(3, int), 0.0
    for p, out in zip(all_prompts, outs):
        c, w = teacher_forced_check(model, np.asarray(p), out, GAP, dev)
        counts, worst = counts + c, max(worst, w)
    ttft = sorted(e.ttft(rid) for e in engines.values()
                  for rid in e.sched.finished)
    first8 = sorted(engines[n].ttft(rid) for n in engines
                    for rid, r in engines[n].sched.finished.items()
                    if tuple(r.prompt0) in {tuple(map(int, p))
                                            for p in prompts})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = {"ttft_p50_s": float(np.median(first8)), "ttft_max_s": first8[-1],
           "tok_s": len(prompts) * NEW_TOKENS / wall, "wall_s": wall,
           "peak_mem_gib": peak, "launches_k5": launches["K5"]}
    print(f"gateway: {len(outs)} SSE streams (8 concurrent + a shared-"
          f"prefix pair, the second routed by affinity to {to} with "
          f"{hits[to]} cached pages hit) FINISHED with {NEW_TOKENS} tokens, "
          f"each the serving engine's result(); teacher-forced check of "
          f"{NEW_TOKENS * len(outs)} tokens passed: "
          f"{describe(counts, worst, GAP)}; K5 {launches['K5']} launches = "
          f"{L} x {total} dispatches", flush=True)
    print(f"gateway: 8 concurrent streams over two replicas, TTFT p50 "
          f"{res['ttft_p50_s']:.4f} s, max {res['ttft_max_s']:.4f} s "
          f"(engine-side; all ten {ttft[0]:.4f}-{ttft[-1]:.4f}), "
          f"{res['tok_s']:.1f} tokens/s end to end ({len(prompts)} x "
          f"{NEW_TOKENS} tokens in {wall:.2f} s, captures included); the "
          f"direct bf16 engine: TTFT p50 {direct['ttft_p50_s']:.4f} s, max "
          f"{direct['ttft_max_s']:.4f} s, {8 * NEW_TOKENS / direct['wall_s']:.1f}"
          f" tokens/s end to end ({direct['wall_s']:.2f} s, captures "
          f"included), decode {direct['decode_tok_s']:.1f} tokens/s; peak "
          f"memory {peak:.2f} GiB (one model, two engines), on {card}",
          flush=True)
    # the gateway handle holds the replica set, and with it the engines
    # and the model: drop every reference before the fleet's workers
    del gw, rs, engines, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _worker_logs(paths, tail=2000):
    for p in paths:
        try:
            text = Path(p).read_text()[-tail:]
        except OSError:
            continue
        print(f"--- worker log {p} (tail)\n{text}", flush=True)


def fleet_phase(dev, card, store):
    """Two supervised worker processes, each serving the seeded Llama-3-8B
    bf16 engine (:func:`make_engine`), leased through ``store``; a
    ``FleetReplicaSet`` behind the durable gateway; the engine phase's
    eight prompts streamed over HTTP; one worker SIGKILLed once every
    stream has ``FLEET_KILL_AT`` tokens.  Its streams resume on the
    survivor, the supervisor respawns it and it rejoins through
    membership.  Then the workers stop and the dense reference, built here
    from the same seed, checks every stream."""
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.inference.frontend import (FleetReplicaSet,
                                                     WorkerSupervisor,
                                                     start_gateway)
    from paddle_tpu_torch.models.llama_module import LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    print(f"fleet: before the workers, this process holds "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} reserved; the "
          f"card has {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free",
          flush=True)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    journal = tempfile.mkdtemp(prefix="chip_smoke_journal_", dir=scratch)
    logs, procs = [], []
    group = "smoke-fleet"

    def spawner(name):
        def spawn():
            log = scratch / f"chip_smoke_{name}_{len(procs)}.log"
            logs.append(log)
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "paddle_tpu_torch.inference.frontend.worker",
                     "--engine-spec", FLEET_ENGINE_SPEC,
                     "--name", name, "--store-port", str(store.port),
                     "--group", group, "--ttl", str(FLEET_TTL)],
                    cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT))
            return procs[-1]
        return spawn

    sups = {n: WorkerSupervisor(spawner(n), name=n, base_delay=0.1,
                                max_crashes=3, crash_window=600.0)
            for n in ("w0", "w1")}
    fleet = FleetReplicaSet(TCPStore(port=store.port, timeout=60),
                            group=group, ttl=FLEET_TTL, page_size=PAGE)
    gw = None
    t_start = time.perf_counter()
    try:
        for sup in sups.values():
            sup.start(interval=0.2)
        fleet.start_sync(0.2)
        deadline = time.monotonic() + WORKER_READY_S
        while (len(fleet.alive_replicas()) < 2
               and time.monotonic() < deadline):
            check(all(p.poll() is None for p in procs),
                  "a fleet worker exited while starting")
            time.sleep(0.5)
        check(len(fleet.alive_replicas()) == 2,
              f"fleet workers did not join within {WORKER_READY_S} s")
        ready_s = time.perf_counter() - t_start
        gw = start_gateway(fleet, port=0, journal_dir=journal)
        progress = [0] * len(prompts)
        keys = [f"c{i}" for i in range(len(prompts))]
        box = {}

        def clients():
            box["streams"] = run_clients(
                lambda i, p: sse_stream(
                    gw.url, p, NEW_TOKENS, key=keys[i],
                    on_token=lambda n: progress.__setitem__(i, n)),
                [(i, p) for i, p in enumerate(prompts)])

        runner = threading.Thread(target=clients)
        t0 = time.perf_counter()
        runner.start()
        # the victim, once every stream is routed: the worker with the most
        # unfinished streams (one worker can finish its streams before the
        # other has streamed its first tokens), killed once each of those
        # has FLEET_KILL_AT tokens
        deadline = time.monotonic() + 600
        victim = before = None
        pids = {n: m.meta["pid"]
                for n, m in fleet.membership.members().items()}
        while victim is None and time.monotonic() < deadline:
            on = {}
            for k in keys:
                r = gw.plane.get(k)
                if r is not None and r.handle is not None:
                    on[k] = r.handle.replica.name
            if len(on) == len(keys) and before is None:
                # the workers' health under load, read before the victim
                # is picked: the RPCs take long enough for a worker near
                # its last tokens to finish every stream before the kill
                before = {n: fleet.replica(n).health() for n in ("w0", "w1")}
                continue
            if len(on) == len(keys):
                open_ = {n: [progress[i] for i, k in enumerate(keys)
                             if on[k] == n and progress[i] < NEW_TOKENS]
                         for n in ("w0", "w1")}
                most = max(open_, key=lambda n: (len(open_[n]), n == "w0"))
                if open_[most] and min(open_[most]) >= FLEET_KILL_AT:
                    victim = most
            time.sleep(0.002)
        check(victim is not None, f"streams never reached {FLEET_KILL_AT} "
              f"tokens ({progress})")
        pid = pids[victim]
        at_kill = list(progress)
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        runner.join(timeout=900)
        check("streams" in box, "fleet clients did not finish")
        streams = box["streams"]
        wall = time.perf_counter() - t0
        handles = {k: gw.plane.get(k).handle for k in on}
        deadline = time.monotonic() + WORKER_READY_S
        while time.monotonic() < deadline:
            m = fleet.membership.members().get(victim)
            rep = next((r for r in fleet.alive_replicas()
                        if r.name == victim), None)
            if m is not None and m.epoch >= 2 and rep is not None \
                    and rep.epoch == m.epoch:
                break
            time.sleep(0.5)
        members = fleet.membership.members()
        check(victim in members and members[victim].epoch == 2,
              f"the respawned {victim} did not rejoin "
              f"({ {k: v.epoch for k, v in members.items()} })")
        rejoin_s = time.perf_counter() - t_kill
        check(sups[victim].restarts == 1,
              f"{victim} restarted {sups[victim].restarts} times")
        after = {n: fleet.replica(n).health() for n in ("w0", "w1")}
        smi = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        free_end = torch.cuda.mem_get_info(dev)[0]
    except BaseException:
        _worker_logs(logs)
        raise
    finally:
        if gw is not None:
            gw.close()
        fleet.close()
        for sup in sups.values():
            sup.stop(term_timeout=30.0)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    victims = sorted(k for k, n in on.items() if n == victim)
    check(any(at_kill[int(k[1:])] < NEW_TOKENS for k in victims),
          f"no stream on {victim} was mid-way at the kill ({on}, "
          f"{at_kill})")
    resumed = []
    for i, st in enumerate(streams):
        k = f"c{i}"
        check(st["status"] == "finished", f"fleet stream {k} ended "
              f"{st['status']}")
        check(st["index"] == list(range(NEW_TOKENS)),
              f"fleet stream {k}: SSE indices {st['index']} (a gap or a "
              f"duplicate)")
        kept = [t for t, at in zip(st["tokens"], st["times"]) if at < t_kill]
        check(len(kept) >= at_kill[i], f"fleet stream {k}: {len(kept)} "
              f"tokens before the kill, {at_kill[i]} seen then")
        if handles[k].resumed:
            check(k in victims and handles[k].replica.name != victim,
                  f"fleet stream {k} resumed from {on.get(k)} onto "
                  f"{handles[k].replica.name}")
            # the survivor's first token ends the longest stall after the
            # kill (tokens the victim sent before dying may land after it)
            times = st["times"]
            j = max((j for j in range(1, len(times)) if times[j] >= t_kill),
                    key=lambda j: times[j] - times[j - 1])
            resumed.append(times[j] - t_kill)
    check(resumed, f"no stream on {victim} resumed after the kill")
    # the dense reference, from the same seed, once the workers are gone
    model = full_width_model(torch.bfloat16, dev)
    counts, worst = np.zeros(3, int), 0.0
    for p, st in zip(prompts, streams):
        c, w = teacher_forced_check(model, p, st["tokens"], GAP, dev)
        counts, worst = counts + c, max(worst, w)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fleet: store {store.server_kind}; 2 worker processes joined in "
          f"{ready_s:.1f} s; 8 SSE streams through the durable gateway, "
          f"{victim} SIGKILLed (pid {pid}) with {len(victims)} streams on "
          f"it at {at_kill} tokens; every stream FINISHED with exactly "
          f"{NEW_TOKENS} tokens, indices 0-{NEW_TOKENS - 1}, no gap or "
          f"duplicate, the tokens sent before the kill kept; "
          f"{len(resumed)} resumed on the survivor; teacher-forced check "
          f"of {NEW_TOKENS * len(streams)} tokens passed: "
          f"{describe(counts, worst, GAP)}", flush=True)
    print(f"fleet: kill to the resumed streams' first token "
          f"{min(resumed):.2f}-{max(resumed):.2f} s; {victim} respawned "
          f"(restarts {sups[victim].restarts}) and rejoined under epoch 2 "
          f"{rejoin_s:.1f} s after the kill; 8 x {NEW_TOKENS} tokens in "
          f"{wall:.2f} s end to end, on {card}", flush=True)
    for snap in (before, after):
        for n, h in snap.items():
            check(h["step_failures"] == 0,
                  f"fleet worker {n}: {h['step_failures']} steps failed")
    for when, snap in (("before the kill", before), ("at the end", after)):
        print("fleet: worker memory " + when + ": " + ", ".join(
            f"{n} {h['mem_gib']:.2f} GiB allocated, peak "
            f"{h['peak_mem_gib']:.2f}, reserved {h['reserved_gib']:.2f}"
            for n, h in snap.items()), flush=True)
    print(f"fleet: with both workers up at the end the card had "
          f"{free_end / 2 ** 30:.2f} GiB free; nvidia-smi compute apps "
          f"(pid, used memory): {smi or 'none visible'}", flush=True)
    return {"resume_s": resumed, "rejoin_s": rejoin_s, "ready_s": ready_s,
            "wall_s": wall, "memory": {"before": before, "after": after}}


class _PinRouter:
    """Routes to the pinned replica while it is a candidate, else to the
    first candidate."""

    def __init__(self, pin=None):
        self.pin = pin

    def route(self, prompt_ids, replicas):
        from paddle_tpu_torch.inference.frontend import RouteDecision
        return RouteDecision(next((r for r in replicas if r.name == self.pin),
                                  replicas[0]), "pinned")

    def note_event(self, replica_name, event, key):
        pass

    def forget(self, name):
        pass


def tiny_front_door(dev, store):
    """The tiny float32 Llama behind the front door on the card: four
    concurrent SSE streams through a two-replica gateway, token-exact with
    one direct engine; then a fleet of two thread-hosted workers over
    ``store`` behind the durable gateway, the worker serving two streams
    killed (its RPC listener and step loop closed, its lease left) once
    they have streamed, their streams resumed on the survivor and
    token-exact with an uninterrupted run."""
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.inference.frontend import (FleetReplicaSet,
                                                     ReplicaSet,
                                                     WorkerServer,
                                                     http_completion,
                                                     start_gateway)
    from paddle_tpu_torch.inference.serving import LLMEngine
    model, rng = tiny_f32_model(dev)
    vocab = model.config.vocab_size
    prompts = [list(map(int, rng.randint(0, vocab, n)))
               for n in (5, 16, 21, 9)]
    knobs = dict(device=dev, max_batch=2, max_len=64, page_size=8,
                 prefill_chunk=8, prefix_cache=True)
    direct = LLMEngine(model, **knobs)
    rids = [direct.add_request(p, max_new_tokens=24) for p in prompts]
    direct.run_until_done()
    want = [[int(t) for t in direct.result(r)] for r in rids]
    rs = ReplicaSet([LLMEngine(model, **knobs), LLMEngine(model, **knobs)])
    gw = start_gateway(rs, port=0)
    try:
        got = run_clients(
            lambda p: http_completion(gw.url, p, max_tokens=24, stream=True,
                                      timeout=300), [(p,) for p in prompts])
    finally:
        gw.close()
        rs.close()
    check(all(r.engine.step_failures == 0 for r in rs.replicas),
          "tiny f32 gateway: an engine step failed")
    check([g["tokens"] for g in got] == want,
          "tiny f32 gateway: streams differ from the direct engine")
    print("front door tiny f32: 4 concurrent SSE streams through two "
          "replicas token-exact with the direct engine", flush=True)

    def paced_engine():
        eng = LLMEngine(model, **knobs)
        step = eng.step

        def paced():
            time.sleep(0.02)
            return step()

        eng.step = paced
        return eng

    group = "smoke-tiny"
    router = _PinRouter("w0")
    fleet = FleetReplicaSet(TCPStore(port=store.port, timeout=60),
                            group=group,
                            ttl=FLEET_TTL, router=router, page_size=8)
    workers = {}
    gw = None
    try:
        for n in ("w0", "w1"):
            workers[n] = WorkerServer(
                n, paced_engine(), TCPStore(port=store.port, timeout=60),
                group=group, ttl=FLEET_TTL).start()
        fleet.sync()
        check(len(fleet.alive_replicas()) == 2, "tiny workers did not join")
        gw = start_gateway(fleet, port=0, journal_dir=tempfile.mkdtemp(
            prefix="chip_smoke_tiny_journal_", dir=ROOT / "build"))
        started = threading.Event()
        box = {}

        def clients():
            box["out"] = run_clients(
                lambda i: sse_stream(
                    gw.url, prompts[i], 24, key=f"t{i}",
                    on_token=lambda n: n >= 3 and started.set()),
                [(0,), (1,)])

        t = threading.Thread(target=clients)
        t.start()
        check(started.wait(120), "tiny fleet streams never started")
        victim = workers.pop("w0")
        victim.rpc.close()
        victim.replica.close()
        router.pin = None
        t.join(timeout=300)
        check("out" in box, "tiny fleet clients did not finish")
        handles = [gw.plane.get(f"t{i}").handle for i in range(2)]
        check(workers["w1"].replica.engine.step_failures == 0,
              "tiny f32 fleet: a step of the survivor failed")
    finally:
        if gw is not None:
            gw.close()
        fleet.close()
        for w in workers.values():
            w.close(drain=False)
    out = box["out"]
    check([o["tokens"] for o in out] == want[:2], "tiny f32 fleet: resumed "
          "streams differ from the uninterrupted run")
    check(all(o["index"] == list(range(24)) for o in out),
          "tiny f32 fleet: a gap or a duplicate in the SSE indices")
    check(any(h.resumed for h in handles),
          f"tiny f32 fleet: no stream resumed ({handles})")
    print(f"front door tiny f32: a fleet of two workers over the "
          f"{store.server_kind} store, w0 killed mid-stream, "
          f"{sum(h.resumed for h in handles)} streams resumed on w1 and "
          f"{sum(h.requeued for h in handles)} requeued, both token-exact "
          f"with the uninterrupted run", flush=True)


def front_door_phase(dev, card, direct):
    """The serving front door and fleet: K5 from a fresh thread; the tiny
    float32 gateway and fleet; Llama-3-8B bf16 behind the in-process
    gateway; the fleet of worker processes with a SIGKILL.  Returns the
    phases' numbers and the ``TCPStore`` master (the process's one native
    daemon) for the disaggregation phase."""
    from paddle_tpu_torch.distributed.store import TCPStore
    # the engine phase's models sit in reference cycles (their programs'
    # bodies): collect them before the front door's engines and workers
    gc.collect()
    torch.cuda.empty_cache()
    fresh_thread_launch(dev)
    store = TCPStore(is_master=True, timeout=60)
    print(f"front door: TCPStore master served by the {store.server_kind} "
          f"daemon", flush=True)
    check(store.server_kind == "native", "the store's native daemon did "
          "not start (no g++?)")
    tiny_front_door(dev, store)
    gateway = gateway_phase(dev, card, direct)
    fleet = fleet_phase(dev, card, store)
    return {"gateway": gateway, "fleet": fleet, "store": store}


# ------------------------------------------------- phase: disaggregation
# the in-process pools at full width: (tag, DisaggEngine knobs); the first
# keeps prefix caching on its prefill side and serves the shared-prefix
# pair, the second serves the pair without it (the pair's reference)
DISAGG_POOLS = (("1:1", dict(prefix_cache=True)),
                ("1:1 sync", dict(async_handoff=False)),
                ("2:1", dict(n_prefill=2)), ("1:2", dict(n_decode=2)),
                ("2:2", dict(n_prefill=2, n_decode=2)))
# bench.py's disagg trace: short requests decoding while long prompts
# arrive mid-stream; decode_block 1, so the gap series is the TPOT series
MIXED_SHORT_AT = tuple(range(6))       # the steps the short requests arrive
MIXED_LONG_AT = (2, 6, 10)             # the steps the long prompts arrive
MIXED_SHORT, MIXED_LONG, MIXED_LONG_NEW = 8, 600, 4
DISAGG_GROUP = "smoke-disagg"


def pool_engine(model, dev, **kw):
    """A ``DisaggEngine`` with the direct bf16 engine's geometry."""
    from paddle_tpu_torch.inference.serving import DisaggEngine
    return DisaggEngine(model, device=dev, max_batch=8, max_len=1024,
                        page_size=PAGE, prefill_chunk=32, **kw)


def pool_members(pool):
    """(name, engine, role) of each local engine of a pool."""
    return ([(f"prefill[{i}]", e, "prefill")
             for i, e in enumerate(pool.prefills)]
            + [(f"decode[{j}]", e, "decode")
               for j, e in enumerate(pool.decodes)])


def pool_identity(tag, pool, L):
    """Each local engine of a greedy pool as :func:`replica_identity`
    holds a replica (captured, 0 eager, K5 = layers x its dispatches), the
    prefill engines dispatching only prefill and the decode engines only
    decode; returns the pool's dispatches."""
    total = 0
    for name, eng, role in pool_members(pool):
        n, line = replica_identity(f"disagg {tag}", name, eng, L)
        print(line, flush=True)
        kinds = _dispatches(eng)
        other = ("decode", "verify") if role == "prefill" else ("prefill",)
        check(all(kinds[k] == 0 for k in other),
              f"disagg {tag} {name}: a {role} engine dispatched {kinds}")
        total += n
    return total


def drive_pool(pool, prompts, n_new):
    """Serve ``prompts`` through ``pool`` round by round; returns the
    request ids, the wall seconds and each round's (seconds, whether a
    prefill engine dispatched, whether a program was captured, tokens
    emitted)."""
    members = [e for _, e, _ in pool_members(pool)]
    rids = [pool.add_request(p, max_new_tokens=n_new) for p in prompts]
    rounds = []
    t0 = time.perf_counter()
    while pool.has_work():
        check(len(rounds) < 20000, "the pool did not drain")
        pf = sum(e.prefill_dispatches for e in pool.prefills)
        caps = sum(program_totals(e, None)["captures"] for e in members)
        toks = sum(len(pool._lookup(r).out) for r in rids)
        a = time.perf_counter()
        pool.step()
        torch.cuda.synchronize()
        rounds.append((
            time.perf_counter() - a,
            sum(e.prefill_dispatches for e in pool.prefills) != pf,
            sum(program_totals(e, None)["captures"] for e in members) != caps,
            sum(len(pool._lookup(r).out) for r in rids) - toks))
    return rids, time.perf_counter() - t0, rounds


def decode_rounds(rounds):
    """The rounds in which only decode ran (no prefill engine dispatched,
    nothing was captured): tokens a second, ms a round and tokens a round
    (the decode batch).  A pool decodes each request as soon as its prompt
    is in, so these rounds are mostly the tail of the last prompts: the
    batch, not the step, sets their rate."""
    pure = [(dt, n) for dt, pf, cap, n in rounds if not pf and not cap and n]
    secs = sum(dt for dt, _ in pure)
    if not pure:
        return {"decode_tok_s": None, "decode_step_ms": None,
                "decode_batch": None}
    return {"decode_tok_s": sum(n for _, n in pure) / secs,
            "decode_step_ms": 1e3 * secs / len(pure),
            "decode_batch": sum(n for _, n in pure) / len(pure)}


def check_pool(tag, pool, rids, want, L, launches):
    """A greedy pool's run: every request FINISHED with its reference's
    tokens, one handoff each and none failed, the combined page audit
    clean, each engine's identity, and K5 = layers x the pool's dispatches
    with no other paged kernel launched."""
    from paddle_tpu_torch.inference.serving import RequestStatus
    for i, (rid, w) in enumerate(zip(rids, want)):
        check(pool.status(rid) == RequestStatus.FINISHED,
              f"disagg {tag}: request {i} ended {pool.status(rid)} "
              f"({pool.error(rid)})")
        check([int(t) for t in pool.result(rid)] == w,
              f"disagg {tag}: request {i}'s tokens differ from the "
              f"reference's")
    st = pool.handoff_stats()
    check(st["handoffs"] == len(rids) and st["failures"] == 0
          and st["retries"] == 0, f"disagg {tag}: handoffs {st}")
    audit = pool.audit_refcounts()
    check(audit == [], f"disagg {tag}: page audit {audit}")
    total = pool_identity(tag, pool, L)
    expected = {k: 0 for k in launches}
    expected["K5"] = L * total
    check(launches == expected, f"disagg {tag}: launches {launches} != "
          f"{expected} (layers x the pool's dispatches)")
    return st, total


def handoff_device_ms(pool, n_pages, n=10):
    """Device time of one in-process handoff of ``n_pages`` pages, as
    ``_stage`` and ``_land`` queue it: the prefill runner's
    ``gather_pages`` and the decode runner's ``scatter_pages`` (their page
    index copies included), summed over the profiler's device activity and
    taken per call; with the bytes they move (the block read and written by
    each) and that traffic's bound.  Run on a drained pool: the decode
    pages it overwrites hold no request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    src, dst = pool.pre.runner, pool.dec.runner
    pages = list(range(n_pages))

    def handoff():
        dst.scatter_pages(pages, src.gather_pages(pages))

    handoff()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            handoff()
        torch.cuda.synchronize()
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3 / n
    block = sum(a[:, :n_pages].numel() * a.element_size() for a in src.cache)
    return {"handoff_pages": n_pages, "handoff_mib": block / 2 ** 20,
            "handoff_dev_ms": dev_ms,
            "handoff_bound_ms": 4 * block / HBM_BYTES_PER_S * 1e3}


def serve_pool(model, tag, dev, direct, prompts, pair=None, **kw):
    """One in-process pool at full width: the eight prompts, timed round by
    round and held token-exact to the direct bf16 engine; then, with
    ``pair``, two requests sharing a two-page prefix, the second sent once
    the first has its first token.  Returns the pool's numbers and the
    pair's tokens.  The pool is freed before returning."""
    from paddle_tpu_torch import observability as obs
    L = model.config.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pool = pool_engine(model, dev, **kw)
    obs.enable()
    try:
        reset_launch_counts()
        rids, wall, rounds = drive_pool(pool, prompts, NEW_TOKENS)
        hits, pair_out = 0, None
        if pair is not None:
            hits0 = pool.prefix_cache_stats().get("hits", 0)
            first = pool.add_request(pair[0], max_new_tokens=NEW_TOKENS)
            while not pool._lookup(first).out:
                pool.step()
            second = pool.add_request(pair[1], max_new_tokens=NEW_TOKENS)
            pool.run_until_done()
            hits = pool.prefix_cache_stats().get("hits", 0) - hits0
            rids = rids + [first, second]
            pair_out = [[int(t) for t in pool.result(r)]
                        for r in (first, second)]
        launches = launch_counts()
        want = direct["outputs"] + (pair_out or [])
        st, total = check_pool(tag, pool, rids, want, L, launches)
    finally:
        obs.disable()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    handoff = handoff_device_ms(pool, -(-max(PROMPT_LENS) // PAGE))
    if kw.get("prefix_cache"):
        check(hits >= 2, f"disagg {tag}: the pair's second request hit "
              f"{hits} cached pages, its prefix is two")
    ttft = sorted(pool.ttft(r) for r in rids[:len(prompts)])
    res = {"ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
           **decode_rounds(rounds), "wall_s": wall,
           "tok_s": len(prompts) * NEW_TOKENS / wall,
           "handoffs": st["handoffs"], "queue_wait_s": st["queue_wait_s"],
           "transfer_s": st["transfer_s"],
           "transfer_overlap_s": st["transfer_overlap_s"],
           "prefix_hits": hits, "dispatches": total,
           "launches_k5": launches["K5"],
           "peak_mem_gib": peak, **handoff}
    del pool
    gc.collect()
    torch.cuda.empty_cache()
    return res, pair_out


def pool_line(tag, res, direct, card):
    def f(x, spec):
        return "n/a" if x is None else format(x, spec)
    pair = (f" (and the shared-prefix pair, {res['prefix_hits']} cached "
            f"pages hit)" if res["prefix_hits"] else "")
    print(f"disagg {tag}: 8 requests token-exact with the direct bf16 "
          f"engine{pair}; {res['handoffs']} handoffs, K5 "
          f"{res['launches_k5']} launches = layers x {res['dispatches']} "
          f"dispatches; TTFT p50 {res['ttft_p50_s']:.4f} s, max "
          f"{res['ttft_max_s']:.4f} s (direct {direct['ttft_p50_s']:.4f} / "
          f"{direct['ttft_max_s']:.4f}); decode-only rounds "
          f"{f(res['decode_step_ms'], '.2f')} ms at batch "
          f"{f(res['decode_batch'], '.2f')}, {f(res['decode_tok_s'], '.1f')}"
          f" tokens/s (direct {f(direct['decode_step_ms'], '.2f')} ms a "
          f"step, {f(direct['decode_tok_s'], '.1f')} tokens/s); 8 x "
          f"{NEW_TOKENS} tokens in {res['wall_s']:.2f} s "
          f"({res['tok_s']:.1f} tokens/s; direct "
          f"{8 * NEW_TOKENS / direct['wall_s']:.1f}, captures included); "
          f"queue wait {res['queue_wait_s']:.4f} s, transfer "
          f"{res['transfer_s']:.4f} s, transfer overlap "
          f"{res['transfer_overlap_s']:.4f} s (host time); one "
          f"{res['handoff_pages']}-page handoff ({res['handoff_mib']:.1f} "
          f"MiB) {res['handoff_dev_ms']:.4f} ms on the device (bound "
          f"{res['handoff_bound_ms']:.4f} ms); peak memory "
          f"{res['peak_mem_gib']:.2f} GiB, on {card}", flush=True)


def mixed_engine(model, dev, kind):
    """The mixed trace's engines: colocated, the 1:1 pool with the
    blocking hop, the 2:1 pool with the pipelined one."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    if kind == "colocated":
        return LLMEngine(model, device=dev, max_batch=8, max_len=1024,
                         page_size=PAGE, prefill_chunk=32, decode_block=1)
    if kind == "1:1 sync":
        return pool_engine(model, dev, async_handoff=False, decode_block=1)
    return pool_engine(model, dev, n_prefill=2, decode_block=1)


def drive_mixed(eng, arrivals, warm):
    """bench.py's ``_drive``: warm the engine's programs (one long prompt a
    prefill engine, then two short ones), then feed ``arrivals`` (step,
    prompt, new tokens, short?) at their steps, stepping once between
    polls; returns the short requests' inter-token gaps, every request's
    TTFT and tokens (in arrival order), and a pool's handoff counters as
    the warm-up left them."""
    for _ in range(max(len(getattr(eng, "prefills", ())), 1)):
        eng.add_request(warm[0], max_new_tokens=MIXED_LONG_NEW)
    eng.run_until_done()
    for _ in range(2):
        eng.add_request(warm[1], max_new_tokens=MIXED_LONG_NEW)
    eng.run_until_done()
    warmed = eng.handoff_stats() if hasattr(eng, "handoff_stats") else None
    pend = list(arrivals)
    rids, shorts, last, gaps, step = [], set(), {}, [], 0
    while pend or any(not eng.status(r).terminal for r in rids):
        while pend and pend[0][0] <= step:
            _, p, new, short = pend.pop(0)
            rids.append(eng.add_request(p, max_new_tokens=new))
            if short:
                shorts.add(rids[-1])
        eng.step()
        now = time.perf_counter()
        for rid in rids:
            for _ in eng.new_tokens(rid):
                if rid in last and rid in shorts:
                    gaps.append(now - last[rid])
                last[rid] = now
        step += 1
        check(step < 5000, "the mixed trace did not drain")
    return gaps, [eng.ttft(r) for r in rids], [
        [int(t) for t in eng.result(r)] for r in rids], warmed


def mixed_trace(model, dev, card):
    """The mixed trace served colocated, by a 1:1 pool with the blocking
    hop and by a 2:1 pool with the pipelined one, each warmed first: the
    short requests' inter-token gaps (p50 / p95), TTFT, handoffs and mean
    queue wait; every request's tokens equal across the three and within
    ``GAP`` of the dense reference."""
    V = model.config.vocab_size
    rng = np.random.RandomState(SEED + 1)
    warm = (rng.randint(0, V, MIXED_LONG), rng.randint(0, V, MIXED_SHORT))
    arrivals = sorted(
        [(s, rng.randint(0, V, MIXED_SHORT), NEW_TOKENS, True)
         for s in MIXED_SHORT_AT]
        + [(s, rng.randint(0, V, MIXED_LONG), MIXED_LONG_NEW, False)
           for s in MIXED_LONG_AT], key=lambda a: a[0])
    out = {}
    for kind in ("colocated", "1:1 sync", "2:1 async"):
        gc.collect()
        torch.cuda.empty_cache()
        eng = mixed_engine(model, dev, kind)
        gaps, ttft, toks, warmed = drive_mixed(eng, arrivals, warm)
        engines = ([eng] if kind == "colocated"
                   else [e for _, e, _ in pool_members(eng)])
        for e in engines:
            check(e.step_failures == 0, f"mixed {kind}: a step failed")
            check(program_totals(e, None)["eager"] == 0,
                  f"mixed {kind}: an eager dispatch, all requests greedy")
        handoffs, wait = 0, 0.0
        if warmed is not None:
            st = eng.handoff_stats()
            check(st["failures"] == 0 and eng.audit_refcounts() == [],
                  f"mixed {kind}: {st}, audit {eng.audit_refcounts()}")
            handoffs = st["handoffs"] - warmed["handoffs"]
            wait = st["queue_wait_s"] - warmed["queue_wait_s"]
            check(handoffs == len(arrivals), f"mixed {kind}: {handoffs} "
                  f"handoffs for {len(arrivals)} requests")
        out[kind] = {
            "gap_ms_p50": float(np.percentile(gaps, 50)) * 1e3,
            "gap_ms_p95": float(np.percentile(gaps, 95)) * 1e3,
            "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_ms_p95": float(np.percentile(ttft, 95)) * 1e3,
            "handoffs": handoffs,
            "queue_wait_ms": 1e3 * wait / max(handoffs, 1),
            "tokens": toks}
        del eng, engines
    base = out["colocated"]["tokens"]
    for kind in ("1:1 sync", "2:1 async"):
        check(out[kind]["tokens"] == base, f"mixed {kind}: tokens differ "
              f"from the colocated engine's")
    counts, worst = np.zeros(3, int), 0.0
    for (_, p, _, _), toks in zip(arrivals, base):
        c, w = teacher_forced_check(model, p, toks, GAP, dev)
        counts, worst = counts + c, max(worst, w)
    for kind, r in out.items():
        print(f"mixed trace {kind}: short requests' inter-token gap p50 "
              f"{r['gap_ms_p50']:.2f} ms, p95 {r['gap_ms_p95']:.2f} ms; TTFT "
              f"p50 {r['ttft_ms_p50']:.2f} ms, p95 {r['ttft_ms_p95']:.2f} ms;"
              f" {r['handoffs']} handoffs, mean queue wait "
              f"{r['queue_wait_ms']:.3f} ms, on {card}", flush=True)
    print(f"mixed trace: {len(arrivals)} requests (6 x {MIXED_SHORT}-token "
          f"prompts, {NEW_TOKENS} new; 3 x {MIXED_LONG}-token prompts at "
          f"steps {MIXED_LONG_AT}, {MIXED_LONG_NEW} new) token-identical "
          f"three ways; teacher-forced check passed: "
          f"{describe(counts, worst, GAP)}", flush=True)
    return {k: {m: v for m, v in r.items() if m != "tokens"}
            for k, r in out.items()}


def remote_prefill(model, dev, direct, prompts, store, card):
    """The cross-process tier: one worker process on the card with
    ``--role prefill`` (:func:`make_engine`), joined through ``store``'s
    leases; the ``FleetReplicaSet`` hands it over as a prefill tier (never
    a replica) to a pool whose decode engine runs here.  The eight prompts
    token-exact with the direct bf16 engine, the worker's page audit folded
    into the pool's; the worker is then stopped and its memory must come
    back to the card."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.inference.frontend import FleetReplicaSet
    L = model.config.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(dev)[0]
    log = ROOT / "build" / "chip_smoke_prefill_worker.log"
    log.parent.mkdir(exist_ok=True)
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.frontend.worker",
             "--engine-spec", FLEET_ENGINE_SPEC, "--name", "pf0",
             "--store-port", str(store.port), "--group", DISAGG_GROUP,
             "--ttl", str(FLEET_TTL), "--role", "prefill"],
            cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT)
    fleet = FleetReplicaSet(TCPStore(port=store.port, timeout=60),
                            group=DISAGG_GROUP, ttl=FLEET_TTL,
                            page_size=PAGE)
    pool = None
    pulls = []
    t0 = time.perf_counter()
    try:
        fleet.start_sync(0.2)
        deadline = time.monotonic() + WORKER_READY_S
        while "pf0" not in fleet.prefill_tiers and time.monotonic() < deadline:
            check(proc.poll() is None, "the prefill worker exited while "
                  "starting")
            time.sleep(0.5)
        check("pf0" in fleet.prefill_tiers, f"the prefill worker did not "
              f"join within {WORKER_READY_S} s")
        ready_s = time.perf_counter() - t0
        check(fleet.replicas == [], "a prefill-role member became a "
              "serving replica")
        tier = fleet.prefill_tiers["pf0"]
        pull = tier.pull

        def timed_pull(rid):
            a = time.perf_counter()
            payload = pull(rid)
            block = payload["block"] or ()
            pulls.append((time.perf_counter() - a,
                          sum(b.nbytes for b in block)))
            return payload

        tier.pull = timed_pull
        torch.cuda.reset_peak_memory_stats()
        pool = pool_engine(model, dev, n_prefill=0, remote_prefill=[tier])
        obs.enable()
        try:
            reset_launch_counts()
            rids, wall, rounds = drive_pool(pool, prompts, NEW_TOKENS)
            launches = launch_counts()
            st, total = check_pool("remote", pool, rids, direct["outputs"],
                                   L, launches)
        finally:
            obs.disable()
        check(st["cross_device"] and st["n_prefill"] == 1,
              f"disagg remote: {st}")
        health = tier.client.call("health", ctx=None)
        check(health["step_failures"] == 0,
              f"the prefill worker: {health['step_failures']} steps failed")
        ttft = sorted(pool.ttft(r) for r in rids)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    except BaseException:
        _worker_logs([log])
        raise
    finally:
        del pool
        fleet.close()
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    gc.collect()
    torch.cuda.empty_cache()
    free_end = torch.cuda.mem_get_info(dev)[0]
    check(free_end >= free0 - 2 ** 30, f"the card's memory did not come "
          f"back after the prefill worker: {free0 / 2 ** 30:.2f} GiB free "
          f"before it, {free_end / 2 ** 30:.2f} after")
    secs = [s for s, _ in pulls]
    nbytes = [b for _, b in pulls]
    res = {"ready_s": ready_s, "ttft_p50_s": float(np.median(ttft)),
           "ttft_max_s": ttft[-1], **decode_rounds(rounds),
           "wall_s": wall, "tok_s": len(prompts) * NEW_TOKENS / wall, "pull_s": secs, "pull_bytes": nbytes,
           "transfer_s": st["transfer_s"], "queue_wait_s": st["queue_wait_s"],
           "worker_peak_gib": health["peak_mem_gib"],
           "worker_mem_gib": health["mem_gib"], "peak_mem_gib": peak}
    print(f"disagg remote: a prefill worker process joined in "
          f"{ready_s:.1f} s and served as a tier (no replica); 8 requests "
          f"token-exact with the direct bf16 engine, {st['handoffs']} "
          f"handoffs pulled over RPC, K5 {launches['K5']} launches = layers "
          f"x {total} decode dispatches here; the worker's audit folded in "
          f"clean", flush=True)
    print(f"disagg remote: a handoff {min(nbytes) / 2 ** 20:.1f}-"
          f"{max(nbytes) / 2 ** 20:.1f} MiB ({sum(nbytes) / 2 ** 20:.1f} in "
          f"all), pull {1e3 * min(secs):.1f}-{1e3 * max(secs):.1f} ms "
          f"({1e3 * sum(secs):.1f} in all; the longest prompt's "
          f"{1e3 * secs[int(np.argmax(nbytes))]:.1f} ms); transfer (put + "
          f"scatter) {st['transfer_s']:.4f} s; TTFT p50 "
          f"{res['ttft_p50_s']:.4f} s, max {res['ttft_max_s']:.4f} s "
          f"(direct {direct['ttft_p50_s']:.4f} / {direct['ttft_max_s']:.4f})"
          f"; decode-only rounds {res['decode_step_ms'] or 0:.2f} ms at "
          f"batch {res['decode_batch'] or 0:.2f}; 8 x {NEW_TOKENS} tokens "
          f"in {wall:.2f} s ({res['tok_s']:.1f} tokens/s); the "
          f"worker {health['mem_gib']:.2f} GiB allocated, peak "
          f"{health['peak_mem_gib']:.2f}; this process's peak "
          f"{peak:.2f} GiB; card free {free0 / 2 ** 30:.2f} GiB before the "
          f"worker, {free_end / 2 ** 30:.2f} after it stopped, on {card}",
          flush=True)
    return res


def tiny_disagg(dev, store, hidden, heads, kv_heads, ffn):
    """The tiny float32 Llama through ``DisaggEngine`` on the card, each
    case token-exact with the tiny colocated engine of the same options:
    speculative decoding on the decode side (K5 + K7), with int8 pages (K6
    + K7q), fixed-seed sampling, transient ``serving.kv_handoff`` faults
    retried, one poisoned handoff quarantining only its request, a cancel
    in the handoff queue releasing its pages, and a thread-hosted prefill
    worker over RPC."""
    from paddle_tpu_torch.inference.frontend import WorkerServer
    from paddle_tpu_torch.inference.frontend.disagg import RemotePrefillTier
    from paddle_tpu_torch.inference.serving import (DisaggEngine, LLMEngine,
                                                    RequestStatus,
                                                    SpecConfig)
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.testing import FAULTS, Always, FailNth, injected
    model, rng = tiny_f32_model(dev, hidden, heads, kv_heads, ffn)
    d = hidden // heads
    prompts = tiny_prompts(rng, model.config.vocab_size)
    knobs = dict(device=dev, max_batch=2, max_len=64, page_size=8,
                 prefill_chunk=8)
    sampled = dict(do_sample=True, temperature=0.8, top_p=0.9, top_k=20)

    def serve(eng, req=None):
        req = req or {}
        rids = [eng.add_request(p, max_new_tokens=8,
                                **({**req, "seed": 10 + i} if req else {}))
                for i, p in enumerate(prompts)]
        eng.run_until_done()
        return rids, [[int(t) for t in eng.result(r)] for r in rids]

    def held(tag, pool, handoffs=len(prompts), failures=0):
        """The pool's engines stepped without failure, its audit is clean
        and its handoffs are as expected."""
        for _, e, _ in pool_members(pool):
            check(e.step_failures == 0, f"tiny disagg D={d} {tag}: a step "
                  f"failed")
        st = pool.handoff_stats()
        check(st["handoffs"] == handoffs and st["failures"] == failures,
              f"tiny disagg D={d} {tag}: {st}")
        audit = pool.audit_refcounts()
        check(audit == [], f"tiny disagg D={d} {tag}: audit {audit}")
        return st

    def ran(before):
        after = launch_counts()
        return {k for k in ("K5", "K6", "K7", "K7q") if after[k] > before[k]}

    _, base = serve(LLMEngine(model, **knobs))
    lines = []
    for tag, kernels, kw in (
            ("spec", {"K5", "K7"}, dict(spec_decode=SpecConfig(
                max_draft=MAX_DRAFT))),
            ("int8 + spec", {"K6", "K7q"}, dict(
                kv_cache_dtype="int8",
                spec_decode=SpecConfig(max_draft=MAX_DRAFT)))):
        _, want = serve(LLMEngine(model, **knobs, **kw))
        pool = DisaggEngine(model, **knobs, **kw)
        before = launch_counts()
        _, got = serve(pool)
        check(ran(before) == kernels, f"tiny disagg D={d} {tag}: launched "
              f"{sorted(ran(before))}, expected {sorted(kernels)}")
        check(got == want, f"tiny disagg D={d} {tag}: tokens differ from "
              f"the colocated engine's")
        held(tag, pool)
        check(pool.spec_stats()["verify_dispatches"] > 0,
              f"tiny disagg D={d} {tag}: no verify step")
        lines.append(f"{tag} ({'+'.join(sorted(kernels))})")
    _, want = serve(LLMEngine(model, **knobs), sampled)
    pool = DisaggEngine(model, **knobs)
    _, got = serve(pool, sampled)
    check(got == want, f"tiny disagg D={d}: fixed-seed sampling differs "
          f"from the colocated engine's")
    held("sampled", pool)
    lines.append("fixed-seed sampling")
    pool = DisaggEngine(model, **knobs)
    with injected("serving.kv_handoff", FailNth({1, 3}), transient=True):
        _, got = serve(pool)
    st = held("transient", pool)
    check(got == base and st["retries"] >= 2,
          f"tiny disagg D={d}: transient faults not retried losslessly "
          f"({st})")
    lines.append(f"{st['retries']} transient faults retried")
    pool = DisaggEngine(model, **knobs)
    rids = [pool.add_request(p, max_new_tokens=8) for p in prompts]
    poison = rids[1]
    FAULTS.install("serving.kv_handoff", Always(),
                   match=lambda ctx: poison in ctx.get("rids", ()))
    try:
        pool.run_until_done()
    finally:
        FAULTS.reset()
    check(pool.status(poison) == RequestStatus.FAILED,
          f"tiny disagg D={d}: the poisoned request ended "
          f"{pool.status(poison)}")
    for i in (0, 2, 3):
        check([int(t) for t in pool.result(rids[i])] == base[i],
              f"tiny disagg D={d}: request {i} moved under the poison")
    held("poison", pool, handoffs=len(prompts) - 1, failures=1)
    lines.append("a poisoned handoff quarantined alone")
    pool = DisaggEngine(model, **knobs)
    rids = [pool.add_request(p, max_new_tokens=8) for p in prompts]
    steps = 0
    while not pool._queue and steps < 200:
        pool.pre.step()
        steps += 1
    check(bool(pool._queue), f"tiny disagg D={d}: nothing reached the "
          f"handoff queue")
    h = pool._queue[0]
    free, held_pages = pool.pre.pool.n_available(), len(h.pages)
    check(pool.cancel(h.r.rid), f"tiny disagg D={d}: cancel refused")
    check(pool.pre.pool.n_available() == free + held_pages
          and pool.status(h.r.rid) == RequestStatus.CANCELLED,
          f"tiny disagg D={d}: the cancel released "
          f"{pool.pre.pool.n_available() - free} of {held_pages} pages")
    pool.run_until_done()
    for i, rid in enumerate(rids):
        if rid != h.r.rid:
            check([int(t) for t in pool.result(rid)] == base[i],
                  f"tiny disagg D={d}: request {i} moved under the cancel")
    held("cancel", pool, handoffs=len(prompts) - 1)
    lines.append("a cancel in the queue released its pages")
    worker = WorkerServer(f"tiny-pf-{d}", LLMEngine(model, **knobs),
                          TCPStore(port=store.port, timeout=60),
                          group=f"{DISAGG_GROUP}-tiny", ttl=60.0,
                          role="prefill").start(heartbeat=False)
    tier = RemotePrefillTier(worker.rpc.host, worker.rpc.port,
                             name=worker.name)
    try:
        pool = DisaggEngine(model, n_prefill=0, remote_prefill=[tier],
                            **knobs)
        _, got = serve(pool)
        held("remote", pool)
    finally:
        tier.close()
        worker.close(drain=False)
    check(got == base, f"tiny disagg D={d}: the thread-hosted prefill "
          f"worker's tokens differ from the colocated engine's")
    lines.append("a thread-hosted prefill worker over RPC")
    print(f"disagg tiny f32 D={d}: token-exact with the colocated engine: "
          + "; ".join(lines), flush=True)


def disagg_phase(dev, card, direct, store):
    """Disaggregated serving (``DisaggEngine``): the tiny float32 pools with
    every option, fault and transport; Llama-3-8B bf16 through the
    in-process pools of ``DISAGG_POOLS``, the mixed trace, and a prefill
    worker process behind the fleet.  ``direct``: the direct bf16 engine's
    run (tokens and rates); ``store``: a ``TCPStore`` master (a process
    hosts one native daemon).  The card's memory is handed back whole."""
    gc.collect()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(dev)[0]
    for kw in TINY_ENGINES:
        tiny_disagg(dev, store, *kw)
    model = full_width_model(torch.bfloat16, dev)
    cfg = model.config
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    shared = list(rng.randint(0, cfg.vocab_size, 2 * PAGE))
    pair = [shared + list(rng.randint(0, cfg.vocab_size, n)) for n in (5, 9)]
    pools, pair_outs = {}, []
    for tag, kw in DISAGG_POOLS:
        with_pair = tag in ("1:1", "1:1 sync")
        pools[tag], pair_out = serve_pool(model, tag, dev, direct, prompts,
                                          pair if with_pair else None, **kw)
        pool_line(tag, pools[tag], direct, card)
        if pair_out is not None:
            pair_outs.append(pair_out)
    check(pair_outs[0] == pair_outs[1], "the shared-prefix pair's tokens "
          "differ between the prefix-cached pool and the one without")
    counts, worst = np.zeros(3, int), 0.0
    for p, out in zip(pair, pair_outs[0]):
        c, w = teacher_forced_check(model, np.asarray(p), out, GAP, dev)
        counts, worst = counts + c, max(worst, w)
    print(f"disagg: the shared-prefix pair token-identical with and without "
          f"the prefill side's prefix cache; teacher-forced check passed: "
          f"{describe(counts, worst, GAP)}", flush=True)
    mixed = mixed_trace(model, dev, card)
    remote = remote_prefill(model, dev, direct, prompts, store, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    free_end = torch.cuda.mem_get_info(dev)[0]
    check(free_end >= free0 - 2 ** 30, f"the disaggregation phase kept the "
          f"card's memory: {free0 / 2 ** 30:.2f} GiB free before it, "
          f"{free_end / 2 ** 30:.2f} after")
    print(f"disagg: card free {free0 / 2 ** 30:.2f} GiB before the phase, "
          f"{free_end / 2 ** 30:.2f} after", flush=True)
    return {"pools": pools, "mixed": mixed, "remote": remote}


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
    from paddle_tpu_torch.models.llama_module import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=7168, num_hidden_layers=4,
                       num_attention_heads=16, num_key_value_heads=4,
                       max_position_embeddings=1024,
                       tie_word_embeddings=True), 8, 1024


@contextlib.contextmanager
def dense_attention():
    """The models attend through the reference's dense path (``_sdpa_ref``,
    float32 softmax) instead of the flash kernels: the same model, the
    check the flash path is held against.  Covers the ``torch.nn`` models
    and the ``Layer`` route (``nn.functional.attention._sdpa``)."""
    from paddle_tpu_torch.models import gpt2_module as gpt2
    from paddle_tpu_torch.models import llama_module as llama
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref
    saved = (gpt2.scaled_dot_product_attention, llama.flash_attention,
             attention._sdpa)
    gpt2.scaled_dot_product_attention = (
        lambda q, k, v, is_causal=False, **kw: _sdpa_ref(q, k, v,
                                                          causal=is_causal))
    llama.flash_attention = (
        lambda q, k, v, causal=False, **kw: (_sdpa_ref(q, k, v,
                                                       causal=causal), None))
    # the Layer route (F.scaled_dot_product_attention on Tensors)
    attention._sdpa = (
        lambda q, k, v, mask, dropout_p, is_causal, training, generator:
        _sdpa_ref(q, k, v, mask=mask, causal=is_causal,
                  dropout_p=dropout_p if training else 0.0,
                  generator=generator))
    try:
        yield
    finally:
        (gpt2.scaled_dot_product_attention, llama.flash_attention,
         attention._sdpa) = saved


@contextlib.contextmanager
def library_attention():
    """The ``Layer`` route's attention through ``torch.nn.functional.
    scaled_dot_product_attention`` (the library's flash kernels) instead
    of the port's: a yardstick of a library kernel's numerics on the same
    step, never the port's path."""
    from paddle_tpu_torch.nn.functional import attention
    saved = attention._sdpa

    def sdpa(q, k, v, mask, dropout_p, is_causal, training, generator):
        out = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=is_causal, enable_gqa=True)
        return out.transpose(1, 2)
    attention._sdpa = sdpa
    try:
        yield
    finally:
        attention._sdpa = saved


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
    from paddle_tpu_torch.models.gpt2 import GPT2Config
    from paddle_tpu_torch.models.gpt2_module import GPT2ForCausalLM
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
    dk / dv bodies the path runs) and each one's launches as the profiler
    counts them beside its launch counter's.  The window opens with a
    small kernel, synchronised, before the step: CUPTI may miss launches
    at the very start of a session, and this puts any it misses outside the
    step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    warm = torch.zeros(1, device=x.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm += 1
        torch.cuda.synchronize()
        before = launch_counts()
        t0 = time.perf_counter()
        train_step(model, opt, x, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(ms for _, _, ms in rows)
    pats = dict(zip(kernels, ("fwd_bf16", "dq_bf16", "dkv_bf16")))
    share = {k: sum(ms for key, _, ms in rows if pat in key)
             for k, pat in pats.items()}
    counted = {k: sum(n for key, n, _ in rows if pat in key)
               for k, pat in pats.items()}
    pct = (lambda ms: 100 * ms / busy) if busy else (lambda ms: 0.0)
    print(f"profile train {tag}: 1 step in {wall:.1f} ms (profiled), device "
          f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%); "
          + ", ".join(f"{k} {ms:.2f} ms ({pct(ms):.1f}%)"
                      for k, ms in share.items()), flush=True)
    print(f"profile train {tag}: launches by the profiler / by the launch "
          f"counters: "
          + ", ".join(f"{k} {counted[k]} / {after[k] - before[k]}"
                      f"{'' if counted[k] == after[k] - before[k] else ' (differ)'}"
                      for k in kernels), flush=True)
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
    from paddle_tpu_torch.models.gpt2_module import GPT2ForCausalLM
    from paddle_tpu_torch.models.llama_module import LlamaForCausalLM
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


# ------------------------------------------------- phase 6b: the spine (M1)
SPINE_LR = 0.1           # plain SGD on one repeated batch
SPINE_STEPS = 3
SPINE_TIMED_NN = 3       # timed torch.nn steps on the same batch
SPINE_ADDS = 2000        # small adds timed back to back, each way


def spine_layer_norm(x, w, b, eps):
    """LayerNorm over the last axis from ``mean``, subtraction and
    ``rsqrt``, in float32, as torch's LayerNorm computes a bf16 input."""
    import paddle_tpu_torch as paddle
    xf = x.astype("float32")
    xc = xf - xf.mean(axis=-1, keepdim=True)
    var = (xc * xc).mean(axis=-1, keepdim=True)
    y = xc * paddle.rsqrt(var + eps) * w.astype("float32") + b.astype("float32")
    return y.astype(x.dtype)


def spine_gelu(x):
    """tanh-GELU from ``tanh`` and ``pow``, in float32."""
    import paddle_tpu_torch as paddle
    xf = x.astype("float32")
    inner = math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf.pow(3))
    return (0.5 * xf * (1.0 + paddle.tanh(inner))).astype(x.dtype)


def spine_gpt2_loss(params, x, y, num_heads=12, eps=1e-5, gelu=spine_gelu,
                    tap=None):
    """GPT-2's mean next-token loss written in the Paddle Tensor API with the
    port's ops only: ``params`` maps the JAX model's ``state_dict`` names to
    Tensors in Paddle's layout (Linear weights ``[in, out]``); ``x`` and
    ``y`` are ``[B, S]`` token ids.  Embeddings by ``wte[x]`` and
    ``wpe[:S]``, layer norms and tanh-GELU in float32 from elementwise ops,
    ``@`` for the linear layers, the Tensor-level
    ``scaled_dot_product_attention(..., is_causal=True)`` (K1-K3, or K4 with
    FLAGS_flash_layout_direct), the tied head, and the loss from
    ``logsumexp`` and ``take_along_axis`` in float32.  ``tap(name,
    tensor)``, when given, sees the embedding output ("emb") and each
    layer's attention output ("attn0", ...)."""
    from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
    import paddle_tpu_torch as paddle
    B, S = x.shape
    wte = params["gpt2.wte.weight"]
    hidden = wte.shape[1]
    h = wte[x] + params["gpt2.wpe.weight"][:S]
    if tap is not None:
        tap("emb", h)
    n_layers = sum(1 for n in params if n.endswith(".attn.qkv.weight"))
    for i in range(n_layers):
        def p(s):
            return params[f"gpt2.blocks.{i}.{s}"]
        a = spine_layer_norm(h, p("ln1.weight"), p("ln1.bias"), eps)
        qkv = (a @ p("attn.qkv.weight") + p("attn.qkv.bias")).reshape(
            [B, S, 3, num_heads, hidden // num_heads])
        q, k, v = qkv.unbind(axis=2)
        o = scaled_dot_product_attention(q, k, v, is_causal=True)
        if tap is not None:
            tap(f"attn{i}", o)
        h = h + (o.reshape([B, S, hidden]) @ p("attn.proj.weight")
                 + p("attn.proj.bias"))
        a = spine_layer_norm(h, p("ln2.weight"), p("ln2.bias"), eps)
        m = gelu(a @ p("mlp.fc.weight") + p("mlp.fc.bias"))
        h = h + (m @ p("mlp.proj.weight") + p("mlp.proj.bias"))
    h = spine_layer_norm(h, params["gpt2.ln_f.weight"],
                         params["gpt2.ln_f.bias"], eps)
    logits = (h @ wte.T).astype("float32")
    lse = paddle.logsumexp(logits, axis=2)
    picked = paddle.take_along_axis(logits, y.unsqueeze(2), axis=2)
    return (lse - picked.squeeze(2)).mean()


def spine_gelu_layer():
    """tanh-GELU as a PyLayer: forward ``spine_gelu``, backward its
    analytic derivative in float32."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.autograd import PyLayer
    c = math.sqrt(2.0 / math.pi)

    class Gelu(PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return spine_gelu(x)

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            xf = x.astype("float32")
            t = paddle.tanh(c * (xf + 0.044715 * xf.pow(3)))
            d = 0.5 * (1.0 + t) + 0.5 * xf * (1.0 - t * t) * c * (
                1.0 + 3 * 0.044715 * xf * xf)
            return (dy.astype("float32") * d).astype(x.dtype)
    return Gelu


def paddle_layout(tensors):
    """GPT-2 tensors by the JAX model's names in Paddle's layout: Linear
    weights (and their gradients) ``[in, out]``, the rest as they are."""
    from paddle_tpu_torch.models.convert import gpt2_linear
    return {n: t.t() if gpt2_linear(n) else t for n, t in tensors.items()}


def spine_params(model):
    """The torch.nn model's weights as Paddle ``Parameter``s (copies, Linear
    weights transposed to ``[in, out]``), by the JAX model's names."""
    import paddle_tpu_torch as paddle
    return {n: paddle.Parameter(w.contiguous().clone(), name=n)
            for n, w in paddle_layout({n: p.detach() for n, p in
                                       model.named_parameters()}).items()}


def _spine_grads(params):
    """Each parameter's gradient as float32, in torch's layout."""
    return {n: g.float() for n, g in paddle_layout(
        {n: p.grad._buf for n, p in params.items()
         if p.grad is not None}).items()}


def _dispatch_costs(fn):
    """(apply_op dispatches, mean host microseconds each) of one call of fn,
    read from the observability dispatch families."""
    from paddle_tpu_torch import observability as obs
    obs.reset()
    obs.enable()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        obs.disable()
    snap = obs.snapshot(prefix="dispatch_ops_total").get(
        "dispatch_ops_total", {"series": []})
    n = int(sum(s["value"] for s in snap["series"]))
    hist = obs.DISPATCH_SECONDS.labels()
    return n, hist.sum / max(hist.count, 1) * 1e6


def _grad_errors(got, want):
    """{name: largest error over the largest element} of two gradient
    sets (missing gradients count as infinitely off)."""
    return {n: ((got[n] - g).abs().max() / g.abs().max()).item()
            if n in got else float("inf") for n, g in want.items()}


def _sgd(params, lr):
    """Plain SGD with in-place Tensor ops under no_grad, then clear_grad."""
    import paddle_tpu_torch as paddle
    with paddle.no_grad():
        for p in params.values():
            if p.grad is not None:
                p.subtract_(p.grad * lr)
            p.clear_grad()


def _profiled(fn, dev):
    """One call of fn under torch.profiler: (wall ms, device busy ms, the
    kernels by device time as (name, launches, ms)).  A small kernel,
    synchronised, opens the window (CUPTI may miss the first launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    warm = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation), key=lambda r: -r[2])
    return wall, sum(ms for _, _, ms in rows), rows


def spine_phase(dev, card):
    """GPT-2 124M (``gpt2_bench_config``: bf16, B16 S1024) trained through
    the Paddle Tensor API.  The torch.nn model's flash step on a seeded
    batch is the reference; ``spine_gpt2_loss`` over the same weights as
    Parameters takes SPINE_STEPS plain SGD steps, the first held to it
    (loss at TRAIN_LOSS_TOL, every gradient at TRAIN_GRAD_TOL of its
    largest element), the loss falling, K1-K3 launched layers x steps and
    K4 never; one step with FLAGS_flash_layout_direct (K4 only, held the
    same way); the spine's semantics at full width (paddle.grad, a hook,
    stop_gradient, a PyLayer); and its costs: the step's wall against the
    torch.nn eager step's, dispatches a step and host microseconds each,
    a small add against torch.add, peak memory, and one profiled step of
    each program (device busy, the top kernels).  Returns the numbers."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt2_module import GPT2ForCausalLM
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq = gpt2_bench_config()
    L, heads = cfg.num_layers, cfg.num_heads
    model = GPT2ForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                            generator=torch.Generator(device=dev).manual_seed(
                                SEED))
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    tx = torch.as_tensor(ids[:, :-1], device=dev)
    ty = torch.as_tensor(ids[:, 1:], device=dev)
    x = paddle.to_tensor(ids[:, :-1], place=dev)
    y = paddle.to_tensor(ids[:, 1:], place=dev)

    # the reference: the torch.nn model's flash step (K1-K3)
    with layout_direct(False):
        _, ref = model(tx, labels=ty)
        ref.backward()
    ref_loss = ref.item()
    ref_grads = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)

    def spine_step(params, **kw):
        loss = spine_gpt2_loss(params, x, y, num_heads=heads, **kw)
        loss.backward()
        return loss

    def hold(tag, loss, grads):
        errs = _grad_errors(grads, ref_grads)
        worst = max(errs, key=errs.get)
        check(abs(loss - ref_loss) <= TRAIN_LOSS_TOL,
              f"spine {tag}: loss {loss} vs the torch.nn flash step's "
              f"{ref_loss}")
        check(errs[worst] <= TRAIN_GRAD_TOL,
              f"spine {tag}: gradient of {worst} off by {errs[worst]} of its "
              f"largest")
        print(f"spine {tag}: first loss {loss:.5f} vs the torch.nn flash "
              f"step {ref_loss:.5f} (tol {TRAIN_LOSS_TOL}); {len(errs)} "
              f"gradients, largest error {errs[worst]:.3e} of the largest "
              f"element ({worst}; tol {TRAIN_GRAD_TOL})", flush=True)

    # the Tensor-API steps on the default path (K1-K3)
    params = spine_params(model)
    losses, walls = [], []
    with layout_direct(False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for step in range(SPINE_STEPS):
            t0 = time.perf_counter()
            loss = spine_step(params)
            if step == 0:
                hold("default path", loss.item(), _spine_grads(params))
            _sgd(params, SPINE_LR)
            losses.append(loss.item())
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: L * SPINE_STEPS if k in ("K1", "K2", "K3") else 0
            for k in FLASH_COUNTERS}
    print(f"spine gpt2-124m bf16 B{batch} S{seq}: SGD({SPINE_LR}) losses "
          f"{[round(v, 4) for v in losses]}; flash launches {launches} "
          f"(expected {want}: {L} layers x {SPINE_STEPS} steps)", flush=True)
    check(all(np.isfinite(losses)), "spine: a loss is not finite")
    check(losses[-1] < losses[0], f"spine: the loss did not fall ({losses})")
    check(launches == want, f"spine: launches {launches}, expected {want}")

    # one step with FLAGS_flash_layout_direct (K4), from the model's weights
    direct_params = spine_params(model)
    with layout_direct(True):
        reset_launch_counts()
        loss = spine_step(direct_params)
        hold("layout-direct", loss.item(), _spine_grads(direct_params))
        direct = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    want_d = {k: L if k.startswith("K4") else 0 for k in FLASH_COUNTERS}
    print(f"spine layout-direct step: flash launches {direct} (expected "
          f"{want_d})", flush=True)
    check(direct == want_d, f"spine layout-direct: launches {direct}")
    del direct_params

    # semantics at full width, on fresh Parameters of the model's weights
    sem = spine_params(model)
    up, down = "gpt2.blocks.0.attn.qkv.weight", "gpt2.ln_f.weight"
    frozen = "gpt2.blocks.0.mlp.fc.weight"

    def clear():
        for p in sem.values():
            p.clear_grad()
    with layout_direct(False):
        first = spine_step(sem).item()              # every .grad is set
        plain = _spine_grads(sem)
        before = {n: (p.grad, p.grad._buf.clone()) for n, p in sem.items()}
        taps = {}
        loss = spine_gpt2_loss(sem, x, y, num_heads=heads,
                               tap=lambda k, t: taps.setdefault(k, t))
        (g_emb,) = paddle.grad(loss, [taps["emb"]])
        untouched = all(sem[n].grad is g and torch.equal(g._buf, v)
                        for n, (g, v) in before.items())
        check(untouched and taps["emb"].grad is None,
              "spine: paddle.grad changed a .grad")
        check(g_emb.shape == [batch, seq, cfg.hidden_size]
              and bool(torch.isfinite(g_emb._buf).all()),
              f"spine: paddle.grad of the embedding: {g_emb.shape}")
        del before, taps, g_emb
        clear()

        def double_attn0(k, t):
            if k == "attn0":
                t.register_hook(lambda g: g * 2)
        spine_step(sem, tap=double_attn0)
        hooked = _spine_grads(sem)
        twice = ((hooked[up] - 2 * plain[up]).abs().max()
                 / (2 * plain[up]).abs().max()).item()
        same = ((hooked[down] - plain[down]).abs().max()
                / plain[down].abs().max()).item()
        check(twice <= 1e-2 and same <= TRAIN_GRAD_TOL,
              f"spine: a hook doubling attn0's gradient left {up} off 2x by "
              f"{twice} and {down} off by {same}")
        del hooked
        clear()
        sem[frozen].stop_gradient = True
        spine_step(sem)
        check(sem[frozen].grad is None
              and all(p.grad is not None for n, p in sem.items()
                      if n != frozen),
              "spine: a stop_gradient weight got a gradient, or another none")
        sem[frozen].stop_gradient = False
        clear()
        pl = spine_step(sem, gelu=spine_gelu_layer().apply).item()
        errs = _grad_errors(_spine_grads(sem), plain)
        worst = max(errs, key=errs.get)
        check(abs(pl - first) <= TRAIN_LOSS_TOL
              and errs[worst] <= TRAIN_GRAD_TOL,
              f"spine: the PyLayer GELU's loss {pl} vs {first}, gradient "
              f"of {worst} off by {errs[worst]}")
    print(f"spine semantics: paddle.grad left all {len(sem)} .grad "
          f"untouched; a hook doubling attn0's gradient doubled {up}'s "
          f"(error {twice:.2e}) and left {down}'s ({same:.2e}); the "
          f"stop_gradient {frozen} got none; the PyLayer GELU matched its "
          f"plain twin (loss {pl:.5f} vs {first:.5f}, largest gradient error "
          f"{errs[worst]:.2e}, {worst})", flush=True)
    del sem, plain

    def tensor_api_step():
        spine_step(params)
        _sgd(params, SPINE_LR)

    # costs: dispatches a step and host time each (the observability
    # recorder), outside the counted steps
    n_disp, host_us = _dispatch_costs(tensor_api_step)

    def nn_step():
        _, loss = model(tx, labels=ty)
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(p.grad * SPINE_LR)
                p.grad = None
        return loss

    profiles = {"Tensor-API": _profiled(tensor_api_step, dev)}
    del params
    # the torch.nn eager step on the same batch (plain SGD, the same lr)
    nn_walls = []
    for _ in range(SPINE_TIMED_NN):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nn_step().item()
        nn_walls.append((time.perf_counter() - t0) * 1e3)
    profiles["torch.nn"] = _profiled(nn_step, dev)
    for tag, (wall, busy, rows) in profiles.items():
        print(f"profile spine {tag} step: {wall:.1f} ms (profiled), device "
              f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
              f"{sum(n for _, n, _ in rows)} kernels", flush=True)
        for key, count, ms in rows[:10]:
            print(f"profile spine {tag}:   {ms:9.3f} ms "
                  f"{100 * ms / busy:5.1f}%  x{count:<5d} {key[:90]}")
    # one small add: the Tensor's dispatch against the raw torch call
    a = paddle.to_tensor(np.ones(8, np.float32), place=dev)
    ta = a._buf
    t_port = Timer.host_us(lambda: a + a, n=SPINE_ADDS)
    t_raw = Timer.host_us(lambda: torch.add(ta, ta), n=SPINE_ADDS)
    step_ms = float(np.median(walls[1:]))
    nn_ms = float(np.median(nn_walls))
    print(f"spine cost: Tensor-API step {step_ms:.2f} ms (median of steps "
          f"2-{SPINE_STEPS}; {[round(w, 2) for w in walls]}) vs the torch.nn "
          f"eager step {nn_ms:.2f} ms ({[round(w, 2) for w in nn_walls]}), "
          f"{step_ms / nn_ms:.3f}x; {n_disp} apply_op dispatches a step at "
          f"{host_us:.2f} host us each; a small add {t_port:.2f} us vs "
          f"torch.add {t_raw:.2f} us ({t_port / t_raw:.2f}x); peak memory "
          f"{peak:.2f} GiB over the Tensor-API steps; on {card}", flush=True)
    del model, ref_grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "nn_step_ms": nn_ms, "dispatches": n_disp,
            "host_us": host_us, "add_us": t_port, "torch_add_us": t_raw,
            "peak_gib": peak, "launches": launches, "direct": direct,
            "busy_ms": {k: v[1] for k, v in profiles.items()}}


# ------------------------------------- phase 6c: nn.Layer and optimizers (M2)
LAYER_TIMED = 6          # timed steps after the checked first one (median)
LAYER_LR = 3e-4          # bench.py's AdamW rate
# bf16 agreement of a parameter after the first AdamW step with the torch.nn
# model's, as a share of its largest element.  Adam's first update is about
# lr * sign(g), so where the reference gradient is within the gradient bar
# of zero (TRAIN_GRAD_TOL of its largest element) the two runs may step in
# opposite directions: there the bar is 2 lr plus one bf16 rounding.
LAYER_PARAM_TOL = 2e-2
LAYER_ROUND_TRIP_B = 2   # batch of the state_dict round trip's forward


def layer_phase(dev, card):
    """The reference's own GPT-2 124M written on ``nn.Layer``
    (``models/gpt2.py``; ``gpt2_bench_config``: bf16, B16 S1024, one 16384-
    token bf16 loss chunk) trained with ``paddle.optimizer.AdamW`` and
    ``ClipGradByGlobalNorm`` through ``bench.py``'s ``train_step``, on the
    card.  The torch.nn model's weights load through ``set_state_dict``
    from numpy; its first step (the port's AdamW on torch tensors) is the
    reference: one step with FLAGS_flash_layout_direct (K4 only) and the
    first default step (K1-K3) held to its loss and block 0's attention
    gradients, every parameter after the first AdamW step held to its, the
    loss falling over the timed steps, K1-K3 launched layers x steps and
    K4 never; a state_dict round trip into a fresh model gives an equal
    forward.  Then the costs beside the torch.nn AdamW step of this run:
    step ms, tokens/s, MFU, apply_op dispatches and host us each, peak
    memory, one profiled step each.  Returns the numbers."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.models.gpt2 import GPT2ForCausalLM as LayerGPT2
    from paddle_tpu_torch.models.gpt2_module import GPT2ForCausalLM
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq = gpt2_bench_config()
    L = cfg.num_layers
    paddle.set_device(dev)           # the Layer's parameters go there
    ref = GPT2ForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED))
    paddle.seed(SEED)
    model = LayerGPT2(cfg)
    params = model.parameters()
    model.to(dtype="bfloat16")
    check(all(a is b and b.dtype == torch.bfloat16 and b.is_leaf
              and not b.stop_gradient
              for a, b in zip(params, model.parameters())),
          "layer: to(dtype=) did not keep the parameters trainable leaves")
    weights = {n: p.detach() for n, p in ref.named_parameters()}
    missing, unexpected = model.set_state_dict(
        {n: w.float().cpu().numpy() for n, w in paddle_layout(weights).items()})
    check(not missing and not unexpected,
          f"layer: set_state_dict missing {missing}, unexpected {unexpected}")
    opt = paddle.optimizer.AdamW(LAYER_LR, weight_decay=0.01,
                                 parameters=model.parameters(),
                                 grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    n_params = sum(p.size for p in model.parameters())

    def step(x, y):                  # bench.py _train's train_step, verbatim
        _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    x = paddle.to_tensor(ids[:, :-1])
    y = paddle.to_tensor(ids[:, 1:])
    tx, ty = x._buf.long(), y._buf.long()

    # the reference: the torch.nn model's first step (K1-K3) and the port's
    # AdamW on its torch tensors
    topt = new_adamw(ref)
    with layout_direct(False):
        _, rl = ref(tx, labels=ty)
        rl.backward()
        ref_loss = rl.item()
        ref_grads = {n: g.float() for n, g in paddle_layout(
            {n: p.grad for n, p in ref.named_parameters()}).items()}
        topt.step()
        topt.clear_grad()
    ref_after = {n: w.float() for n, w in paddle_layout(weights).items()}
    attn0 = [n for n in ref_grads if n.startswith("gpt2.blocks.0.attn.")]

    def hold(tag, loss):
        got = {n: p.grad._buf.float() for n, p in model.named_parameters()
               if p.grad is not None}
        check(set(got) == set(ref_grads), "ernie: the flash route's "
              "gradients are not the dense twin's parameters")
        errs = _grad_errors(got, ref_grads)
        worst = max(errs, key=errs.get)
        check(abs(loss - ref_loss) <= TRAIN_LOSS_TOL,
              f"layer {tag}: loss {loss} vs the torch.nn step's {ref_loss}")
        bad = {n: errs[n] for n in attn0 if not errs[n] <= TRAIN_GRAD_TOL}
        check(not bad, f"layer {tag}: block 0's attention gradients off by "
              f"{bad} of their largest")
        print(f"layer {tag}: first loss {loss:.5f} vs the torch.nn step "
              f"{ref_loss:.5f} (tol {TRAIN_LOSS_TOL}); block 0 attention "
              f"gradients off by "
              + ", ".join(f"{n.split('.', 3)[-1]} {errs[n]:.3e}"
                          for n in attn0)
              + f" of their largest (tol {TRAIN_GRAD_TOL}); all {len(errs)} "
              f"gradients within {errs[worst]:.3e} ({worst})", flush=True)

    # one step's forward and backward with FLAGS_flash_layout_direct (K4)
    with layout_direct(True):
        torch.cuda.synchronize()
        reset_launch_counts()
        _, loss = model(x, labels=y)
        loss.backward()
        hold("layout-direct", loss.item())
        direct = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    model.clear_gradients()
    want_d = {k: L if k.startswith("K4") else 0 for k in FLASH_COUNTERS}
    check(direct == want_d, f"layer layout-direct: launches {direct}, "
          f"expected {want_d}")

    # the default path: the checked first step, then the timed ones
    with layout_direct(False):
        torch.cuda.synchronize()
        reset_launch_counts()
        _, loss = model(x, labels=y)
        loss.backward()
        first = loss.item()
        hold("default path", first)
        opt.step()
        opt.clear_grad()
        worst, flips = 0.0, 0
        for n, p in model.named_parameters():
            want = ref_after[n]
            diff = (p._buf.float() - want).abs()
            top = want.abs().max()
            flip = ref_grads[n].abs() <= TRAIN_GRAD_TOL * ref_grads[n].abs().max()
            ok = (diff <= LAYER_PARAM_TOL * top) | (
                flip & (diff <= 2 * LAYER_LR + 2 ** -7 * want.abs()))
            check(bool(ok.all()), f"layer: parameter {n} after the first "
                  f"AdamW step off by {diff.max().item()} (largest element "
                  f"{top.item()})")
            worst = max(worst, (diff.max() / top).item())
            flips += int((flip & (diff > LAYER_PARAM_TOL * top)).sum())
        print(f"layer: every parameter after the first AdamW + clip step vs "
              f"the torch.nn model's: largest error {worst:.3e} of the "
              f"largest element (tol {LAYER_PARAM_TOL}); {flips} elements "
              f"past it, each where the reference gradient is within "
              f"{TRAIN_GRAD_TOL} of its largest, within 2 lr", flush=True)
        del ref_after, ref_grads
        losses, walls = [first], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(LAYER_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(x, y).item())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 1 + LAYER_TIMED
    want = {k: L * steps if k in ("K1", "K2", "K3") else 0
            for k in FLASH_COUNTERS}
    print(f"layer gpt2-124m bf16 B{batch} S{seq}: AdamW + clip losses "
          f"{[round(v, 4) for v in losses]}; flash launches {launches} "
          f"(expected {want}: {L} layers x {steps} steps)", flush=True)
    check(all(np.isfinite(losses)), "layer: a loss is not finite")
    check(losses[-1] < losses[0], f"layer: the loss did not fall ({losses})")
    check(launches == want, f"layer: launches {launches}, expected {want}")

    # the state_dict round trip: numpy out, a fresh model, an equal forward
    paddle.seed(SEED + 1)
    fresh = LayerGPT2(cfg)
    fresh.to(dtype="bfloat16")
    fresh.set_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    xs = x[:LAYER_ROUND_TRIP_B]
    model.eval()
    fresh.eval()
    with paddle.no_grad(), layout_direct(False):
        a, b = model(xs), fresh(xs)
        same = torch.equal(a._buf, b._buf)
    model.train()
    check(same, "layer: a fresh model from the state_dict's numpy arrays "
          "gives another forward")
    print(f"layer: state_dict -> numpy -> a fresh model: {len(model.state_dict())} "
          f"arrays, logits [{LAYER_ROUND_TRIP_B}, {seq}, {cfg.vocab_size}] "
          f"bitwise equal", flush=True)
    del fresh, a, b

    # costs: dispatches and host time a step, the profiled step, and the
    # torch.nn AdamW step of this run on the same batch
    n_disp, host_us = _dispatch_costs(lambda: step(x, y))
    profiles = {"Layer": _profiled(lambda: step(x, y), dev)}
    nn_walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LAYER_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(ref, topt, tx, ty).item()
        torch.cuda.synchronize()
        nn_walls.append((time.perf_counter() - t0) * 1e3)
    nn_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nn_disp, _ = _dispatch_costs(lambda: train_step(ref, topt, tx, ty))
    profiles["torch.nn"] = _profiled(
        lambda: train_step(ref, topt, tx, ty), dev)
    flops_per_token = 6 * n_params + 12 * L * cfg.hidden_size * seq
    out = {}
    for tag, ws, pk, nd in (("Layer", walls, peak, n_disp),
                            ("torch.nn", nn_walls, nn_peak, nn_disp)):
        ms = float(np.median(ws))
        tok_s = batch * seq / (ms / 1e3)
        wall, busy, rows = profiles[tag]
        out[tag] = {"step_ms": ms, "tokens_s": tok_s,
                    "mfu": tok_s * flops_per_token / BF16_FLOPS,
                    "peak_gib": pk, "dispatches": nd, "busy_ms": busy,
                    "profiled_ms": wall}
        print(f"layer cost {tag} AdamW step: median {ms:.2f} ms over "
              f"{len(ws)} steps ({[round(w, 2) for w in ws]}), {tok_s:.0f} "
              f"tokens/s, MFU {out[tag]['mfu']:.4f}, {nd} apply_op "
              f"dispatches a step, peak memory {pk:.2f} GiB; profiled "
              f"{wall:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / wall:.1f}%), {sum(n for _, n, _ in rows)} "
              f"kernels; on {card}", flush=True)
        for key, count, kms in rows[:10]:
            print(f"profile layer {tag}:   {kms:9.3f} ms "
                  f"{100 * kms / busy:5.1f}%  x{count:<5d} {key[:90]}")
    out["Layer"]["host_us"] = host_us
    print(f"layer cost: the Layer step {out['Layer']['step_ms']:.2f} ms vs "
          f"the torch.nn AdamW step {out['torch.nn']['step_ms']:.2f} ms, "
          f"{out['Layer']['step_ms'] / out['torch.nn']['step_ms']:.3f}x; "
          f"{n_disp} apply_op dispatches a step at {host_us:.2f} host us "
          f"each; device busy {out['Layer']['busy_ms']:.1f} vs "
          f"{out['torch.nn']['busy_ms']:.1f} ms; on {card}", flush=True)
    del model, opt, ref, topt
    gc.collect()
    torch.cuda.empty_cache()
    out.update(launches=launches, direct=direct)
    return out


# ------------------------------------ phase 6d: train-step capture (M5b)
CAPTURE_REPLAYS = 6      # timed replays of a captured step (median)
CAPTURE_WARM = 4         # calls a step may take to be captured (spies)
DIRECT_REPLAYS = 3       # replays of the layout-direct capture
SCAN_K = (1, 6)          # scan_steps' K: the differential's low and high
SCAN_TRIALS = 3          # (t_hi - t_lo) / (k_hi - k_lo) samples, median
GUARD_REPLAYS = 6        # timed replays of the guarded and broken step
AMP_REPLAYS = 3          # replays of each AMP capture


def _programs(static):
    """The CapturedPrograms of a StaticFunction's variants."""
    return [v.compiled for g in static._cache.values() for v in g.variants
            if v.compiled is not None]


def _graphs(static):
    return sum(p.graph is not None for p in _programs(static))


def _synced(fn):
    """(fn's result, wall ms), the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _bench_step(model, opt):
    def train_step(x, y):            # bench.py _train's train_step, verbatim
        _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return train_step


def _warm_capture(static, call, tag, graphs=1):
    """Call a to_static step until it has ``graphs`` graphs (the spy, a
    re-spy for state the spy made, the capture): the losses, and the peak
    memory allocated during the call that captured (GiB)."""
    losses = []
    while _graphs(static) < graphs:
        check(len(losses) < CAPTURE_WARM,
              f"capture {tag}: no graph after {len(losses)} calls")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses.append(call())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(not any(g.eager_only for g in static._cache.values()),
          f"capture {tag}: the signature fell back to eager")
    return losses, peak


def _hold_twins(tag, got, want, a, b, bar=LAYER_PARAM_TOL):
    """Losses of the captured run against the eager twin's (the bf16 bar,
    TRAIN_LOSS_TOL), then every parameter (``bar`` of its largest
    element); returns whether everything is bitwise equal."""
    got, want = [float(v) for v in got], [float(v) for v in want]
    check(len(got) == len(want) and all(np.isfinite(got)),
          f"capture {tag}: losses {got} vs the eager twin's {want}")
    worst_loss = max(abs(g - w) for g, w in zip(got, want))
    check(worst_loss <= TRAIN_LOSS_TOL, f"capture {tag}: losses {got} vs "
          f"the eager twin's {want}")
    worst, same = 0.0, got == want
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        pa, pb = p._buf.float(), q._buf.float()
        same = same and torch.equal(p._buf, q._buf)
        top = pb.abs().max().item()
        err = (pa - pb).abs().max().item()
        check(err <= bar * top, f"capture {tag}: parameter {n} off the eager "
              f"twin's by {err} (largest element {top})")
        worst = max(worst, err / top if top else err)
    print(f"capture {tag}: {len(got)} losses vs the eager twin's, largest "
          f"difference {worst_loss:.3e} (tol {TRAIN_LOSS_TOL}); every "
          f"parameter within {worst:.3e} of its largest element (tol {bar}); "
          f"{'bitwise equal' if same else 'not bitwise equal'}", flush=True)
    return same


def capture_phase(dev, card):
    """Train-step capture on the card (``jit.to_static``, ``scan_steps``,
    ``amp``): the reference's GPT-2 124M on ``nn.Layer`` (bf16, B16 S1024,
    the torch.nn model's weights) with bench.py's AdamW + clip, each
    captured step held to an eager twin from the same weights taking the
    same steps: ``to_static(train_step)`` (spy, capture, replays: K1-K3
    layers x replays and K4 never through the replay tally, the body not
    run and 0 apply_op dispatches in a replay), the same with
    FLAGS_flash_layout_direct (K4 only), ``scan_steps`` at K = 1 and 6
    (bench.py's differential), a guarded and broken step (a loss guard, a
    float(loss) metric, one forced guard flip) and the float32 model under
    O1 autocast with a GradScaler and after ``amp.decorate(level="O2")``.
    Returns the numbers."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.core.dispatch import _state
    from paddle_tpu_torch.models.gpt2 import GPT2ForCausalLM as LayerGPT2
    from paddle_tpu_torch.models.gpt2_module import GPT2ForCausalLM
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq = gpt2_bench_config()
    L = cfg.num_layers
    paddle.set_device(dev)
    out = {}
    ref = GPT2ForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED))
    weights = {n: w.float().cpu().numpy() for n, w in paddle_layout(
        {n: p.detach() for n, p in ref.named_parameters()}).items()}
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                           (batch, seq + 1))
    x = paddle.to_tensor(ids[:, :-1])
    y = paddle.to_tensor(ids[:, 1:])
    tx, ty = x._buf.long(), y._buf.long()
    n_params = sum(p.numel() for p in ref.parameters())
    flops_per_token = 6 * n_params + 12 * L * cfg.hidden_size * seq

    def rate(ms):
        tok_s = batch * seq / (ms / 1e3)
        return tok_s, tok_s * flops_per_token / BF16_FLOPS

    # the torch.nn AdamW step of this run, the yardstick
    topt = new_adamw(ref)
    nn_ms = [_synced(lambda: train_step(ref, topt, tx, ty))[1]
             for _ in range(1 + CAPTURE_REPLAYS)][1:]
    del ref, topt
    gc.collect()
    torch.cuda.empty_cache()

    def layer_model(dtype="bfloat16"):
        paddle.seed(SEED)
        m = LayerGPT2(cfg)
        if dtype != "float32":
            m.to(dtype=dtype)
        missing, unexpected = m.set_state_dict(weights)
        check(not missing and not unexpected, "capture: set_state_dict")
        return m

    def adamw(m):
        return paddle.optimizer.AdamW(LAYER_LR, weight_decay=0.01,
                                      parameters=m.parameters(),
                                      grad_clip=pnn.ClipGradByGlobalNorm(1.0))

    def reset(*models):
        for m in models:
            m.set_state_dict(weights)
            m.clear_gradients()

    def free(*statics):
        for s in statics:
            s._cache.clear()
        gc.collect()
        torch.cuda.empty_cache()

    A, B = layer_model(), layer_model()
    body = {"n": 0}
    A.register_forward_pre_hook(
        lambda layer, inputs: body.__setitem__("n", body["n"] + 1))

    # 1. to_static(train_step): spy, capture, replays, beside the eager twin
    optA, optB = adamw(A), adamw(B)
    stepA, stepB = _bench_step(A, optA), _bench_step(B, optB)
    static = paddle.jit.to_static(stepA)
    with layout_direct(False):
        t0 = time.perf_counter()
        warm, cap_peak = _warm_capture(static, lambda: static(x, y).item(),
                                       "step")
        warm_s = time.perf_counter() - t0
        (prog,) = _programs(static)
        want = [stepB(x, y).item() for _ in warm]
        n0, rep0 = body["n"], prog.replays
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        got, walls = [], []
        for _ in range(CAPTURE_REPLAYS):
            loss, wall = _synced(lambda: static(x, y))
            got.append(loss.item())
            walls.append(wall)
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        # a replay allocates nothing: its blocks are the graph pool's,
        # allocated while capturing (cap_peak)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(body["n"] == n0, f"capture step: the Python body ran "
              f"{body['n'] - n0} times in {CAPTURE_REPLAYS} replays")
        check(prog.replays - rep0 == CAPTURE_REPLAYS and prog.captures == 1
              and prog.eager == 0, f"capture step: program {prog.stats()}")
        wantL = {k: L * CAPTURE_REPLAYS if k in ("K1", "K2", "K3") else 0
                 for k in FLASH_COUNTERS}
        check(launches == wantL, f"capture step: replays launched {launches}"
              f", expected {wantL}")
        torch.cuda.reset_peak_memory_stats()
        eager, eager_ms = [], []
        for _ in range(CAPTURE_REPLAYS):
            loss, wall = _synced(lambda: stepB(x, y))
            eager.append(loss.item())
            eager_ms.append(wall)
        eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_disp, _ = _dispatch_costs(lambda: static(x, y))
        e_disp, e_host = _dispatch_costs(lambda: stepB(x, y))
        check(n_disp == 0, f"capture step: a replay made {n_disp} apply_op "
              "dispatches")
        prof = {"captured": _profiled(lambda: static(x, y), dev),
                "eager": _profiled(lambda: stepB(x, y), dev)}
        same = _hold_twins("step", warm + got, want + eager, A, B)
    ms, e_ms = float(np.median(walls)), float(np.median(eager_ms))
    nn_med = float(np.median(nn_ms))
    out["step"] = {"ms": ms, "eager_ms": e_ms, "nn_ms": nn_med,
                   "capture_s": prog.capture_s, "warm_calls": len(warm),
                   "warm_s": warm_s, "replay_peak_gib": peak,
                   "capture_peak_gib": cap_peak,
                   "eager_peak_gib": eager_peak, "launches": launches,
                   "bitwise": same, "eager_dispatches": e_disp,
                   "eager_host_us": e_host,
                   "busy_ms": prof["captured"][1],
                   "eager_busy_ms": prof["eager"][1]}
    for tag, w in (("captured", ms), ("eager Layer", e_ms),
                   ("torch.nn", nn_med)):
        tok_s, mfu = rate(w)
        out["step"][f"{tag}_tokens_s"] = tok_s
        print(f"capture cost {tag} step: median {w:.2f} ms, {tok_s:.0f} "
              f"tokens/s, MFU {mfu:.4f}; on {card}", flush=True)
    for tag, (wall, busy, rows) in prof.items():
        print(f"capture profile {tag}: 1 step in {wall:.1f} ms (profiled), "
              f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
              f"{sum(n for _, n, _ in rows)} kernels", flush=True)
        for key, count, kms in rows[:6]:
            print(f"capture profile {tag}:   {kms:9.3f} ms x{count:<5d} "
                  f"{key[:80]}")
    print(f"capture step: gpt2-124m bf16 B{batch} S{seq} to_static("
          f"train_step) captured at call {len(warm)} ({prog.capture_s:.2f} s "
          f"capturing, {warm_s:.2f} s for the {len(warm)} calls), "
          f"{CAPTURE_REPLAYS} replays {[round(v, 2) for v in walls]} ms: "
          f"median {ms:.2f} ms vs the eager Layer step {e_ms:.2f} ms "
          f"({[round(v, 2) for v in eager_ms]}) and the torch.nn AdamW step "
          f"{nn_med:.2f} ms; replay launches {launches}; 0 Python bodies and "
          f"{n_disp} apply_op dispatches a replay (eager: {e_disp} at "
          f"{e_host:.1f} host us); peak memory over the capturing call "
          f"{cap_peak:.2f} GiB, over the replays {peak:.2f} (the eager "
          f"twin's steps {eager_peak:.2f}; both models and optimizers "
          f"resident); on {card}", flush=True)

    # 2. the same step with FLAGS_flash_layout_direct, captured (K4 only)
    with layout_direct(True):
        static_d = paddle.jit.to_static(stepA)
        warm, _ = _warm_capture(static_d, lambda: static_d(x, y).item(),
                                "layout-direct")
        want = [stepB(x, y).item() for _ in warm]
        reset_launch_counts()
        got = [static_d(x, y).item() for _ in range(DIRECT_REPLAYS)]
        launches_d = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        want += [stepB(x, y).item() for _ in range(DIRECT_REPLAYS)]
        wantD = {k: L * DIRECT_REPLAYS if k.startswith("K4") else 0
                 for k in FLASH_COUNTERS}
        check(launches_d == wantD, f"capture layout-direct: replays "
              f"launched {launches_d}, expected {wantD}")
        _hold_twins("layout-direct", warm + got, want, A, B)
    print(f"capture layout-direct: captured at call {len(warm)}, "
          f"{DIRECT_REPLAYS} replays launched {launches_d}", flush=True)
    out["direct"] = {"launches": launches_d}
    free(static, static_d)

    # 3. scan_steps at K = 1 and K = 6: bench.py's differential
    scan = paddle.jit.scan_steps(stepA)

    def stacked(k):
        return (paddle.to_tensor(np.repeat(ids[None, :, :-1], k, 0)),
                paddle.to_tensor(np.repeat(ids[None, :, 1:], k, 0)))

    lo, hi = SCAN_K
    lo_data, hi_data = stacked(lo), stacked(hi)
    with layout_direct(False):
        t0 = time.perf_counter()
        # the peak while capturing K steps in one graph: the pool hands a
        # step the blocks the step before it freed, or it holds K steps
        scan_peak = {k: _warm_capture(scan, lambda d=d: scan(*d), f"scan K "
                                      f"= {k}", graphs=n)[1]
                     for n, (k, d) in enumerate(((lo, lo_data),
                                                 (hi, hi_data)), 1)}
        scan_warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses_hi = scan(*hi_data)
        scan_launch = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        wantS = {k: L * hi if k in ("K1", "K2", "K3") else 0
                 for k in FLASH_COUNTERS}
        check(scan_launch == wantS, f"capture scan: K = {hi} launched "
              f"{scan_launch}, expected {wantS}")
        vals = [float(v) for v in losses_hi.numpy()]
        check(all(np.isfinite(vals)) and vals[-1] < vals[0],
              f"capture scan: K = {hi} losses {vals}")
        diffs, uppers = [], []
        for _ in range(SCAN_TRIALS):
            _, t_lo = _synced(lambda: scan(*lo_data).numpy())
            _, t_hi = _synced(lambda: scan(*hi_data).numpy())
            uppers.append(t_hi / hi)
            diffs.append((t_hi - t_lo) / (hi - lo))
        replay_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    diffs.sort()
    dt, upper = diffs[len(diffs) // 2], min(uppers)
    scan_cap = sum(p.capture_s for p in _programs(scan))
    tok_s, mfu = rate(dt)
    print(f"capture scan_steps: K = {lo} and {hi} captured ({scan_cap:.2f} s "
          f"capturing, {scan_warm_s:.2f} s for the spies and captures); "
          f"K = {hi} losses {[round(v, 4) for v in vals]}, launches "
          f"{scan_launch}; step (t{hi} - t{lo}) / {hi - lo} samples "
          f"{[round(d, 3) for d in diffs]} ms: median {dt:.2f} ms, upper "
          f"bound t{hi} / {hi} {upper:.2f} ms; {tok_s:.0f} tokens/s, MFU "
          f"{mfu:.4f}; peak memory over the capturing call at K = {lo} "
          f"{scan_peak[lo]:.2f} GiB, at K = {hi} {scan_peak[hi]:.2f} GiB, "
          f"over the replays {replay_peak:.2f} GiB (the eager twin's steps "
          f"{eager_peak:.2f}); on {card}", flush=True)
    out["scan"] = {"ms": dt, "upper_ms": upper, "samples": diffs,
                   "capture_s": scan_cap, "peak_gib": scan_peak,
                   "replay_peak_gib": replay_peak,
                   "tokens_s": tok_s, "mfu": mfu}
    free(scan)

    # 4. the guarded and broken step: a loss guard, a float(loss) metric
    reset(A, B)
    optA, optB = adamw(A), adamw(B)
    metrics_a, metrics_b = [], []

    def guarded(model, opt, metrics):
        def step(x, y, thresh):
            _, loss = model(x, labels=y)
            loss.backward()
            if loss > thresh:          # skip the update on a loss explosion
                opt.clear_grad()
            else:
                opt.step()
                opt.clear_grad()
            metrics.append(float(loss))
            return loss
        return step

    stepB = guarded(B, optB, metrics_b)
    static_g = paddle.jit.to_static(guarded(A, optA, metrics_a))
    high = paddle.to_tensor(np.float32(1e6))
    low = paddle.to_tensor(np.float32(0.0))
    echo_ms = []
    real_echo = static_g._echo

    def timed_echo(*a):
        t0 = time.perf_counter()
        try:
            return real_echo(*a)
        finally:
            echo_ms.append((time.perf_counter() - t0) * 1e3)

    static_g._echo = timed_echo
    with layout_direct(False):
        warm, _ = _warm_capture(static_g,
                                lambda: static_g(x, y, high).item(),
                                "guarded")
        want = [stepB(x, y, high).item() for _ in warm]
        n0 = body["n"]
        got, walls = [], []
        for _ in range(GUARD_REPLAYS):
            loss, wall = _synced(lambda: static_g(x, y, high))
            got.append(loss.item())
            walls.append(wall)
        want += [stepB(x, y, high).item() for _ in range(GUARD_REPLAYS)]
        (prog,) = _programs(static_g)
        check(prog.captures == 1 and prog.replays >= GUARD_REPLAYS
              and len(echo_ms) >= GUARD_REPLAYS, f"capture guarded: program "
              f"{prog.stats()}, {len(echo_ms)} echo passes")
        # the echo pass runs the Python once a call; the body did not
        check(body["n"] - n0 == len(echo_ms[-GUARD_REPLAYS:]),
              f"capture guarded: {body['n'] - n0} forwards in "
              f"{GUARD_REPLAYS} replays")
        steady_echo = list(echo_ms)
        check(metrics_a[-GUARD_REPLAYS:] == got,
              f"capture guarded: the metric hook saw {metrics_a[-6:]}, the "
              f"steps returned {got}")
        # one forced flip: the update variant replays, its guard diverges,
        # the snapshot rolls the step back, the skip branch is captured
        flip = [static_g(x, y, low).item(), static_g(x, y, high).item(),
                static_g(x, y, high).item()]
        want += [stepB(x, y, low).item(), stepB(x, y, high).item(),
                 stepB(x, y, high).item()]
        group = next(iter(static_g._cache.values()))
        check(not group.eager_only and len(group.variants) == 2,
              f"capture guarded: {len(group.variants)} variants, eager-only "
              f"{group.eager_only}")
        same_g = _hold_twins("guarded", warm + got + flip, want, A, B)
        # (a capture re-runs the Python with the spy's values: one stale
        # entry per capture, as in the reference)
        check(metrics_a[-1] == flip[-1], "capture guarded: the metric hook "
              f"missed the true value after the flip ({metrics_a[-4:]} vs "
              f"{flip})")
    g_ms = float(np.median(walls))
    snap = sum(b.numel() * b.element_size()
               for b in group.variants[0].snap_src) / 2 ** 30
    print(f"capture guarded: the loss-guard + float(loss) step captured at "
          f"call {len(warm)}; {GUARD_REPLAYS} replays "
          f"{[round(v, 2) for v in walls]} ms, median {g_ms:.2f} ms vs the "
          f"plain capture's {ms:.2f} ms: {g_ms - ms:.2f} ms more a step (one "
          f"device->host read of the guard and break, a {snap:.2f} GiB "
          f"snapshot, the echo pass at "
          f"{float(np.median(steady_echo)):.2f} host ms); after one forced "
          f"flip {len(group.variants)} variants, parameters against the "
          f"eager twin's: {'bitwise equal' if same_g else 'within the bar'};"
          f" on {card}", flush=True)
    out["guarded"] = {"ms": g_ms, "extra_ms": g_ms - ms,
                      "echo_ms": float(np.median(steady_echo)),
                      "snapshot_gib": snap, "bitwise": same_g}
    free(static_g)
    del A, B, optA, optB, stepA, stepB
    gc.collect()
    torch.cuda.empty_cache()

    # 5. AMP: the float32 model under O1 with a GradScaler, then O2
    A, B = layer_model("float32"), layer_model("float32")
    for level in ("O1", "O2"):
        reset(A, B)
        optA, optB = adamw(A), adamw(B)
        if level == "O2":
            paddle.amp.decorate(A, optA, level="O2")
            paddle.amp.decorate(B, optB, level="O2")

        def amp_step(model, opt, scaler, level=level):
            def step(x, y):
                with paddle.amp.auto_cast(level=level):
                    _, loss = model(x, labels=y)
                if scaler is None:
                    loss.backward()
                    opt.step()
                else:
                    scaler.scale(loss).backward()
                    scaler.step(opt)
                opt.clear_grad()
                return loss
            return step

        scalers = ((paddle.amp.GradScaler(), paddle.amp.GradScaler())
                   if level == "O1" else (None, None))
        static_a = paddle.jit.to_static(amp_step(A, optA, scalers[0]))
        stepB = amp_step(B, optB, scalers[1])
        with layout_direct(False):
            warm, _ = _warm_capture(static_a, lambda: static_a(x, y).item(),
                                    level)
            want = [stepB(x, y).item() for _ in warm]
            reset_launch_counts()
            got = [static_a(x, y).item() for _ in range(AMP_REPLAYS)]
            launches_a = {k: launch_counts()[k] for k in FLASH_COUNTERS}
            want += [stepB(x, y).item() for _ in range(AMP_REPLAYS)]
            wantA = {k: L * AMP_REPLAYS if k in ("K1", "K2", "K3") else 0
                     for k in FLASH_COUNTERS}
            check(launches_a == wantA, f"capture {level}: replays launched "
                  f"{launches_a}, expected {wantA}")
            same_a = _hold_twins(level, warm + got, want, A, B)
            audit = None
            if level == "O1":
                paddle.set_flags({"FLAGS_low_precision_op_list": 1})
                paddle.amp.clear_low_precision_op_list()
                try:
                    stepB(x, y)
                    audit = paddle.amp.low_precision_op_list()
                finally:
                    paddle.set_flags({"FLAGS_low_precision_op_list": 0})
                    paddle.amp.clear_low_precision_op_list()
                check(audit.get("scaled_dot_product_attention") == L,
                      f"capture O1: the audit saw {audit}")
        print(f"capture {level}: float32 GPT-2 124M "
              f"{'with a GradScaler ' if level == 'O1' else 'decorated O2 '}"
              f"captured at call {len(warm)}, {AMP_REPLAYS} replays launched "
              f"{launches_a} (K1-K3 in bf16); "
              f"{'bitwise equal' if same_a else 'within the bar'}"
              + (f"; one step's low_precision_op_list {audit}" if audit
                 else ""), flush=True)
        out[level] = {"launches": launches_a, "bitwise": same_a,
                      "audit": audit}
        free(static_a)
    del A, B
    gc.collect()
    torch.cuda.empty_cache()
    check(_state.trace_ctx is None, "capture: a trace context leaked")
    return out


# ------------------------------- phase 6e: ERNIE 3.0 base and M2's rest
ERNIE_B, ERNIE_S = 16, 512       # 8192 tokens a step
ERNIE_TIMED = 6                  # timed eager steps after the checked first
ERNIE_REPLAYS = 6                # replays of the captured step
ERNIE_MLM = 0.15                 # share of the positions with an MLM label
ERNIE_MASK_ID = 3                # the input id put at a labelled position
# a query projection's gradient, off the dense twin's by more than the
# training bar, still passes within this factor of the library flash
# attention's error on the same step (measured on the H100: the top
# layers' 4.2-7.2 % against the library's 3.6-6.5 %, relative norm)
LIB_GRAD_FACTOR = 1.25
PAD_B, PAD_LAST = 8, 100         # the padded eval batch, its pad positions
STEM_B = 8                       # the conv / pool stem's batch (224 x 224)
STEM_TOL = 1e-4                  # of each tensor's largest CPU magnitude
GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW = 4, 100, 32
GEN_TOP_K, GEN_TEMPERATURE = 50, 0.8


def ernie_base_config():
    """ernie-3.0-base-zh's geometry (``ErnieConfig.base``: vocab 40000,
    hidden 768, 12 layers of 12 heads, FFN 3072, 2048 positions, 4 token
    types, 3 task types) with dropout off: attention dropout would send
    attention to ``_sdpa_ref`` on both paths (the reference's own capture
    test turns it off for the same reason)."""
    from paddle_tpu_torch.models.ernie import ErnieConfig
    return ErnieConfig.base(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)


def ernie_batch(cfg):
    """Input ids, token types (0 on the first half, 1 on the second) and
    MLM labels (the original id at ``ERNIE_MLM`` of the positions, whose
    input becomes ``ERNIE_MASK_ID``; -100 elsewhere), from ``SEED``."""
    rng = np.random.RandomState(SEED)
    batch, seq = ERNIE_B, ERNIE_S
    ids = rng.randint(5, cfg.vocab_size, (batch, seq))
    tt = np.zeros((batch, seq), np.int64)
    tt[:, seq // 2:] = 1
    pick = rng.rand(batch, seq) < ERNIE_MLM
    labels = np.where(pick, ids, -100)
    return np.where(pick, ERNIE_MASK_ID, ids), tt, labels


def _shift_invariant(name):
    """A key projection's bias: every score of a query moves by the same
    q . b, which the softmax cancels, so its gradient is zero in exact
    arithmetic and what either path computes is rounding."""
    return name.endswith("self_attn.k_proj.bias")


def _query_grad(name):
    """A query projection: its gradient is X^T dQ, and dQ = dS K sums terms
    that cancel (each row of dS sums to zero; with the near-uniform
    attention of random weights over 512 keys, nearly all of each term), so
    the kernels' bf16 dS leaves it a larger error of its largest element
    than any other gradient has."""
    return "self_attn.q_proj." in name


def _ernie_grad_errors(got, want):
    """{name: (largest error over the scale, relative norm error)}: the
    scale is the gradient's own largest element, or for a shift-invariant
    bias its layer's key weight gradient's (its own is rounding on both
    paths)."""
    errs = {}
    for n, g in want.items():
        ref = want[n[:-len("bias")] + "weight"] if _shift_invariant(n) else g
        errs[n] = (((got[n] - g).abs().max() / ref.abs().max()).item(),
                   ((got[n] - g).norm() / ref.norm()).item())
    return errs


def _ernie_step(model, opt):
    def step(x, tt, y):              # bench.py's train_step, ERNIE's inputs
        _, loss = model(x, tt, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def _params_against(tag, model, want, grads, lr, got):
    """Every parameter against ``want`` after one AdamW step (the bar of
    ``layer_phase``: LAYER_PARAM_TOL of the largest element, or 2 lr where
    the reference gradient ``grads`` is within TRAIN_GRAD_TOL of its
    largest element of zero, or where the step's own gradient ``got``
    parts from it by more than LAYER_PARAM_TOL of the element: Adam's
    first update lr g / (|g| + eps) moves by at most lr times g's relative
    change, so elsewhere the bar holds; a parameter without a gradient is
    not stepped)."""
    worst, flips = 0.0, 0
    for n, p in model.named_parameters():
        w = want[n]
        diff = (p._buf.float() - w).abs()
        top = w.abs().max()
        g = grads.get(n, torch.zeros_like(w))
        flip = (g.abs() <= TRAIN_GRAD_TOL * g.abs().max()) & (n in grads)
        if n in got:
            flip = flip | ((got[n] - g).abs() > LAYER_PARAM_TOL * g.abs())
        if _shift_invariant(n):       # its gradient is rounding: any sign
            flip = torch.ones_like(flip)
        ok = (diff <= LAYER_PARAM_TOL * top) | (
            flip & (diff <= 2 * lr + 2 ** -7 * w.abs()))
        if not bool(ok.all()):
            i = int(torch.where(ok, 0.0, diff).argmax())
            at = {k: v.reshape(-1)[i].item() for k, v in (
                ("parameter", p._buf.float()), ("want", w), ("gradient",
                 got.get(n, g)), ("reference gradient", g))}
            check(False, f"{tag}: parameter {n} after the first AdamW step "
                  f"off by {diff.max().item()} (largest element "
                  f"{top.item()}; at element {i}: {at}, the reference "
                  f"gradient's largest {g.abs().max().item()})")
        worst = max(worst, (diff.max() / top.clamp_min(1e-30)).item())
        flips += int((flip & (diff > LAYER_PARAM_TOL * top)).sum())
    return worst, flips


def ernie_train(dev, card, cfg, model, x, tt, y):
    """The eager path: the dense twin's first step (the reference), then
    the checked first step on the flash route, timed steps, the costs."""
    import paddle_tpu_torch as paddle
    L = cfg.num_hidden_layers
    n_params = sum(p.size for p in model.parameters())
    saved = {n: p._buf.detach().clone() for n, p in model.named_parameters()}

    def restore():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p._buf.copy_(saved[n])
        model.clear_gradients()

    # the reference: the same model with attention through _sdpa_ref
    opt = new_adamw(model)
    reset_launch_counts()
    with dense_attention():
        _, rl = model(x, tt, labels=y)
        rl.backward()
        ref_loss = rl.item()
        ref_grads = {n: p.grad._buf.float().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}     # the MLM head skips the pooler
        opt.step()
        opt.clear_grad()
    ref_after = {n: p._buf.float().clone()
                 for n, p in model.named_parameters()}
    dense = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    check(not any(dense.values()), f"ernie: the dense twin launched {dense}")
    restore()
    # the yardstick: the library's flash attention on the same step, its
    # query gradients against the dense twin's
    with library_attention():
        _, ll = model(x, tt, labels=y)
        ll.backward()
        lib = _ernie_grad_errors(
            {n: p.grad._buf.float() for n, p in model.named_parameters()
             if _query_grad(n)},
            {n: g for n, g in ref_grads.items() if _query_grad(n)})
    restore()

    # the flash route: the checked first step, then the timed ones
    opt = new_adamw(model)
    step = _ernie_step(model, opt)
    with layout_direct(False):
        torch.cuda.synchronize()
        reset_launch_counts()
        _, loss = model(x, tt, labels=y)
        loss.backward()
        first = loss.item()
        check(abs(first - ref_loss) <= TRAIN_LOSS_TOL,
              f"ernie: first loss {first} vs the dense twin's {ref_loss}")
        got = {n: p.grad._buf.float() for n, p in model.named_parameters()
               if p.grad is not None}
        check(set(got) == set(ref_grads), "ernie: the flash route's "
              "gradients are not the dense twin's parameters")
        errs = _ernie_grad_errors(got, ref_grads)
        # the query projections by their norm (see _query_grad), every
        # other gradient by its largest element
        held = {n: e[1] if _query_grad(n) else e[0] for n, e in errs.items()}
        bad = {n: errs[n] for n, e in held.items() if not e <= TRAIN_GRAD_TOL}
        # a query projection also passes within LIB_GRAD_FACTOR of the
        # library's flash attention on the same step (its dQ has the same
        # bf16 cancellation: see _query_grad)
        bad = {n: e for n, e in bad.items() if not (
            _query_grad(n) and errs[n][1] <= LIB_GRAD_FACTOR * lib[n][1])}
        check(not bad, f"ernie: gradients off the dense twin's by {bad} "
              f"(of their largest, relative norm); the library's there: "
              f"{ {n: lib[n] for n in bad if n in lib} }")
        rest = [n for n in errs if not _query_grad(n)]
        worst_g = max(rest, key=lambda n: errs[n][0])
        queries = [n for n in errs if _query_grad(n)]
        worst_q = max(queries, key=lambda n: errs[n][1])
        worst_qmax = max(queries, key=lambda n: errs[n][0])
        for n in queries:
            print(f"ernie: {n} gradient vs the dense twin: largest error "
                  f"{errs[n][0]:.3e} of the largest element, relative norm "
                  f"error {errs[n][1]:.3e} (tol {TRAIN_GRAD_TOL}); the "
                  f"library's flash attention (SDPA) on the same step "
                  f"{lib[n][0]:.3e} / {lib[n][1]:.3e}")
        got = {n: g.clone() for n, g in got.items()}
        opt.step()
        opt.clear_grad()
        worst_p, flips = _params_against("ernie", model, ref_after,
                                         ref_grads, LAYER_LR, got)
        del got, ref_after, ref_grads
        print(f"ernie: first loss {first:.5f} vs the dense twin "
              f"{ref_loss:.5f} (tol {TRAIN_LOSS_TOL}); {len(rest)} "
              f"gradients within {errs[worst_g][0]:.3e} of their largest "
              f"({worst_g}; tol {TRAIN_GRAD_TOL}; the key biases', zero in "
              f"exact arithmetic, of their key weights' largest: "
              f"{max(errs[n][0] for n in rest if _shift_invariant(n)):.3e});"
              f" the {len(queries)} query projections' within relative norm "
              f"error {errs[worst_q][1]:.3e} ({worst_q}; tol "
              f"{TRAIN_GRAD_TOL}), their largest elements' error up to "
              f"{errs[worst_qmax][0]:.3e} ({worst_qmax}); every parameter after "
              f"the first AdamW + clip step within {worst_p:.3e} of its "
              f"largest (tol {LAYER_PARAM_TOL}; {flips} elements past it, "
              f"each where the reference gradient is within "
              f"{TRAIN_GRAD_TOL} of its largest of zero or the two "
              f"gradients part by more than {LAYER_PARAM_TOL} of it, within "
              f"2 lr)", flush=True)
        losses, walls = [first], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(ERNIE_TIMED):
            loss, wall = _synced(lambda: step(x, tt, y))
            losses.append(loss.item())
            walls.append(wall)
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 1 + ERNIE_TIMED
    want = {k: L * steps if k in ("K1", "K2", "K3") else 0
            for k in FLASH_COUNTERS}
    print(f"ernie-3.0-base bf16 B{ERNIE_B} S{ERNIE_S} MLM: AdamW + clip "
          f"losses {[round(v, 4) for v in losses]}; flash launches "
          f"{launches} (expected {want}: {L} layers x {steps} steps, "
          f"non-causal)", flush=True)
    check(all(np.isfinite(losses)), "ernie: a loss is not finite")
    check(losses[-1] < losses[0], f"ernie: the loss did not fall ({losses})")
    check(launches == want, f"ernie: launches {launches}, expected {want}")

    # costs: dispatches and host time a step, one profiled step
    n_disp, host_us = _dispatch_costs(lambda: step(x, tt, y))
    wall, busy, rows = _profiled(lambda: step(x, tt, y), dev)
    flash = {k: sum(ms for key, _, ms in rows if pat in key)
             for k, pat in (("K1", "fwd_bf16"), ("K2", "dq_bf16"),
                            ("K3", "dkv_bf16"))}
    ms = float(np.median(walls))
    tokens = ERNIE_B * ERNIE_S
    # 12 L h S counts every query-key pair: the work of non-causal
    # attention (for causal attention it counts twice what is computed)
    flops_per_token = 6 * n_params + 12 * L * cfg.hidden_size * ERNIE_S
    tok_s = tokens / (ms / 1e3)
    mfu = tok_s * flops_per_token / BF16_FLOPS
    print(f"ernie cost eager step: median {ms:.2f} ms over {ERNIE_TIMED} "
          f"steps ({[round(w, 2) for w in walls]}), {tok_s:.0f} tokens/s, "
          f"MFU {mfu:.4f} ({n_params} parameters, {flops_per_token} flops a "
          f"token: 6N + 12 L h S, attention's term counting every pair, as "
          f"non-causal attention computes them), peak memory {peak:.2f} "
          f"GiB; {n_disp} apply_op dispatches a step at {host_us:.2f} host "
          f"us each; profiled {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%), "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}% of busy)"
                      for k, v in flash.items())
          + f"; on {card}", flush=True)
    for key, count, kms in rows[:10]:
        print(f"profile ernie:   {kms:9.3f} ms {100 * kms / busy:5.1f}%  "
              f"x{count:<5d} {key[:90]}")
    return {"step_ms": ms, "tokens_s": tok_s, "mfu": mfu, "peak_gib": peak,
            "dispatches": n_disp, "host_us": host_us, "busy_ms": busy,
            "profiled_ms": wall, "flash_ms": flash, "launches": launches,
            "losses": losses, "flops_per_token": flops_per_token}


def ernie_capture(dev, card, cfg, weights, x, tt, y, flops_per_token):
    """The step under ``jit.to_static``: spied, captured and replayed
    ``ERNIE_REPLAYS`` times beside an eager twin from the same weights
    taking the same steps: losses and every parameter bitwise equal, K1-K3
    launched 12 x replays through the replay tally and K4 never, no Python
    body and no ``apply_op`` dispatch in a replay."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.ernie import ErnieForMaskedLM
    L = cfg.num_hidden_layers

    def model_from_weights():
        paddle.seed(SEED)
        m = ErnieForMaskedLM(cfg)
        m.to(dtype="bfloat16")
        missing, unexpected = m.set_state_dict(weights)
        check(not missing and not unexpected, "ernie capture: set_state_dict")
        return m

    A, B = model_from_weights(), model_from_weights()
    body = {"n": 0}
    A.register_forward_pre_hook(
        lambda layer, inputs: body.__setitem__("n", body["n"] + 1))
    stepA, stepB = _ernie_step(A, new_adamw(A)), _ernie_step(B, new_adamw(B))
    static = paddle.jit.to_static(stepA)
    with layout_direct(False):
        t0 = time.perf_counter()
        warm, cap_peak = _warm_capture(
            static, lambda: static(x, tt, y).item(), "ernie")
        warm_s = time.perf_counter() - t0
        (prog,) = _programs(static)
        want = [stepB(x, tt, y).item() for _ in warm]
        n0, rep0 = body["n"], prog.replays
        reset_launch_counts()
        got, walls = [], []
        for _ in range(ERNIE_REPLAYS):
            loss, wall = _synced(lambda: static(x, tt, y))
            got.append(loss.item())
            walls.append(wall)
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        check(body["n"] == n0, f"ernie capture: the Python body ran "
              f"{body['n'] - n0} times in {ERNIE_REPLAYS} replays")
        check(prog.replays - rep0 == ERNIE_REPLAYS and prog.captures == 1
              and prog.eager == 0, f"ernie capture: program {prog.stats()}")
        wantL = {k: L * ERNIE_REPLAYS if k in ("K1", "K2", "K3") else 0
                 for k in FLASH_COUNTERS}
        check(launches == wantL, f"ernie capture: replays launched "
              f"{launches}, expected {wantL}")
        want += [stepB(x, tt, y).item() for _ in range(ERNIE_REPLAYS)]
        # two more replays (their dispatches, the profiled one) and the
        # twin's two steps, so both have taken the same steps
        n_disp, _ = _dispatch_costs(lambda: static(x, tt, y))
        check(n_disp == 0, f"ernie capture: a replay made {n_disp} apply_op "
              "dispatches")
        wall, busy, _ = _profiled(lambda: static(x, tt, y), dev)
        stepB(x, tt, y)
        stepB(x, tt, y)
        torch.cuda.synchronize()
        same = _hold_twins("ernie", warm + got, want, A, B)
        capture_s = prog.capture_s
    check(same, "ernie capture: the captured run is not bitwise the eager "
          "twin's")
    ms = float(np.median(walls))
    tok_s = ERNIE_B * ERNIE_S / (ms / 1e3)
    mfu = tok_s * flops_per_token / BF16_FLOPS
    print(f"ernie capture: to_static(train_step) captured at call "
          f"{len(warm)} ({prog.capture_s:.2f} s capturing, {warm_s:.2f} s for "
          f"the {len(warm)} calls), {ERNIE_REPLAYS} replays "
          f"{[round(v, 2) for v in walls]} ms: median {ms:.2f} ms, "
          f"{tok_s:.0f} tokens/s, MFU {mfu:.4f}; replay launches {launches}; "
          f"0 Python bodies and {n_disp} apply_op dispatches a replay; a "
          f"profiled replay {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%); peak memory over the capturing call "
          f"{cap_peak:.2f} GiB (two models and optimizers resident); "
          f"bitwise equal to the eager twin; on {card}", flush=True)
    static._cache.clear()
    del A, B, static, stepA, stepB, prog
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "tokens_s": tok_s, "mfu": mfu,
            "capture_s": capture_s, "busy_ms": busy,
            "profiled_ms": wall, "launches": launches, "bitwise": same}


def ernie_padding(dev, card, cfg):
    """``ErnieForSequenceClassification`` (3 classes, bf16) in eval at
    B8 S512 with an ``attention_mask`` padding the last ``PAD_LAST``
    positions: other ids at the pad positions leave the unpadded positions'
    sequence output and the logits as they were (the reference's
    ``test_padding_mask_blocks_pad_influence``); the mask sends attention
    to the dense path, so K1 never launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification
    paddle.seed(SEED + 1)
    model = ErnieForSequenceClassification(cfg, num_classes=3)
    model.to(dtype="bfloat16")
    model.eval()
    rng = np.random.RandomState(SEED + 1)
    ids = rng.randint(5, cfg.vocab_size, (PAD_B, ERNIE_S))
    ids2 = ids.copy()
    ids2[:, -PAD_LAST:] = rng.randint(5, cfg.vocab_size, (PAD_B, PAD_LAST))
    mask = np.ones((PAD_B, ERNIE_S), np.float32)
    mask[:, -PAD_LAST:] = 0.0
    keep = ERNIE_S - PAD_LAST
    reset_launch_counts()
    outs = []
    with paddle.no_grad():
        for a in (ids, ids2):
            m = paddle.to_tensor(mask)
            seq, _ = model.ernie(paddle.to_tensor(a), attention_mask=m)
            logits = model(paddle.to_tensor(a), attention_mask=m)
            outs.append((seq._buf[:, :keep].float(), logits._buf.float()))
    torch.cuda.synchronize()
    k1 = launch_counts()["K1"]
    seq_err = (outs[0][0] - outs[1][0]).abs().max().item()
    log_err = (outs[0][1] - outs[1][1]).abs().max().item()
    finite = all(bool(torch.isfinite(t).all()) for o in outs for t in o)
    print(f"ernie padding: classifier eval B{PAD_B} S{ERNIE_S}, the last "
          f"{PAD_LAST} positions padded; other pad ids move the unpadded "
          f"sequence output by {seq_err:.3e} and the logits by "
          f"{log_err:.3e} (tol 1e-5); K1 launched {k1} times", flush=True)
    check(finite and seq_err <= 1e-5 and log_err <= 1e-5,
          f"ernie padding: pad ids moved the unpadded outputs by {seq_err} "
          f"/ {log_err}")
    check(k1 == 0, f"ernie padding: K1 launched {k1} times under a mask")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"seq_err": seq_err, "logits_err": log_err}


def conv_stem(nn):
    """Conv2D(3, 64, 7, stride 2, padding 3) -> BatchNorm2D -> ReLU ->
    MaxPool2D(3, 2, 1) -> AdaptiveAvgPool2D(1): a ResNet stem."""
    return nn.Sequential(nn.Conv2D(3, 64, 7, stride=2, padding=3),
                         nn.BatchNorm2D(64), nn.ReLU(),
                         nn.MaxPool2D(3, 2, 1), nn.AdaptiveAvgPool2D(1))


def stem_phase(dev, card):
    """The conv / pool stem at B8 x 3 x 224 x 224 in float32 (TF32 off) on
    the card and on the CPU from the same weights and input: the output
    and the input's, the convolution's and the norm's gradients of a
    weighted sum, each within ``STEM_TOL`` of its largest CPU
    magnitude."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import device as core_device
    rng = np.random.RandomState(SEED)
    x = rng.standard_normal((STEM_B, 3, 224, 224)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (STEM_B, 64, 1, 1)).astype(np.float32)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = core_device._current_device
    res = {}
    try:
        state = None
        for place in (dev, "cpu"):
            paddle.set_device(place)
            paddle.seed(SEED)
            stem = conv_stem(nn)
            if state is None:
                state = {k: v.numpy() for k, v in stem.state_dict().items()}
            else:
                stem.set_state_dict(state)
            xt = paddle.to_tensor(x)
            xt.stop_gradient = False
            t0 = time.perf_counter()
            out = stem(xt)
            (out * paddle.to_tensor(w)).sum().backward()
            got = {"output": out, "input grad": xt.grad,
                   "conv weight grad": stem[0].weight.grad,
                   "norm weight grad": stem[1].weight.grad}
            res[str(place)] = {k: v._buf.detach().cpu() for k, v in
                               got.items()}
            if place == dev:
                torch.cuda.synchronize()
                res["card_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        core_device._current_device = prev
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    errs = {}
    for k, want in res["cpu"].items():
        g = res[str(dev)][k]
        errs[k] = ((g - want).abs().max() / want.abs().max()).item()
        check(g.shape == want.shape and bool(torch.isfinite(g).all())
              and errs[k] <= STEM_TOL, f"stem: {k} off the CPU's by "
              f"{errs[k]} of its largest")
    print(f"conv / pool stem f32 B{STEM_B}x3x224x224 (TF32 off), card vs "
          f"CPU: " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
          + f" of the largest (tol {STEM_TOL}); the card's first forward and "
          f"backward {res['card_ms']:.1f} ms; on {card}", flush=True)
    return errs


def generate_phase(dev, card):
    """The Layer GPT-2 124M in float32 on the card (the ``torch.nn``
    model's seeded weights): ``generate`` of ``GEN_NEW`` tokens from
    ``GEN_PROMPTS`` prompts of ``GEN_PROMPT_LEN``: ``top_k=1``
    token-exact against a greedy argmax loop over the ``torch.nn`` model,
    K1 launched once a layer (only the context of 128 passes
    ``supported``), its tokens/s; ``top_k=50, temperature=0.8`` from a
    fixed seed twice: equal, and each token among its step's 50 highest
    logits."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.gpt2 import GPT2Config
    from paddle_tpu_torch.models.gpt2 import GPT2ForCausalLM as LayerGPT2
    from paddle_tpu_torch.models.gpt2_module import GPT2ForCausalLM
    cfg = GPT2Config.gpt2_small(hidden_dropout_prob=0.0,
                                attention_dropout_prob=0.0)
    L = cfg.num_layers
    paddle.set_device(dev)
    ref = GPT2ForCausalLM(cfg, device=dev, dtype=torch.float32,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED))
    ref.eval()
    paddle.seed(SEED)
    model = LayerGPT2(cfg)
    missing, unexpected = model.set_state_dict(
        {n: w.detach().cpu().numpy() for n, w in paddle_layout(
            dict(ref.named_parameters())).items()})
    check(not missing and not unexpected, "generate: set_state_dict")
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (GEN_PROMPTS, GEN_PROMPT_LEN))
    x = paddle.to_tensor(prompts)
    with layout_direct(False):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        greedy = model.generate(x, max_new_tokens=GEN_NEW, top_k=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = {n: launch_counts()[n] for n in FLASH_COUNTERS}
        ctx = torch.as_tensor(prompts, device=dev)
        with torch.no_grad():
            for _ in range(GEN_NEW):
                nxt = ref(ctx)[:, -1, :].argmax(-1, keepdim=True)
                ctx = torch.cat([ctx, nxt], 1)
        exact = torch.equal(greedy._buf.long(), ctx)
        paddle.seed(SEED + 7)
        a = model.generate(x, max_new_tokens=GEN_NEW, top_k=GEN_TOP_K,
                           temperature=GEN_TEMPERATURE)
        paddle.seed(SEED + 7)
        b = model.generate(x, max_new_tokens=GEN_NEW, top_k=GEN_TOP_K,
                           temperature=GEN_TEMPERATURE)
        same = torch.equal(a._buf, b._buf)
        seq = a._buf
        inside = 0
        with paddle.no_grad():
            for t in range(GEN_PROMPT_LEN, GEN_PROMPT_LEN + GEN_NEW):
                logits = model(paddle.to_tensor(seq[:, :t]))._buf[:, -1]
                top = logits.topk(GEN_TOP_K, -1).indices
                inside += int((top == seq[:, t:t + 1]).any(-1).sum())
    want_k = {n: L if n == "K1" else 0 for n in FLASH_COUNTERS}
    tok_s = GEN_PROMPTS * GEN_NEW / wall
    print(f"generate: Layer GPT-2 124M f32, {GEN_PROMPTS} prompts of "
          f"{GEN_PROMPT_LEN} + {GEN_NEW} tokens: top_k=1 "
          f"{'token-exact with' if exact else 'DIFFERS from'} the torch.nn "
          f"model's greedy loop, flash launches {k} (expected {want_k}: the "
          f"context of 128 only), {wall:.3f} s, {tok_s:.1f} tokens/s; "
          f"top_k={GEN_TOP_K} T={GEN_TEMPERATURE}: two runs at one seed "
          f"{'equal' if same else 'DIFFER'}, {inside} / "
          f"{GEN_PROMPTS * GEN_NEW} tokens among their step's {GEN_TOP_K} "
          f"highest logits; on {card}", flush=True)
    check(exact, "generate: top_k=1 differs from the greedy argmax loop")
    check(k == want_k, f"generate: launches {k}, expected {want_k}")
    check(same, "generate: two runs at one seed differ")
    check(inside == GEN_PROMPTS * GEN_NEW, f"generate: {inside} tokens of "
          f"{GEN_PROMPTS * GEN_NEW} among their step's top {GEN_TOP_K}")
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens_s": tok_s, "launches": k}


def ernie_phase(dev, card):
    """ERNIE 3.0 base (``ernie_base_config``, bf16 through
    ``to(dtype="bfloat16")``, weights from ``SEED`` on the card) trained as
    masked-LM on one B16 S512 batch with bench.py's AdamW + clip: the first
    step's loss, every gradient and every parameter after it held to the
    same model with the flash route off (``dense_attention``), K1 = K2 =
    K3 = 12 x steps non-causally and K4 never, the loss falling; the step
    captured (``ernie_capture``); a padded classifier forward
    (``ernie_padding``); the conv / pool stem (``stem_phase``); the Layer
    GPT-2's ``generate`` (``generate_phase``).  Returns the readings."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.ernie import ErnieForMaskedLM
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ernie_base_config()
    paddle.set_device(dev)
    paddle.seed(SEED)
    model = ErnieForMaskedLM(cfg)
    model.to(dtype="bfloat16")
    ids, tts, labels = ernie_batch(cfg)
    x, tt, y = (paddle.to_tensor(a) for a in (ids, tts, labels))
    out = {"train": ernie_train(dev, card, cfg, model, x, tt, y)}
    weights = {n: p.numpy() for n, p in model.state_dict().items()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["capture"] = ernie_capture(dev, card, cfg, weights, x, tt, y,
                                   out["train"]["flops_per_token"])
    out["padding"] = ernie_padding(dev, card, cfg)
    out["stem"] = stem_phase(dev, card)
    out["generate"] = generate_phase(dev, card)
    return out


# ------------------------------------------ phase 6f: the Layer Llama (M7b)
LLAMA_LAYER_TIMED = 3            # timed eager steps of each model (median)
LLAMA_SCAN_TRIALS = 3            # (t_hi - t_lo) / (k_hi - k_lo) samples
LLAMA_GEN_B, LLAMA_GEN_PROMPT, LLAMA_GEN_NEW = 4, 128, 32
LLAMA_GEN_RUNS = 3               # generate calls: spies, captures, replays
LLAMA_F32_LAYERS = 2             # depth of the float32 generate check


def _llama_linear(name):
    """Whether a Llama parameter is a Linear weight (``[in, out]`` on the
    ``Layer`` model, ``[out, in]`` on the ``torch.nn`` one)."""
    return name.endswith("_proj.weight") or name == "lm_head.weight"


def llama_nn_twin(model, cfg, dev, dtype):
    """The ``torch.nn`` Llama (``models/llama_module.py``) holding a
    ``Layer`` Llama's weights, copied on the card (Linear weights
    transposed): no host round trip, so the 8B weights cross too."""
    from paddle_tpu_torch.models.llama_module import LlamaForCausalLM
    twin = LlamaForCausalLM(cfg, device=dev, dtype=dtype)
    src = dict(model.named_parameters())
    params = dict(twin.named_parameters())
    check(set(params) == set(src), f"llama twin: names {sorted(params)} vs "
          f"{sorted(src)}")
    with torch.no_grad():
        for n, p in params.items():
            w = src[n]._buf
            p.copy_(w.t() if _llama_linear(n) else w)
    return twin


def _layer_layout(tensors):
    """torch.nn Llama tensors by name in the ``Layer`` layout, float32."""
    return {n: (t.t() if _llama_linear(n) else t).detach().float()
            for n, t in tensors.items()}


def llama_layer_train(dev, card):
    """``bench.py`` ``_llama_child`` on the port: ``paddle.seed(0)``, the
    ``Layer`` ``LlamaForCausalLM(llama_bench_config())`` in bf16, AdamW(3e-4,
    decay 0.01) + ClipGradByGlobalNorm(1.0).  First held to the ``torch.nn``
    twin from the same weights on the same batch (first loss, every
    gradient, every parameter after the first AdamW step), then
    ``jit.scan_steps(train_step)`` captured at K = 1 and 6 beside an eager
    ``Layer`` twin taking the same steps (bitwise, or at the training
    bar), K1-K3 launched layers x steps through the replay tally, timed by
    bench.py's differential (its upper bound where bench.py falls back to
    it), one replay profiled.  Returns the readings."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq = llama_bench_config()
    L, hidden = cfg.num_hidden_layers, cfg.hidden_size
    paddle.set_device(dev)
    paddle.seed(SEED)
    model = LlamaForCausalLM(cfg)
    model.to(dtype="bfloat16")
    n_params = sum(p.size for p in model.parameters())
    flops_per_token = 6 * n_params + 12 * L * hidden * seq
    saved = {n: p._buf.detach().clone() for n, p in model.named_parameters()}
    twin = llama_nn_twin(model, cfg, dev, torch.bfloat16)
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    tx, ty = x._buf.long(), y._buf.long()

    # the torch.nn twin's first step: the reference, then its timed steps
    topt = new_adamw(twin)
    with layout_direct(False):
        _, rl = twin(tx, labels=ty)
        rl.backward()
        ref_loss = rl.item()
        ref_grads = _layer_layout({n: p.grad for n, p in
                                   twin.named_parameters()})
        topt.step()
        topt.clear_grad()
        ref_after = _layer_layout(dict(twin.named_parameters()))
        nn_ms = [_synced(lambda: train_step(twin, topt, tx, ty))[1]
                 for _ in range(1 + LLAMA_LAYER_TIMED)][1:]
    del twin, topt
    gc.collect()
    torch.cuda.empty_cache()

    # the Layer model's eager first step against it
    opt = new_adamw(model)
    step = _bench_step(model, opt)
    with layout_direct(False):
        torch.cuda.synchronize()
        reset_launch_counts()
        _, loss = model(x, labels=y)
        loss.backward()
        first = loss.item()
        got = {n: p.grad._buf.float().clone()
               for n, p in model.named_parameters() if p.grad is not None}
        check(set(got) == set(ref_grads), "llama layer: the gradients are "
              "not the twin's parameters")
        errs = {n: ((got[n] - g).abs().max() / g.abs().max()).item()
                for n, g in ref_grads.items()}
        worst_g = max(errs, key=errs.get)
        check(abs(first - ref_loss) <= TRAIN_LOSS_TOL, f"llama layer: first "
              f"loss {first} vs the torch.nn twin's {ref_loss}")
        bad = {n: e for n, e in errs.items() if not e <= TRAIN_GRAD_TOL}
        check(not bad, f"llama layer: gradients off the torch.nn twin's by "
              f"{bad} of their largest")
        opt.step()
        opt.clear_grad()
        worst_p, flips = _params_against("llama layer", model, ref_after,
                                         ref_grads, LAYER_LR, got)
        eager_ms = [_synced(lambda: step(x, y))[1]
                    for _ in range(LLAMA_LAYER_TIMED)]
        eager_launch = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    want = {k: L * (1 + LLAMA_LAYER_TIMED) if k in ("K1", "K2", "K3")
            else 0 for k in FLASH_COUNTERS}
    check(eager_launch == want, f"llama layer: eager launches "
          f"{eager_launch}, expected {want}")
    print(f"llama layer: Layer LlamaForCausalLM (bench.py _llama_child: "
          f"hidden {hidden}, {L} layers, GQA {cfg.num_attention_heads}:"
          f"{cfg.num_key_value_heads}, head_dim "
          f"{hidden // cfg.num_attention_heads}, tied vocab "
          f"{cfg.vocab_size}, bf16, B{batch} S{seq}, {n_params} parameters)"
          f": first loss {first:.5f} vs the torch.nn twin {ref_loss:.5f} "
          f"(tol {TRAIN_LOSS_TOL}); all {len(errs)} gradients within "
          f"{errs[worst_g]:.3e} of their largest ({worst_g}; tol "
          f"{TRAIN_GRAD_TOL}); every parameter after the first AdamW + clip "
          f"step within {worst_p:.3e} of its largest (tol {LAYER_PARAM_TOL}"
          f"; {flips} elements past it within 2 lr); eager launches "
          f"{eager_launch} (expected {want})", flush=True)
    del model, opt, step, got, ref_after, ref_grads
    gc.collect()
    torch.cuda.empty_cache()

    # scan_steps at K = 1 and 6 beside an eager Layer twin
    def from_saved():
        paddle.seed(SEED)
        m = LlamaForCausalLM(cfg)
        m.to(dtype="bfloat16")
        with torch.no_grad():
            for n, p in m.named_parameters():
                p._buf.copy_(saved[n])
        return m

    A, B = from_saved(), from_saved()
    stepA, stepB = _bench_step(A, new_adamw(A)), _bench_step(B, new_adamw(B))
    scan = paddle.jit.scan_steps(stepA)
    lo, hi = SCAN_K

    def batch_data(k):              # bench.py's batch_data: fresh ids a call
        a = rng.randint(0, cfg.vocab_size, (k, batch, seq + 1)).astype(
            np.int32)
        return a, (paddle.to_tensor(a[:, :, :-1]),
                   paddle.to_tensor(a[:, :, 1:]))

    lo_ids, lo_data = batch_data(lo)
    hi_ids, hi_data = batch_data(hi)
    calls, got = [], []
    with layout_direct(False):
        t0 = time.perf_counter()
        cap_peak = {}
        for n, (k, a, d) in enumerate(((lo, lo_ids, lo_data),
                                       (hi, hi_ids, hi_data)), 1):
            while _graphs(scan) < n:
                check(len(calls) < 2 * CAPTURE_WARM, f"llama layer scan: no "
                      f"graph at K = {k} after {len(calls)} calls")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                got += [float(v) for v in scan(*d).numpy()]
                calls.append(a)
                cap_peak[k] = torch.cuda.max_memory_allocated() / 2 ** 30
        warm_s = time.perf_counter() - t0
        check(not any(g.eager_only for g in scan._cache.values()),
              "llama layer scan: a signature fell back to eager")
        progs = _programs(scan)
        torch.cuda.synchronize()
        reset_launch_counts()
        replay = [float(v) for v in scan(*hi_data).numpy()]
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        got += replay
        calls.append(hi_ids)
        wantS = {k: L * hi if k in ("K1", "K2", "K3") else 0
                 for k in FLASH_COUNTERS}
        check(launches == wantS, f"llama layer scan: K = {hi} replay "
              f"launched {launches}, expected {wantS}")
        check(all(np.isfinite(replay)) and replay[-1] < got[0],
              f"llama layer scan: losses {got}")
        # the eager twin takes the same steps
        want_l = []
        for a in calls:
            for i in range(a.shape[0]):
                want_l.append(stepB(paddle.to_tensor(a[i, :, :-1]),
                                    paddle.to_tensor(a[i, :, 1:])).item())
        torch.cuda.synchronize()
        same = _hold_twins("llama-layer scan", got, want_l, A, B)
        del B, stepB
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        diffs, uppers = [], []
        for _ in range(LLAMA_SCAN_TRIALS):
            _, t_lo = _synced(lambda: scan(*lo_data).numpy())
            _, t_hi = _synced(lambda: scan(*hi_data).numpy())
            uppers.append(t_hi / hi)
            diffs.append((t_hi - t_lo) / (hi - lo))
        replay_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall, busy, rows = _profiled(lambda: scan(*hi_data).numpy(), dev)
    diffs.sort()
    dt, upper = diffs[len(diffs) // 2], min(uppers)
    method = "scan_differential"
    if dt <= 0 or dt > upper * 1.5:            # bench.py's fallback
        dt, method = upper, "scan_upper_bound"
    capture_s = sum(p.capture_s for p in progs)
    tok_s = batch * seq / (dt / 1e3)
    mfu = tok_s * flops_per_token / BF16_FLOPS
    nn_step, eager_step = float(np.median(nn_ms)), float(np.median(eager_ms))
    flash = {k: sum(ms for key, _, ms in rows if pat in key)
             for k, pat in (("K1", "fwd_bf16"), ("K2", "dq_bf16"),
                            ("K3", "dkv_bf16"))}
    print(f"llama layer scan_steps: K = {lo} and {hi} captured "
          f"({capture_s:.2f} s capturing, {warm_s:.2f} s for {len(calls) - 1} "
          f"calls of spies and captures); the K = {hi} replay's losses "
          f"{[round(v, 4) for v in replay]}, launches {launches} (replay "
          f"tally; expected {wantS}); {'bitwise equal to' if same else 'at the training bar of'} "
          f"the eager Layer twin over {len(got)} steps; step ({method}) "
          f"{dt:.2f} ms (samples {[round(d, 3) for d in diffs]}, upper "
          f"bound t{hi} / {hi} {upper:.2f} ms), {tok_s:.0f} tokens/s, MFU "
          f"{mfu:.4f} ({flops_per_token} flops a token: 6N + 12 L h S, vs "
          f"989 TFLOP/s bf16 dense); peak memory over the capturing calls "
          f"{ {k: round(v, 2) for k, v in cap_peak.items()} } GiB (two models "
          f"resident), over the replays {replay_peak:.2f} GiB; a profiled "
          f"K = {hi} replay {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%), "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in flash.items())
          + f"; beside it the eager Layer step {eager_step:.2f} ms and the "
          f"torch.nn step (training_phase's model, this run) {nn_step:.2f} "
          f"ms; on {card}", flush=True)
    for key, count, kms in rows[:8]:
        print(f"profile llama-layer:   {kms:9.3f} ms "
              f"{100 * kms / max(busy, 1e-9):5.1f}%  x{count:<5d} {key[:90]}")
    del A, stepA, scan, progs, saved
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": dt, "method": method, "upper_ms": upper,
            "tokens_s": tok_s, "mfu": mfu, "capture_s": capture_s,
            "busy_pct": 100 * busy / wall, "launches": launches,
            "bitwise": same, "eager_ms": eager_step, "nn_ms": nn_step,
            "peak_gib": replay_peak, "loss": (first, ref_loss)}


def _gen_programs(model):
    """{shape: CapturedProgram} of generate's one to_static step (the
    prefill [B, prompt] and the decode [B, 1] signatures)."""
    (entry,) = model._gen_states.values()
    return {k.split("|")[1].split(":")[0]: v.compiled
            for k, g in entry["step"]._cache.items() for v in g.variants}


def llama_layer_generate(dev, card):
    """The ``Layer`` Llama at Llama-3-8B width and depth (bf16 weights from
    ``paddle.seed(SEED)``, handed on the card to the ``torch.nn`` twin):
    greedy ``generate`` of ``LLAMA_GEN_NEW`` tokens from ``LLAMA_GEN_B``
    prompts of ``LLAMA_GEN_PROMPT``, ``LLAMA_GEN_RUNS`` times (the first
    spies both signatures and captures decode, the second captures
    prefill, the third replays both: no Python body runs), every run's
    tokens equal, each token teacher-forced against the twin's
    ``forward_ref`` within ``GAP``; then at ``LLAMA_F32_LAYERS`` layers in
    float32, token-exact with the twin's ``generate``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig.llama3_8b()
    B, P, N = LLAMA_GEN_B, LLAMA_GEN_PROMPT, LLAMA_GEN_NEW
    paddle.set_device(dev)
    paddle.seed(SEED)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg)
    model.to(dtype="bfloat16")
    model.eval()
    twin = llama_nn_twin(model, cfg, dev, torch.bfloat16)
    twin.eval()
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    n_params = sum(p.size for p in model.parameters())
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    x = paddle.to_tensor(prompts)
    bodies = {"n": 0}
    model.llama.register_forward_pre_hook(
        lambda layer, inputs: bodies.__setitem__("n", bodies["n"] + 1))
    runs, walls, body_runs, stats = [], [], [], []
    for _ in range(LLAMA_GEN_RUNS):
        n0 = bodies["n"]
        out, wall = _synced(lambda: model.generate(x, max_new_tokens=N))
        runs.append(out.numpy())
        walls.append(wall)
        body_runs.append(bodies["n"] - n0)
        stats.append({k: p.stats() for k, p in _gen_programs(model).items()})
    progs = _gen_programs(model)
    dec, pre = progs[f"T({B}, 1)"], progs[f"T({B}, {P})"]
    check(all((r == runs[0]).all() for r in runs) and runs[0].shape == (
        B, P + N), f"llama generate: the {LLAMA_GEN_RUNS} runs differ")
    check(body_runs == [3, 1, 0], f"llama generate: the Python body ran "
          f"{body_runs} times a run (want [3, 1, 0]: spies and captures, "
          "then replays only)")
    check(dec.captures == 1 and dec.eager == 0 and pre.captures == 1
          and pre.eager == 0, f"llama generate: programs decode "
          f"{dec.stats()}, prefill {pre.stats()}")
    counts, worst = np.zeros(3, int), 0.0
    with torch.no_grad():
        for b in range(B):
            c, w = teacher_forced_check(twin, prompts[b], runs[0][b, P:],
                                        GAP, dev)
            counts += c
            worst = max(worst, w)
    tok_s = B * N / (walls[-1] / 1e3)
    # one more run, all replays, under the profiler: where its time goes
    wall, busy, rows = _profiled(
        lambda: model.generate(x, max_new_tokens=N), dev)
    print(f"llama generate: a profiled run (every program replayed) "
          f"{wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%); on {card}", flush=True)
    for key, count, kms in rows[:8]:
        print(f"profile llama-generate:   {kms:9.3f} ms "
              f"{100 * kms / max(busy, 1e-9):5.1f}%  x{count:<5d} {key[:90]}")
    print(f"llama generate: Layer Llama-3-8B bf16 ({n_params} parameters, "
          f"built and handed to the torch.nn twin on the card in "
          f"{built_s:.1f} s), {B} prompts of {P} + {N} greedy tokens, "
          f"{LLAMA_GEN_RUNS} runs of {[round(w, 1) for w in walls]} ms, "
          f"tokens equal across runs; the last (every program replayed) "
          f"{tok_s:.1f} tokens/s; Python bodies a run {body_runs}; decode "
          f"program captures {dec.captures}, replays {dec.replays}, eager "
          f"{dec.eager}, capture {dec.capture_s:.2f} s; prefill captures "
          f"{pre.captures}, replays {pre.replays}, eager {pre.eager}, capture "
          f"{pre.capture_s:.2f} s (each run's stats {stats}); teacher-forced "
          f"against the twin's forward_ref: {B * N} tokens, top-1/top-2 gap "
          f"<= {GAP} at {counts[0]}, not its argmax {counts[1]}, outside "
          f"its top 2 {counts[2]}, largest shortfall {worst:.4f} (allowed "
          f"{GAP}); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; on {card}", flush=True)
    del model, twin, progs, dec, pre
    gc.collect()
    torch.cuda.empty_cache()

    # float32, LLAMA_F32_LAYERS layers: token-exact with the twin
    cfg32 = LlamaConfig.llama3_8b(num_hidden_layers=LLAMA_F32_LAYERS)
    paddle.seed(SEED)
    model = LlamaForCausalLM(cfg32)
    model.eval()
    twin = llama_nn_twin(model, cfg32, dev, torch.float32)
    a = model.generate(x, max_new_tokens=N).numpy()
    b = twin.generate(x._buf.long(), max_new_tokens=N).cpu().numpy()
    exact = a.shape == b.shape and bool((a == b).all())
    print(f"llama generate f32: Layer Llama-3-8B width at "
          f"{LLAMA_F32_LAYERS} layers, {B} prompts of {P} + {N} greedy "
          f"tokens: {'token-exact with' if exact else 'DIFFERS from'} the "
          f"torch.nn twin's generate ({int((a != b).sum())} tokens differ)"
          f"; on {card}", flush=True)
    check(exact, "llama generate f32: tokens differ from the twin's")
    del model, twin
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens_s": tok_s, "walls_ms": walls, "body_runs": body_runs,
            "teacher_forced": counts.tolist(), "worst": worst,
            "f32_exact": exact, "busy_pct": 100 * busy / wall}


M2_TOL = 1e-4                    # of each result's largest CPU magnitude
RNN_B, RNN_T, RNN_IN, RNN_HIDDEN = 16, 128, 256, 512
CTC_T, CTC_B, CTC_C, CTC_L = 100, 16, 32, 20
GRID_X, GRID_OUT = (8, 16, 64, 64), (8, 32, 32, 2)


def _held_to_cpu(tag, got, want):
    """Each card result within ``M2_TOL`` of its CPU twin's largest
    magnitude; returns the worst ratio."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.detach().float().cpu()
        top = max(w.abs().max().item(), 1e-30)
        err = (g.detach().float().cpu() - w).abs().max().item()
        check(bool(torch.isfinite(g).all()) and err <= M2_TOL * top,
              f"m2 {tag}: result {i} off the CPU's by {err} (largest {top})")
        worst = max(worst, err / top)
    return worst


def _both_places(dev, run):
    """``run()`` with the port's place set to the CPU, then to the card:
    ({place: its torch tensors}, the card's wall ms)."""
    import paddle_tpu_torch as paddle
    res, ms = {}, None
    for place in ("cpu", dev):
        paddle.set_device(place)
        if place == "cpu":
            res[place] = run()
        else:
            res[place], ms = _synced(run)
    return res, ms


def m2_rest_phase(dev, card):
    """M2's rest on the card, for correctness (float32, TF32 off): a
    2-layer bidirectional ``LSTM`` and ``GRU`` (cuDNN's fused recurrence),
    ``ctc_loss`` and ``grid_sample``, forward and backward, each result
    held to the same call on the CPU; then ``flash_attn_qkvpacked`` at
    GPT-2's shape in bf16: K1 forward and K2 / K3 backward launched once
    each, K4 never, and bitwise equal to ``F.flash_attention`` on the same
    q, k and v.  Returns the readings."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn as pnn
    import paddle_tpu_torch.nn.functional as F
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    out = {}
    try:
        for cls in ("LSTM", "GRU"):
            paddle.set_device("cpu")
            paddle.seed(SEED)
            state = {k: v.numpy() for k, v in getattr(pnn, cls)(
                RNN_IN, RNN_HIDDEN, num_layers=2,
                direction="bidirect").state_dict().items()}
            x = rng.randn(RNN_B, RNN_T, RNN_IN).astype(np.float32)

            def run(cls=cls, state=state, x=x):
                net = getattr(pnn, cls)(RNN_IN, RNN_HIDDEN, num_layers=2,
                                        direction="bidirect")
                net.set_state_dict(state)
                t = paddle.to_tensor(x)
                t.stop_gradient = False
                y, st = net(t)
                leaves = [y] + (list(st) if cls == "LSTM" else [st])
                sum(o.sum() for o in leaves).backward()
                return [o._buf for o in leaves] + [t.grad._buf] + [
                    p.grad._buf for p in net.parameters()]
            res, ms = _both_places(dev, run)
            out[cls] = {"worst": _held_to_cpu(cls, res[dev], res["cpu"]),
                        "ms": ms}
        # ctc_loss: the reference's alpha recursion, a loop over time
        arrays = [rng.randn(CTC_T, CTC_B, CTC_C).astype(np.float32),
                  rng.randint(1, CTC_C, (CTC_B, CTC_L)).astype(np.int32),
                  rng.randint(CTC_T // 2, CTC_T + 1, CTC_B).astype(np.int32),
                  rng.randint(1, CTC_L + 1, CTC_B).astype(np.int32)]

        def run_ctc():
            lp = paddle.to_tensor(arrays[0])
            lp.stop_gradient = False
            loss = F.ctc_loss(lp, *[paddle.to_tensor(a) for a in arrays[1:]])
            loss.backward()
            return [loss._buf, lp.grad._buf]
        res, ms = _both_places(dev, run_ctc)
        out["ctc_loss"] = {"worst": _held_to_cpu("ctc_loss", res[dev],
                                                 res["cpu"]), "ms": ms}
        img = rng.randn(*GRID_X).astype(np.float32)
        grid = (rng.rand(*GRID_OUT) * 2.2 - 1.1).astype(np.float32)

        def run_grid():
            a, g = paddle.to_tensor(img), paddle.to_tensor(grid)
            a.stop_gradient = g.stop_gradient = False
            y = F.grid_sample(a, g)
            (y * y).sum().backward()
            return [y._buf, a.grad._buf, g.grad._buf]
        res, ms = _both_places(dev, run_grid)
        out["grid_sample"] = {"worst": _held_to_cpu(
            "grid_sample", res[dev], res["cpu"]), "ms": ms}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    print("m2 rest: f32 on the card against the CPU, each result within "
          "(largest error / largest CPU magnitude, tol "
          f"{M2_TOL}): "
          + "; ".join(f"{k} {v['worst']:.3e} ({v['ms']:.1f} ms forward and "
                      f"backward on the card)" for k, v in out.items())
          + f" (LSTM / GRU: 2 layers, bidirectional, hidden {RNN_HIDDEN}, "
          f"B{RNN_B} T{RNN_T}; ctc_loss T{CTC_T} B{CTC_B} C{CTC_C} "
          f"L{CTC_L}; grid_sample {GRID_X} on {GRID_OUT}); on {card}",
          flush=True)

    # flash_attn_qkvpacked at GPT-2's shape: the flash kernels
    paddle.set_device(dev)
    cfg, batch, seq = gpt2_bench_config()
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    qkv_np = rng.randn(batch, seq, 3, H, D).astype(np.float32)
    do = paddle.to_tensor(rng.randn(batch, seq, H, D).astype(
        np.float32)).astype("bfloat16")

    def packed_pair():
        qkv = paddle.to_tensor(qkv_np).astype("bfloat16")
        qkv.stop_gradient = False
        return qkv

    with layout_direct(False):
        a = packed_pair()
        torch.cuda.synchronize()
        reset_launch_counts()
        o1, _ = F.flash_attn_qkvpacked(a, causal=True)
        (o1 * do).sum().backward()
        torch.cuda.synchronize()
        launched = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        b = packed_pair()
        o2, _ = F.flash_attention(b[:, :, 0], b[:, :, 1], b[:, :, 2],
                                  causal=True)
        (o2 * do).sum().backward()
    same = torch.equal(o1._buf, o2._buf) and torch.equal(a.grad._buf,
                                                         b.grad._buf)
    want = {k: 1 if k in ("K1", "K2", "K3") else 0 for k in FLASH_COUNTERS}
    print(f"m2 flash_attn_qkvpacked: bf16 qkv [{batch}, {seq}, 3, {H}, {D}]"
          f" (GPT-2's shape), causal: launches {launched} (expected {want})"
          f"; output and qkv gradient {'bitwise equal to' if same else 'DIFFER from'} "
          f"F.flash_attention on the same q, k, v; on {card}", flush=True)
    check(launched == want, f"m2 qkvpacked: launches {launched}, expected "
          f"{want}")
    check(same, "m2 qkvpacked: not bitwise equal to flash_attention")
    out["qkvpacked"] = {"launches": launched, "bitwise": same}
    del a, b, o1, o2, do
    gc.collect()
    torch.cuda.empty_cache()
    return out


def llama_layer_phase(dev, card):
    """The reference's Llama on ``nn.Layer`` (``models/llama.py``): bench.py's
    Llama-3-shaped step under ``scan_steps`` (``llama_layer_train``), then
    ``generate`` at Llama-3-8B width (``llama_layer_generate``), then M2's
    rest for correctness (``m2_rest_phase``).  Returns the readings."""
    out = {"train": llama_layer_train(dev, card)}
    out["generate"] = llama_layer_generate(dev, card)
    out["m2"] = m2_rest_phase(dev, card)
    return out


# ------------------------------ phase 6g: the training workflow around M10
# (io, framework.io, hapi, metric, quantization)
WF_TRAIN, WF_EVAL = 2048, 512    # samples of the fine-tune and of the eval
WF_S, WF_B = 128, 32             # sequence length, batch
WF_ITERS = 40                    # fit steps (num_iters)
WF_LR = 1e-4                     # the fine-tune's AdamW rate
WF_POS = (100, 108)              # ids at position 0 that make label 1
WF_NEG = (200, 208)              # ids at position 0 that make label 0
WF_CALIB = 8                     # PTQ calibration batches
WF_TIMED = 10                    # timed train_batch and bare steps, in turn
WF_BAR = 0.05                    # the reference's int8 bar (test_quantization)
QAT_STEPS = 6                    # captured and eager QAT steps held bitwise
QAT_REPLAYS = 6                  # timed replays of each captured step
WF_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_workflow"


def workflow_data(cfg):
    """Seeded ids ``[N, WF_S]`` (int64, uniform in [5, vocab)) and labels
    ``[N, 1]``: position 0 (the one the pooler reads) holds one of the
    ``WF_POS`` ids for label 1 and one of the ``WF_NEG`` ids for label 0,
    so the rule can be learned in a few dozen steps."""
    rng = np.random.RandomState(SEED + 19)
    n = WF_TRAIN + WF_EVAL
    ids = rng.randint(5, cfg.vocab_size, (n, WF_S)).astype(np.int64)
    y = rng.randint(0, 2, (n, 1)).astype(np.int64)
    ids[:, 0] = np.where(y[:, 0] == 1, rng.randint(*WF_POS, n),
                         rng.randint(*WF_NEG, n))
    return (ids[:WF_TRAIN], y[:WF_TRAIN]), (ids[WF_TRAIN:], y[WF_TRAIN:])


def _wf_adamw(net):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=WF_LR, weight_decay=0.01,
                 parameters=net.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))


def _wf_model(net):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.metric import Accuracy
    m = paddle.Model(net)
    m.prepare(_wf_adamw(net), nn.CrossEntropyLoss(), Accuracy())
    return m


def _ernie_classifier(cfg, seed, weights=None):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.ernie import ErnieForSequenceClassification
    paddle.seed(seed)
    net = ErnieForSequenceClassification(cfg, num_classes=2)
    net.to(dtype="bfloat16")
    if weights is not None:
        missing, unexpected = net.set_state_dict(weights)
        check(not missing and not unexpected, "workflow: set_state_dict")
    return net


def _loader_epoch(loader):
    """(the batches of one epoch, seconds for it, the card synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(loader)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _sampled(io, ds):
    """A shuffled batch sampler drawing from its own seeded Generator."""
    import paddle_tpu_torch as paddle
    return io.BatchSampler(sampler=io.RandomSampler(
        ds, generator=paddle.Generator(SEED)), batch_size=WF_B)


def workflow_loaders(dev, card, train_ds):
    """One epoch of the fine-tune's shuffled order through each engine:
    the native one (``dataloader.cc``'s threads), forked Python workers
    (forked with CUDA up: they collate on the CPU place and ship host
    arrays) and the synchronous path; every batch equal across the three.
    Returns {engine: batches/s}."""
    from paddle_tpu_torch import io
    runs = {}
    for tag, kw in (("native", dict(num_workers=2, engine="native")),
                    ("python workers", dict(num_workers=2,
                                            engine="python")),
                    ("sync", dict(num_workers=0, engine="python"))):
        loader = io.DataLoader(train_ds, batch_sampler=_sampled(io, train_ds),
                               **kw)
        runs[tag] = _loader_epoch(loader)
    ref = runs["native"][0]
    for tag, (batches, _) in runs.items():
        check(len(batches) == WF_TRAIN // WF_B and all(
            a._buf.device == b._buf.device and a._buf.device.type ==
            dev.type and torch.equal(a._buf, b._buf)
            for got, want in zip(batches, ref) for a, b in zip(got, want)),
            f"workflow loaders: the {tag} engine's batches are not the "
            "native engine's")
    rates = {tag: len(b) / s for tag, (b, s) in runs.items()}
    print(f"workflow loaders: one epoch of {WF_TRAIN // WF_B} shuffled "
          f"batches of {WF_B} x {WF_S} ids (one sampler seed), every batch "
          f"equal across the engines; "
          + ", ".join(f"{t} {r:.1f} batches/s ({runs[t][1] * 1e3:.1f} ms)"
                      for t, r in rates.items()) + f"; on {card}",
          flush=True)
    return rates


def workflow_finetune(dev, card, cfg):
    """ERNIE 3.0 base fine-tuned as a classifier through ``Model.fit`` on
    the native ``DataLoader``; the first batch held bitwise to a bare
    ``Layer`` step; K1-K3 12 x steps; the checkpoint restored into a fresh
    Model bitwise; the costs.  Returns (model, eval loader, readings)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io, nn
    from paddle_tpu_torch.hapi.callbacks import Callback, ModelCheckpoint
    from paddle_tpu_torch.io import native_loader
    from paddle_tpu_torch.core.native import build as native_build
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    check(native_loader.available(), "workflow: dataloader.cc did not "
          f"build: {native_build.last_error('pt_dataloader')}")
    print(f"workflow: dataloader.cc built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    (tx, ty), (ex, ey) = workflow_data(cfg)
    train_ds, eval_ds = io.TensorDataset([tx, ty]), io.TensorDataset([ex, ey])
    rates = workflow_loaders(dev, card, train_ds)

    net = _ernie_classifier(cfg, SEED)
    weights = {n: p.numpy() for n, p in net.state_dict().items()}
    twin = _ernie_classifier(cfg, SEED + 1, weights)
    model = _wf_model(net)
    opt = model._optimizer
    first, walls = {}, []
    fit_step, opt_step = model.train_batch, opt.step

    def train_batch(data, label):
        if not first:
            first["batch"] = (data, label)
        out = fit_step(data, label)
        first.setdefault("loss", out[0][0])
        return out

    def step_spy():
        if "grads" not in first:
            first["grads"] = {n: p.grad._buf.clone()
                              for n, p in net.named_parameters()
                              if n.startswith("classifier.")}
        return opt_step()

    class Walls(Callback):
        def on_train_batch_begin(self, step, logs=None):
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            walls.append((time.perf_counter() - self.t0) * 1e3)

    model.train_batch, opt.step = train_batch, step_spy
    shutil.rmtree(WF_DIR, ignore_errors=True)
    np.random.seed(SEED)
    loader = io.DataLoader(train_ds, batch_size=WF_B, shuffle=True,
                           num_workers=2, engine="native")
    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    with layout_direct(False):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, num_iters=WF_ITERS, verbose=0,
                  callbacks=[Walls(), Losses(),
                             ModelCheckpoint(save_dir=str(WF_DIR))])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
    del model.train_batch, opt.step
    want = {k: L * WF_ITERS if k in ("K1", "K2", "K3") else 0
            for k in FLASH_COUNTERS}
    check(launches == want, f"workflow fit: launches {launches}, expected "
          f"{want} ({L} layers x {WF_ITERS} steps, non-causal)")
    check(len(losses) == WF_ITERS and all(np.isfinite(losses)),
          f"workflow fit: losses {losses}")
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(tail < head, f"workflow fit: the loss did not fall ({losses})")

    # the first batch: a bare eager Layer step from the same weights
    x, y = first["batch"]
    twin.train()
    tl = nn.CrossEntropyLoss()(twin(x), y)
    tl.backward()
    bare = {n: p.grad._buf for n, p in twin.named_parameters()
            if n.startswith("classifier.")}
    same_first = float(tl.item()) == first["loss"] and bare.keys() == \
        first["grads"].keys() and all(torch.equal(bare[n], g)
                                      for n, g in first["grads"].items())
    print(f"workflow fit: first batch loss {first['loss']:.6f} vs the bare "
          f"Layer step's {float(tl.item()):.6f}; classifier gradients "
          f"{'bitwise equal' if same_first else 'DIFFER'}", flush=True)
    check(same_first, "workflow fit: the first fit batch is not bitwise the "
          "bare Layer step")
    del twin, tl, bare

    # evaluate, then the checkpoint in a fresh Model
    eval_loader = io.DataLoader(eval_ds, batch_size=WF_B, engine="native")
    ev = model.evaluate(eval_loader, verbose=0)
    path = str(WF_DIR / "0")
    nbytes = sum(os.path.getsize(path + s) for s in (".pdparams", ".pdopt"))
    fresh = _wf_model(_ernie_classifier(cfg, SEED + 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.save(str(WF_DIR / "again"))
    save_s = time.perf_counter() - t0
    ev2 = fresh.evaluate(eval_loader, verbose=0)
    check(ev == ev2, f"workflow checkpoint: evaluate {ev} vs the loaded "
          f"Model's {ev2}")
    x, y = next(iter(eval_loader))
    steps = [(model.train_batch(x, y), fresh.train_batch(x, y))
             for _ in range(2)]
    same_state = all(a == b for a, b in steps) and all(
        torch.equal(p._buf, q._buf) for p, q in
        zip(model.parameters(), fresh.parameters()))
    check(same_state, f"workflow checkpoint: train_batch after load "
          f"{steps} differs, or the parameters after it do")
    del fresh
    gc.collect()

    # costs: hapi's train_batch against the bare step on one batch
    net = model.network
    loss_fn = model._loss

    def bare_step():
        out = net(x)
        loss = loss_fn(out, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    hapi_ms, bare_ms = [], []
    for _ in range(WF_TIMED):
        hapi_ms.append(_synced(lambda: model.train_batch(x, y))[1])
        bare_ms.append(_synced(bare_step)[1])
    n_hapi, hapi_us = _dispatch_costs(lambda: model.train_batch(x, y))
    n_bare, bare_us = _dispatch_costs(bare_step)
    wall, busy, rows = _profiled(lambda: model.train_batch(x, y), dev)
    flash = {k: sum(ms for key, _, ms in rows if pat in key)
             for k, pat in (("K1", "fwd_bf16"), ("K2", "dq_bf16"),
                            ("K3", "dkv_bf16"))}
    n_params = sum(p.size for p in net.parameters())
    flops_per_token = 6 * n_params + 12 * L * cfg.hidden_size * WF_S
    ms = float(np.median(walls[1:]))
    tok_s = WF_B * WF_S / (ms / 1e3)
    mfu = tok_s * flops_per_token / BF16_FLOPS
    h_ms, b_ms = float(np.median(hapi_ms)), float(np.median(bare_ms))
    print(f"workflow fit: ERNIE 3.0 base classifier bf16 B{WF_B} S{WF_S}, "
          f"{WF_ITERS} steps of Model.fit on the native DataLoader "
          f"(AdamW {WF_LR} + clip) in {fit_s:.2f} s: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (first five mean {head:.4f}, last five "
          f"{tail:.4f}); step median {ms:.2f} ms ({[round(w, 2) for w in walls[:4]]}"
          f"...), {tok_s:.0f} tokens/s, MFU {mfu:.4f} ({n_params} parameters, "
          f"{flops_per_token} flops a token: 6N + 12 L h S); flash launches "
          f"{launches}; eval loss {ev['loss'][0]:.4f} acc {ev['acc']:.4f} "
          f"over {WF_EVAL}; on {card}", flush=True)
    print(f"workflow hapi: train_batch median {h_ms:.2f} ms "
          f"({[round(v, 2) for v in hapi_ms]}) against the bare step's "
          f"{b_ms:.2f} ms ({[round(v, 2) for v in bare_ms]}): hapi adds "
          f"{h_ms - b_ms:.2f} ms (loss.item() and Accuracy's host reads); "
          f"{n_hapi} apply_op dispatches a train_batch at {hapi_us:.2f} host "
          f"us each against the bare step's {n_bare} at {bare_us:.2f}; a "
          f"profiled train_batch {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%), "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}% of busy)"
                      for k, v in flash.items()) + f"; on {card}", flush=True)
    print(f"workflow checkpoint: {nbytes} bytes (.pdparams + .pdopt), save "
          f"{save_s:.3f} s, load into a fresh Model {load_s:.3f} s; its "
          f"evaluate bitwise the saved Model's ({ev2}); two more "
          f"train_batch each equal ({steps[1][0]}), parameters bitwise "
          f"equal after them", flush=True)
    return model, eval_loader, {
        "step_ms": ms, "tokens_s": tok_s, "mfu": mfu, "fit_s": fit_s,
        "losses": losses, "eval": ev, "launches": launches,
        "hapi_ms": h_ms, "bare_ms": b_ms, "dispatches": (n_hapi, n_bare),
        "busy_ms": busy, "profiled_ms": wall, "flash_ms": flash,
        "loaders": rates, "ckpt_bytes": nbytes, "save_s": save_s,
        "load_s": load_s}


def _hist_thresholds(act, card_side):
    """(Hist threshold, KL threshold, host ms of each) of one activation:
    on the card's tensor, or on its CPU copy with the CPU place."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.core import device as core_device
    prev = core_device._current_device
    if not card_side:
        paddle.set_device("cpu")
        act = paddle.to_tensor(act._buf.float().cpu().numpy())
    try:
        out = []
        for cls in (Q.HistObserverLayer, Q.KLObserverLayer):
            t0 = time.perf_counter()
            o = cls()
            o(act)
            out.append((float(o.scales()), (time.perf_counter() - t0) * 1e3))
    finally:
        core_device._current_device = prev
    return out


def workflow_ptq(dev, card, model, eval_loader):
    """PTQ of the fine-tuned model: absmax activations and per-channel
    weights, calibrated on ``WF_CALIB`` eval batches, converted to int8
    ``QuantizedLinearInfer`` layers; evaluated through ``Model``; the
    logits within the reference's bar of the float model's; the int8
    state dict round-tripped bitwise; Hist / KL observers on one real
    activation held to the same numpy run on its CPU copy."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.metric import Accuracy
    net = model.network
    net.eval()
    batches = list(eval_loader)
    act = {}
    hook = net.ernie.encoder.layers[0].linear1.register_forward_pre_hook(
        lambda layer, inputs: act.setdefault("x", inputs[0]))
    with paddle.no_grad():
        net(batches[0][0])           # the activation for the histograms
    hook.remove()
    ptq = Q.PTQ(Q.QuantConfig(activation=Q.AbsmaxObserver(),
                              weight=Q.PerChannelAbsmaxObserver(
                                  quant_axis=1)))
    t0 = time.perf_counter()
    calib = ptq.quantize(net)
    with paddle.no_grad():
        for x, _ in batches[:WF_CALIB]:
            calib(x)
    infer = ptq.convert(calib)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    qlayers = [l for l in infer.sublayers()
               if type(l).__name__ == "QuantizedLinearInfer"]
    linears = [l for l in net.sublayers() if type(l).__name__ == "Linear"]
    check(len(qlayers) == len(linears) == 74 and all(
        l.qweight._buf.dtype == torch.int8 and l.qweight._buf.device.type ==
        dev.type
        for l in qlayers), f"workflow ptq: {len(qlayers)} "
        f"QuantizedLinearInfer of {len(linears)} Linear, expected 74 int8 "
        "on the card")
    check(not any(type(l).__name__ == "Linear" for l in infer.sublayers()),
          "workflow ptq: a Linear was left unconverted")
    qm = paddle.Model(infer)
    qm.prepare(loss=nn.CrossEntropyLoss(), metrics=Accuracy())
    qev = qm.evaluate(eval_loader, verbose=0)
    fev = model.evaluate(eval_loader, verbose=0)
    err, top = 0.0, 0.0
    with paddle.no_grad():
        for x, _ in batches:
            f, q = net(x)._buf.float(), infer(x)._buf.float()
            err = max(err, (f - q).abs().max().item())
            top = max(top, f.abs().max().item())
    rel = err / top
    check(np.isfinite(rel) and rel < WF_BAR, f"workflow ptq: logits off the "
          f"float model's by {rel} of its largest (bar {WF_BAR})")
    int8_bytes = sum(l.qweight._buf.numel() + 4 * l.scale._buf.numel()
                     for l in qlayers)
    bf16_bytes = sum(2 * l.weight._buf.numel() for l in linears)
    path = str(WF_DIR / "ptq.pdparams")
    sd = infer.state_dict()
    paddle.save(sd, path)
    back = paddle.load(path)
    same = back.keys() == sd.keys() and all(
        back[k]._buf.dtype == v._buf.dtype and torch.equal(back[k]._buf,
                                                           v._buf)
        for k, v in sd.items())
    check(same, "workflow ptq: the int8 state dict did not round-trip "
          "bitwise")
    hist = _hist_thresholds(act["x"], True)
    hist_cpu = _hist_thresholds(act["x"], False)
    check([h[0] for h in hist] == [h[0] for h in hist_cpu],
          f"workflow ptq: Hist / KL thresholds {hist} vs the CPU copy's "
          f"{hist_cpu}")
    print(f"workflow ptq: PTQ(absmax activations, per-channel weights) "
          f"calibrated on {WF_CALIB} batches and converted in {ptq_s:.2f} s: "
          f"{len(qlayers)} QuantizedLinearInfer (int8 weights on the card) "
          f"for {len(linears)} Linear; eval acc int8 {qev['acc']:.4f} "
          f"(loss {qev['loss'][0]:.4f}) beside float {fev['acc']:.4f} (loss "
          f"{fev['loss'][0]:.4f}); logits within {rel:.4f} of the float "
          f"model's largest (bar {WF_BAR}); weight bytes int8 {int8_bytes} "
          f"(scales included) against bf16 {bf16_bytes} "
          f"({bf16_bytes / int8_bytes:.2f}x); the int8 state dict "
          f"({len(sd)} tensors) round-tripped bitwise; on {card}", flush=True)
    print(f"workflow observers: layer 0's FFN input "
          f"{list(act['x'].shape)}: Hist threshold {hist[0][0]:.6f} "
          f"({hist[0][1]:.1f} host ms), KL {hist[1][0]:.6f} "
          f"({hist[1][1]:.1f} host ms), equal to the same numpy run on its "
          f"CPU copy", flush=True)
    del calib, infer, qm
    gc.collect()
    torch.cuda.empty_cache()
    return {"acc_int8": qev["acc"], "acc_float": fev["acc"], "rel": rel,
            "int8_bytes": int8_bytes, "bf16_bytes": bf16_bytes,
            "hist": hist, "ptq_s": ptq_s}


def _quanters(model):
    return [l for l in model.sublayers()
            if type(l).__name__ == "FakeQuanterWithAbsMaxObserverLayer"]


def workflow_qat(dev, card):
    """QAT of the reference's Layer GPT-2 124M at bench.py's step (bf16,
    B16 S1024, AdamW + clip): the float step captured and replayed (this
    run's yardstick); two QAT models from the same weights, one stepped
    under ``to_static`` and one eagerly for ``QAT_STEPS`` steps, losses,
    parameters and the 48 EMA scale / state buffers bitwise equal; the
    captured replays timed and profiled; the QAT model converted to 48
    int8 layers within the reference's bar."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import quantization as Q
    from paddle_tpu_torch.models.gpt2 import GPT2ForCausalLM as LayerGPT2
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq = gpt2_bench_config()
    L = cfg.num_layers
    paddle.seed(SEED)
    ref = LayerGPT2(cfg)
    ref.to(dtype="bfloat16")
    weights = {n: p.numpy() for n, p in ref.state_dict().items()}
    del ref
    ids = np.random.RandomState(SEED + 19).randint(0, cfg.vocab_size,
                                                   (batch, seq + 1))
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])

    def model(quant):
        paddle.seed(SEED)
        m = LayerGPT2(cfg)
        m.to(dtype="bfloat16")
        missing, unexpected = m.set_state_dict(weights)
        check(not missing and not unexpected, "workflow qat: set_state_dict")
        if quant:
            m = Q.QAT(Q.QuantConfig(
                activation=Q.FakeQuanterWithAbsMaxObserver(),
                weight=Q.FakeQuanterChannelWiseAbsMax())).quantize(
                    m, inplace=True)
        return m

    def replays(static, n):
        walls = []
        for _ in range(n):
            walls.append(_synced(lambda: static(x, y))[1])
        return walls

    res = {}
    with layout_direct(False):
        # this run's float captured step, the yardstick
        F = model(False)
        fstatic = paddle.jit.to_static(_bench_step(F, new_adamw(F)))
        _warm_capture(fstatic, lambda: fstatic(x, y).item(), "qat float")
        f_ms = float(np.median(replays(fstatic, QAT_REPLAYS)))
        _, f_busy, _ = _profiled(lambda: fstatic(x, y), dev)
        fstatic._cache.clear()
        del F, fstatic
        gc.collect()
        torch.cuda.empty_cache()

        A, B = model(True), model(True)
        qa = [l for l in A.sublayers() if type(l).__name__ == "QuantedLinear"]
        check(len(qa) == 48 and len(_quanters(A)) == 48,
              f"workflow qat: {len(qa)} QuantedLinear, {len(_quanters(A))} "
              "EMA quanters, expected 48 each")
        static = paddle.jit.to_static(_bench_step(A, new_adamw(A)))
        eager = _bench_step(B, new_adamw(B))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = [static(x, y).item() for _ in range(QAT_STEPS)]
        warm_s = time.perf_counter() - t0
        cap_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = [eager(x, y).item() for _ in range(QAT_STEPS)]
        (prog,) = _programs(static)
        check(_graphs(static) == 1 and prog.captures == 1 and
              not any(g.eager_only for g in static._cache.values()),
              f"workflow qat: program {prog.stats()}")
        same_p = all(torch.equal(p._buf, q._buf) for p, q in
                     zip(A.parameters(), B.parameters()))
        qb = _quanters(B)
        same_s = all(torch.equal(a.scale._buf, b.scale._buf) and
                     torch.equal(a.state._buf, b.state._buf)
                     for a, b in zip(_quanters(A), qb))
        print(f"workflow qat: {QAT_STEPS} captured steps' losses "
              f"{[round(v, 5) for v in got]} vs the eager twin's "
              f"{[round(v, 5) for v in want]}; parameters "
              f"{'bitwise equal' if same_p else 'DIFFER'}; the 48 EMA "
              f"scale / state buffers {'bitwise equal' if same_s else 'DIFFER'}"
              f" (state {float(qb[0].state):.4f} after {QAT_STEPS} steps)",
              flush=True)
        check(got == want and same_p and same_s, "workflow qat: the captured "
              "QAT steps are not bitwise the eager twin's")
        check(all(np.isfinite(got)), f"workflow qat: losses {got}")
        reset_launch_counts()
        walls = replays(static, QAT_REPLAYS)
        launches = {k: launch_counts()[k] for k in FLASH_COUNTERS}
        wantL = {k: L * QAT_REPLAYS if k in ("K1", "K2", "K3") else 0
                 for k in FLASH_COUNTERS}
        check(launches == wantL, f"workflow qat: replays launched "
              f"{launches}, expected {wantL}")
        wall, busy, rows = _profiled(lambda: static(x, y), dev)
        q_ms = float(np.median(walls))
        capture_s = prog.capture_s
        static._cache.clear()
        del B, eager, static, prog
        gc.collect()
        torch.cuda.empty_cache()

        # convert: 48 int8 layers, the loss and logits within the bar
        A.eval()
        infer = Q.QAT(Q.QuantConfig(
            activation=Q.FakeQuanterWithAbsMaxObserver(),
            weight=Q.FakeQuanterChannelWiseAbsMax())).convert(A)
        n_int8 = sum(type(l).__name__ == "QuantizedLinearInfer" and
                     l.qweight._buf.dtype == torch.int8
                     for l in infer.sublayers())
        with paddle.no_grad():
            _, lq = A(x, labels=y)
            _, li = infer(x, labels=y)
            fq, fi = A(x[:2])._buf.float(), infer(x[:2])._buf.float()
        lq, li = float(lq), float(li)
        loss_rel = abs(li - lq) / abs(lq)
        logit_rel = ((fi - fq).abs().max() / fq.abs().max()).item()
    check(n_int8 == 48, f"workflow qat: convert gave {n_int8} int8 layers")
    check(loss_rel < WF_BAR and logit_rel < WF_BAR, f"workflow qat: the "
          f"int8 model's loss {li} vs the QAT model's {lq} ({loss_rel}), "
          f"logits {logit_rel} (bar {WF_BAR})")
    print(f"workflow qat: GPT-2 124M bf16 B{batch} S{seq} QAT (EMA absmax "
          f"activations, channel-wise weights; 48 QuantedLinear): its "
          f"first {QAT_STEPS} calls (spy, capture, replays) {warm_s:.2f} s "
          f"({capture_s:.2f} s capturing), peak memory over them "
          f"{cap_peak:.2f} GiB (two QAT models and optimizers resident); "
          f"replay median {q_ms:.2f} ms ({[round(w, 2) for w in walls]}) "
          f"against this run's float captured step {f_ms:.2f} ms "
          f"(+{100 * (q_ms / f_ms - 1):.1f}%); replay launches {launches}; a "
          f"profiled replay {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%) against the float replay's "
          f"{f_busy:.1f} ms: fake quantization and the EMA take "
          f"{busy - f_busy:.1f} ms ({100 * (busy - f_busy) / busy:.1f}% of "
          f"busy); converted to {n_int8} int8 QuantizedLinearInfer: loss "
          f"{li:.5f} vs QAT {lq:.5f} ({loss_rel:.2e}), logits within "
          f"{logit_rel:.4f} of the largest (bar {WF_BAR}); on {card}",
          flush=True)
    for key, count, kms in rows[:8]:
        print(f"profile qat:   {kms:9.3f} ms {100 * kms / busy:5.1f}%  "
              f"x{count:<5d} {key[:90]}")
    del A, infer
    gc.collect()
    torch.cuda.empty_cache()
    return {"replay_ms": q_ms, "float_ms": f_ms, "busy_ms": busy,
            "float_busy_ms": f_busy, "capture_s": capture_s,
            "peak_gib": cap_peak, "launches": launches,
            "loss_rel": loss_rel, "logit_rel": logit_rel}


def workflow_phase(dev, card):
    """The training workflow around M10 on the card: ERNIE 3.0 base
    fine-tuned through ``Model.fit`` on the native ``DataLoader``
    (``workflow_finetune``), quantized after training (``workflow_ptq``),
    and GPT-2 124M's QAT step captured (``workflow_qat``).  Returns the
    readings."""
    import paddle_tpu_torch as paddle
    gc.collect()
    torch.cuda.empty_cache()
    paddle.set_device(dev)
    t0 = time.perf_counter()
    cfg = ernie_base_config()
    model, eval_loader, fit = workflow_finetune(dev, card, cfg)
    out = {"fit": fit, "ptq": workflow_ptq(dev, card, model, eval_loader)}
    del model, eval_loader
    gc.collect()
    torch.cuda.empty_cache()
    out["qat"] = workflow_qat(dev, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"workflow: the phase took {out['seconds']:.1f} s", flush=True)
    return out


# ------------------------------------------------- phase 6h: hybrid parallel
# (distributed, fleet, DTensor shardings, ZeRO, MoE with expert parallelism,
# recompute): two launched ranks sharing the card, and the NCCL world-1 twins
HYBRID_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_hybrid"
HYBRID_SCRIPT = Path(__file__).resolve().parent / "tools" / "hybrid_phase.py"
HYBRID_TIMEOUT = {"twin": 300, "ranks": 420}     # seconds a job may take
HYBRID_TINY_BAR = 3e-5          # (a): dryrun_multichip's loss bar
HYBRID_TINY_NORM = 1e-4         # (a): the gradient norm, relative
HYBRID_LOSS = 2e-3              # (b), (c): first loss, relative to the twin
HYBRID_NORM = 1e-2              # (b), (c): first gradient norm, relative


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _hybrid_job(tag, cmd, env, timeout):
    """Run one job of the phase under ``timeout``; its output goes to
    ``HYBRID_DIR/<tag>.log`` and its tail is printed when it fails."""
    log = HYBRID_DIR / f"{tag}.log"
    t0 = time.perf_counter()
    with open(log, "wb") as f:
        p = subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                             cwd=str(Path(__file__).resolve().parent),
                             start_new_session=True)
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            rc = "timeout"
    secs = time.perf_counter() - t0
    tail = log.read_text(errors="replace")[-4000:]
    if rc != 0:
        print(f"hybrid {tag}: rc {rc} after {secs:.1f} s; log tail:\n{tail}",
              flush=True)
    check(rc == 0, f"hybrid: the {tag} job failed (rc {rc})")
    return secs


def _hybrid_readings(tag, r, card, backend):
    ms = sorted(r["ms"][-3:])[1]
    comm = ", ".join(f"{k} {c:g} calls {b / 2 ** 20:.1f} MiB"
                     for k, (c, b) in sorted(r["comm_per_step"].items()))
    print(f"hybrid {tag}: step {ms:.1f} ms (median of the last 3), "
          f"{r['tokens_per_step'] / ms * 1e3:.0f} tokens/s, peak "
          f"{r['peak_gb']:.2f} GiB, collectives a step: {comm or 'none'}, "
          f"launches {r['launches']}, losses {r['losses']} "
          f"[{backend}, on {card}]", flush=True)
    return ms


def hybrid_phase(dev, card):
    """Hybrid-parallel training on the card (``tools/hybrid_phase.py``):
    first the single-process twins (NCCL at world size 1 through
    ``fleet.init``): ``bench.py``'s Llama and the 2-layer DeepSeekMoE-16B
    width Llama, and GPT-2 124M with ``use_recompute`` on and off; then two
    launched ranks sharing the card (one process group): (a) the tiny f32
    Llama under dp / mp / sharding = 2 and the tiny MoE under ep = 2, each
    within 3e-5 of a replicated run of the same batch (gradient norm within
    1e-4); (b) the full-width Llama under dp = 2 (DataParallel), mp = 2
    (``shard_llama``) and sharding = 2 (ZeRO-3), and (c) the MoE under
    ep = 2, each held to its twin (first loss 2e-3, first gradient norm
    1e-2, the loss falls; the MoE's aux loss finite and the twin's).
    Prints each configuration's step ms, tokens/s, peak memory, collectives
    a step and K1-K3 launches a rank.  Returns the readings and each rank's
    K1-K3 launches."""
    import socket
    gc.collect()
    torch.cuda.empty_cache()
    print(f"hybrid: this process holds {torch.cuda.memory_reserved() / 2**30:.2f}"
          " GiB of the card", flush=True)
    shutil.rmtree(HYBRID_DIR, ignore_errors=True)
    HYBRID_DIR.mkdir(parents=True)
    t_phase = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    twin_s = _hybrid_job("twin", [sys.executable, str(HYBRID_SCRIPT),
                                  "--twin", "--out", str(HYBRID_DIR)],
                         env, HYBRID_TIMEOUT["twin"])
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    ranks_s = _hybrid_job("ranks", [
        sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
        "--nproc_per_node", "2", "--log_dir", str(HYBRID_DIR / "log"),
        str(HYBRID_SCRIPT), "--ranks", "--out", str(HYBRID_DIR)],
        env, HYBRID_TIMEOUT["ranks"])
    twin = json.loads((HYBRID_DIR / "twin.json").read_text())
    ranks = [json.loads((HYBRID_DIR / f"ranks.{r}.json").read_text())
             for r in range(2)]
    backend = ranks[0]["backend"]
    label = f"2 ranks on one card, {backend}"
    print(f"hybrid: backend {backend} ({ranks[0]['why']}); twins on "
          f"{twin['backend']} at world size 1 ({twin['why']}); twin job "
          f"{twin_s:.1f} s, ranks job {ranks_s:.1f} s", flush=True)

    # (a) the tiny float32 runs against their replicated runs
    for kind in ("dp", "mp", "sharding", "ep"):
        for r, res in enumerate(ranks):
            (got, gn), (want, wn) = res["a"][kind]["run"], \
                res["a"][kind]["replicated"]
            dl = max(abs(a - b) for a, b in zip(got, want))
            dn = max(_rel(a, b) for a, b in zip(gn, wn))
            ok = np.allclose(got, want, atol=HYBRID_TINY_BAR,
                             rtol=HYBRID_TINY_BAR)
            print(f"hybrid (a) tiny f32 {kind}=2 rank {r}: losses {got} vs "
                  f"replicated {want} (|d| {dl:.2e}, bar {HYBRID_TINY_BAR}),"
                  f" gradient norm rel {dn:.2e} (bar {HYBRID_TINY_NORM}) "
                  f"[{label}]", flush=True)
            check(ok, f"hybrid (a) {kind}: losses {got} vs {want}")
            check(dn <= HYBRID_TINY_NORM, f"hybrid (a) {kind}: norm {dn}")

    # (b) full width against the NCCL world-1 twin
    out = {"backend": backend, "b": {}}
    tw = twin["b"]
    _hybrid_readings("(b) twin, world 1", tw, card, twin["backend"])
    for kind in ("dp", "mp", "sharding"):
        rs = [res["b"][kind] for res in ranks]
        # dp: each rank's loss is its half's mean; the global mean is theirs
        first = (sum(r["losses"][0] for r in rs) / 2 if kind == "dp"
                 else rs[0]["losses"][0])
        last = (sum(r["losses"][-1] for r in rs) / 2 if kind == "dp"
                else rs[0]["losses"][-1])
        el, en = _rel(first, tw["losses"][0]), _rel(rs[0]["norms"][0],
                                                    tw["norms"][0])
        print(f"hybrid (b) {kind}=2: first loss {first:.6f} vs twin "
              f"{tw['losses'][0]:.6f} (rel {el:.2e}, bar {HYBRID_LOSS}), "
              f"first grad norm {rs[0]['norms'][0]:.5f} vs "
              f"{tw['norms'][0]:.5f} (rel {en:.2e}, bar {HYBRID_NORM}), last "
              f"loss {last:.6f}", flush=True)
        check(el <= HYBRID_LOSS, f"hybrid (b) {kind}: first loss rel {el}")
        check(en <= HYBRID_NORM, f"hybrid (b) {kind}: first norm rel {en}")
        check(last < first, f"hybrid (b) {kind}: the loss did not fall")
        ms = [_hybrid_readings(f"(b) {kind}=2 rank {r}", res, card, label)
              for r, res in enumerate(rs)]
        for r, res in enumerate(rs):
            want = {k: res["layers"] * len(res["losses"])
                    for k in ("K1", "K2", "K3")}
            check(res["launches"] == want, f"hybrid (b) {kind} rank {r}: "
                  f"launches {res['launches']} != layers x steps {want}")
        out["b"][kind] = {"ms": ms, "first_rel": el, "norm_rel": en}

    # (c) the MoE against its twin
    tc = twin["c"]
    _hybrid_readings("(c) twin, world 1", tc, card, twin["backend"])
    rc = [res["c"] for res in ranks]
    el = _rel(rc[0]["losses"][0], tc["losses"][0])
    en = _rel(rc[0]["norms"][0], tc["norms"][0])
    ea = _rel(rc[0]["aux"][0], tc["aux"][0])
    print(f"hybrid (c) MoE ep=2 (DeepSeekMoE-16B width, {tc['layers']} "
          f"layers, bf16, {tc['tokens_per_step']} tokens a step): first loss "
          f"{rc[0]['losses'][0]:.6f} vs twin {tc['losses'][0]:.6f} (rel "
          f"{el:.2e}), first grad norm rel {en:.2e}, aux {rc[0]['aux'][0]:.6f}"
          f" vs {tc['aux'][0]:.6f} (rel {ea:.2e}), parameters a rank "
          f"{[r['params_this_rank'] for r in rc]}, twin "
          f"{tc['params_this_rank']}", flush=True)
    check(el <= HYBRID_LOSS, f"hybrid (c): first loss rel {el}")
    check(en <= HYBRID_NORM, f"hybrid (c): first norm rel {en}")
    check(all(math.isfinite(a) for r in rc for a in r["aux"]),
          "hybrid (c): the aux loss is not finite")
    check(ea <= HYBRID_LOSS, f"hybrid (c): aux rel {ea}")
    check(rc[0]["losses"][-1] < rc[0]["losses"][0],
          "hybrid (c): the loss did not fall")
    for r, res in enumerate(rc):
        _hybrid_readings(f"(c) MoE ep=2 rank {r}", res, card, label)
        want = {k: res["layers"] * len(res["losses"])
                for k in ("K1", "K2", "K3")}
        check(res["launches"] == want, f"hybrid (c) rank {r}: launches "
              f"{res['launches']} != layers x steps {want}")
    out["c"] = {"first_rel": el, "norm_rel": en, "aux_rel": ea}

    # recompute: GPT-2 124M with use_recompute against without
    rcmp = twin["recompute"]
    p, q = rcmp["plain"], rcmp["recompute"]
    lr_ = max(_rel(a, b) for a, b in zip(q["losses"], p["losses"]))
    print(f"hybrid recompute (GPT-2 124M bf16 B16 S1024, world 1): bitwise "
          f"{rcmp['bitwise']}, losses {q['losses']} vs {p['losses']} (rel "
          f"{lr_:.2e}), worst gradient rel {rcmp['worst_grad_rel']:.2e} over "
          f"{rcmp['params']} parameters; step {sorted(q['ms'][-3:])[1]:.1f} vs "
          f"{sorted(p['ms'][-3:])[1]:.1f} ms, peak {q['peak_gb']:.2f} vs "
          f"{p['peak_gb']:.2f} GiB [on {card}]", flush=True)
    check(rcmp["bitwise"] or (lr_ <= HYBRID_LOSS
                              and rcmp["worst_grad_rel"] <= HYBRID_NORM),
          "hybrid recompute: not the plain step")
    check(q["peak_gb"] < p["peak_gb"], "hybrid recompute: no memory saved")
    out["launches"] = {k: [sum(res["b"][kind]["launches"][k]
                               for kind in ("dp", "mp", "sharding"))
                           + res["c"]["launches"][k] for res in ranks]
                       for k in ("K1", "K2", "K3")}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"hybrid phase: {out['seconds']:.1f} s, backend {backend}, on "
          f"{card}", flush=True)
    return out


# ------------------------------------ phase 6p: pipeline and the sep axis
# (parallel/pipeline_layer.py, pipeline.py, ring_attention.py, ulysses.py):
# the same two launched ranks and NCCL world-1 twins as the hybrid phase
PP_SEP_TIMEOUT = {"twin": 240, "ranks": 420}   # seconds a job may take
PART_C_NORM = 1e-4              # part C's gradient norm, relative (dryrun)
RING_BAR = 2e-2                 # the ring's kernels against its plain twin


def _pp_sep_expected(kind, steps, rank):
    """K1-K3 launches a rank of a (d) run: layers x blocks x microbatches x
    steps.  Under ZB-H1 a stage whose chunk takes an activation runs the
    flash backward twice (B for the input's gradient, W's sweep again for
    the weights'); stage 0's chunk takes token ids, so its B has nothing
    to do and W runs it once."""
    if kind in ("1F1B", "VPP"):          # 2 layers a rank x 4 microbatches
        return {"K1": 8 * steps, "K2": 8 * steps, "K3": 8 * steps}
    if kind == "ZB-H1":
        n = 8 * steps * (2 if rank else 1)
        return {"K1": 8 * steps, "K2": n, "K3": n}
    if kind == "ring":                   # 4 layers x (rank + 1) blocks
        n = 4 * (rank + 1) * steps
        return {"K1": n, "K2": n, "K3": n}
    return {"K1": 4 * steps, "K2": 4 * steps, "K3": 4 * steps}   # ulysses


def pipeline_sep_phase(dev, card):
    """Pipeline parallelism and the 'sep' axis on the card
    (``tools/hybrid_phase.py``): first the single-process NCCL world-1
    twins (``_llama_child``'s step with 4 microbatches accumulated, its
    full-batch step, part C's stages in sequence), then the two launched
    ranks sharing the card: a 32 MB exchange each way over the CUDA
    backend; the ring's kernels (K1-K3 a block) against its plain twin at
    the sep run's shapes (``RING_BAR``); ``_llama_child`` at pp = 2 under
    1F1B, the interleaved schedule (v = 2) and ZB-H1 (each held to the
    microbatched twin: first loss 2e-3, first gradient norm 1e-2, the loss
    falls; the tied weight's copies on the two stages equal after the
    clipped steps), at sep = 2 with ring and Ulysses attention (held to the
    full-batch twin the same way), and dryrun part C (two f32 stages at
    hidden 2048, M = 4: the gradient norm within 1e-4 of the stages run in
    sequence).  Prints each run's step ms, tokens/s, peak memory, the
    staged collectives a step and K1-K3 launches a rank, held to their
    counts.  Returns the readings and each rank's K1-K3 launches a run."""
    import socket
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = HYBRID_DIR / "pp_sep"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    twin_s = _hybrid_job("pp_sep_twin", [
        sys.executable, str(HYBRID_SCRIPT), "--pp-sep-twin", "--out",
        str(out_dir)], env, PP_SEP_TIMEOUT["twin"])
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    ranks_s = _hybrid_job("pp_sep_ranks", [
        sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
        "--nproc_per_node", "2", "--log_dir", str(out_dir / "log"),
        str(HYBRID_SCRIPT), "--pp-sep-ranks", "--out", str(out_dir)],
        env, PP_SEP_TIMEOUT["ranks"])
    twin = json.loads((out_dir / "pp_sep_twin.json").read_text())
    ranks = [json.loads((out_dir / f"pp_sep.{r}.json").read_text())["d"]
             for r in range(2)]
    label = "2 ranks on one card"
    print(f"pipeline_sep: twin job {twin_s:.1f} s, ranks job {ranks_s:.1f} "
          f"s", flush=True)
    for r, res in enumerate(ranks):
        ex = res["exchange"]
        print(f"pipeline_sep rank {r}: a 32 MB exchange each way (both "
              f"ranks send first) over the CUDA backend: {ex['ok']}, "
              f"{ex['ms']:.1f} ms [{label}, on {card}]", flush=True)
        check(ex["ok"], f"pipeline_sep rank {r}: the exchange did not arrive")
        rc = res["ring_check"]
        print(f"pipeline_sep rank {r}: ring K1-K3 vs its plain twin, q / kv "
              f"{rc['shape']} bf16 causal: o, dq, dk, dv rel err "
              f"{[f'{e:.2e}' for e in rc['errs']]} (bar {RING_BAR}); fwd + "
              f"bwd {rc['ms']['kernel']:.2f} ms vs plain "
              f"{rc['ms']['plain']:.2f} ms; launches {rc['launches']} "
              f"[on {card}]", flush=True)
        check(all(e <= RING_BAR for e in rc["errs"]),
              f"pipeline_sep rank {r}: the ring is off its plain twin "
              f"{rc['errs']}")
    out = {"launches": {k: {} for k in ("K1", "K2", "K3")}, "runs": {}}
    for kind, tw in (("1F1B", twin["micro"]), ("VPP", twin["micro"]),
                     ("ZB-H1", twin["micro"]), ("ring", twin["full"]),
                     ("ulysses", twin["full"])):
        rs = [res[kind] for res in ranks]
        el = _rel(rs[0]["losses"][0], tw["losses"][0])
        en = _rel(rs[0]["norms"][0], tw["norms"][0])
        print(f"pipeline_sep {kind}: first loss {rs[0]['losses'][0]:.6f} vs "
              f"twin {tw['losses'][0]:.6f} (rel {el:.2e}, bar "
              f"{HYBRID_LOSS}), first grad norm {rs[0]['norms'][0]:.5f} vs "
              f"{tw['norms'][0]:.5f} (rel {en:.2e}, bar {HYBRID_NORM}), "
              f"losses {rs[0]['losses']}", flush=True)
        check(all(r_["losses"] == rs[0]["losses"] for r_ in rs),
              f"pipeline_sep {kind}: the ranks' losses differ")
        check(el <= HYBRID_LOSS, f"pipeline_sep {kind}: first loss rel {el}")
        check(en <= HYBRID_NORM, f"pipeline_sep {kind}: first norm rel {en}")
        check(rs[0]["losses"][-1] < rs[0]["losses"][0],
              f"pipeline_sep {kind}: the loss did not fall")
        if "tie_diff" in rs[0]:
            print(f"pipeline_sep {kind}: the tied embedding's two copies "
                  f"after {len(rs[0]['losses'])} clipped steps differ by "
                  f"{[r_['tie_diff'] for r_ in rs]}", flush=True)
            check(all(r_["tie_diff"] == 0 for r_ in rs),
                  f"pipeline_sep {kind}: the tied weight's copies drifted")
        ms = [_hybrid_readings(f"(d) {kind} rank {r}", res_, card, label)
              for r, res_ in enumerate(rs)]
        for r, res_ in enumerate(rs):
            want = _pp_sep_expected(kind, len(res_["losses"]), r)
            check(res_["launches"] == want, f"pipeline_sep {kind} rank {r}: "
                  f"launches {res_['launches']} != {want}")
            for k in out["launches"]:
                out["launches"][k].setdefault(kind, []).append(
                    res_["launches"][k])
        out["runs"][kind] = {"ms": ms, "first_rel": el, "norm_rel": en}
    _hybrid_readings("(d) twin, 4 microbatches, world 1", twin["micro"], card,
                     twin["backend"])
    _hybrid_readings("(d) twin, full batch, world 1", twin["full"], card,
                     twin["backend"])
    tc = twin["C"]
    for r, res in enumerate(ranks):
        c = res["C"]
        en, el = _rel(c["norm"], tc["norm"]), _rel(c["loss"], tc["loss"])
        print(f"pipeline_sep part C rank {r} (pp = 2 SPMD GPipe, one f32 "
              f"decoder layer a stage at hidden 2048, M 4, B 2, S 1024): "
              f"grad norm {c['norm']:.6e} vs in sequence {tc['norm']:.6e} "
              f"(rel {en:.2e}, bar {PART_C_NORM}), loss rel {el:.2e}; "
              f"{c['ms']:.1f} ms vs {tc['ms']:.1f} ms; launches "
              f"{c['launches']} (sequence {tc['launches']}) [{label}, on "
              f"{card}]", flush=True)
        check(en <= PART_C_NORM and el <= PART_C_NORM,
              f"pipeline_sep part C rank {r}: norm rel {en}, loss rel {el}")
        check(c["launches"]["K1"] > 0 and c["launches"]["K2"] > 0,
              f"pipeline_sep part C rank {r}: no flash launch")
        for k in out["launches"]:
            out["launches"][k].setdefault("part_c", []).append(
                c["launches"][k])
    out["seconds"] = time.perf_counter() - t_phase
    print(f"pipeline_sep phase: {out['seconds']:.1f} s, on {card}",
          flush=True)
    return out


# --------------------------------------------------- phase 5: weight-only
# Llama-3-8B's seven projections of a layer, (name, in_features K,
# out_features N), as weight_only_linear stores them: [K, N]
LLAMA_PROJ = [("q", 4096, 4096), ("k", 4096, 1024), ("v", 4096, 1024),
              ("o", 4096, 4096), ("gate", 4096, 14336), ("up", 4096, 14336),
              ("down", 14336, 4096)]
WO_LAYERS = 32
WO_M = 8                 # decode batch
WO_PASSES = 5            # timed passes, median
WO_SPIN = 40_000_000     # cycles (about 20 ms): longer than a pass's issue
# K8 against quant_matmul_ref: bf16 at 2e-2 of the largest reference
# magnitude, the bar of tests/test_quantization.py's kernel test (both sum
# in f32; they differ by the order of the sum and one bf16 rounding of
# y); f32 at 1e-5 of it (full f32 on both sides, sums in other orders).
WO_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


# extra K8 cases beside the pass: batch rows at the q / o shape and at
# down's K = 14336, and the smallest shape K8 takes
WO_M_CASES = (1, 13, 300)
WO_SMALL = (256, 256)
K8_DESIGN = ("bf16 x: y^T = W^T x^T on mma.sync m16n8k16 (the weight the "
             "16-row A operand, the batch n = 8); one block an SM, a "
             "cp.async ring of raw int8 / int4 bytes (16 KB stages, up to 8, "
             "XOR-swizzled; int4 in two pipelines), each lane dequantizing "
             "its fragment in registers (byte permutes, no conversion unit, "
             "no bf16 tile in shared memory); K split over a thread block "
             "cluster of up to 8, every cluster resident at once, the "
             "partials added in rank order through distributed shared "
             "memory: one launch a GEMM. f32 x: CUDA cores, whole K a block")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / want.float().abs().max().item())


def k8_plan_check(sms):
    """The bf16 K8 bodies' plans as the card's library compiled them
    (``quant_matmul_plan``) against ``ops/quant_matmul.py``'s
    ``body_plan``, with no local memory (spills); each body's ptxas
    report printed; and the launch plan of each Llama-3-8B projection at
    the pass's M.  Returns the launch plans by projection."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant_matmul as qm
    log = _build.LOGS.get("quant_matmul", "")
    for bn in (64, 128):
        for int4 in (False, True):
            for mt in (1, 2, 4):
                want = qm.body_plan(bn, int4, mt)
                got = qm.compiled_plan(bn, int4, mt)
                check(all(got[k] == v for k, v in want.items()),
                      f"K8 plan bn={bn} int4={int4} mt={mt}: compiled {got}, "
                      f"recorded {want}")
                check(got["local_bytes"] == 0,
                      f"K8 bn={bn} int4={int4} mt={mt} uses "
                      f"{got['local_bytes']} bytes of local memory (spills)")
                tag = f"qmm_bf16ILi{bn}ELb{int(int4)}ELi{mt}E"
                lines = log.splitlines()
                report = next(
                    (" ".join(x.strip() for x in lines[i + 1:i + 4]
                              if "registers" in x or "spill" in x)
                     for i, x in enumerate(lines)
                     if "Compiling entry function" in x and tag in x),
                    "not in this process" if not log else "no report")
                print(f"K8 body qmm_bf16<{bn}, {'int4' if int4 else 'int8'}, "
                      f"{mt}>: {got['ks']} k rows a stage, {got['pipes']} "
                      f"pipeline(s) of {got['stages']} stages, "
                      f"{got['threads']} threads, dynamic shared "
                      f"memory {got['smem']} bytes, static "
                      f"{got['static_smem']}; registers {got['registers']}, "
                      f"local {got['local_bytes']} bytes; ptxas: {report}",
                      flush=True)
    plans = {}
    dev = torch.cuda.current_device()
    for name, K, N in LLAMA_PROJ:
        for int4 in (False, True):
            bn, splits, mt = qm.launch_plan(
                WO_M, K, N, sms,
                lambda b, m, s: qm.max_clusters(dev, b, int4, m, s))
            blocks = N // bn * splits
            resident = qm.max_clusters(dev, bn, int4, mt, splits)
            plans[f"{name} {K}x{N}{' int4' if int4 else ''}"] = {
                "strip": bn, "splits": splits, "cluster": splits,
                "batch_tiles": mt, "blocks": blocks,
                "clusters_resident": resident}
            check(blocks <= sms and N // bn <= resident,
                  f"K8 plan for {name}: {blocks} blocks, {N // bn} clusters "
                  f"of {splits}, {resident} resident at once, {sms} SMs")
    print("K8 launch plans at M = 8 (strip columns, splits of K = cluster "
          "size, blocks, clusters of that size the card holds at once): "
          + ", ".join(f"{k} {v['strip']} / {v['splits']} / {v['blocks']} / "
                      f"{v['clusters_resident']}" for k, v in plans.items()),
          flush=True)
    return plans


def _k8_case(x, q, s, int4, tag):
    """K8 at (x, q, s) twice: bitwise the same, finite, within WO_TOL of
    ``quant_matmul_ref``; returns the error of the largest."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    y = qm.quant_matmul(x, q, s, int4=int4)
    again = qm.quant_matmul(x, q, s, int4=int4)
    e = _rel_err(y, qm.quant_matmul_ref(x, q, s, int4=int4))
    check(bool(torch.isfinite(y).all())
          and tuple(y.shape) == (x.shape[0], q.shape[1]),
          f"weight-only {tag}: output not finite or of the wrong shape")
    check(torch.equal(y, again), f"weight-only {tag}: a second launch "
          f"differs bitwise")
    check(e <= WO_TOL[x.dtype], f"weight-only {tag}: error {e} over "
          f"{WO_TOL[x.dtype]}")
    return e


def _timed(fn, n=WO_PASSES, kernels=None):
    """Times of ``fn``, a pass over distinct weights whose bytes exceed the
    50 MB L2 (so no flush is needed): ``wall``, the median of ``n``
    synchronised runs between CUDA events, host issue included;
    ``held``, the median of three device spans of the pass, the card held
    in a spin while its launches are queued (CUDA events, no profiler:
    the kernels and the gaps between them); and ``device``, the median
    over three runs under torch.profiler of the device time of its
    kernels (those whose names contain one of ``kernels``, or all), with
    ``recorded``, how many launches of them the profiler saw (late in
    this script it has missed a few per cent of K8's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    walls, helds, devs = [], [], []
    for spin in [0] * n + [WO_SPIN] * 3:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        (helds if spin else walls).append(a.elapsed_time(b))
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and (kernels is None or any(k in e.key for k in kernels))]
        devs.append((sum(e.self_device_time_total for e in ev) / 1e3,
                     sum(e.count for e in ev)))
    devs.sort()
    return {"wall": float(np.median(walls)), "held": float(np.median(helds)),
            "device": devs[1][0], "recorded": devs[1][1]}


def _kernel_counts(fn):
    """{kernel name: launches} of one run of fn under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def _quantized_pass(dev, algo):
    """Llama-3-8B's 224 projection weights, drawn in bf16 from seed
    ``SEED`` on ``dev`` one at a time and quantized to ``algo``, in pass
    order ([(K, N, qw, scale)]), the pass's x by K (drawn after them), and
    the generator, for later draws."""
    from paddle_tpu_torch.nn import quant
    gen = torch.Generator(device=dev).manual_seed(SEED)
    weights = []
    for _ in range(WO_LAYERS):
        for _, K, N in LLAMA_PROJ:
            w = torch.randn(K, N, generator=gen, device=dev,
                            dtype=torch.bfloat16) * 0.02
            weights.append((K, N, *quant.weight_quantize(
                w, algo=f"weight_only_{algo}")))
            del w
    xs = {K: torch.randn(WO_M, K, generator=gen, device=dev).to(
        torch.bfloat16) for K in {K for _, K, _ in LLAMA_PROJ}}
    return weights, xs, gen


def k8_profile_child():
    """In a fresh process: one profiled weight-only pass each in int8 and
    int4 (after one unprofiled), printing {algo: {kernel: launches the
    profiler recorded}} as the last line (late in a long process the
    profiler misses some of K8's launches; in a fresh one it has recorded
    all of them)."""
    from paddle_tpu_torch.nn import quant
    dev = torch.device("cuda", 0)
    out = {}
    for algo in ("int8", "int4"):
        weights, xs, _ = _quantized_pass(dev, algo)

        def run():
            with torch.no_grad():
                for K, N, q, s in weights:
                    quant.weight_only_linear(xs[K], q, weight_scale=s,
                                             weight_dtype=algo)
        run()
        out[algo] = _kernel_counts(run)
        del weights, xs
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def k8_fresh_process_counts():
    """:func:`k8_profile_child` in a child process of this interpreter,
    from this script's directory; returns its counts."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.k8_profile_child())"],
        cwd=here, capture_output=True, text=True, timeout=900)
    check(res.returncode == 0, f"the fresh-process profiled K8 pass failed "
          f"(rc {res.returncode}): {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


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
    ``quant_matmul_ref``, and bitwise the same in a second pass.  First
    the compiled plans (``k8_plan_check``).  Then M = 1, 13 and 300 and
    one f32 case at the q / o shape and at down's K = 14336, and M = 1, 8,
    13, 300 and f32 at the smallest shape K8 takes (256 x 256), each run
    twice and bitwise equal; a call that needs a gradient (the dequant
    formulation, no launch), and the memory a call allocates.  Times: the
    pass (and a profiled pass running K8's kernel alone), the host's
    microseconds a call, the dequant formulation over the same pass,
    F.linear on dequantized bf16 weights, the library's calls where they
    run on CUDA, the plain twin, and K8 per projection shape.  Returns the
    kernels' lines and launches."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.jit import CapturedProgram, graph_pool
    from paddle_tpu_torch.nn import quant
    from paddle_tpu_torch.ops import quant_matmul as qm
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fresh = k8_fresh_process_counts()
    print(f"weight-only: a profiled pass in a fresh process ("
          f"{time.perf_counter() - t0:.1f} s): {fresh}", flush=True)
    t0 = time.perf_counter()
    weights = {}                # algo -> [(K, N, qw, scale)] in pass order
    for algo in ("int8", "int4"):
        # the same bf16 weights and x for both (one seed)
        weights[algo], xs, gen = _quantized_pass(dev, algo)
    torch.cuda.synchronize()
    wbytes = {a: sum(q.numel() for _, _, q, _ in ws)
              for a, ws in weights.items()}
    print(f"weight-only: Llama-3-8B's {len(weights['int8'])} projection "
          f"weights ({WO_LAYERS} layers) drawn in bf16 and quantized in "
          f"{time.perf_counter() - t0:.1f} s: int8 {wbytes['int8'] / 1e9:.2f} "
          f"GB, int4 {wbytes['int4'] / 1e9:.2f} GB", flush=True)

    def run_pass(algo, out=None):
        for K, N, q, s in weights[algo]:
            y = quant.weight_only_linear(xs[K], q, weight_scale=s,
                                         weight_dtype=algo)
            if out is not None:
                out.append(y)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = k8_plan_check(sms)
    lines, launches = [], {}
    for algo, kern in (("int8", "K8"), ("int4", "K8-int4")):
        int4 = algo == "int4"
        outs, again = [], []
        with torch.no_grad():
            reset_launch_counts()
            run_pass(algo, outs)
            got = launch_counts()
            run_pass(algo, again)
        torch.cuda.synchronize()
        launches[kern] = got[kern]
        want = {k: len(weights[algo]) if k == kern else 0 for k in COUNTERS}
        check(got == want, f"weight-only {algo} pass: launches {got}, "
              f"expected {want}")
        worst = 0.0
        for (K, N, q, s), y, y2 in zip(weights[algo], outs, again):
            e = _rel_err(y, qm.quant_matmul_ref(xs[K], q, s, int4=int4))
            check(bool(torch.isfinite(y).all()) and y.shape == (WO_M, N)
                  and e <= WO_TOL[torch.bfloat16],
                  f"weight-only {algo} {K}x{N}: error {e} of the largest")
            check(torch.equal(y, y2), f"weight-only {algo} {K}x{N}: the "
                  f"pass's second run differs bitwise")
            worst = max(worst, e)
        del outs, again
        errs = {f"bf16 M={WO_M} pass": worst}
        # other batch rows at the q / o shape and at down's K = 14336, one
        # f32 case at each, and the smallest shape; every case twice
        small_w = torch.randn(*WO_SMALL, generator=gen, device=dev,
                              dtype=torch.bfloat16) * 0.02
        small = (*WO_SMALL, *quant.weight_quantize(
            small_w, algo=f"weight_only_{algo}"))
        del small_w
        down = next(t for t in weights[algo] if t[0] == 14336)
        for K, N, q, s in (weights[algo][0], down, small):
            for M, dt in ([(M, torch.bfloat16) for M in WO_M_CASES]
                          + [(WO_M, torch.bfloat16), (WO_M, torch.float32)]):
                if M == WO_M and dt == torch.bfloat16 and K != WO_SMALL[0]:
                    continue               # the pass has it
                x = torch.randn(M, K, generator=gen, device=dev).to(dt)
                tag = (f"{'bf16' if dt == torch.bfloat16 else 'f32'} M={M} "
                       f"{K}x{N}")
                errs[tag] = _k8_case(x, q, s, int4, f"{algo} {tag}")
        del small
        print(f"weight-only {algo} ({kern}): {got[kern]} launches over "
              f"{len(weights[algo])} GEMMs, each output bitwise the same in "
              f"a second pass; errors of the largest reference magnitude "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol bf16 {WO_TOL[torch.bfloat16]:.0e}, f32 "
              f"{WO_TOL[torch.float32]:.0e}; every case run twice, bitwise "
              f"equal)", flush=True)
        K, N, q, s = weights[algo][0]
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
        k8 = ("qmm",)
        with torch.no_grad():
            t = _timed(lambda: run_pass(algo), kernels=k8)
            # the profiled pass, from a fresh process (late in this one
            # the profiler misses a few per cent of the launches): K8's
            # kernel alone, once a GEMM
            by_kernel = fresh[algo]
            check(all("qmm_bf16" in k for k in by_kernel)
                  and sum(by_kernel.values()) == len(weights[algo]),
                  f"weight-only {algo}: the profiled pass ran {by_kernel}, "
                  f"not K8's kernel alone, once a GEMM")
            host_us = Timer.host_us(lambda: qm.quant_matmul(
                xs[K], q, s, int4=int4))
            # the same call with the launch plan searched every call, as
            # before plans were cached by shape
            host_us_search = Timer.host_us(lambda: (
                qm._plans.clear(), qm.quant_matmul(xs[K], q, s, int4=int4)))
            # the pass captured once into a CUDA graph and replayed
            pass_prog = CapturedProgram(
                lambda b: tuple(
                    quant.weight_only_linear(b[f"x{K}"], q, weight_scale=s,
                                             weight_dtype=algo)
                    for K, N, q, s in weights[algo]),
                {f"x{K}": x for K, x in xs.items()}, graph_pool(dev),
                f"weight-only {algo} pass")
            eager_outs = [quant.weight_only_linear(
                xs[K], q, weight_scale=s, weight_dtype=algo)
                for K, N, q, s in weights[algo]]
            pass_prog.run({})                          # captures
            reset_launch_counts()
            replayed = pass_prog.run({})
            got = launch_counts()
            check(got[kern] == len(weights[algo]) and all(
                torch.equal(a, b) for a, b in zip(replayed, eager_outs)),
                f"weight-only {algo}: the replayed pass counted {got[kern]} "
                f"launches or differs bitwise from the eager pass")
            del replayed, eager_outs
            replay = _timed(pass_prog.graph.replay, kernels=k8)
            capture_s = pass_prog.capture_s
            del pass_prog
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
                    "held_ms": ts["held"] / len(mine),
                    "device_ms": ts["device"] / max(ts["recorded"], 1),
                    "recorded": ts["recorded"], "calls": len(mine),
                    "wall_ms": ts["wall"] / len(mine),
                    "bound_ms": _gemm_bound([(K, N)], 0.5 if int4 else 1)[0]}
        shapes = [(K, N) for K, N, _, _ in weights[algo]]
        bound_ms, bound_by = _gemm_bound(shapes, 0.5 if int4 else 1)
        lib, lib_note, lib_err = (_int4pack if int4 else _int8pack)(
            weights[algo], xs)
        lib_ms = None if lib is None else lib["held"]
        lines.append({
            "name": f"quant_matmul_{algo}", "kernel": kern, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:32",
            "launches": None,
            "max_abs_err": max(v for k, v in errs.items()
                               if k.startswith("bf16")),
            "tolerance": WO_TOL[torch.bfloat16],
            "max_abs_err_f32": max(v for k, v in errs.items()
                                   if k.startswith("f32")),
            "tolerance_f32": WO_TOL[torch.float32],
            "error_of": "y, relative to the largest reference magnitude",
            "ms": t["held"], "device_ms": t["device"],
            "device_recorded": t["recorded"], "plain_ms": plain["held"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": lib_note, "library_err": lib_err,
            "plain": "quant_matmul_ref over the same pass",
            "times_are": ("ms, plain_ms, library_ms, dequant_ms: the pass's "
                          "device span, the card held while it is queued "
                          "(kernels and the gaps between them); device_ms: "
                          "torch.profiler's time of the kernels it recorded "
                          "(device_recorded of the launches); *_wall_ms: the "
                          "synchronised pass, host issue included"),
            "device_plain_ms": plain["device"],
            "device_library_ms": None if lib is None else lib["device"],
            "device_dequant_ms": dequant["device"],
            "wall_ms": t["wall"], "plain_wall_ms": plain["wall"],
            "library_wall_ms": None if lib is None else lib["wall"],
            "dequant_ms": dequant["held"], "dequant_wall_ms": dequant["wall"],
            "design": K8_DESIGN, "plan": plans,
            "kernels_a_pass": by_kernel,
            "kernels_a_pass_from": "a fresh process's profiled pass",
            "host_us_a_call": host_us,
            "host_us_a_call_plan_searched": host_us_search,
            "replay_wall_ms": replay["wall"], "replay_ms": replay["held"],
            "replay_device_ms": replay["device"],
            "capture_s": capture_s,
            "shape": (f"one decode step of Llama-3-8B's linear layers: "
                      f"{len(shapes)} GEMMs (32 layers x q, k, v, o, gate, "
                      f"up, down) at M={WO_M}, bf16 x, {algo} weights "
                      f"{wbytes[algo]} bytes"),
            "per_shape": per_shape,
        })
        print(f"weight-only {algo} ({kern}) pass of {len(shapes)} GEMMs at "
              f"M={WO_M}, held device span (profiler device time of the "
              f"launches it recorded; wall, host issue included): kernel "
              f"{t['held']:.4f} ms ({t['device']:.4f} ms, {t['recorded']} of "
              f"{len(shapes)}; {t['wall']:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}), dequant formulation {dequant['held']:.4f} ms "
              f"({dequant['device']:.4f}; {dequant['wall']:.4f}), plain "
              f"{plain['held']:.4f} ms ({plain['device']:.4f}; "
              f"{plain['wall']:.4f}), library "
              + ("n/a" if lib is None else
                 f"{lib['held']:.4f} ms ({lib['device']:.4f}; "
                 f"{lib['wall']:.4f}), error {lib_err:.2e} of the largest")
              + f" ({lib_note}); the profiled pass's kernels in a fresh "
              f"process, K8's alone ({by_kernel}, of {len(shapes)} "
              f"launches); the pass replayed from a CUDA graph (captured in "
              f"{capture_s:.2f} s, {len(shapes)} launches counted a replay, "
              f"outputs bitwise the eager pass's): wall {replay['wall']:.4f} "
              f"ms, held {replay['held']:.4f} ms (profiler "
              f"{replay['device']:.4f}, {replay['recorded']} launches) "
              f"against the eager pass's wall {t['wall']:.4f} and held "
              f"{t['held']:.4f} ms; host {host_us:.1f} us a call ({K}x{N}; "
              f"{host_us_search:.1f} with the launch plan searched every "
              f"call); per projection, held "
              f"(profiler a recorded launch; wall) a call: "
              + ", ".join(f"{k} {v['held_ms']:.4f} ({v['device_ms']:.4f}, "
                          f"{v['recorded']} of {v['calls']}; "
                          f"{v['wall_ms']:.4f}) ms, bound {v['bound_ms']:.4f}"
                          for k, v in per_shape.items())
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
          f"pass: held {lin['held']:.4f} ms (profiler device "
          f"{lin['device']:.4f}, {lin['recorded']} launches; wall "
          f"{lin['wall']:.4f}), bound {lin_bound:.4f} ms (bytes)", flush=True)
    for line in lines:
        line["bf16_linear_ms"] = lin["held"]
        line["bf16_linear_device_ms"] = lin["device"]
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
    # the staged backend (g++ against torch's headers) builds beside the
    # kernels' nvcc runs
    from paddle_tpu_torch.distributed import staged
    staged_build = threading.Thread(target=staged.load, daemon=True)
    staged_build.start()
    secs = _build.build_all()
    print(f"build: {', '.join(_build.sources())} in {secs:.1f} s", flush=True)
    staged_build.join()
    staged.load()
    print(f"build: staged_backend.cpp done at "
          f"{time.perf_counter() - t_run:.1f} s", flush=True)
    for src, log in _build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"build {src}: {line.strip()}")

    mark("build")
    # first, while this process holds the least of the card: two ranks of
    # the MoE run hold about 33 GiB each
    hybrid = hybrid_phase(dev, card)
    mark("hybrid")
    pp_sep = pipeline_sep_phase(dev, card)
    mark("pipeline_sep")
    timer = Timer(dev)
    kernels = kernel_phase(dev, timer)
    mark("paged kernels")
    kernels += flash_kernel_phase(dev, timer)
    mark("flash kernels")
    head_dim_phase(dev)
    mark("head dims")
    del timer
    torch.cuda.empty_cache()
    launches, windows, direct = engine_phase(dev, card)
    mark("engines")
    store = front_door_phase(dev, card, direct)["store"]
    mark("front door")
    disagg_phase(dev, card, direct, store)
    mark("disaggregation")
    launches.update(training_phase(dev, card))
    mark("training")
    spine_phase(dev, card)
    mark("spine")
    layer_phase(dev, card)
    mark("layer")
    capture_phase(dev, card)
    mark("capture")
    ernie_phase(dev, card)
    mark("ernie")
    llama_layer_phase(dev, card)
    mark("llama layer")
    workflow_phase(dev, card)
    mark("workflow")
    wo_lines, wo_launches = weight_only_phase(dev, card)
    mark("weight-only")
    kernels += wo_lines
    launches.update(wo_launches)
    for k in kernels:
        k["launches"] = launches[k["kernel"]]
        check(k["launches"] > 0, f"{k['kernel']} never launched on its path")
        if k["kernel"] in hybrid["launches"]:
            # the hybrid phase's runs, a rank each (layers x steps)
            k["hybrid_launches"] = hybrid["launches"][k["kernel"]]
            # the pipeline and sep runs, a rank each, by run
            k["pipeline_sep_launches"] = pp_sep["launches"][k["kernel"]]
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

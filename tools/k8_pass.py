#!/usr/bin/env python3
"""K8's weight-only pass (one decode step of Llama-3-8B's 224 projections at
M = 8, int8 and int4), timed in the checkout this is run from, on one CUDA
card, without relying on the profiler's count of launches.

Run from the root of a checkout:  python3 <path to>/k8_pass.py

It imports that checkout's ``chip_smoke`` (its ``LLAMA_PROJ``, ``WO_LAYERS``
and ``WO_M``) and ``paddle_tpu_torch``, so two checkouts, each run in its
turn in one call, give comparable readings.  Weights are drawn in bf16
from seed 0 on the card and quantized with ``weight_quantize``; x is drawn
after them.  For each weight type it prints: ``held``, the device span of
the pass (the card held in a spin while the pass's launches are queued,
CUDA events around them, median of five; it includes the gaps between
kernels); ``profiler``, torch.profiler's device time of the kernels whose
names contain "qmm" with the number of their launches it recorded; and the
same two readings for each projection shape over its 32 weights.  The card's
name and power limit come first.
"""
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.nn import quant  # noqa: E402

SPIN = 40_000_000          # cycles: longer than the pass's host issue


def held(fn, n=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda._sleep(SPIN)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profiled(fn):
    """(device ms of the kernels named qmm*, launches the profiler saw)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "qmm" in e.key]
    return (sum(e.self_device_time_total for e in ev) / 1e3,
            sum(e.count for e in ev))


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), "|", torch.cuda.get_device_name(0), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for algo in ("int8", "int4"):
        ws = []
        for _ in range(cs.WO_LAYERS):
            for name, K, N in cs.LLAMA_PROJ:
                w = torch.randn(K, N, generator=gen, device=dev,
                                dtype=torch.bfloat16) * 0.02
                ws.append((name, K, N, *quant.weight_quantize(
                    w, algo=f"weight_only_{algo}")))
                del w
        xs = {K: torch.randn(cs.WO_M, K, generator=gen, device=dev).to(
            torch.bfloat16) for K in {K for _, K, _ in cs.LLAMA_PROJ}}

        def run(sel):
            with torch.no_grad():
                for name, K, N, q, s in sel:
                    quant.weight_only_linear(xs[K], q, weight_scale=s,
                                             weight_dtype=algo)

        h = held(lambda: run(ws))
        p, seen = profiled(lambda: run(ws))
        print(f"{algo} pass of {len(ws)} GEMMs: held {h:.4f} ms; profiler "
              f"{p:.4f} ms over {seen} recorded launches", flush=True)
        for name, K, N in cs.LLAMA_PROJ:
            sel = [t for t in ws if t[0] == name]
            h = held(lambda: run(sel)) / len(sel)
            p, seen = profiled(lambda: run(sel))
            print(f"{algo} {name} {K}x{N}: held {h:.4f} ms a call; "
                  f"profiler {p / max(seen, 1):.4f} ms a recorded launch "
                  f"({seen} of {len(sel)})", flush=True)
        del ws, xs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

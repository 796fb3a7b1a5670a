#!/usr/bin/env python3
"""The paged-attention kernels at ``chip_smoke.py``'s main-path shapes, read
in the checkout this is run from, on one CUDA card.

Run from the root of a checkout:  python3 <path to>/paged_readings.py

It imports that checkout's ``chip_smoke`` and ``paddle_tpu_torch`` (so two
checkouts, each run in its turn in one call, give comparable readings,
also where their kernels differ) and builds each case from
``chip_smoke.Case`` (bf16, Llama-3-8B heads): K5 and K6 (``paged_attention``,
pages in q's dtype and int8) at the decode contexts, K7 and K7q
(``paged_attention_multiquery``) at the verify contexts.  For each it
prints the largest error against the plain twin and three readings with
``chip_smoke.Timer``: ``ms`` (CUDA events right after an L2 flush),
``held_ms`` (the card held in a spin first) and ``device_ms`` (the
profiler's time of the call's kernels, those whose names contain "paged"
or "mq_"), then the profiler's time of each of those kernels by name.
The card's name and power limit come first.
"""
import re
import sys

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import paged_attention as pa  # noqa: E402

KERNEL_NAMES = ("paged", "mq_")


def by_kernel(timer, fn, n=20):
    """Device ms a call of fn, for each kernel whose name contains one of
    KERNEL_NAMES (L2 flushed before each call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {re.search(r"(paged|mq_)\w*(<[^()]*>)?", e.key).group(0):
            e.self_device_time_total / 1e3 / n
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(m in e.key for m in KERNEL_NAMES)}


def main():
    if not torch.cuda.is_available():
        print("paged_readings: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    print(cs.card_line(), flush=True)
    cases = []
    for name, mq, quant in (("K5", False, False), ("K6", False, True),
                            ("K7", True, False), ("K7q", True, True)):
        ctx, q_len = (cs.VERIFY_CTX, cs.VERIFY_Q) if mq else (cs.DECODE_CTX,
                                                              None)
        kern, ref = ((pa.paged_attention_multiquery,
                      pa.paged_attention_multiquery_ref) if mq else
                     (pa.paged_attention, pa.paged_attention_ref))
        c = cs.Case(torch.bfloat16, ctx, gen, dev, q_len=q_len, quant=quant)
        err = (c.run(kern).float() - c.run(ref).float()).abs().max().item()
        cs.check(err <= cs.TOL[torch.bfloat16],
                 f"{name}: error {err} over the bf16 tolerance")
        cases.append((name, "verify" if mq else "decode", c, kern, err))
    for name, shape, c, kern, err in cases:
        def fn():
            return c.run(kern)
        ms = timer.ms(fn)
        held = timer.held_ms(fn)
        device = timer.device_ms(fn, KERNEL_NAMES)
        print(f"readings {name} {shape}: err {err:.3e} ms {ms:.4f} held "
              f"{held:.4f} device {device:.4f}", flush=True)
    for name, shape, c, kern, _ in cases:
        parts = by_kernel(timer, lambda: c.run(kern))
        print(f"readings {name} {shape} by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(parts.items())),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

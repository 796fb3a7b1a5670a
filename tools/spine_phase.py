#!/usr/bin/env python3
"""The spine phase of ``chip_smoke.py`` alone, on one CUDA card: GPT-2 124M
written in the Paddle Tensor API (``chip_smoke.spine_gpt2_loss``) held to
the ``torch.nn`` model's flash step, trained three SGD steps, one
``FLAGS_flash_layout_direct`` step, the semantics checks and the costs
(step wall against the ``torch.nn`` step, dispatches and host time, a small
add, peak memory, a profiled step of each program).

Run from the root of a checkout:  python3 <path to>/spine_phase.py

It builds the flash-attention kernels (K1-K4) of that checkout first; the
rest of ``chip_smoke.py`` does not run, so a call takes about a minute.
"""
import sys
import time

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("spine_phase: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    _build.load("flash_attention")
    print(f"build flash_attention {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    out = cs.spine_phase(torch.device("cuda", 0), card)
    print(f"spine phase {time.time() - t0:.1f} s: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

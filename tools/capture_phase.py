#!/usr/bin/env python3
"""The layer and capture phases of ``chip_smoke.py`` alone, on one CUDA
card: the reference's GPT-2 124M on ``nn.Layer`` (bf16, B16 S1024) trained
eagerly beside the ``torch.nn`` model (``layer_phase``), then its
``train_step`` under ``paddle.jit.to_static`` / ``scan_steps`` replayed
from CUDA graphs beside eager twins, a guarded and broken step, and the
float32 model under AMP O1 + ``GradScaler`` and O2 (``capture_phase``).

Run from the root of a checkout:  python3 <path to>/capture_phase.py
(``--capture`` runs the capture phase alone).

It builds the flash-attention kernels (K1-K4) of that checkout first; the
rest of ``chip_smoke.py`` does not run, so a call takes a few minutes.
"""
import sys
import time

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("capture_phase: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    _build.load("flash_attention")
    print(f"build flash_attention {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    if "--capture" not in sys.argv:
        t0 = time.time()
        cs.layer_phase(dev, card)
        print(f"layer phase {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    out = cs.capture_phase(dev, card)
    print(f"capture phase {time.time() - t0:.1f} s: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The ``workflow`` phase of ``chip_smoke.py`` alone, on one CUDA card:
ERNIE 3.0 base fine-tuned as a classifier through ``paddle.Model.fit`` on
the native ``DataLoader`` (``core/native/dataloader.cc``), checkpointed and
restored with ``paddle.save`` / ``paddle.load``, quantized after training
(PTQ to int8 ``QuantizedLinearInfer`` layers), and GPT-2 124M's
quantization-aware training step captured by ``jit.to_static`` and held
bitwise to its eager twin.

Run from the root of a checkout:  python3 <path to>/workflow_phase.py

It builds the flash-attention kernels (K1-K4) and ``dataloader.cc`` of that
checkout first; the rest of ``chip_smoke.py`` does not run.
"""
import sys
import time

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.io import native_loader  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("workflow_phase: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    _build.load("flash_attention")
    print(f"build flash_attention {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    if not native_loader.available():
        print("workflow_phase: dataloader.cc did not build", file=sys.stderr)
        return 1
    print(f"build dataloader.cc {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    out = cs.workflow_phase(dev, card)
    print(f"workflow phase {time.time() - t0:.1f} s: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The ``llama_layer`` phase of ``chip_smoke.py`` alone, on one CUDA card:
the reference's Llama on ``nn.Layer`` (``paddle_tpu_torch/models/llama.py``)
trained as ``bench.py``'s ``_llama_child`` does it (bf16, B8 S1024, AdamW +
clip, ``jit.scan_steps`` at K = 1 and 6) and held to the ``torch.nn``
twin, ``generate`` at Llama-3-8B width (bf16, and float32 at 2 layers),
then the RNNs, ``ctc_loss``, ``grid_sample`` and ``flash_attn_qkvpacked``
against the same calls on the CPU.

Run from the root of a checkout:  python3 <path to>/llama_layer_phase.py

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
        print("llama_layer_phase: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    _build.load("flash_attention")
    print(f"build flash_attention {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    out = cs.llama_layer_phase(dev, card)
    print(f"llama layer phase {time.time() - t0:.1f} s: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

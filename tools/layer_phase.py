#!/usr/bin/env python3
"""The layer phase of ``chip_smoke.py`` alone, on one CUDA card: the
reference's GPT-2 124M on ``nn.Layer`` (``paddle_tpu_torch/models/gpt2.py``,
bf16, B16 S1024) trained with ``paddle.optimizer.AdamW`` and
``ClipGradByGlobalNorm`` through ``bench.py``'s ``train_step``, held to the
``torch.nn`` model's first step (one ``FLAGS_flash_layout_direct`` step
too), the loss falling, the launches counted, a ``state_dict`` round trip,
and the costs beside the ``torch.nn`` AdamW step (step ms, tokens/s, MFU,
dispatches and host time, peak memory, a profiled step of each).

Run from the root of a checkout:  python3 <path to>/layer_phase.py

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
        print("layer_phase: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    _build.load("flash_attention")
    print(f"build flash_attention {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    out = cs.layer_phase(torch.device("cuda", 0), card)
    print(f"layer phase {time.time() - t0:.1f} s: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

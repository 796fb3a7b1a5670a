#!/usr/bin/env python3
"""The ``vision_audio`` phase of ``chip_smoke.py`` alone, on one CUDA card
(M13 part 1): the reference's ResNet-50 trained through ``paddle.Model.fit``
at ImageNet width (eager against a ``torch.nn`` twin, then captured by
``jit.to_static``), ESC-50-shaped log-mel / MFCC features, ``nms`` /
``roi_align`` / ``roi_pool`` at Faster R-CNN sizes, a CRF's Viterbi decode,
and every ``vision.models`` factory against the CPU.

Run from the root of a checkout:  python3 <path to>/vision_audio_phase.py

No kernel of K1-K8 lies on this path, so nothing is built first; the rest
of ``chip_smoke.py`` does not run.  Images and WAV files are written under
``build/chip_smoke_vision/``.
"""
import sys
import time

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("vision_audio_phase: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    out = cs.vision_audio_phase(dev, card)
    print(f"vision_audio phase {time.time() - t0:.1f} s: {out['seconds']:.1f}"
          f" s inside", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

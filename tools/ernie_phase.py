#!/usr/bin/env python3
"""The ERNIE phase of ``chip_smoke.py`` alone, on one CUDA card: K1-K3 at
ERNIE 3.0 base's attention shape (``FLASH_CASES`` "ernie": bf16 B16 S512
H12 D64, non-causal) against their plain versions and timed beside SDPA
and the bound, then ``ernie_phase``: ERNIE 3.0 base trained as masked-LM
(bf16, B16 S512, AdamW + clip) held to its dense twin, the launches
counted, the step captured and replayed bitwise equal to an eager twin, a
padded classifier forward, the conv / pool stem against the CPU, and the
Layer GPT-2's ``generate``.

Run from the root of a checkout:  python3 <path to>/ernie_phase.py
(``--no-flash`` skips the kernel case).

It builds the flash-attention kernels (K1-K4) of that checkout first; the
rest of ``chip_smoke.py`` does not run, so a call takes about a minute.
"""
import sys
import time

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402


def flash_case(dev, card):
    """The "ernie" case of ``FLASH_CASES``: checked twice, then timed."""
    case = next(c for c in cs.FLASH_CASES if c[0] == "ernie")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    c = cs.FlashCase(*case, gen, dev)
    errs = c.check()
    t = c.times(cs.Timer(dev))
    for role in ("fwd", "dq", "dkv"):
        bound_ms, bound_by = c.bound(role)
        flops = c.work(role)[0]
        print(f"ernie shape {role}: held {t[f'{role}_held']:.4f} ms, "
              f"device {t[f'{role}_device']:.4f}, ms {t[role]:.4f}, "
              f"{flops / t[f'{role}_held'] / 1e9:.1f} TFLOP/s, "
              f"{100 * bound_ms / t[f'{role}_held']:.1f}% of the bound "
              f"{bound_ms:.4f} ms ({bound_by}); on {card}", flush=True)
    lib = ("library_fwd", "library_bwd")
    print("ernie shape SDPA: " + ", ".join(
        f"{n} held {t[f'{n}_held']:.4f} ms, device {t[f'{n}_device']:.4f}"
        for n in lib) + f"; errors {errs}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("ernie_phase: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    _build.load("flash_attention")
    print(f"build flash_attention {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    if "--no-flash" not in sys.argv:
        t0 = time.time()
        flash_case(dev, card)
        print(f"flash case {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    out = cs.ernie_phase(dev, card)
    print(f"ernie phase {time.time() - t0:.1f} s: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K8 (the weight-only matmul, ``csrc/quant_matmul.cu``) at the Llama-3-8B
decode projections, read in the checkout this is run from, on one CUDA card.

Run from the root of a checkout:  python3 <path to>/k8_readings.py

For each projection (q / o 4096 x 4096, k / v 4096 x 1024, gate / up 4096 x
14336, down 14336 x 4096) at M = 8 in bf16, int8 and int4 weights, it
prints the device time of one call (the card held in a spin while the calls
over distinct weights, more bytes than the L2 holds, are queued; CUDA events
around them, median of five; inter-kernel gaps included) beside the byte
bound, for the wrapper's launch plan (``launch_plan``) and the other plans
listed in ``PLANS``, each checked against ``quant_matmul_ref``.  Beside the
kernel as it is, it builds variants of the source with ``nvcc`` (one each,
in parallel, into ``build/k8_variants/``): ``ring`` streams the same bytes
through the same ring with no math, ``no_convert`` keeps the fragment loads
and the MMAs but not the dequantization, ``pipes_swapped`` gives int8 two
pipelines and int4 one (deeper rings, to keep a block an SM), ``warps16``
runs 16 warps a block, ``l2_256`` asks the L2 to fetch 256-byte blocks
around each copy, ``math`` does the math on whatever the ring holds
with no copies.  The opcodes of each bf16 body's SASS (``cuobjdump``)
are counted, and those of its main loop printed by kind.  Then F.linear on bf16 weights of the same shapes
(a streaming yardstick) and the clusters of 1-8 blocks the card holds at
once.  The card's name and power limit come first.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")

from paddle_tpu_torch.nn import quant  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import quant_matmul as qm  # noqa: E402

SHAPES = {"q": (4096, 4096, 8), "k": (4096, 1024, 24),
          "gate": (4096, 14336, 4), "down": (14336, 4096, 4)}
# (strip, splits) beside the wrapper's own plan
PLANS = {"q": [(128, 2), (128, 4)], "k": [(64, 4), (64, 8)],
         "gate": [(64, 1), (128, 2)], "down": [(128, 2), (128, 4)]}
COMPUTE = "    for (int i = 0; i < P::STEPS; ++i) {\n"
VARIANTS = {
    "ring": [(COMPUTE, "    for (int i = 0; i < (p.M < 0 ? P::STEPS : 0); "
                       "++i) {\n")],
    "no_convert": [
        ("        frag_int4(w, a, conv);",
         "        a[0][0] = w[0]; a[0][1] = w[1]; a[0][2] = w[0] ^ 1; "
         "a[0][3] = w[1] ^ 1; a[1][0] = w[0] ^ 2; a[1][1] = w[1] ^ 2; "
         "a[1][2] = w[0] ^ 3; a[1][3] = w[1] ^ 3;"),
        ("        frag_int8(w, a, conv);",
         "        a[0][0] = w[0]; a[0][1] = w[1]; a[0][2] = w[2]; "
         "a[0][3] = w[3]; a[1][0] = w[0] ^ 1; a[1][1] = w[1] ^ 1; "
         "a[1][2] = w[2] ^ 1; a[1][3] = w[3] ^ 1;")],
    "pipes_swapped": [("static constexpr int PIPES = kInt4 ? 2 : 1;",
                       "static constexpr int PIPES = kInt4 ? 1 : 2;"),
                      ("constexpr int kMaxStages = 8;",
                       "constexpr int kMaxStages = 16;")],
    "warps16": [("constexpr int kThreads = 256;",
                 "constexpr int kThreads = 512;")],
    "l2_256": [("cp.async.cg.shared.global [%0], [%1], 16, %2;",
                "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;")],
    "math": [("    if (s < steps) load(s);", "    if (p.M < 0) load(s);"),
             ("    if (j + P::STAGES - 1 < steps) load(j + P::STAGES - 1);",
              "    if (p.M < 0) load(j + P::STAGES - 1);")],
}
OUT = Path("build/k8_variants")


def build_variants():
    """{name: ctypes library} for every variant whose substitutions apply
    to this checkout's source."""
    src = (Path(_build.__file__).parent.parent / "csrc"
           / "quant_matmul.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            text = text.replace(old, new)
        if text == src or any(old not in src for old, _ in subs):
            print(f"variant {name}: does not apply to this source")
            continue
        path = OUT / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-o", str(OUT / f"{name}.so"),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    libs = {"kernel": qm._kernel_lib()}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            print(f"variant {name}: build failed\n{err[-2000:]}")
            continue
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.quant_matmul.argtypes = qm._kernel_lib().quant_matmul.argtypes
        lib.quant_matmul.restype = ctypes.c_int
        libs[name] = lib
    return libs


def sass_mix(lib_path):
    """{kernel: {opcode: count}} of the qmm_bf16 bodies in a library,
    from cuobjdump -sass."""
    import re
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True).stdout
    mix, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S*qmm_bf16ILi(\d+)ELb(\d)ELi(\d)E)",
                      line)
        if m:
            name = (f"qmm_bf16<{m.group(2)}, "
                    f"{'int4' if m.group(3) == '1' else 'int8'}, {m.group(4)}>")
            mix[name] = {}
            continue
        if "Function :" in line:
            name = None
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?P\d\s+)?([A-Z][A-Z0-9]*)",
                       line)
        if name and op:
            mix[name][op.group(1)] = mix[name].get(op.group(1), 0) + 1
    return mix


def held_ms(fn):
    """Device span of fn's launches: the card spun while they are queued,
    CUDA events around them; median of five."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[2]


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), "|", torch.cuda.get_device_name(0), flush=True)
    dev = torch.device("cuda", 0)
    libs = build_variants()
    so = next(Path(_build._BUILD).glob("quant_matmul-*.so"))
    for name, ops in sass_mix(so).items():
        if name.endswith(", 1>"):
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
            print(f"SASS {name}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in top), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (K, N, copies) in SHAPES.items():
        x = torch.randn(8, K, generator=gen, device=dev).to(torch.bfloat16)
        for int4 in (False, True):
            ws = []
            for _ in range(copies):
                w = torch.randn(K, N, generator=gen, device=dev,
                                dtype=torch.bfloat16) * 0.02
                ws.append(quant.weight_quantize(
                    w, algo="weight_only_int4" if int4 else
                    "weight_only_int8"))
                del w
            ref = qm.quant_matmul_ref(x, *ws[0], int4=int4).float()
            ys = [torch.empty(8, N, dtype=torch.bfloat16, device=dev)
                  for _ in ws]
            bound = (K * N * (0.5 if int4 else 1) + 16 * K + 4 * N + 16 * N
                     ) / 3.35e12 * 1e3
            own = qm.launch_plan(8, K, N, sms, lambda b, m, s: qm.max_clusters(
                0, b, int4, m, s))[:2]
            for vname, lib in libs.items():
                for bn, splits in [own] + PLANS[name]:
                    def run():
                        for (q, s), y in zip(ws, ys):
                            err = lib.quant_matmul(
                                x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                y.data_ptr(), 8, K, N, bn, splits, 1,
                                int(int4), 1, stream)
                            assert err == 0, err
                    ms = held_ms(run) / copies
                    e = ((ys[0].float() - ref).abs().max()
                         / ref.abs().max()).item()
                    tag = "plan" if (bn, splits) == own else "    "
                    print(f"{name} {K}x{N} {'int4' if int4 else 'int8'} "
                          f"{vname:13s} {tag} strip {bn:3d} splits {splits}: "
                          f"{ms:.4f} ms a call, {100 * bound / ms:.0f} % of "
                          f"the bound {bound:.4f}; error {e:.1e}", flush=True)
            del ws, ys
            torch.cuda.empty_cache()
        dense = [torch.randn(N, K, generator=gen, device=dev,
                             dtype=torch.bfloat16) for _ in range(copies)]
        ms = held_ms(lambda: [torch.nn.functional.linear(x, d)
                              for d in dense]) / copies
        b16 = (2 * K * N + 16 * K + 16 * N) / 3.35e12 * 1e3
        print(f"{name} {K}x{N} bf16 F.linear: {ms:.4f} ms a call, "
              f"{100 * b16 / ms:.0f} % of the bound {b16:.4f}", flush=True)
        del dense
        torch.cuda.empty_cache()
    for int4 in (False, True):
        print(f"clusters held at once ({'int4' if int4 else 'int8'}, strip "
              f"128): " + ", ".join(
                  f"{s}: {qm.max_clusters(0, 128, int4, 1, s)}"
                  for s in (1, 2, 4, 7, 8)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

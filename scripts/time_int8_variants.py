#!/usr/bin/env python3
"""What bounds the int8 dense kernel: time variants of its source on one
GPU.

    python3 scripts/time_int8_variants.py [--variants a,b] [--source F] [--out runs/int8_variants.json]

Builds `xlxmert_tpu_torch/csrc/int8_dense.cu` as it is ("base") and in
variants, each with ops/_build.NVCC_FLAGS into runs/int8_variants/,
bound with ctypes:
  - no_quant: the activation tile's bf16 bits go to wgmma unquantized;
  - no_wgmma: no product is issued (the fragments are xor-ed into the
    accumulators);
  - no_loads: no step is loaded (nor waited for) after a tile's
    prologue;
  - t128x256, t64x128, t64x64: every shape on that tile;
  - s6: six ring stages on the 128 x 256 and 64 x 128 tiles.
The first three give wrong results: only their time matters. --source
times another revision of the file instead (for example the parent
commit's, from `git show`), with the variants whose edits it takes. Each is
timed with chip_smoke.queued_ms (the card's queue kept full; median of
3) in static mode at the serving path's shapes. No GPU: exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SOURCE = os.path.join(ROOT, "xlxmert_tpu_torch", "csrc", "int8_dense.cu")
_STREAM = "  const cudaStream_t s = static_cast<cudaStream_t>(stream);\n"


def _force(tile: str) -> tuple:
    return (_STREAM, _STREAM + f"  return launch_tile<{tile}>(x, w, "
            "col_scale, bias, out, M, N, K, inv_a, dynamic, s);\n")


EDITS = {
    "no_quant": [("af[p][j][2 * h + rr] =\n                  quantize4(",
                  "af[p][j][2 * h + rr] = raw.x ^ raw.y;\n              "
                  "if (false) quantize4(")],
    "no_wgmma": [("            wgmma_s8<NI>(acc[i], af[p][j],",
                  "            if (true) acc[i][0] ^= af[p][j][0] ^ "
                  "af[p][j][3];\n            else wgmma_s8<NI>(acc[i], "
                  "af[p][j],")],
    "no_loads": [("if (kt + STAGES - 2 < KT) load_stage(",
                  "if (kt + STAGES - 2 < 0) load_stage("),
                 ("        mbar_wait(bar_u32 + 8 * slot, (phases >> slot) & 1);\n"
                  "        phases ^= 1u << slot;\n",
                  "        if (kt < STAGES - 2) {\n"
                  "          mbar_wait(bar_u32 + 8 * slot, (phases >> slot) & 1);\n"
                  "          phases ^= 1u << slot;\n        }\n")],
    "t128x256": [_force("2, 128, 2, 5")],
    "t64x128": [_force("1, 128, 1, 4")],
    "t64x64": [_force("1, 64, 1, 4")],
    "s6": [("launch_tile<2, 128, 2, 5>", "launch_tile<2, 128, 2, 6>"),
           ("launch_tile<1, 128, 1, 4>", "launch_tile<1, 128, 1, 6>")],
}
# (M, K, N): the visual stack (B=256 x 64 cells), the text stack at
# L=12 and L=20, the answer head
SHAPES = [(16384, 768, 2304), (16384, 768, 768), (16384, 768, 3072),
          (16384, 3072, 768), (16384, 2048, 768), (3072, 768, 2304),
          (3072, 768, 768), (3072, 768, 3072), (3072, 3072, 768),
          (5120, 768, 768), (5120, 3072, 768), (256, 1536, 3129)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variants", default=",".join(EDITS))
    p.add_argument("--source", default=SOURCE)
    p.add_argument("--out", default=os.path.join("runs",
                                                  "int8_variants.json"))
    args = p.parse_args(argv)

    import torch

    from xlxmert_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("time_int8_variants: needs a CUDA device", file=sys.stderr)
        return 1
    with open(args.source) as f:
        src = f.read()
    tag = os.path.splitext(os.path.basename(args.source))[0]
    build = os.path.join(ROOT, "runs", "int8_variants", tag)
    os.makedirs(build, exist_ok=True)
    procs = {}
    for name in ["base"] + [v for v in args.variants.split(",") if v]:
        code = src
        for old, new in EDITS.get(name, []):
            if old not in src:
                print(f"time_int8_variants: {name}: the source changed",
                      file=sys.stderr)
                return 1
            code = code.replace(old, new)
        cu = os.path.join(build, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(code)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc()] + _build.NVCC_FLAGS
            + ["-o", cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"time_int8_variants: nvcc failed for {name}:\n{log}",
                  file=sys.stderr)
            return 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    P, In = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"nvidia_smi": card, "ms": {}}
    print(card, flush=True)
    fns = {}
    for name in procs:
        fn = ctypes.CDLL(os.path.join(build, f"{name}.so")).int8_dense_launch
        fn.argtypes = [P] * 5 + [In, In, In, ctypes.c_float, In, P]
        fn.restype = In
        fns[name] = fn
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        col = torch.rand(N, generator=gen, device="cuda") * 1e-3
        bias = torch.randn(N, generator=gen, device="cuda") * 0.02
        y = torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
        call = (x.data_ptr(), w.data_ptr(), col.data_ptr(), bias.data_ptr(),
                y.data_ptr(), M, N, K, 30.0, 0, stream)
        line = []
        for name, fn in fns.items():
            if fn(*call):
                print(f"time_int8_variants: {name} failed to launch",
                      file=sys.stderr)
                return 1
            ms = chip_smoke.queued_times(torch, {"ms": lambda: fn(*call)})
            out["ms"].setdefault(name, {})[f"{M}x{K}x{N}"] = ms["ms"]
            line.append(f"{name} {ms['ms']:.4f}")
        print(f"M={M:5d} K={K:4d} N={N:4d}  " + "  ".join(line), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

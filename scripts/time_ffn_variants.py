#!/usr/bin/env python3
"""What bounds the fused FFN kernel: time variants of its source on one GPU.

    python3 scripts/time_ffn_variants.py [--out runs/ffn_variants.json]

Builds `xlxmert_tpu_torch/csrc/fused_ffn.cu` as it is and in variants
that each take one part of a step away (the results of those are wrong;
only their time matters):
  - stages3:  a 3-stage weight ring (2 tiles in flight) instead of 8;
  - no_loads: no weight tile is copied after the first ring fill;
  - no_sync:  no barrier between steps;
  - no_mma:   the products replaced by one register xor each.
Each is built with ops/_build.NVCC_FLAGS into runs/ffn_variants/ and
bound with ctypes, then timed with CUDA events (2 warm-up and 10 timed
launches) at the model's widths (768, 3,072) and M = 128, 2,048, 4,096
and 16,384 rows. Up to M = 4,096 a launch is one wave of CTAs, so its
time is one CTA's pass over the intermediate dimension. No GPU: exits
non-zero.
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

SOURCE = os.path.join(ROOT, "xlxmert_tpu_torch", "csrc", "fused_ffn.cu")
MMA = '''  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "'''
EDITS = {
    "stages3": ("constexpr int kStages = 8;", "constexpr int kStages = 3;"),
    "no_loads": ("    if (ahead < n_tiles)\n      load_tile(",
                 "    if (ahead < 0)\n      load_tile("),
    "no_sync": ("    cp_async_wait_ring();\n    __syncthreads();",
                "    cp_async_wait_ring();"),
    "no_mma": (MMA, "  c[0] += __uint_as_float(a[0] ^ b[0]);\n  return;\n"
               + MMA),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("runs",
                                                  "ffn_variants.json"))
    args = p.parse_args(argv)

    import torch

    from xlxmert_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("time_ffn_variants: needs a CUDA device", file=sys.stderr)
        return 1
    with open(SOURCE) as f:
        src = f.read()
    build = os.path.join(ROOT, "runs", "ffn_variants")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for name in ["base"] + list(EDITS):
        code = src
        if name in EDITS:
            old, new = EDITS[name]
            if old not in src:
                print(f"time_ffn_variants: {name}: the source changed",
                      file=sys.stderr)
                return 1
            code = src.replace(old, new)
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
            print(f"time_ffn_variants: nvcc failed for {name}:\n{log}",
                  file=sys.stderr)
            return 1

    H, I = 768, 3072
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    w1 = randn(I, H, scale=0.02).bfloat16()
    w2 = randn(H, I, scale=0.02).bfloat16()
    vecs = [randn(I, scale=0.02)] + [randn(H, scale=0.02) for _ in range(3)]
    P, In = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    out = {"device": torch.cuda.get_device_name(0), "ms": {}}
    for name in procs:
        fn = ctypes.CDLL(os.path.join(build, f"{name}.so")).fused_ffn_launch
        fn.argtypes = [P] * 8 + [In, In, ctypes.c_float, In, P]
        fn.restype = In
        out["ms"][name] = {}
        for M in (128, 2048, 4096, 16384):
            x = randn(M, H).bfloat16()
            y = torch.empty_like(x)
            call = (x.data_ptr(), w1.data_ptr(), vecs[0].data_ptr(),
                    w2.data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
                    vecs[3].data_ptr(), y.data_ptr(), M, I, 1e-12, 1,
                    stream)
            for _ in range(2):
                if fn(*call):
                    print(f"time_ffn_variants: {name} failed to launch",
                          file=sys.stderr)
                    return 1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn(*call)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 10
            out["ms"][name][M] = ms
            print(f"{name:9} M={M:5d} {ms:.4f} ms", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

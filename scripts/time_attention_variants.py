#!/usr/bin/env python3
"""What bounds the bf16 attention kernel: time variants of its source on one GPU.

    python3 scripts/time_attention_variants.py [--out runs/attention_variants.json]

Builds `xlxmert_tpu_torch/csrc/mha_blhd.cu` (whose bf16 route is
`csrc/attention_mma.cuh`) as it is and in variants of the header:
  - div:             p = e / sum, a division per score, instead of e
                     times the row's reciprocal;
  - zero_guard:      the division, skipped where e = 0 (a division of 0
                     leaves the division's fast path);
  - no_exp:          no exponential: p = (s - max) / sum (wrong
                     results; only the time matters);
  - tie_off, tie64:  no score recomputed near a bf16 rounding tie, or
                     those within 64 fp32 steps of one (16 as built).
Each is built with ops/_build.NVCC_FLAGS into runs/attention_variants/
and bound with ctypes, held against mha_blhd_reference on --draws fresh
inputs per shape (the largest error, and the draws beyond chip_smoke's
2e-2 bar, for the variants that keep the function), and timed with the
card's queue kept full (chip_smoke.queued_ms; each shape: the variants
in turn, 5 rounds, the median) at the serving path's
shapes: B=256, packed heads (12 x 64) as column slices of fused
projections, text 8 and 20 and the 64 visual cells, the text keys with
the padding bias. No GPU: exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "xlxmert_tpu_torch", "csrc")
HEADER = "attention_mma.cuh"
RCP = """        float p0 = __fmul_rn(s[2 * kk + half][2 * r], inv[r]);
        float p1 = __fmul_rn(s[2 * kk + half][2 * r + 1], inv[r]);"""
EDITS = {
    "div": (RCP, """        float p0 = __fdiv_rn(s[2 * kk + half][2 * r], sum[r]);
        float p1 = __fdiv_rn(s[2 * kk + half][2 * r + 1], sum[r]);"""),
    "zero_guard": (RCP, """        float p0 = s[2 * kk + half][2 * r] == 0.f ? 0.f
            : __fdiv_rn(s[2 * kk + half][2 * r], sum[r]);
        float p1 = s[2 * kk + half][2 * r + 1] == 0.f ? 0.f
            : __fdiv_rn(s[2 * kk + half][2 * r + 1], sum[r]);"""),
    "no_exp": ("        x = expf(x);\n", ""),
    "tie_off": ("constexpr int kTieUlps = 16;", "constexpr int kTieUlps = -1;"),
    "tie64": ("constexpr int kTieUlps = 16;", "constexpr int kTieUlps = 64;"),
}
EXACT = ("base", "div", "zero_guard", "tie_off", "tie64")
REPEATS = 5
SHAPES = ((20, 20, True), (64, 64, False), (20, 64, False), (64, 20, True),
          (8, 8, True), (8, 64, False), (64, 8, True), (64, 12, True),
          (64, 16, True), (12, 12, True), (64, 64, True))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("runs",
                                                  "attention_variants.json"))
    p.add_argument("--draws", type=int, default=10)
    args = p.parse_args(argv)

    import torch

    import chip_smoke
    from xlxmert_tpu_torch.ops import _build, attention

    if not torch.cuda.is_available():
        print("time_attention_variants: needs a CUDA device", file=sys.stderr)
        return 1
    with open(os.path.join(CSRC, HEADER)) as f:
        header = f.read()
    build = os.path.join(ROOT, "runs", "attention_variants")
    procs = {}
    for name in ["base"] + list(EDITS):
        code = header
        if name in EDITS:
            old, new = EDITS[name]
            if old not in header:
                print(f"time_attention_variants: {name}: the source changed",
                      file=sys.stderr)
                return 1
            code = header.replace(old, new)
        d = os.path.join(build, name)
        os.makedirs(d, exist_ok=True)
        for f in ("attention.cuh", "mha_blhd.cu"):
            shutil.copy(os.path.join(CSRC, f), d)
        with open(os.path.join(d, HEADER), "w") as f:
            f.write(code)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc()] + _build.NVCC_FLAGS
            + ["-o", os.path.join(d, "lib.so"), os.path.join(d, "mha_blhd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"time_attention_variants: nvcc failed for {name}:\n{log}",
                  file=sys.stderr)
            return 1

    H, HD, B = 12, 768, chip_smoke.BATCH
    rng = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
           "draws": args.draws}
    print(card, flush=True)
    fns = {}
    for name in procs:
        fn = ctypes.CDLL(os.path.join(build, name, "lib.so")).mha_blhd_launch
        fn.argtypes = attention.KERNEL.argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
        for key in ("ms", "max_abs_err", "draws_over_tol"):
            out.setdefault(key, {})[name] = {}
    tol = chip_smoke.MHA_TOL["bfloat16"]
    for lq, lk, with_bias in SHAPES:
        key = f"{lq}x{lk}{' bias' if with_bias else ''}"
        errs = {name: [] for name in fns}
        for draw in range(args.draws):
            q, k, v, bias = chip_smoke._qkv_bias(
                torch, rng, B, lq, lk, HD, torch.bfloat16, with_bias)
            o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            ref = attention.mha_blhd_reference(q, k, v, bias, H, True)
            calls = {}
            for name, fn in fns.items():
                calls[name] = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               None if bias is None else bias.data_ptr(),
                               o.data_ptr(),
                               *attention._blhd_args(q, k, v, H, True),
                               stream)
                if fn(*calls[name]):
                    print(f"time_attention_variants: {name} failed to "
                          "launch", file=sys.stderr)
                    return 1
                errs[name].append((o.float() - ref.float()).abs().max()
                                  .item())
        # the last draw's inputs: every variant in turn, REPEATS rounds
        times = {name: [] for name in fns}
        for _ in range(REPEATS):
            for name, fn in fns.items():
                ms, queued = chip_smoke.queued_ms(
                    torch, lambda: fn(*calls[name]))
                if not queued:
                    print(f"time_attention_variants: {name} {key} waits "
                          "for the card", file=sys.stderr)
                    return 1
                times[name].append(ms)
        for name in fns:
            ms = sorted(times[name])[REPEATS // 2]
            over = sum(e > tol for e in errs[name])
            out["ms"][name][key] = ms
            out["max_abs_err"][name][key] = max(errs[name])
            out["draws_over_tol"][name][key] = over
            print(f"{name:11} B={B} {key:12} {ms:.4f} ms (of "
                  + ", ".join(f"{t:.4f}" for t in times[name])
                  + f")  max err {max(errs[name]):.2e}, {over} of "
                  f"{args.draws} draws over {tol:g}", flush=True)
    bad = [(name, key) for name in EXACT
           for key, n in out["draws_over_tol"][name].items() if n]
    if "base" in {name for name, _ in bad}:
        print(f"time_attention_variants: over {tol:g}: {bad}",
              file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The int8 attention kernel beside other revisions and variants of its
source, and beside B1, at phase (o)'s shapes on one GPU.

    python3 scripts/time_int8_attention_variants.py [--source NAME=PATH ...] [--variants a,b] [--out runs/int8_attention_variants.json]

Builds `xlxmert_tpu_torch/csrc/mha_int8.cu` as it is ("base"), each
`--source` (another revision of the file with the same C interface, for
example the parent commit's, unpacked with `git archive`) and each
variant (a text edit of base, in EDITS), all at once with
ops/_build.NVCC_FLAGS and `-Xptxas -v` (registers and spills are
printed), bound with ctypes:
  - div_ieee: e / sum by __fdiv_rn, not the reciprocal and two residual
    steps (the same quotient: its output must be base's, bit for bit);
  - unroll2: 2 of k's 16-byte loads in flight a thread, not 4;
  - no_exp, no_div, no_quant, no_store: the softmax's expf, its
    quotient, the quantization's arithmetic (the bf16 bits are packed as
    they are) or the context's stores to device memory left out.
The no_ variants give wrong results: only their time matters; the others
must give base's bits. At every shape of chip_smoke.mha_int8_cases that
the serving forwards at B=256 launch, each is held to mha_int8_reference
(base and the --source files under chip_smoke's gate) and timed, B1
(mha_blhd(fast=True), the bf16 route at the same shapes) too, with
chip_smoke.queued_ms in turns: ROUNDS rounds, every other one in reverse
order (a, b, b, a), the median kept. Each shape's line gives the CTAs an
SM holds (mha_int8_resident, the card's occupancy calculator) where the
revision exports it. The sums per serving forward of the mix
(VQA_LENGTH_MIX) and at L=20 close the output. No GPU: exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SOURCE = os.path.join(ROOT, "xlxmert_tpu_torch", "csrc", "mha_int8.cu")
ROUNDS = 6
_QUOTIENT = "p = quotient(x[j][e], sum[e / 2], y[e / 2]);"
EDITS = {
    "div_ieee": [(_QUOTIENT, "p = __fdiv_rn(x[j][e], sum[e / 2]);")],
    "unroll2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "no_exp": [("y = expf(__fsub_rn(x[j][e], mx[e / 2]));",
                "y = __fsub_rn(x[j][e], mx[e / 2]);")],
    "no_div": [(_QUOTIENT, "p = x[j][e];")],
    "no_quant": [("""  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(__fmul_rn(x, inv), -127.f), 127.f), kRound));""",
                  "  return __float_as_uint(x);")],
    "no_store": [("    if (m0 + r < Lq)\n      *reinterpret_cast<uint4*>(ob",
                  "    if (m0 + r < 0)\n      *reinterpret_cast<uint4*>(ob")],
}
# the variants whose arithmetic is base's: each must give base's bits
EXACT = ("div_ieee", "unroll2")


def ptxas_summary(log: str) -> list:
    """nvcc -Xptxas -v's lines on registers and spills, one a kernel."""
    return [line.strip() for line in log.splitlines()
            if re.search(r"registers|spill", line)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", default=[],
                   help="NAME=PATH of another revision of mha_int8.cu")
    p.add_argument("--variants", default=",".join(EDITS))
    p.add_argument("--out", default=os.path.join(
        "runs", "int8_attention_variants.json"))
    args = p.parse_args(argv)

    import torch

    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.ops import _build, attention, attention_int8
    from xlxmert_tpu_torch.serving.lxmert_int8 import VQA_LENGTH_MIX

    if not torch.cuda.is_available():
        print("time_int8_attention_variants: needs a CUDA device",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    with open(SOURCE) as f:
        base = f.read()
    build = os.path.join(ROOT, "runs", "int8_attention_variants")
    shutil.rmtree(build, ignore_errors=True)
    sources = {"base": base}
    for item in args.source:
        name, path = item.split("=", 1)
        with open(path) as f:
            sources[name] = f.read()
    for name in [v for v in args.variants.split(",") if v]:
        code = base
        for old, new in EDITS[name]:
            if old not in base:
                print(f"time_int8_attention_variants: {name}: the source "
                      "changed", file=sys.stderr)
                return 1
            code = code.replace(old, new)
        sources[name] = code
    kernels = {}
    for name, code in sources.items():
        os.makedirs(os.path.join(build, name))
        path = os.path.join(build, name, "mha_int8.cu")
        with open(path, "w") as f:
            # the name keeps each library apart from the package's own
            # build, so that nvcc runs (and reports) for every one
            f.write(code + f"\n// {name}\n")
        kernels[name] = _build.Kernel("mha_int8", path,
                                      attention_int8.KERNEL.argtypes)
    kernels["mha_blhd"] = attention.KERNEL
    build_s = _build.build_all(list(kernels.values()), verbose=True)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
           "build_s": build_s, "ptxas": {}, "shapes": []}
    for name, kern in kernels.items():
        out["ptxas"][name] = ptxas_summary(kern.build_log)
        print(f"--- {name}\n" + "\n".join(out["ptxas"][name]), flush=True)

    cfg = LxmertConfig()
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    rng = torch.Generator(device="cuda").manual_seed(0)
    labels = [n for n in kernels if n != "mha_blhd"] + ["mha_blhd"]
    sums = {kind: dict.fromkeys(labels, 0.0)
            for kind in [f"L={L}" for L in chip_smoke.BUCKETS]}
    bounds = dict.fromkeys(sums, 0.0)
    bad = []
    for B, lq, lk, with_bias, uses in chip_smoke.mha_int8_cases(
            cfg, chip_smoke.BATCH):
        uses = {k: n for k, n in uses.items() if k in sums}
        if not uses:
            continue
        q, k, v, bias = chip_smoke._qkv_bias(torch, rng, B, lq, lk, HD,
                                             torch.bfloat16, with_bias)
        b4 = None if bias is None else bias[:, None, None]
        inv, scale = zip(*(chip_smoke.int8_scales(t) for t in (q, k, v)))
        ref = attention_int8.mha_int8_reference(q, k, v, b4, H, inv, scale)
        rec = {"B": B, "Lq": lq, "Lk": lk, "bias": with_bias, "uses": uses,
               "check": {}, "ms": {}}
        fns = {"mha_blhd": lambda: attention.mha_blhd(q, k, v, b4, H, True)}
        outs = {}
        for name in labels[:-1]:
            o = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")
            a = attention_int8.launch_args(q, k, v, b4, o, H, inv, scale)
            kern = kernels[name]
            kern.launch(*a)
            torch.cuda.synchronize()
            d = (o.float() - ref.float()).abs()
            within = bool((d <= scale[2] + 2.0 ** -7
                           * ref.float().abs()).all())
            equal = (d == 0).float().mean().item()
            rec["check"][name] = {"max_abs_err": d.max().item(),
                                  "within": within, "bit_equal": equal}
            if name not in EDITS or name in EXACT:
                if not (within and equal >= chip_smoke.INT8_ATT_EQUAL):
                    bad.append((name, B, lq, lk, with_bias))
            if name in EXACT and not torch.equal(o, outs["base"]):
                bad.append((name, "not base's bits", B, lq, lk, with_bias))
            outs[name] = o
            fns[name] = lambda kern=kern, a=a: kern.launch(*a)
            try:
                resident = kern.lib().mha_int8_resident
            except AttributeError:  # a revision without it
                continue
            resident.argtypes = [ctypes.c_int] * 2
            rec.setdefault("resident", {})[name] = resident(lq, lk)
        times = {name: [] for name in labels}
        for r in range(ROUNDS):
            for name in (labels if r % 2 == 0 else labels[::-1]):
                ms, queued = chip_smoke.queued_ms(torch, fns[name])
                if not queued:
                    print(f"time_int8_attention_variants: {name} waits for "
                          "the card", file=sys.stderr)
                    return 1
                times[name].append(ms)
        nbytes = B * (2 * lq + 2 * lk) * HD * 2 + (
            0 if bias is None else bias.numel() * 2)
        rec["bound_ms"] = chip_smoke.bound(
            nbytes, 4.0 * B * H * lq * lk * 64, "int8")["bound_ms"]
        for name, ts in times.items():
            rec["ms"][name] = sorted(ts)[ROUNDS // 2]
        for kind, n in uses.items():
            bounds[kind] += n * rec["bound_ms"]
            for name in labels:
                sums[kind][name] += n * rec["ms"][name]
        out["shapes"].append(rec)
        print(f"B={B} {lq:2d}x{lk:2d} bias={with_bias!s:5} bound "
              f"{rec['bound_ms']:.4f}  " + "  ".join(
                  f"{n} {rec['ms'][n]:.4f}" for n in labels)
              + "  CTAs an SM: " + ", ".join(
                  f"{n} {c}" for n, c in rec.get("resident", {}).items()),
              flush=True)
    mix = {name: sum(VQA_LENGTH_MIX[L] * sums[f"L={L}"][name]
                     for L in chip_smoke.BUCKETS) for name in labels}
    mix_bound = sum(VQA_LENGTH_MIX[L] * bounds[f"L={L}"]
                    for L in chip_smoke.BUCKETS)
    out.update(per_forward=sums, bound_per_forward=bounds, mix=mix,
               mix_bound=mix_bound)
    for kind, row in list(sums.items()) + [("mix", mix)]:
        bnd = mix_bound if kind == "mix" else bounds[kind]
        print(f"per {kind} forward (B={chip_smoke.BATCH}, 34 launches): "
              f"bound {bnd:.4f}  " + "  ".join(
                  f"{n} {ms:.4f} ({bnd / ms:.0%})" for n, ms in row.items()),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if bad:
        print(f"time_int8_attention_variants: outside chip_smoke's gate: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What bounds the two whole-chain kernels: time variants of their
sources on one GPU.

    python3 scripts/time_ffn_variants.py [--kernel fused_ffn|fused_block]
        [--variants a,b] [--source F] [--split S] [--out runs/ffn_variants.json]

Builds `xlxmert_tpu_torch/csrc/fused_ffn.cu` (or `fused_block.cu`) as it
is ("base") and in variants that each take one part away, with
ops/_build.NVCC_FLAGS into runs/ffn_variants/<kernel>/<tag>/ (the shared
header csrc/hopper.cuh copied beside each, edited where a variant says
so), bound with ctypes:
  - no_products: no wgmma is issued (the accumulators keep what they
    hold);
  - no_loads: no weight tile is loaded after the ring's first STAGES
    steps (the producer only arrives on a step's barrier);
  - no_exchange: the cluster's partial sums and LayerNorm statistics do
    not cross to the other CTAs (each keeps its own);
  - no_gelu: no gelu on the activation (fused_ffn: it is 0).
"a+b" takes both away. Only the time of a variant means anything; its
output is wrong. --source
times another revision of the file instead (for example the parent
commit's, from `git archive`), with the variants whose edits it takes;
a file without launch plans (the earlier mma.sync kernels) takes their
launch signature.
--split forces the cluster's split (ops/_plan.launch_plan). Each is
timed with chip_smoke.queued_times (the card's queue kept full, median
of 3) at the path's shapes (chip_smoke.ffn_cases / fused_block_cases at
B=256), and summed per forward of the VQA_LENGTH_MIX mix. No GPU: exits
non-zero.

What bounds each kernel (the variants' times, PERF.md §6) is in the
header of its source.
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

import chip_smoke  # noqa: E402

CSRC = os.path.join(ROOT, "xlxmert_tpu_torch", "csrc")

# (file, old, new) edits; "hopper.cuh" edits the header's copy
_WGMMA = {"fused_ffn": "wgmma_bf16_ss(", "fused_block": "wgmma_s8_ss("}
_SKIP = ("template <class... A>\n__device__ __forceinline__ void "
         "skip_product(A&&...) {}\n")


def edits(kernel: str) -> dict:
    return {
        "no_products": [(None, "namespace {\n\nusing namespace hopper;",
                         "namespace {\n\nusing namespace hopper;\n" + _SKIP),
                        (None, "      " + _WGMMA[kernel],
                         "      skip_product(")],
        "no_loads": [("hopper.cuh", "    issue(u, slot, full + 8 * slot);",
                      "    if (u < STAGES) issue(u, slot, full + 8 * slot);\n"
                      "    else mbar_arrive(full + 8 * slot);")],
        "no_gelu": ([(None, "__floats2bfloat162_rn(i < I ? h0 : 0.f, i + 1 < I ? h1 : 0.f)",
                      "__floats2bfloat162_rn(0.f, 0.f)")]
                    if kernel == "fused_ffn" else
                    [(None, "quant(bf16_round(gelu_tanh(a1)), p.f2.inv)",
                      "quant(a1, p.f2.inv)")]),
        "no_exchange": [("hopper.cuh",
                         "          st_cluster_u32(mapa(a, j), ",
                         "          if (j == rank) st_cluster_u32(mapa(a, j), "),
                        (None, "        if (o == slice) continue;",
                         "        if (true) continue;")],
    }


def shapes(kernel: str, cfg):
    """(M, variant, uses) at the serving forwards' shapes (B=256)."""
    if kernel == "fused_ffn":
        return [(M, "ffn", {k: n for k, n in uses.items()
                            if k.startswith("L=")})
                for M, uses in chip_smoke.ffn_cases(cfg, chip_smoke.BATCH)
                if any(k.startswith("L=") for k in uses)]
    return [(M, v, {k: n for k, n in uses.items() if k.startswith("L=")})
            for M, v, uses in chip_smoke.fused_block_cases(
                cfg, chip_smoke.BATCH)
            if any(k.startswith("L=") for k in uses)]


def build(kernel: str, src_path: str, names, out_dir: str):
    with open(src_path) as f:
        src = f.read()
    with open(os.path.join(CSRC, "hopper.cuh")) as f:
        header = f.read()
    from xlxmert_tpu_torch.ops import _build

    procs, table = {}, edits(kernel)
    for name in names:
        code, hdr = src, header
        for where, old, new in [e for part in name.split("+")
                                for e in table.get(part, [])]:
            text = hdr if where else code
            if old not in text:
                print(f"time_ffn_variants: {name}: the source changed",
                      file=sys.stderr)
                return None
            if where:
                hdr = hdr.replace(old, new)
            else:
                code = code.replace(old, new)
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "hopper.cuh"), "w") as f:
            f.write(hdr)
        cu = os.path.join(d, f"{kernel}.cu")
        with open(cu, "w") as f:
            f.write(code)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc()] + _build.NVCC_FLAGS
            + ["-o", os.path.join(d, f"{kernel}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"time_ffn_variants: nvcc failed for {name}:\n{log}",
                  file=sys.stderr)
            return None
    return {n: os.path.join(out_dir, n, f"{kernel}.so") for n in procs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kernel", default="fused_ffn",
                   choices=("fused_ffn", "fused_block"))
    p.add_argument("--variants", default=None,
                   help="comma-separated (default: every variant)")
    p.add_argument("--source", default=None)
    p.add_argument("--split", type=int, default=None)
    p.add_argument("--out", default=os.path.join("runs",
                                                  "ffn_variants.json"))
    args = p.parse_args(argv)

    import torch

    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.ops import _plan
    from xlxmert_tpu_torch.ops import fused_block as fb
    from xlxmert_tpu_torch.ops.quant import (quantize_weight,
                                             with_activation_scale)
    from xlxmert_tpu_torch.serving.lxmert_int8 import VQA_LENGTH_MIX

    if not torch.cuda.is_available():
        print("time_ffn_variants: needs a CUDA device", file=sys.stderr)
        return 1
    kernel = args.kernel
    source = args.source or os.path.join(CSRC, f"{kernel}.cu")
    with open(source) as f:
        planned = "int split" in f.read()
    names = ["base"] + [v for v in (args.variants.split(",")
                                    if args.variants is not None
                                    else edits(kernel)) if v]
    tag = os.path.relpath(os.path.abspath(source), ROOT).replace(os.sep, "_")
    out_dir = os.path.join(ROOT, "runs", "ffn_variants", kernel, tag)
    libs = build(kernel, source, names, out_dir)
    if libs is None:
        return 1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = LxmertConfig()
    H, I, Nq = cfg.hidden_size, cfg.intermediate_size, 3 * cfg.hidden_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    P, In, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    plan_args = [In] if planned else []
    fns = {}
    for name, so in libs.items():
        fn = getattr(ctypes.CDLL(so), f"{kernel}_launch")
        fn.argtypes = ([P] * 8 + [In, In, Fl, In] + plan_args + [P]
                       if kernel == "fused_ffn" else
                       [P] * 20 + [In] * 3 + [Fl] * 5 + plan_args + [P])
        fn.restype = In
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream

    if kernel == "fused_ffn":
        w1, w2 = randn(I, H, scale=0.02).bfloat16(), \
            randn(H, I, scale=0.02).bfloat16()
        vecs = [randn(I, scale=0.02)] + [randn(H, scale=0.02)
                                         for _ in range(3)]
    else:
        def weight(k, n, amax):
            qw = quantize_weight((randn(k, n, scale=0.03)).cpu().numpy(),
                                 randn(n, scale=0.05).cpu().numpy())
            return fb.fused_weight(with_activation_scale(qw, amax)).to(dev)

        ws = {"o": weight(H, H, 4.0), "1": weight(H, I, 4.5),
              "2": weight(I, H, 2.5), "q": weight(H, Nq, 4.5)}
        lns = [randn(H, scale=0.1) + 1.0, randn(H, scale=0.05)] * 2

    rows = {n: [] for n in fns}
    for M, variant, uses in shapes(kernel, cfg):
        ffn_on, tail_on = variant != "tail", variant != "ffn"
        split = args.split or _plan.launch_plan(M, I if ffn_on else 0)
        extra = [split] if planned else []
        x = randn(M, H).bfloat16()
        if kernel == "fused_ffn":
            y = torch.empty_like(x)
            call = (x.data_ptr(), w1.data_ptr(), vecs[0].data_ptr(),
                    w2.data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
                    vecs[3].data_ptr(), y.data_ptr(), M, I, 1e-12, 1,
                    *extra, stream)
        else:
            ctx = randn(M, H).bfloat16()
            y = torch.empty_like(x)
            tail = torch.empty(M, Nq, device=dev, dtype=torch.bfloat16)

            def ptrs(w, on=True):
                return ([w.w_i8.data_ptr(), w.out_scale.data_ptr(),
                         w.bias.data_ptr()] if on else [None] * 3)

            call = (ctx.data_ptr(), x.data_ptr(), *ptrs(ws["o"]),
                    lns[0].data_ptr(), lns[1].data_ptr(),
                    *ptrs(ws["1"], ffn_on), *ptrs(ws["2"], ffn_on),
                    *((lns[2].data_ptr(), lns[3].data_ptr()) if ffn_on
                      else (None, None)),
                    *ptrs(ws["q"], tail_on), y.data_ptr(),
                    tail.data_ptr() if tail_on else None, M,
                    I if ffn_on else 0, Nq if tail_on else 0,
                    ws["o"].inv_a, ws["1"].inv_a, ws["2"].inv_a,
                    ws["q"].inv_a, 1e-12, *extra, stream)
        line = []
        for name, fn in fns.items():
            if fn(*call):
                print(f"time_ffn_variants: {name} failed to launch at "
                      f"M={M} {variant}", file=sys.stderr)
                return 1
            torch.cuda.synchronize()
            ms = chip_smoke.queued_times(torch, {"ms": lambda: fn(*call)})
            rows[name].append({"M": M, "variant": variant, "ms": ms["ms"],
                               "split": split, "uses": uses})
            line.append(f"{name} {ms['ms']:.4f}")
        print(f"M={M:5d} {variant:8} split={split}  " + "  ".join(line),
              flush=True)
    kinds = [f"L={L}" for L in chip_smoke.BUCKETS]
    per = {}
    for name, rs in rows.items():
        tot = {k: sum(r["ms"] * r["uses"].get(k, 0) for r in rs)
               for k in kinds}
        per[name] = sum(VQA_LENGTH_MIX[L] * tot[f"L={L}"]
                        for L in chip_smoke.BUCKETS)
    print("per mix forward (ms): " + "  ".join(
        f"{n} {v:.4f}" for n, v in per.items()), flush=True)
    out = {"kernel": kernel, "source": os.path.relpath(source, ROOT),
           "nvidia_smi": card, "rows": rows, "per_mix_forward_ms": per}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

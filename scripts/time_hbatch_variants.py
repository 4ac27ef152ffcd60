#!/usr/bin/env python3
"""Ring depth of the batched-head attention kernel: time its plans on one GPU.

    python3 scripts/time_hbatch_variants.py [--out runs/hbatch_variants.json]

Builds `xlxmert_tpu_torch/csrc/mha_hbatch.cu` and `csrc/mha_blhd.cu` (B1,
the same function) and, at the attention-layout path's shapes (B=256 and
the calibration batch 8; text 20 against itself and the 64 visual cells,
the text keys with the padding bias), launches mha_hbatch with
`ops/_plan.hbatch_plan`'s plan and with every other plan of its grid
that the kernel takes: lanes (heads computed at once, at most the
launch bounds' warps) by ring slots (more than the lanes, unless every
head has one; at most 8). Each is held
bit for bit to mha_blhd(fast=True) on the same inputs, shown with the
CTAs an SM holds by the card's occupancy calculator beside
`_plan.hbatch_resident` and the waves of the launch, and timed with the
card's queue kept full (chip_smoke.queued_ms; each shape: B1 and the
plans in turn, 5 rounds, the median; only the plans that run in one wave). The sums over the 34 launches of
a layout forward at B=256 (chip_smoke's uses), the plan's and the
fastest plan's at each shape, close the output. No GPU: exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPEATS = 5
SHAPES = ((20, 20, True), (64, 64, False), (20, 64, False), (64, 20, True))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("runs",
                                                  "hbatch_variants.json"))
    args = p.parse_args(argv)

    import torch

    import chip_smoke
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.ops import _build, _plan, attention

    if not torch.cuda.is_available():
        print("time_hbatch_variants: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    kernels = [attention.HBATCH_KERNEL, attention.KERNEL]
    build_s = _build.build_all(kernels, verbose=True)
    print(f"built in {build_s:.1f}s\n" + attention.HBATCH_KERNEL.build_log,
          flush=True)
    launch = getattr(attention.HBATCH_KERNEL.lib(), "mha_hbatch_launch")

    cfg = LxmertConfig()
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    uses = {(b, lq, lk): n for b, lq, lk, _, u in chip_smoke.hbatch_cases(
        cfg, chip_smoke.BATCH) for n in u.values()}
    rng = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": card,
           "shapes": []}
    sums, bad = {}, []
    for B in (chip_smoke.BATCH, chip_smoke.CALIB_BATCH):
        for lq, lk, with_bias in SHAPES:
            q, k, v, bias = chip_smoke._qkv_bias(
                torch, rng, B, lq, lk, HD, torch.bfloat16, with_bias)
            b4 = None if bias is None else bias[:, None, None]
            ref = attention.mha_blhd(q, k, v, b4, H, True)
            o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            chosen = _plan.hbatch_plan(B, H, lq, lk)
            fns = {"mha_blhd": lambda: attention.mha_blhd(q, k, v, b4, H,
                                                          True)}
            rec = {"B": B, "Lq": lq, "Lk": lk, "bias": with_bias,
                   "plan": chosen._asdict(), "variants": {}}
            qt = -(-lq // 16)
            variants = [chosen._replace(
                lanes=n, slots=m, warps=n * qt,
                smem=_plan.hbatch_smem(lq, lk, m, chosen.heads))
                for n in range(1, min(chosen.heads, 12 // qt) + 1)
                if n * qt <= _plan.hbatch_max_warps(lk)
                for m in range(min(chosen.heads, n + 1),
                               min(chosen.heads, _plan.HBATCH_SLOTS) + 1)]
            for plan in variants:
                if plan.smem > _plan.CTA_SMEM:
                    continue
                on_sm = chip_smoke.hbatch_resident_on_card(attention, plan,
                                                           lk)
                if B * plan.grid[1] > sms * on_sm:
                    continue  # more than one wave
                name = f"lanes={plan.lanes} slots={plan.slots}"
                a = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if bias is None else bias.data_ptr(), o.data_ptr(),
                     *attention._blhd_args(q, k, v, H, True)[:-2],
                     *plan.launch_args(), stream)
                o.zero_()
                code = launch(*a)
                torch.cuda.synchronize()
                if code:
                    print(f"time_hbatch_variants: {name} failed to launch "
                          f"({code})", file=sys.stderr)
                    return 1
                equal = torch.equal(o, ref)
                if not equal:
                    bad.append((B, lq, lk, name))
                rec["variants"][name] = {
                    "plan": plan._asdict(), "bit_equal": equal,
                    "resident": on_sm,
                    "resident_model": _plan.hbatch_resident(plan, lk)}
                fns[name] = lambda a=a: launch(*a)
            times = {name: [] for name in fns}
            for _ in range(REPEATS):
                for name, fn in fns.items():
                    ms, queued = chip_smoke.queued_ms(torch, fn)
                    if not queued:
                        print(f"time_hbatch_variants: {name} waits for the "
                              "card", file=sys.stderr)
                        return 1
                    times[name].append(ms)
            n = uses.get((B, lq, lk), 0)   # SHAPES carry the path's bias
            nbytes = B * (2 * lq + 2 * lk) * HD * 2 + (
                0 if bias is None else bias.numel() * 2)
            rec["bound_ms"] = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
            rec["launches_per_forward"] = n
            mine = f"lanes={chosen.lanes} slots={chosen.slots}"
            for name, ts in times.items():
                ms = sorted(ts)[REPEATS // 2]
                rec.setdefault("ms", {})[name] = ms
                extra = rec["variants"].get(name, {})
                print(f"B={B:3d} {lq:2d}x{lk:2d} bias={with_bias!s:5} "
                      f"{name:18}{'*' if name == mine else ' '} {ms:.4f} ms "
                      f"({rec['bound_ms'] / ms:.0%} of the bound "
                      f"{rec['bound_ms']:.4f})"
                      + (f"  {extra['plan']['warps']} warps, "
                         f"{extra['plan']['smem']} B, {extra['resident']} "
                         f"CTAs an SM (model {extra['resident_model']}), "
                         f"bit-equal {extra['bit_equal']}" if extra else ""),
                      flush=True)
            fastest = min((k for k in rec["ms"] if k != "mha_blhd"),
                          key=rec["ms"].get)
            for key, name in (("mha_blhd", "mha_blhd"), ("plan", mine),
                              ("fastest", fastest)):
                sums[key] = sums.get(key, 0.0) + n * rec["ms"][name]
            out["shapes"].append(rec)
    out["per_layout_forward_ms"] = sums
    print("per layout forward (B=256, 34 launches; * the plan's): "
          + "  ".join(f"{k} {v:.4f}" for k, v in sums.items()), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if bad:
        print(f"time_hbatch_variants: not bit-equal to mha_blhd: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

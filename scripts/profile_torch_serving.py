#!/usr/bin/env python3
"""Where the time of the port's VQA forward goes on one GPU.

    python3 scripts/profile_torch_serving.py [--seed 0] [--path int8]

--path int8 (the default) builds the full-width int8 engine as
chip_smoke.py does (random weights from --seed, calibrated through
cli/serve.serve on a synthetic stream) and times
cli/serve.serving_forward, the forward serve() runs on every batch;
--path int8+fused_block does the same through serve(fused=True) and
times cli/serve.fused_serving_forward (the whole-block fused engine); a
bf16 path (a key of chip_smoke.BF16_CONFIGS: bf16, bf16+fused_ffn,
bf16+pallas+fused_ffn) builds the bf16 VQAModel from the same weights
with that configuration's attention route and FFN and times
cli/serve.bf16_serving_forward. Runs 5 steady forwards at B=256 for
each bucket length and traces them with torch.profiler. Prints, per
length: the wall time per forward (host clock ending in a synchronize,
profiler off), the device time summed over kernels in the traced run,
the device's busy share (device time over that wall time), the shares
of the port's kernels, of cuBLAS products and of the plain glue, and
the device time by kernel name, largest first. Writes the same as JSON
to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


# the port's kernels, by the name of their __global__ function
PORT_KERNELS = ("attend_mma_kernel", "mha_blhd_kernel", "int8_dense_kernel",
                "fused_ffn_kernel", "fused_block_kernel")


def group(name: str) -> str:
    """A device kernel's group: one of the port's kernels (mha_blhd and
    fused_mha run attend_mma_kernel in bf16, mha_blhd_kernel in fp32), a
    cuBLAS/CUTLASS product, or the plain PyTorch glue (LayerNorm, gelu,
    adds, casts, copies, gathers)."""
    for k in PORT_KERNELS:
        if k in name:
            return k
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "cublas_gemm"
    return "glue"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--path", default="int8",
                   choices=["int8", "int8+fused_block"]
                   + list(chip_smoke.BF16_CONFIGS))
    p.add_argument("--out", default=None, help="default: runs/"
                   "profile_torch_serving_<path>.json")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xlxmert_tpu_torch.cli.serve import (
        bf16_serving_forward, fused_serving_forward, serving_forward,
    )
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.models.lxmert import ServingOptions
    from xlxmert_tpu_torch.models.task_heads import vqa_model
    from xlxmert_tpu_torch.ops import (
        _build, attention, ffn, fused_block, int8_matmul,
    )
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache

    if not torch.cuda.is_available():
        chip_smoke.fail("needs a CUDA device")
    kernels = [attention.KERNEL, attention.FUSED_MHA_KERNEL,
               int8_matmul.KERNEL, ffn.KERNEL, fused_block.KERNEL]
    _build.build_all(kernels, verbose=False)
    smoke_args = chip_smoke.parse_args(["--seed", str(args.seed)])
    cfg = LxmertConfig()
    B, V, n_fwd = chip_smoke.BATCH, 64, 5
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    table = torch.randn(chip_smoke.IMAGES, V, cfg.visual_feat_dim,
                        generator=gen, device="cuda", dtype=torch.bfloat16)
    cache = FeatureCache(table, {})
    if args.path in ("int8", "int8+fused_block"):
        # the calibrated full-width engine, built through the serving
        # entry point on chip_smoke's weights and questions
        fused = args.path != "int8"
        setup = chip_smoke.Setup(torch, smoke_args,
                                 lambda m: print(m, flush=True), cfg)
        res, *_ = setup.serve(torch, kernels, fused=fused,
                              calib_samples=chip_smoke.CALIB_SAMPLES)
        tree, hqp = res["engine"]
        run = (fused_serving_forward if fused else serving_forward)(
            tree, hqp, cache, cfg, "cuda")
    else:
        attn, fused, _ = chip_smoke.BF16_CONFIGS[args.path]
        bert, head = engine.random_params(cfg, 3129, seed=args.seed)
        model = vqa_model({"bert": bert, "answer_head": head}, cfg, 3129,
                          dtype=torch.bfloat16,
                          options=ServingOptions(True, attn, fused))
        run = bf16_serving_forward(model, cache, "cuda")
    rng = np.random.RandomState(args.seed + 1)

    out = {"device": torch.cuda.get_device_name(0), "path": args.path,
           "lengths": {}}
    low = 2
    for L in chip_smoke.BUCKETS:
        # host inputs as cli/serve builds them: token ids padded with 0 to
        # the bucket length (lengths inside the bucket), the mask from the
        # ids, catalog rows; pinned
        n_tok = rng.randint(low + 1, L + 1, size=B)
        low = L
        ids = rng.randint(5, cfg.vocab_size, size=(B, L))
        ids[np.arange(L)[None] >= n_tok[:, None]] = 0
        picks = rng.randint(0, chip_smoke.IMAGES, size=B)
        host = [torch.from_numpy(a).pin_memory() for a in (
            ids.astype(np.int64), picks.astype(np.int64),
            (ids > 0).astype(np.float32))]

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_fwd):
                run(*host)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n_fwd

        timed()  # warm-up
        wall_ms = timed()  # without the profiler's overhead
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_ms = timed()
        by_name = defaultdict(float)
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] += ev.time_range.elapsed_us() / 1e3
        if not by_name:
            chip_smoke.fail("the trace holds no device time")
        device_ms = sum(by_name.values()) / n_fwd
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        groups = defaultdict(float)
        for name, us in by_name.items():
            groups[group(name)] += us / n_fwd
        row = {"wall_ms_per_forward": wall_ms,
               "traced_wall_ms_per_forward": traced_ms,
               "device_ms_per_forward": device_ms,
               "busy_share": device_ms / wall_ms,
               "qps": B / (wall_ms / 1e3),
               "by_group_ms_per_forward": dict(groups),
               "by_kernel_ms_per_forward": {
                   k: v / n_fwd for k, v in top}}
        out["lengths"][L] = row
        print(f"L={L}: wall {wall_ms:.3f} ms/forward ({row['qps']:.1f} q/s), "
              f"device {device_ms:.3f} ms, busy {row['busy_share']:.3f}; "
              + ", ".join(f"{g} {ms:.3f} ({ms / device_ms:.0%})"
                          for g, ms in sorted(groups.items())),
              flush=True)
        for name, ms in top[:12]:
            print(f"    {ms / n_fwd:9.4f} ms  {name[:90]}",
                  flush=True)
    args.out = args.out or os.path.join(
        "runs", f"profile_torch_serving_{args.path}.json")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if kk != "by_kernel_ms_per_forward"}
                      for k, v in out["lengths"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

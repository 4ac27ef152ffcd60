#!/usr/bin/env python3
"""Variants of the port's Detectron grid extractor on one GPU, at bench.py
measure_factory's widths (X-152-32x8d-FPN, B=8, an 800x1344 canvas of
800x1333 images, random weights from --seed), timed in one process so
that they share a card:

  - bf16 and fp32;
  - channels-last (the port's layout) and NCHW (the model and its input
    converted here);
  - FrozenBN applied as one addcmul (the port's) or as the two passes
    x * scale, then + bias (the JAX package's op order);
  - cuDNN's benchmark mode off (the default) and on.

Each variant: one warm-up and `--batches` batches through
cli/extract_features.extract_batch (host arrays in, features out; img/s
on the host clock), then one profiled batch (busy share, the device time
of the convolutions and of the glue, the glue's largest ops).

    python3 scripts/time_detectron_variants_torch.py --out runs/det.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def two_pass_bn(self, x):
    """FrozenBN as the JAX package writes it: x * scale, then + bias."""
    import torch

    inv = torch.rsqrt(self.running_var)
    scale = (self.weight * inv).to(self.dtype)
    bias = (self.bias - self.running_mean * self.weight * inv).to(
        self.dtype)
    return x.mul_(scale[:, None, None]).add_(bias[:, None, None])


def to_nchw(model):
    """The extractor in NCHW: contiguous conv weights, and its backbone
    fed a contiguous NCHW batch (the port's forward keeps the NHWC
    batch's channels-last strides)."""
    import torch

    model.to(memory_format=torch.contiguous_format)
    bb = model.backbone
    bb.forward = lambda images: bb.fpn(bb.body(
        images.permute(0, 3, 1, 2).contiguous()))
    return model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--out", default=os.path.join("runs",
                                                 "detectron_variants.json"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from xlxmert_tpu_torch.cli.extract_features import extract_batch
    from xlxmert_tpu_torch.models import detectron as det

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    sz = chip_smoke.FACTORY_SIZES
    cfg = det.DetectronConfig()
    tree = det.random_params(cfg, args.seed)
    imgs, sizes = chip_smoke.factory_images(sz["grid_batch"], sz["canvas"],
                                            sz["image"], args.seed)
    addcmul_bn = det.FrozenBN.forward
    out = {"card": card, "variants": {}}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            for cl in (True, False):
                model = det.load_params(det.DetectronGridExtractor(
                    cfg, sz["grid"], dtype=dtype), tree).cuda().eval()
                if not cl:
                    to_nchw(model)
                for bn, fwd, bench in (("addcmul", addcmul_bn, False),
                                       ("two_pass", two_pass_bn, False),
                                       ("addcmul", addcmul_bn, True)):
                    det.FrozenBN.forward = fwd
                    torch.backends.cudnn.benchmark = bench

                    def batch():
                        return extract_batch(model, imgs, sizes, "cuda")

                    batch()
                    t0 = time.perf_counter()
                    for _ in range(args.batches):
                        batch()
                    sec = (time.perf_counter() - t0) / args.batches
                    prof = chip_smoke.profile_groups(
                        torch, batch, {"convolutions": "conv"})
                    key = (f"{str(dtype)[6:]} "
                           f"{'channels_last' if cl else 'NCHW'} bn={bn} "
                           f"cudnn.benchmark={bench}")
                    out["variants"][key] = {
                        "batch_ms": sec * 1e3,
                        "images_per_s": sz["grid_batch"] / sec, **prof}
                    g = prof["device_ms_by_group"]
                    print(f"{key}: {sec * 1e3:.1f} ms a batch, "
                          f"{sz['grid_batch'] / sec:.1f} img/s; busy "
                          f"{prof['busy_share']:.2f}, convolutions "
                          f"{g['convolutions']:.1f} ms, glue "
                          f"{g['glue']:.1f} ms ({card})", flush=True)
                del model
                torch.cuda.empty_cache()
    finally:
        det.FrozenBN.forward = addcmul_bn
        torch.backends.cudnn.benchmark = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

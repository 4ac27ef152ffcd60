"""FID evaluation CLI (port of xlxmert_tpu/cli/eval_fid.py): a directory
of generated images against a directory of real ones.

    python -m xlxmert_tpu_torch.cli.eval_fid --real_dir coco/val2014 \\
        --fake_dir samples/ --weights pt_inception-2015-12-05-6726825d.pth \\
        [--extractor auto|inception|resnet] [--device cuda]

The JAX CLI's flags, plus `--device` (the card by default; `--device
cpu` runs on the CPU). `--weights` takes a torchvision-layout state dict
(`.pth`/`.pt`: pt_inception or torchvision inception_v3, or a resnet50)
or a flax msgpack in the JAX package's layout (a converted state dict);
`--extractor auto` picks inception when `Mixed_5b` is among the weights.
Paper-comparable FID needs pt_inception's weights, which do not ship.
Without `--weights` the extractor is random (models/inception
.random_variables, models/resnet.random_init, seed 0): the port's random
init cannot equal flax's PRNGKey(0) init, so such an FID is only
comparable with FIDs of the same extractor and seed, as in the JAX CLI.

The inception protocol loads each image at its native size and resizes
it once on the host (`bilinear_resize_np`, pytorch-fid's bilinear
without antialiasing) to 299; resnet resizes with LANCZOS to
--image_size. `fid_of_batches` is everything after the files are read,
callable with in-memory batches.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--real_dir", required=True)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--weights", default=None,
                   help="feature-extractor weights: InceptionV3 "
                   "(pt_inception / torchvision inception_v3 .pth, the "
                   "paper-comparable path) or resnet50 .pth/.msgpack")
    p.add_argument("--extractor", choices=["auto", "inception", "resnet"],
                   default="auto",
                   help="auto detects from --weights layout (Mixed_* -> "
                   "inception); without --weights, defaults to resnet "
                   "random-init (relative mode)")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def verify_hub_checksum(path: str) -> None:
    """Integrity check of torch-hub-style weight files whose name embeds
    the sha256 prefix (`<name>-<8 hex>.pth`). The paper-comparable FID
    weights are `pt_inception-2015-12-05-6726825d.pth` (pytorch-fid's
    release): a corrupt or renamed file fails loudly instead of giving a
    wrong FID. Other names are not checked."""
    import hashlib
    import re

    m = re.search(r"-([0-9a-f]{8})\.pth$", Path(path).name)
    if not m:
        return
    want = m.group(1)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    got = h.hexdigest()[:8]
    if got != want:
        raise SystemExit(
            f"CHECKSUM MISMATCH for {path}: filename claims sha256 "
            f"prefix {want} but the file hashes to {got} — corrupt or "
            f"renamed download; re-fetch it (pt_inception: "
            f"github.com/mseitzer/pytorch-fid releases, "
            f"pt_inception-2015-12-05-6726825d.pth)")
    print(f"weights checksum OK (sha256 prefix {want})")


def bilinear_resize_np(img: np.ndarray, out_h: int = 299,
                       out_w: int = 299) -> np.ndarray:
    """Host bilinear resize with half-pixel centers and no antialias: the
    two-tap form of torch's F.interpolate(align_corners=False),
    pytorch-fid's protocol, in float32. On the host because image
    directories hold hundreds of native shapes (COCO's)."""
    H, W, _ = img.shape
    ys = (np.arange(out_h, dtype=np.float64) + 0.5) * (H / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float64) + 0.5) * (W / out_w) - 0.5
    y0f, x0f = np.floor(ys), np.floor(xs)
    wy = (ys - y0f).astype(np.float32)[:, None, None]
    wx = (xs - x0f).astype(np.float32)[None, :, None]
    y0 = np.clip(y0f.astype(np.int64), 0, H - 1)
    y1 = np.clip(y0f.astype(np.int64) + 1, 0, H - 1)
    x0 = np.clip(x0f.astype(np.int64), 0, W - 1)
    x1 = np.clip(x0f.astype(np.int64) + 1, 0, W - 1)
    img = np.asarray(img, np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def image_batches(directory, image_size, batch_size, max_images=-1,
                  native_to_299=False):
    """Yield (B, S, S, 3) float32 batches in [0, 1] of the directory's
    .jpg/.jpeg/.png files in name order. native_to_299 (the inception
    protocol): each image at its native size, resized once to 299 by
    `bilinear_resize_np`; image_size is then ignored."""
    from PIL import Image

    paths = sorted(p for p in Path(directory).iterdir()
                   if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    if max_images > 0:
        paths = paths[:max_images]
    batch = []
    for p in paths:
        img = Image.open(p).convert("RGB")
        if native_to_299:
            batch.append(bilinear_resize_np(
                np.asarray(img, np.float32) / 255.0))
        else:
            img = img.resize((image_size, image_size), Image.LANCZOS)
            batch.append(np.asarray(img, np.float32) / 255.0)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def load_extractor(weights: Optional[str], kind: str = "auto"
                   ) -> Tuple[str, Dict]:
    """(kind, variables) of the feature extractor: `weights` read into
    the JAX layout's {params, batch_stats} (AuxLogits dropped for
    inception), or the random init (with a loud warning) when None."""
    if weights:
        from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint
        from xlxmert_tpu_torch.core.convert import split_variables

        verify_hub_checksum(weights)
        cols = split_variables(load_any_checkpoint(weights))
        variables = {"params": cols["params"],
                     "batch_stats": cols.get("batch_stats", {})}
        if kind == "auto":
            kind = ("inception" if "Mixed_5b" in cols["params"]
                    else "resnet")
        if kind == "inception":
            for col in variables.values():
                col.pop("AuxLogits", None)
        print(f"extractor: {kind} ({weights})")
        return kind, variables
    print("WARNING: random-init feature extractor (no --weights) — "
          "FID values are only comparable to each other, not to "
          "published numbers. For paper-comparable FID pass "
          "--weights pt_inception-2015-12-05-*.pth (InceptionV3 "
          "pool3).")
    if kind == "auto":
        kind = "resnet"
    return kind, {}


def feature_fn(kind: str, variables: Dict, device="cuda"):
    """The extractor's feature function on `device` (host batches in,
    host float32 features out); empty `variables` mean the random
    init."""
    from xlxmert_tpu_torch.utils.fid import (
        inception_feature_fn, resnet_feature_fn,
    )

    if kind == "inception":
        from xlxmert_tpu_torch.models.inception import (
            inception_from_variables, random_variables,
        )

        model = inception_from_variables(variables or random_variables(0))
        return inception_feature_fn(model, device)
    from xlxmert_tpu_torch.models.resnet import (
        load_variables, random_init, resnet50,
    )

    model = resnet50()
    if variables:
        load_variables(model, variables)
    else:
        random_init(model)
    return resnet_feature_fn(model, device)


def fid_of_batches(real_batches: Iterable[np.ndarray],
                   fake_batches: Iterable[np.ndarray], kind: str,
                   variables: Dict, device="cuda") -> float:
    """FID of two streams of NHWC [0, 1] host batches under the extractor
    (`kind`, `variables`) on `device`: the CLI after its files are
    read."""
    from xlxmert_tpu_torch.utils.fid import compute_fid

    return compute_fid(real_batches, fake_batches,
                       feature_fn(kind, variables, device))


def main(argv=None):
    ns = parse_args(argv)

    from xlxmert_tpu_torch.utils.device import resolve_device

    device = resolve_device(ns.device)
    kind, variables = load_extractor(ns.weights, ns.extractor)
    native299 = kind == "inception"
    if native299:
        print("inception protocol: native-resolution load + single "
              "bilinear(antialias=False) resize to 299 (--image_size "
              "ignored)")
    fid = fid_of_batches(
        image_batches(ns.real_dir, ns.image_size, ns.batch_size,
                      ns.max_images, native_to_299=native299),
        image_batches(ns.fake_dir, ns.image_size, ns.batch_size,
                      ns.max_images, native_to_299=native299),
        kind, variables, device)
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()

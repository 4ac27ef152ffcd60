"""Bbox-feature extraction CLI (port of
xlxmert_tpu/cli/extract_bbox_features.py; the reference's
feature_extraction/*_extract_bbox_feature.py).

    python -m xlxmert_tpu_torch.cli.extract_bbox_features \\
        --images_dir datasets/COCO/images/val2014 \\
        --out datasets/COCO/features/maskrcnn_valid_boxes36.h5 \\
        --weights detectron_model.pth [--device cuda]

The JAX CLI's flags, plus --device (cuda, the default, or cpu). Per
image: the full detector (models/detectron.DetectronDetector: RPN
proposals, box-head class scores and fc6 features, fp32), per-class NMS
and max-confidence top-36 (ops/box_selection), then the reference's h5
contract (:296-335): per img_id groups features (36, 2048), obj_id
(36,), boxes (36, 4) in original image coordinates, img_w, img_h.
`extract_batch` is one batch's compute, from host arrays.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

NUM_FEATURES = 36  # coco_extract_bbox_feature.py:42


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images_dir", default=None,
                   help="bare image dir (alternative to --corpus/--root)")
    p.add_argument("--out", default=None, help="output .h5 path "
                   "(derived from the corpus layout when --corpus)")
    p.add_argument("--corpus", default=None,
                   choices=["coco", "vg", "gqa", "nlvr2"],
                   help="reference per-dataset conventions (data/corpora.py)")
    p.add_argument("--root", default=None, help="corpus root")
    p.add_argument("--split", default=None,
                   help="{train,valid,test} (COCO/NLVR2 only)")
    p.add_argument("--weights", default=None,
                   help="detectron_model.pth / .msgpack (random init if "
                   "omitted — pipeline testing only)")
    p.add_argument("--num_features", type=int, default=NUM_FEATURES)
    p.add_argument("--n_classes", type=int, default=1601)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--confidence_threshold", type=float, default=0.0)
    p.add_argument("--background", action="store_true",
                   help="include the background column in selection")
    p.add_argument("--proposals", type=int, default=1000,
                   help="RPN post-NMS proposal budget")
    p.add_argument("--tiny_detectron", action="store_true",
                   help="tiny random config (pipeline tests)")
    p.add_argument("--min_size", type=int, default=800)
    p.add_argument("--max_size", type=int, default=1333)
    p.add_argument("--group_einsum", nargs="?", const="on",
                   choices=["on", "auto", "off"], default="auto",
                   help="the JAX package's TPU lowering of the grouped "
                   "convs; accepted and ignored on the card")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def scaled_shape(h: int, w: int, min_size: int, max_size: int):
    """(th, tw, scale): the exact min/max scaling, no /32 snap; the canvas
    is padded to /32 instead (to_image_list(size_divisible=32),
    coco_extract_bbox_feature.py:144-146,194-204)."""
    scale = min_size / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = max_size / max(h, w)
    return int(scale * h), int(scale * w), scale


def extract_batch(model, images, sizes, scales, device, num_features=36,
                  conf_thresh=0.0, background=False):
    """One batch of the bbox path: the detector and the selection.
    images (B, H, W, 3) preprocessed and zero-padded, sizes (B, 2) valid
    (h, w), scales (B,) resize factors (host arrays or tensors) -> host
    arrays {features (B, N, D), boxes (B, N, 4), obj_id (B, N), cls_prob,
    num_boxes, keep_boxes}."""
    import torch

    from xlxmert_tpu_torch.ops.box_selection import select_top_features

    with torch.inference_mode():
        x = torch.as_tensor(images).to(device)
        s = torch.as_tensor(sizes).to(device)
        proposals, cls_scores, feats, obj = model(x, s)
        out = select_top_features(
            proposals, cls_scores, feats["fc6"],
            torch.as_tensor(scales).to(device), valid=torch.isfinite(obj),
            num_features=num_features, conf_thresh=conf_thresh,
            background=background)
        return {k: v.cpu().numpy() for k, v in out.items()}


def main(argv=None):
    ns = parse_args(argv)

    from xlxmert_tpu_torch.utils.device import resolve_device

    dev = resolve_device(ns.device)

    import h5py
    from PIL import Image

    from xlxmert_tpu_torch.cli.extract_features import (
        detector_model, pad32, resolve_inputs)
    from xlxmert_tpu_torch.models.detectron import (
        DetectronConfig, DetectronDetector, preprocess_image,
        tiny_detectron_config)

    cfg = tiny_detectron_config() if ns.tiny_detectron else DetectronConfig()
    ns.arch = "maskrcnn"  # the reference's fixed bbox backbone tag
    ns.image_size = 0
    paths, out = resolve_inputs(ns, kind="bbox", n_boxes=ns.num_features)
    ns.out = out
    print(f"{len(paths)} images -> {out}")

    shapes = []
    for p in paths:
        with Image.open(p) as im:
            shapes.append(scaled_shape(im.height, im.width, ns.min_size,
                                       ns.max_size))
    canvas_hw = (pad32(max(s[0] for s in shapes)),
                 pad32(max(s[1] for s in shapes)))
    print(f"canvas {canvas_hw}")

    model = detector_model(
        DetectronDetector, ns, cfg, dev, n_classes=ns.n_classes,
        pre_nms_top_n=ns.proposals, post_nms_top_n=ns.proposals,
        fpn_post_nms_top_n=ns.proposals)

    def batches():
        buf, sz, scl, ids, orig = [], [], [], [], []
        for path in paths:
            img = Image.open(path)
            th, tw, scale = scaled_shape(img.height, img.width, ns.min_size,
                                         ns.max_size)
            arr = preprocess_image(np.asarray(img.convert("RGB")), (th, tw))
            pad = np.zeros((*canvas_hw, 3), np.float32)
            pad[:th, :tw] = arr
            buf.append(pad)
            sz.append((th, tw))
            scl.append(scale)
            ids.append(path.stem)
            orig.append((img.width, img.height))
            if len(buf) == ns.batch_size:
                yield (np.stack(buf), np.asarray(sz, np.int32),
                       np.asarray(scl, np.float32), ids, orig)
                buf, sz, scl, ids, orig = [], [], [], [], []
        if buf:
            k = ns.batch_size - len(buf)
            yield (np.concatenate([np.stack(buf),
                                   np.zeros((k, *canvas_hw, 3), np.float32)]),
                   np.concatenate([np.asarray(sz, np.int32),
                                   np.full((k, 2), 32, np.int32)]),
                   np.concatenate([np.asarray(scl, np.float32),
                                   np.ones(k, np.float32)]), ids, orig)

    Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
    t0, n = time.time(), 0
    with h5py.File(ns.out, "w") as f:
        for images, sizes, scales, ids, orig in batches():
            out = extract_batch(model, images, sizes, scales, dev,
                                ns.num_features, ns.confidence_threshold,
                                ns.background)
            for i, img_id in enumerate(ids):
                g = f.create_group(img_id)
                g["features"] = out["features"][i].astype(np.float32)
                g["obj_id"] = out["obj_id"][i]
                g["boxes"] = out["boxes"][i].astype(np.float32)
                g["img_w"] = orig[i][0]
                g["img_h"] = orig[i][1]
            n += len(ids)
    dt = time.time() - t0
    print(f"wrote {n} box features to {ns.out} in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.1f} img/s)")


if __name__ == "__main__":
    main()

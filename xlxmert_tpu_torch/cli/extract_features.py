"""Grid-feature extraction CLI (port of xlxmert_tpu/cli/extract_features.py;
the reference's feature_extraction/*_extract_grid_feature.py, which run
a maskrcnn-benchmark detector at batch 1).

    python -m xlxmert_tpu_torch.cli.extract_features --arch maskrcnn \\
        --images_dir path/to/jpgs --out data/mscoco_imgfeat/x_grid8.h5 \\
        --weights detectron_model.pth --image_size 0 --batch_size 8 \\
        [--device cuda]

The JAX CLI's flags, plus --device (cuda, the default, or cpu). Writes
the reference's h5 contract, f[img_id]['features'] of (G, G, D). The
maskrcnn arch runs models/detectron.DetectronGridExtractor in fp32 over
batches zero-padded onto one canvas (/32); the resnet archs run
models/resnet.grid_features on square resizes. `extract_batch` is one
batch's compute, from host arrays.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images_dir", default=None,
                   help="bare directory of images (alternative to "
                   "--corpus/--root)")
    p.add_argument("--out", default=None, help="output .h5 path "
                   "(derived from the corpus layout when --corpus)")
    p.add_argument("--corpus", default=None,
                   choices=["coco", "vg", "gqa", "nlvr2"],
                   help="use the reference's per-dataset file/id/output "
                   "conventions (data/corpora.py)")
    p.add_argument("--root", default=None,
                   help="corpus root (e.g. datasets/COCO) when --corpus")
    p.add_argument("--split", default=None,
                   help="corpus split {train,valid,test} (COCO/NLVR2 only)")
    p.add_argument("--weights", default=None,
                   help="resnet .pth/.msgpack, or for maskrcnn a "
                   "detectron_model.pth or .msgpack (random init if "
                   "omitted — for pipeline testing only)")
    p.add_argument("--arch", default="resnet50",
                   choices=["resnet50", "resnet101", "maskrcnn"],
                   help="maskrcnn = the Detectron X-152-FPN fc6 graph the "
                   "released checkpoints were trained on (models/detectron)")
    p.add_argument("--grid_size", type=int, default=8)
    p.add_argument("--image_size", type=int, default=256,
                   help="square resize (resnet archs); for maskrcnn this is "
                   "the --imsize mode, 0 = reference min-800/max-1333")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--tiny_detectron", action="store_true",
                   help="tiny random maskrcnn config (pipeline tests)")
    p.add_argument("--group_einsum", nargs="?", const="on",
                   choices=["on", "auto", "off"], default="auto",
                   help="the JAX package's TPU lowering of the grouped "
                   "convs; accepted and ignored on the card (every "
                   "grouped conv is one F.conv2d(groups=32))")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def resolve_inputs(ns, kind: str = "grid", n_boxes: int = 36):
    """(paths, out_path) from either --images_dir/--out or the corpus
    manifest (--corpus/--root/--split)."""
    from xlxmert_tpu_torch.data.corpora import (
        corpus_image_paths, extractor_output_path)

    if ns.corpus:
        if not ns.root:
            raise SystemExit("--corpus requires --root")
        paths = corpus_image_paths(ns.corpus, Path(ns.root), ns.split)
        arch = getattr(ns, "arch", "maskrcnn")
        size = getattr(ns, "image_size", 0)
        if arch == "maskrcnn":
            # the reference tags only the --imsize mode (0 = the
            # min-800/max-1333 canvas, untagged)
            imsize = size or None
        else:
            # resnet archs always square-resize; a non-default size is
            # tagged, so two sizes cannot collide on one output path
            imsize = size if size != 256 else None
        out = ns.out or str(extractor_output_path(
            ns.corpus, Path(ns.root), ns.split, arch, kind,
            getattr(ns, "grid_size", 8), imsize, n_boxes))
        return paths, out
    if not ns.images_dir or not ns.out:
        raise SystemExit("need --images_dir and --out (or --corpus/--root)")
    paths = sorted(p for p in Path(ns.images_dir).iterdir()
                   if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    return paths, ns.out


def pad32(v: int) -> int:
    return (v + 31) // 32 * 32


def extract_batch(model, images, sizes, device) -> np.ndarray:
    """One batch of the maskrcnn grid path: images (B, H, W, 3)
    preprocessed and zero-padded, sizes (B, 2) valid (h, w) (host arrays
    or tensors) -> (B, G*G, D) fp32 host features."""
    import torch

    with torch.inference_mode():
        x = torch.as_tensor(images).to(device)
        s = torch.as_tensor(sizes).to(device)
        return model(x, s).float().cpu().numpy()


def detector_model(cls, ns, cfg, dev, **kw):
    """`cls`(cfg, **kw) on `dev` with --weights, or with the random tree
    of models/detectron.random_params (seed 0) and the JAX CLI's
    warning."""
    from xlxmert_tpu_torch.models.detectron import (
        load_params, load_weights, random_params)

    model = cls(cfg, **kw)
    if ns.weights:
        load_weights(model, ns.weights)
    else:
        print("WARNING: random-init detector (no --weights) — features are "
              "for pipeline testing only")
        load_params(model, random_params(
            cfg, 0, n_classes=kw.get("n_classes")))
    return model.to(dev).eval()


def run_maskrcnn(ns, dev):
    """The Detectron grid path: preprocess (BGR - mean, min-800/max-1333
    or the --image_size square), batched fc6 extraction, the h5 contract
    (coco_extract_grid_feature.py:236-260)."""
    import h5py
    from PIL import Image

    from xlxmert_tpu_torch.models.detectron import (
        DetectronConfig, DetectronGridExtractor, detectron_resize_shape,
        preprocess_image, tiny_detectron_config)

    cfg = tiny_detectron_config() if ns.tiny_detectron else DetectronConfig()
    imsize = ns.image_size or None

    paths, out = resolve_inputs(ns, kind="grid")
    ns.out = out
    print(f"{len(paths)} images -> {out}")

    # one canvas for the run; the FPN's top-down sums need /32 inputs
    if imsize:
        if imsize % 32:
            print(f"--image_size {imsize}: images keep that size; the "
                  f"canvas zero-pads to {pad32(imsize)} "
                  f"(FPN stride alignment)")
        canvas_hw = (pad32(imsize), pad32(imsize))
    else:
        shapes = []
        for p in paths:
            with Image.open(p) as im:
                shapes.append(detectron_resize_shape(im.height, im.width))
        canvas_hw = (pad32(max(s[0] for s in shapes)),
                     pad32(max(s[1] for s in shapes)))
    print(f"canvas {canvas_hw}")

    model = detector_model(DetectronGridExtractor, ns, cfg, dev,
                           grid_size=ns.grid_size)

    def batches():
        buf, sz, ids = [], [], []
        for path in paths:
            img = Image.open(path)
            th, tw = ((imsize, imsize) if imsize
                      else detectron_resize_shape(img.height, img.width))
            arr = preprocess_image(np.asarray(img.convert("RGB")), (th, tw))
            pad = np.zeros((*canvas_hw, 3), np.float32)
            pad[:th, :tw] = arr
            buf.append(pad)
            sz.append((th, tw))
            ids.append(path.stem)
            if len(buf) == ns.batch_size:
                yield np.stack(buf), np.asarray(sz, np.int32), ids
                buf, sz, ids = [], [], []
        if buf:
            k = ns.batch_size - len(buf)
            yield (np.concatenate(
                [np.stack(buf), np.zeros((k, *canvas_hw, 3), np.float32)]),
                np.concatenate([np.asarray(sz, np.int32),
                                np.full((k, 2), 32, np.int32)]), ids)

    Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
    t0, n = time.time(), 0
    with h5py.File(ns.out, "w") as f:
        for images, sizes, ids in batches():
            feats = extract_batch(model, images, sizes, dev)
            if n == 0:
                print(f"first batch {time.time()-t0:.1f}s", flush=True)
            G = ns.grid_size
            for i, img_id in enumerate(ids):
                g = f.create_group(img_id)
                g.create_dataset(
                    "features", data=feats[i].reshape(G, G, -1))
            n += len(ids)
    dt = time.time() - t0
    print(f"wrote {n} features to {ns.out} in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.1f} img/s)")


def iter_image_batches(paths, image_size, batch_size):
    """Square LANCZOS resizes in [0, 1], batch_size at a time (the last
    batch zero-padded), with their ids."""
    from PIL import Image

    batch, ids = [], []
    for path in paths:
        img = Image.open(path).convert("RGB").resize(
            (image_size, image_size), Image.LANCZOS)
        batch.append(np.asarray(img, np.float32) / 255.0)
        ids.append(path.stem)
        if len(batch) == batch_size:
            yield np.stack(batch), ids
            batch, ids = [], []
    if batch:
        pad = batch_size - len(batch)
        yield np.concatenate([np.stack(batch),
                              np.zeros((pad, image_size, image_size, 3),
                                       np.float32)]), ids


def main(argv=None):
    ns = parse_args(argv)

    from xlxmert_tpu_torch.utils.device import resolve_device

    dev = resolve_device(ns.device)
    if ns.arch == "maskrcnn":
        return run_maskrcnn(ns, dev)

    import h5py
    import torch

    from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint
    from xlxmert_tpu_torch.core.convert import split_variables
    from xlxmert_tpu_torch.models.resnet import (
        grid_features, load_variables, random_init, resnet101, resnet50)

    model = resnet50() if ns.arch == "resnet50" else resnet101()
    if ns.weights:
        cols = split_variables(load_any_checkpoint(ns.weights))
        load_variables(model, {"params": cols["params"],
                               "batch_stats": cols.get("batch_stats", {})})
    else:
        print("WARNING: random-init backbone (no --weights) — features are "
              "for pipeline testing only")
        random_init(model)
    model = model.to(dev).eval()

    paths, out = resolve_inputs(ns, kind="grid")
    ns.out = out
    print(f"{len(paths)} images -> {out}")
    Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
    t0, n = time.time(), 0
    with h5py.File(ns.out, "w") as f, torch.inference_mode():
        for images, ids in iter_image_batches(paths, ns.image_size,
                                              ns.batch_size):
            feats = grid_features(model, torch.from_numpy(images).to(dev),
                                  ns.grid_size).float().cpu().numpy()
            for i, img_id in enumerate(ids):
                g = f.create_group(img_id)
                g.create_dataset("features", data=feats[i])
            n += len(ids)
    dt = time.time() - t0
    print(f"wrote {n} features to {ns.out} in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.1f} img/s)")


if __name__ == "__main__":
    main()

"""GAN generator training CLI (port of xlxmert_tpu/cli/train_generator.py;
reference image_generator/scripts/train_generator.bash + src/main.py:
29-332, whose trainer.py is missing: the JAX package's reconstruction).

    python -m xlxmert_tpu_torch.cli.train_generator \\
        --images_dir data/coco/train2014 \\
        --centroids data/cluster_centroids/..._grid8.npy \\
        --cluster_pkl data/cluster_ids/..._train_....pkl \\
        --batch_size 16 --epochs 101 --g_base_dim 32 --d_base_dim 64 \\
        [--classifier_weights resnet50.pth] [--device cuda]

The JAX CLI's flags, plus --device (cuda, the default, or cpu). `main`
reads the centroid table, the cluster-id pickle and the image list, and
calls `train`, the epoch loop, which is callable in memory on any
iterable of batches: every batch trains one D-step and one G-step
(tasks/train_generator.GanEngine); every epoch writes G_{epoch}.msgpack
(params, sn [, batch_stats]: what cli/sample_images --generator reads)
and, with --save_full_state, G_{epoch}_FULL.msgpack in the JAX CLI's
layout (`serialization.to_state_dict(GanState)` plus `epoch`), which
--resume reads, whichever package wrote it.

Several processes (torchrun's environment): the process group starts
first, rank r trains on paths[r::world] (--batch_size a rank) with the
gradients averaged and the "batch" SPADE statistics taken over the
ranks, every rank runs the pairs of the smallest shard, and rank 0
alone logs and writes.
"""
from __future__ import annotations

import argparse
import random
import re
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images_dir", required=True,
                   help="raw images (COCO train2014)")
    p.add_argument("--centroids", required=True)
    p.add_argument("--cluster_pkl", required=True)
    p.add_argument("--output", default="snap/generator")
    p.add_argument("--epochs", type=int, default=101)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--g_base_dim", type=int, default=32)
    p.add_argument("--d_base_dim", type=int, default=64)
    p.add_argument("--codebook_dim", type=int, default=256)
    p.add_argument("--resize_target_size", type=int, default=256)
    p.add_argument("--n_grid", type=int, default=8)
    p.add_argument("--emb_dim", type=int, default=2048)
    p.add_argument("--g_lr", type=float, default=4e-4)
    p.add_argument("--d_lr", type=float, default=1e-4)
    p.add_argument("--gan_loss_lambda", type=float, default=1.0)
    p.add_argument("--gan_loss_cluster_lambda", type=float, default=1.0)
    p.add_argument("--gan_feat_match_lambda", type=float, default=10.0)
    p.add_argument("--feat_loss_lambda", type=float, default=10.0)
    p.add_argument("--classifier", default="resnet50",
                   help="perceptual encoder arch")
    p.add_argument("--classifier_weights", default=None,
                   help="pretrained resnet weights (.pth or .msgpack); "
                   "perceptual loss is disabled when omitted")
    # accepted for train_generator.bash compatibility; the engine always
    # trains the reference recipe (hinge + ACGAN + SN) — these are not
    # ablation switches
    p.add_argument("--ACGAN", action="store_true",
                   help="always on (script-compat no-op)")
    p.add_argument("--SN", action="store_true",
                   help="always on (script-compat no-op)")
    p.add_argument("--hinge", action="store_true",
                   help="always on (script-compat no-op)")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--log_step", type=int, default=100)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--rng_impl", default="rbg",
                   choices=["rbg", "threefry2x32", "unsafe_rbg"],
                   help="JAX's PRNG; accepted without effect (the noise "
                   "draws from a torch.Generator)")
    p.add_argument("--train_topk", type=int, default=-1)
    p.add_argument("--save_full_state", action="store_true",
                   help="also save G_{epoch}_FULL.msgpack (G+D params, "
                   "SN vectors, BN stats, both optimizers, step) for "
                   "exact resume via --resume")
    p.add_argument("--resume", default=None,
                   help="G_{epoch}_FULL.msgpack to exact-resume from "
                   "(restores discriminator + optimizer state)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def gan_config(ns, n_classes: int):
    """The GanConfig of the parsed flags, over `n_classes` centroids."""
    from xlxmert_tpu_torch.core.config import GanConfig

    return GanConfig(
        emb_dim=ns.emb_dim, codebook_dim=ns.codebook_dim,
        g_base_dim=ns.g_base_dim, d_base_dim=ns.d_base_dim,
        init_H=ns.n_grid, init_W=ns.n_grid,
        target_size=ns.resize_target_size,
        lambda_adv=ns.gan_loss_lambda,
        lambda_cls=ns.gan_loss_cluster_lambda,
        lambda_feat_match=ns.gan_feat_match_lambda,
        lambda_feat=ns.feat_loss_lambda,
        g_lr=ns.g_lr, d_lr=ns.d_lr, batch_size=ns.batch_size,
        epochs=ns.epochs, seed=ns.seed, output=ns.output,
        mixed_precision=not ns.fp32, rng_impl=ns.rng_impl,
        n_classes=n_classes)


def image_code_batches(paths, cluster_map, centroids, cfg, batch_size,
                       shuffle_seed=None):
    """Raw JPEG + cluster-id batches (data_utils.py:62-268 equivalent):
    image resized to target, scaled to [-1, 1]; code = centroid embedding
    of the image's cluster ids. PIL is imported here only."""
    from PIL import Image

    order = list(range(len(paths)))
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(order)
    imgs, codes, idss = [], [], []
    for i in order:
        path = paths[i]
        ids = cluster_map.get(path.stem)
        img = Image.open(path).convert("RGB").resize(
            (cfg.target_size, cfg.target_size), Image.LANCZOS)
        imgs.append(np.asarray(img, np.float32) / 127.5 - 1.0)
        codes.append(centroids[ids].reshape(cfg.init_H, cfg.init_W, -1))
        idss.append(ids)
        if len(imgs) == batch_size:
            yield {"image": np.stack(imgs), "code": np.stack(codes),
                   "cluster_id": np.stack(idss).astype(np.int32)}
            imgs, codes, idss = [], [], []


def resume(state, path: str):
    """Exact-resume `state` in place from a FULL checkpoint (either
    package's). Returns (start_epoch, step): the epoch after the saved
    one (stored in the tree; the file name's as the fallback) and the
    state's step, as the JAX CLI sets its counter."""
    from xlxmert_tpu_torch.core.checkpoint import load_pytree
    from xlxmert_tpu_torch.tasks.train_generator import restore_state

    tree = load_pytree(path)
    saved_epoch = tree.pop("epoch", None)
    restore_state(state, tree)
    if saved_epoch is not None:
        start_epoch = int(np.asarray(saved_epoch)) + 1
    else:
        m = re.search(r"G_(\d+)_FULL", Path(path).name)
        start_epoch = int(m.group(1)) + 1 if m else 0
    return start_epoch, state.step


def train(eng, state, centroids: np.ndarray,
          batches: Callable[[int], Iterable[Dict]], logger,
          log_step: int = 100, save_full_state: bool = False,
          start_epoch: int = 0, step: int = 0,
          on_pair: Optional[Callable] = None,
          pairs_per_epoch: Optional[int] = None) -> Dict:
    """The epoch loop: for each epoch in [start_epoch, cfg.epochs), the
    host batches of `batches(epoch)` (numpy dicts: "image", "code",
    "cluster_id"; loaded on a prefetch thread) each train one D-step and
    one G-step; metrics are logged every `log_step` steps (two a pair,
    as the JAX CLI counts); then G_{epoch}.msgpack (and with
    save_full_state G_{epoch}_FULL.msgpack) is written under
    cfg.output. `on_pair(step, d_metrics, g_metrics)` is called after
    every pair; `pairs_per_epoch` caps an epoch's pairs (every rank of a
    multi-process run takes as many). Returns {"state", "step", "pairs",
    "last": the last pair's metrics as floats}."""
    import itertools

    import torch

    from xlxmert_tpu_torch.core.checkpoint import save_on_main
    from xlxmert_tpu_torch.core.metrics import LossMeter
    from xlxmert_tpu_torch.data.io import PrefetchLoader
    from xlxmert_tpu_torch.models.gan import variables_of
    from xlxmert_tpu_torch.tasks.train_generator import state_to_tree

    cfg = eng.cfg
    table = torch.from_numpy(np.ascontiguousarray(centroids, np.float32)
                             ).to(eng.device)
    meters = {"g": LossMeter(), "d": LossMeter()}
    pairs, last = 0, {}
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        loader = PrefetchLoader(lambda: batches(epoch))
        for host in itertools.islice(loader, pairs_per_epoch):
            batch = eng.place(host)
            state, dm = eng.d_step(state, batch, table)
            state, gm = eng.g_step(state, batch, table)
            if step % log_step == 0:
                last = {k: float(v) for k, v in {**gm, **dm}.items()}
                meters["g"].update(last["g_total"])
                meters["d"].update(last["d_total"])
                logger.scalars(step, last)
            if on_pair is not None:
                on_pair(step, dm, gm)
            step += 2
            pairs += 1
        logger.info(f"epoch {epoch}: G {meters['g'].val:.4f} "
                    f"D {meters['d'].val:.4f} ({time.time() - t0:.0f}s)")
        # the generator's params, sn [, batch_stats]: what the JAX CLI
        # writes and cli/sample_images --generator reads
        save_on_main(variables_of(state.G),
                     str(Path(cfg.output) / f"G_{epoch}.msgpack"))
        if save_full_state:
            full = state_to_tree(state)
            # epoch lives inside the tree: a renamed or copied
            # checkpoint still resumes at the right epoch
            full["epoch"] = np.asarray(epoch, np.int32)
            save_on_main(full, str(Path(cfg.output)
                                   / f"G_{epoch}_FULL.msgpack"))
    return {"state": state, "step": step, "pairs": pairs, "last": last}


def main(argv=None) -> Dict:
    ns = parse_args(argv)

    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.data.io import ClusterMap
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.train_generator import GanEngine
    from xlxmert_tpu_torch.utils.device import resolve_device

    pmesh.maybe_initialize_multihost(ns.device)
    resolve_device(ns.device)  # refuse before the run directory is made

    centroids = np.load(ns.centroids).astype(np.float32)
    cfg = gan_config(ns, int(centroids.shape[0]))
    logger = RunLogger(cfg.output, cfg, enabled=pmesh.is_main())
    perceptual_vars = None
    if ns.classifier_weights:
        from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint
        from xlxmert_tpu_torch.core.convert import split_variables

        cols = split_variables(load_any_checkpoint(ns.classifier_weights))
        perceptual_vars = {"params": cols["params"],
                           "batch_stats": cols.get("batch_stats", {})}
    else:
        logger.info("no --classifier_weights: perceptual loss disabled")

    eng = GanEngine(cfg, perceptual_variables=perceptual_vars,
                    device=ns.device)
    cluster_map = ClusterMap(ns.cluster_pkl)
    paths = sorted(p for p in Path(ns.images_dir).iterdir()
                   if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    paths = [p for p in paths if p.stem in cluster_map]
    if ns.train_topk > 0:
        paths = paths[:ns.train_topk]
    logger.info(f"{len(paths)} images; device {eng.device}")
    paths = paths[pmesh.rank()::pmesh.world_size()]
    pairs = pmesh.agree_min(len(paths) // cfg.batch_size)

    state = eng.create_state(cfg.seed, centroids)
    start_epoch, step = 0, 0
    if ns.resume:
        start_epoch, step = resume(state, ns.resume)
        logger.info(f"exact-resumed GAN state from {ns.resume} at "
                    f"epoch {start_epoch}, step {step}")
    try:
        return train(eng, state, centroids,
                     lambda epoch: image_code_batches(
                         paths, cluster_map, centroids, cfg, cfg.batch_size,
                         shuffle_seed=cfg.seed + epoch),
                     logger, log_step=ns.log_step,
                     save_full_state=ns.save_full_state,
                     start_epoch=start_epoch, step=step,
                     pairs_per_epoch=pairs)
    finally:
        logger.close()


if __name__ == "__main__":
    main()

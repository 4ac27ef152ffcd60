"""Pre-training CLI (port of xlxmert_tpu/cli/pretrain.py; the reference's
`bash scripts/pretrain.bash`, lxmert_pretrain.py:688-867).

    python -m xlxmert_tpu_torch.cli.pretrain --taskMaskLM --taskObjPredict \\
        --taskMatched --visualLosses obj --vis_mask_predict --clustering \\
        --grid_model --grid_size 8 --llayers 9 --rlayers 5 --xlayers 5 \\
        --lr 1e-4 --epochs 20 --batchSize 256 --train mscoco_train,... \\
        --data_root data --vocab data/vocab.txt \\
        [--train_attention pallas_blhd] [--device cuda]

`main(argv)` checks the flags as the JAX CLI does, loads the centroid
table and the cluster-id map (or the bbox / grid h5 readers), builds the
datasets and the engine, merges --bert_weights or --load, and calls
`pretrain()`, the epoch loop, which is callable with in-memory datasets:
every epoch trains the task round-robin, evaluates each task and writes
Epoch%02d_LXRT.msgpack (the JAX package's format) from a writer thread.
--save_full_state also writes Epoch%02d_FULL.msgpack (params, Adam's
moments and counts, the schedule position, the step) from the same host
snapshot; a --load of such a file resumes exactly, whichever package
wrote it. --profile N traces N steps of the first epoch with
torch.profiler into <output>/profile.

Several processes (torchrun's environment): the process group starts
first, the ranks lay out on cfg.mesh_shape over cfg.mesh_axis_names
(all on "data" by default; ("data", "model") adds tensor parallelism),
each data index trains on its `shard` of the corpus (--batchSize a data
rank), and rank 0 alone logs, traces and writes (the checkpoints are
gathered first, so their layout is the single process's).
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np


def _check_flags(cfg) -> None:
    """The JAX CLI's refusals, with its messages."""
    if "attr" in cfg.visual_loss_keys:
        # no loader emits attr labels (the reference's data_out never
        # includes 'attr_prob', lxmert_pretrain.py:723-741)
        raise SystemExit(
            "--visualLosses attr: no pretraining data path provides "
            "attr labels (true of the reference as well); drop 'attr' "
            "or drive PretrainEngine directly with attr_label batches")
    if ("feat" in cfg.visual_loss_keys and cfg.clustering
            and not (cfg.feed_exact_feat or cfg.target_exact_feat)):
        raise SystemExit(
            "--visualLosses feat in clustering mode needs an exact-"
            "feature source: add --feed_exact_feat and/or "
            "--target_exact_feat (otherwise no vis_feats are loaded "
            "and the feat loss would silently vanish)")
    if not cfg.clustering and not (cfg.feed_exact_feat
                                   or cfg.target_exact_feat):
        raise SystemExit(
            "non-clustering pretraining needs --feed_exact_feat and/or "
            "--target_exact_feat (exact detector features are the "
            "visual input on this path)")


def eval_generator(device, epoch: int, batch_index: int):
    """The masks of one evaluation batch: a stream of their own for each
    (epoch, batch), so batches are not masked alike."""
    import torch

    return torch.Generator(device=device).manual_seed(
        1_000_003 * epoch + batch_index)


def pretrain(eng, state, train_ds, valid_ds, cfg, centroids, logger,
             start_epoch: int = 0, on_step: Optional[Callable] = None,
             profile: int = 0) -> Dict[str, float]:
    """The epoch loop: cfg.epochs - start_epoch epochs of shuffled full
    batches through `eng.train_step`, the task picked by
    `eng.task_for_step` round-robin; then each task's mean loss over
    `valid_ds` and Epoch%02d_LXRT.msgpack under cfg.output (with
    cfg.save_full_state also Epoch%02d_FULL.msgpack, horizon
    eng.total_steps), written on a background thread (waited for before
    returning, also on error). `on_step(step, task, metrics)` is called
    after every step. `profile` > 0 traces that many steps of the first
    epoch into cfg.output/profile (utils/profiling.trace), starting
    after min(5, steps_per_epoch - profile) steps and ending early with
    the epoch; each step is the range "train_step <task>". Returns the
    last epoch's {valid/<task>: loss}."""
    from xlxmert_tpu_torch.core.checkpoint import (
        AsyncCheckpointer, epoch_ckpt_name, train_state_to_tree,
    )
    import itertools

    from xlxmert_tpu_torch.core.metrics import LossMeter
    from xlxmert_tpu_torch.data.io import PrefetchLoader
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.utils.profiling import span, trace

    steps_per_epoch = max(pmesh.agree_min(len(train_ds)) // cfg.batch_size,
                          1)
    global_step = start_epoch * steps_per_epoch
    summary: Dict[str, float] = {}
    ckpt = AsyncCheckpointer()
    profile_dir = str(Path(cfg.output) / "profile")
    # after the first steps' warm-up, clamped so short epochs still trace
    profile_start = (min(5, max(steps_per_epoch - profile, 0))
                     if profile and not cfg.dry and pmesh.is_main() else -1)
    tracing = contextlib.ExitStack()
    try:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            loader = PrefetchLoader(
                lambda: train_ds.batches(cfg.batch_size, shuffle=True,
                                         seed=cfg.seed + epoch,
                                         drop_last=True))
            if not cfg.dry:
                for i, batch in enumerate(itertools.islice(
                        loader, steps_per_epoch)):
                    if epoch == start_epoch and i == profile_start:
                        logger.info(f"profiler trace of {profile} steps -> "
                                    f"{profile_dir}")
                        tracing.enter_context(trace(profile_dir))
                    elif epoch == start_epoch and i == profile_start + profile:
                        tracing.close()
                    task = eng.task_for_step(global_step)
                    with span(f"train_step {task}"):
                        metrics = eng.train_step(state, batch, task,
                                                 centroids)
                    if i % 50 == 0:
                        logger.scalars(global_step, {
                            f"{task}/loss": float(metrics["total_loss"]),
                            "grad_norm": float(metrics["grad_norm"])})
                    if on_step is not None:
                        on_step(global_step, task, metrics)
                    global_step += 1
                tracing.close()  # an epoch shorter than the trace window
            meters: Dict[str, LossMeter] = {}
            for i, batch in enumerate(valid_ds.batches(cfg.batch_size)):
                for task in cfg.mask_modalities:
                    m = eng.eval_step(state.model, batch, task, centroids,
                                      eval_generator(eng.device, epoch, i))
                    meters.setdefault(task, LossMeter()).update(
                        float(m["total_loss"]))
            summary = {f"valid/{t}": m.val for t, m in meters.items()}
            logger.scalars(global_step, summary)
            logger.info(f"epoch {epoch}: {summary} "
                        f"({time.time() - t0:.0f}s)")
            params_path = str(Path(cfg.output) / epoch_ckpt_name(epoch + 1))
            # gathered on every rank (collectives), written by rank 0
            if cfg.save_full_state:
                # one host snapshot, both files
                full = train_state_to_tree(state, eng.total_steps)
                if pmesh.is_main():
                    ckpt.save_full(full, str(Path(cfg.output) / f"Epoch"
                                             f"{epoch + 1:02d}_FULL.msgpack"),
                                   params_path)
            else:
                params = state.params()
                if pmesh.is_main():
                    ckpt.save(params, params_path)
    finally:
        tracing.close()
        # a queued save survives an exception: the epoch's checkpoint is
        # not lost to a writer thread killed mid-write
        ckpt.wait()
    pmesh.barrier()
    return summary


def _feature_routes(root: Path, cfg, sources, override):
    """{source: h5 path} of the bbox (not grid_model) or grid files, the
    reference's per-source routing (lxmert_pretrain.py:196-201,
    lxmert_data.py:186-193), or `override` for every source."""
    if cfg.grid_model:
        names = {"mscoco_train": ("mscoco_imgfeat", "train_grid"),
                 "mscoco_minival": ("mscoco_imgfeat", "valid_grid"),
                 "mscoco_nominival": ("mscoco_imgfeat", "valid_grid"),
                 "vgnococo": ("vg_imgfeat", "grid")}
        routes = {s: root / d / f"{cfg.encoder}_{n}{cfg.grid_size}.h5"
                  for s, (d, n) in names.items()}
    else:
        names = {"mscoco_train": ("mscoco_imgfeat", "train_boxes"),
                 "mscoco_minival": ("mscoco_imgfeat", "valid_boxes"),
                 "mscoco_nominival": ("mscoco_imgfeat", "valid_boxes"),
                 "vgnococo": ("vg_imgfeat", "boxes")}
        routes = {s: root / d / f"maskrcnn_{n}{cfg.n_boxes}.h5"
                  for s, (d, n) in names.items()}
    out = {}
    for source in sources:
        path = Path(override) if override else routes.get(source)
        if path is None:
            kind = "grid" if cfg.grid_model else "bbox"
            raise ValueError(
                f"no {kind} h5 route for source {source!r}; pass "
                f"--{kind}_h5 or use a known source name")
        out[source] = path
    return out


def main(argv=None):
    import torch

    from xlxmert_tpu_torch.cli.args import (
        base_parser, make_model_config, to_train_config,
    )

    ns = base_parser().parse_args(argv)
    cfg = to_train_config(ns)
    _check_flags(cfg)

    from xlxmert_tpu_torch.core.checkpoint import (
        is_full_state_tree, load_any_checkpoint, merge_params,
        parse_start_epoch, restore_train_state,
    )
    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.data.datasets import PretrainDataset
    from xlxmert_tpu_torch.data.io import ClusterMap, load_json
    from xlxmert_tpu_torch.data.fast_tokenizer import (
        FastTokenizer as Tokenizer,
    )
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine
    from xlxmert_tpu_torch.utils.device import resolve_device
    from xlxmert_tpu_torch.vocab.kmeans import centroid_filename

    pmesh.maybe_initialize_multihost(ns.device)
    device = resolve_device(ns.device)
    mesh = pmesh.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
    logger = RunLogger(cfg.output, cfg, enabled=pmesh.is_main())
    model_cfg = make_model_config(
        ns, num_clusters=cfg.num_clusters if cfg.clustering else 0)
    tokenizer = Tokenizer(ns.vocab)
    root = Path(ns.data_root)

    clusters = bbox_readers = feat_readers = None
    if cfg.clustering:
        centroid_path = ns.centroid_path or root / "cluster_centroids" / \
            centroid_filename(cfg.encoder, cfg.cluster_src, cfg.num_clusters,
                              cfg.kmeans_iterations, cfg.feat_dim,
                              cfg.grid_size)
        centroids = torch.from_numpy(np.load(centroid_path).astype(
            np.float32)).to(device)
        cluster_pkl = ns.cluster_pkl or root / "cluster_ids" / \
            f"{cfg.encoder}_train_img_id_to_cluster_id_{cfg.num_clusters}" \
            f"_iter{cfg.kmeans_iterations}_d{cfg.feat_dim}" \
            f"_grid{cfg.grid_size}.pkl"
        clusters = ClusterMap(cluster_pkl)
    else:
        centroids = torch.zeros(1, cfg.feat_dim, device=device)  # unused

    sources = set(cfg.train.split(",")) | set(cfg.valid.split(","))
    if not cfg.grid_model or cfg.feed_exact_feat or cfg.target_exact_feat:
        from xlxmert_tpu_torch.data.io import (
            BboxFeatureReader, GridFeatureReader,
        )

        reader_cls = GridFeatureReader if cfg.grid_model else \
            BboxFeatureReader
        routes = _feature_routes(root, cfg, sources, ns.grid_h5
                                 if cfg.grid_model else ns.bbox_h5)
        by_path = {str(p): None for p in routes.values()}
        for p in by_path:
            by_path[p] = reader_cls(p)
        readers = {s: by_path[str(p)] for s, p in routes.items()}
        if cfg.grid_model:
            feat_readers = readers
        else:
            bbox_readers = readers

    answer_table = None
    if cfg.task_qa:
        from xlxmert_tpu_torch.data.answer_table import AnswerTable

        answer_table = AnswerTable(root / "lxmert" / "all_ans.json")
    vis_mask_sources = ({"mscoco"} if cfg.vis_mask_COCO_only
                        else {"mscoco", "vg"} if cfg.vis_mask_COCOVG_only
                        else None)
    ds_kw = dict(max_text_length=cfg.max_text_length,
                 grid_size=cfg.grid_size, answer_table=answer_table,
                 vis_mask_sources=vis_mask_sources,
                 bbox_readers=bbox_readers, feat_reader=feat_readers)

    def load_corpus(names: str):
        out = []
        for source in names.split(","):
            for datum in load_json(root / "lxmert" / f"{source}.json"):
                # bbox-path h5 routing is per corpus source
                datum.setdefault("img_source", source)
                out.append(datum)
        return out

    train_ds = PretrainDataset(load_corpus(cfg.train), tokenizer, clusters,
                               topk=cfg.train_topk, **ds_kw)
    valid_ds = PretrainDataset(load_corpus(cfg.valid), tokenizer, clusters,
                               topk=cfg.valid_topk, **ds_kw)
    # the ranks of one model group train on the same data
    train_ds.shard(mesh.index("data"), mesh.size("data"))
    steps_per_epoch = max(pmesh.agree_min(len(train_ds)) // cfg.batch_size,
                          1)
    total_steps = steps_per_epoch * cfg.epochs
    eng = PretrainEngine(cfg, model_cfg=model_cfg, total_steps=total_steps,
                         train_attention=ns.train_attention, device=device,
                         mesh=mesh)
    logger.info(f"{len(train_ds)} examples, {steps_per_epoch} steps/epoch, "
                f"tasks {cfg.mask_modalities}, on {device}")
    state = eng.create_state(cfg.seed)

    start_epoch = 0
    # BERT-pretrained init (the reference default, lxmert_pretrain.py:
    # 58-61; --fromScratch opts out), before any --load overlay
    if cfg.from_scratch:
        if cfg.bert_weights:
            logger.info("--fromScratch set: ignoring --bert_weights "
                        f"{cfg.bert_weights}")
    elif cfg.bert_weights:
        from xlxmert_tpu_torch.core.convert import load_bert_state_dict

        merged, missing, unexpected = merge_params(
            state.params(), load_bert_state_dict(
                cfg.bert_weights, l_layers=model_cfg.l_layers))
        if unexpected:
            raise ValueError(
                f"--bert_weights produced unexpected param paths "
                f"(wrong checkpoint?): {unexpected[:5]}...")
        state.load_params(merged)
        logger.info(f"BERT init from {cfg.bert_weights}: language stack + "
                    f"embeddings + LM/matched heads loaded; "
                    f"{len(missing)} param paths stay random-init")
    elif not cfg.load:
        logger.info(
            "WARNING: no --bert_weights given and --fromScratch not set — "
            "the reference default initializes from bert-base-uncased "
            "(lxmert_pretrain.py:58-61); proceeding from scratch. Pass "
            "--bert_weights pytorch_model.bin or --fromScratch to silence.")
    if cfg.load:
        loaded = load_any_checkpoint(cfg.load, keep_full_state=True)
        start_epoch = parse_start_epoch(cfg.load)
        if is_full_state_tree(loaded):
            # exact resume: Adam's moments and the schedule's position
            saved_total = restore_train_state(state, loaded)
            if saved_total is not None and saved_total != total_steps:
                logger.info(
                    f"WARNING: LR-schedule horizon changed: checkpoint "
                    f"was saved with total_steps={saved_total}, this run "
                    f"computes {total_steps} (epochs/batch/data changed) "
                    f"— continuing is fine, but the continuation is NOT "
                    f"bit-identical to an uninterrupted run")
            logger.info(f"exact-resumed full train state from {cfg.load} "
                        f"at epoch {start_epoch}, step {state.step}")
        else:
            merged, missing, unexpected = merge_params(state.params(),
                                                       loaded)
            if missing or unexpected:
                logger.info(f"checkpoint overlay (strict=False): "
                            f"{len(missing)} missing, {len(unexpected)} "
                            f"unexpected param paths")
            state.load_params(merged)
            logger.info(f"resumed from {cfg.load} at epoch {start_epoch}")

    pretrain(eng, state, train_ds, valid_ds, cfg, centroids, logger,
             start_epoch=start_epoch, profile=ns.profile)
    logger.close()


if __name__ == "__main__":
    main()

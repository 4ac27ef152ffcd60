"""Fine-tune/eval/test CLI shared by VQA, GQA and NLVR2 (port of
xlxmert_tpu/cli/finetune.py; reference tasks/{vqa,gqa,nlvr2}.py).

    python -m xlxmert_tpu_torch.cli.vqa   --train train,nominival \\
        --valid minival --data_root data --vocab data/vocab.txt \\
        --output snap/vqa [--train_attention pallas_blhd] [--device cuda]
    python -m xlxmert_tpu_torch.cli.gqa   --train train,valid --valid testdev
    python -m xlxmert_tpu_torch.cli.nlvr2 --train train --valid valid

`run(task, argv)` parses the flags, loads the files and calls
`finetune()`, the epoch loop, which is callable with in-memory datasets:
every epoch trains, evaluates (`evaluate()`, through the int8 engine
with --serve_int8) and writes LAST.msgpack, and BEST.msgpack when the
score improves, in the JAX package's checkpoint format. With --test (or
--test_only) it writes the leaderboard dump of the split instead.

Several processes (torchrun's environment, e.g. `torchrun
--nproc_per_node 2 -m xlxmert_tpu_torch.cli.vqa ...`): the process group
starts first, each rank trains on its `shard` of the training data
(--batch_size a rank) with the gradients averaged over the ranks, the
evaluation stream is split round-robin over the ranks and merged
through <output>/eval_shards, and rank 0 alone logs and writes.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Optional


def evaluate(eng, model, eval_ds, cfg, label2ans=None, test_mode=False,
             dump_path: Optional[str] = None):
    """Predict over `eval_ds` with `model`; the evaluator's score, or
    None after writing the dump to `dump_path` (rank 0). Several ranks
    take the batches round-robin and merge their answers."""
    from xlxmert_tpu_torch.parallel import mesh as pmesh

    batches = eval_ds.batches(cfg.batch_size, test=test_mode)
    world, rank = pmesh.world_size(), pmesh.rank()
    if world > 1:
        batches = (b for i, b in enumerate(batches) if i % world == rank)
    quesid2ans = eng.predict(model, batches, label2ans, int8=cfg.serve_int8,
                             shard_dir=str(Path(cfg.output) / "eval_shards"))
    if dump_path:
        if pmesh.is_main():
            eval_ds.evaluator.dump_result(quesid2ans, dump_path)
        pmesh.barrier()
        return None
    return eval_ds.evaluator.evaluate(quesid2ans)


def finetune(eng, state, train_ds, eval_ds, cfg, logger, label2ans=None,
             on_step: Optional[Callable] = None) -> float:
    """The epoch loop of the JAX CLI's `run`: cfg.epochs epochs of
    shuffled full batches through `eng.train_step` (update_freq
    accumulation gated by `should_update`), an evaluation, LAST.msgpack
    and BEST.msgpack under cfg.output. `on_step(i, metrics)` is called
    after every step. Returns the best validation score. With several
    ranks `train_ds` is this rank's shard, and every rank runs the
    steps of the smallest shard."""
    import itertools

    from xlxmert_tpu_torch.core.checkpoint import save_on_main
    from xlxmert_tpu_torch.core.metrics import LossMeter
    from xlxmert_tpu_torch.data.io import PrefetchLoader
    from xlxmert_tpu_torch.parallel.mesh import agree_min
    from xlxmert_tpu_torch.tasks.finetune import should_update

    steps_per_epoch = max(agree_min(len(train_ds)) // cfg.batch_size, 1)
    best = -1.0
    for epoch in range(cfg.epochs):
        t0 = time.time()
        meter = LossMeter()
        loader = PrefetchLoader(
            lambda: train_ds.batches(cfg.batch_size, shuffle=True,
                                     seed=cfg.seed + epoch, drop_last=True))
        for i, batch in enumerate(itertools.islice(loader,
                                                   steps_per_epoch)):
            metrics = eng.train_step(
                state, batch,
                should_update(i, steps_per_epoch, cfg.update_freq))
            if i % 50 == 0:
                meter.update(float(metrics["loss"]))
            if on_step is not None:
                on_step(i, metrics)
        score = evaluate(eng, state.model, eval_ds, cfg, label2ans)
        logger.info(f"epoch {epoch}: valid {score:.4f} loss {meter.val:.4f} "
                    f"({time.time() - t0:.0f}s)")
        logger.scalars((epoch + 1) * steps_per_epoch,
                       {"valid/score": score, "train/loss": meter.val})
        params = state.params()
        save_on_main(params, str(Path(cfg.output) / "LAST.msgpack"))
        if score > best:
            best = score
            save_on_main(params, str(Path(cfg.output) / "BEST.msgpack"))
    logger.info(f"best valid: {best:.4f}")
    return best


def run(task: str, argv=None):
    from xlxmert_tpu_torch.cli.args import (
        base_parser, make_model_config, to_finetune_config,
    )

    p = base_parser()
    p.set_defaults(train="train,nominival", valid="minival", lr=5e-5,
                   epochs=10, batch_size=32)
    ns = p.parse_args(argv)
    cfg = to_finetune_config(ns, task)

    from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint
    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.data.answer_table import AnswerTable
    from xlxmert_tpu_torch.data.datasets import (
        GQADataset, NLVR2Dataset, VQADataset,
    )
    from xlxmert_tpu_torch.data.fast_tokenizer import (
        FastTokenizer as Tokenizer,
    )
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine
    from xlxmert_tpu_torch.utils.device import resolve_device

    pmesh.maybe_initialize_multihost(ns.device)
    resolve_device(ns.device)
    logger = RunLogger(cfg.output, cfg, enabled=pmesh.is_main())
    tokenizer = Tokenizer(ns.vocab)
    root = Path(ns.data_root)
    ds_cls = {"vqa": VQADataset, "gqa": GQADataset,
              "nlvr2": NLVR2Dataset}[task]
    kw = dict(max_text_length=cfg.max_text_length, grid_size=cfg.grid_size)
    test_mode = cfg.test is not None or cfg.test_only
    train_ds = None
    if not test_mode:
        train_ds = ds_cls.from_files(root, cfg.train, tokenizer,
                                     encoder=cfg.encoder,
                                     topk=cfg.train_topk, **kw)
        train_ds.shard(pmesh.rank(), pmesh.world_size())
    eval_ds = ds_cls.from_files(root, cfg.test or cfg.valid, tokenizer,
                                encoder=cfg.encoder, topk=cfg.valid_topk,
                                **kw)
    num_answers = 2 if task == "nlvr2" else (train_ds or eval_ds).num_answers
    label2ans = None if task == "nlvr2" else (train_ds or eval_ds).label2ans

    steps_per_epoch = max(pmesh.agree_min(len(train_ds) if train_ds else 0)
                          // cfg.batch_size, 1)
    eng = FinetuneEngine(cfg, num_answers, model_cfg=make_model_config(ns),
                         total_steps=max(steps_per_epoch * cfg.epochs, 1),
                         train_attention=ns.train_attention,
                         device=ns.device)
    state = eng.create_state(cfg.seed)

    # checkpoint loading (vqa.py:53-62 + QA-head surgery)
    if cfg.load:
        merged, _ = eng.load_pretrained(state.params(),
                                        load_any_checkpoint(cfg.load))
        state.load_params(merged)
    elif cfg.load_lxmert_qa:
        table = AnswerTable(root / "lxmert" / "all_ans.json")
        merged, counts = eng.load_pretrained(
            state.params(), load_any_checkpoint(cfg.load_lxmert_qa),
            label2ans=label2ans, answer_table=table)
        logger.info(f"QA surgery: loaded {counts[0]}, zeroed {counts[1]}")
        state.load_params(merged)
    elif cfg.load_lxmert:
        merged, _ = eng.load_pretrained(state.params(),
                                        load_any_checkpoint(cfg.load_lxmert))
        state.load_params(merged)

    if test_mode:
        out = str(Path(cfg.output) / f"{task}_{cfg.test or cfg.valid}_predict"
                  f"{'.csv' if task == 'nlvr2' else '.json'}")
        evaluate(eng, state.model, eval_ds, cfg, label2ans, test_mode=True,
                 dump_path=out)
        logger.info(f"dumped predictions to {out}")
    else:
        finetune(eng, state, train_ds, eval_ds, cfg, logger, label2ans)
    logger.close()

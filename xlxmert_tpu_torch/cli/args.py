"""Argparse bridge (port of xlxmert_tpu/cli/args.py): the JAX CLI's
flag surface, which keeps the reference's (x-lxmert/src/param.py:61-279),
plus `--device`.

Accepted without effect, as in the JAX CLI: `--multiGPU`,
`--distributed`, `--numWorkers`, `--tqdm`, and here also `--rng_impl`
(a JAX PRNG choice; the port draws dropout from a torch.Generator).
`--profile` traces pre-training steps with torch.profiler; fine-tuning
accepts it without effect, as the JAX CLI does. `cli/serve` and
`cli/sample_images` parse their own flags and take `--profile DIR` in
the same sense: the batches after the first one traced into DIR, with
the program's stage spans (utils/profiling.span) as ranges of the
Chrome trace. Fine-tuning reads none of the pre-training flags (task
mix, masking, clustering, the h5 overrides, `--bert_weights`), as in
the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses

from xlxmert_tpu_torch.core.config import FinetuneConfig, TrainConfig


def base_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # data splits (param.py:63-68)
    p.add_argument("--train", default="mscoco_train,mscoco_nominival,vgnococo")
    p.add_argument("--valid", default="mscoco_minival")
    p.add_argument("--test", default=None)
    # optimization (param.py:70-76)
    p.add_argument("--batchSize", dest="batch_size", type=int, default=256)
    p.add_argument("--optim", default="adamw")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--seed", type=int, default=9595)
    p.add_argument("--warmup_ratio", type=float, default=0.05)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--clip_grad_norm", type=float, default=1.0)
    p.add_argument("--update_freq", type=int, default=1)
    # io (param.py:79-91)
    p.add_argument("--output", default="snap/test")
    p.add_argument("--load", default=None)
    p.add_argument("--loadLXMERT", dest="load_lxmert", default=None)
    p.add_argument("--loadLXMERTQA", dest="load_lxmert_qa", default=None)
    p.add_argument("--fromScratch", dest="from_scratch", action="store_true",
                   help="skip BERT-pretrained init (reference param.py:90-93)")
    p.add_argument("--bert_weights", default=None,
                   help="bert-base-uncased torch state_dict (.bin/.pth) for "
                   "the reference-default BERT init of the language stack "
                   "(lxmert_pretrain.py:58-61); required because this "
                   "environment cannot download from the HF hub")
    p.add_argument("--save_full_state", action="store_true",
                   help="also save Epoch%%02d_FULL.msgpack (params + "
                   "optimizer + step) for an exact resume; --load of a "
                   "_FULL checkpoint restores the optimizer moments and "
                   "the LR-schedule position")
    p.add_argument("--comment", default="")
    # model shape (param.py:107-112)
    p.add_argument("--llayers", type=int, default=9)
    p.add_argument("--xlayers", type=int, default=5)
    p.add_argument("--rlayers", type=int, default=5)
    p.add_argument("--model_config", default=None,
                   help="LxmertConfig yaml overriding all shape flags")
    # pretraining tasks (param.py:115-139)
    p.add_argument("--taskMatched", dest="task_matched", action="store_true")
    p.add_argument("--taskMaskLM", dest="task_mask_lm", action="store_true")
    p.add_argument("--taskObjPredict", dest="task_obj_predict",
                   action="store_true")
    p.add_argument("--taskQA", dest="task_qa", action="store_true")
    p.add_argument("--visualLosses", dest="visual_losses", default="obj")
    p.add_argument("--wordMaskRate", dest="word_mask_rate", type=float,
                   default=0.15)
    p.add_argument("--objMaskRate", dest="obj_mask_rate", type=float,
                   default=0.15)
    p.add_argument("--word_mask_predict", action="store_true")
    # bbox-path pretraining (param.py:172-173,246-247)
    p.add_argument("--target_obj_id", action="store_true")
    p.add_argument("--feed_exact_feat", action="store_true")
    p.add_argument("--target_exact_feat", action="store_true")
    p.add_argument("--bbox_h5", default=None,
                   help="boxes36 h5 override used for every data source "
                   "(default: reference per-source routing, "
                   "lxmert_pretrain.py:196-201)")
    p.add_argument("--grid_h5", default=None,
                   help="grid-feature h5 override used for every data "
                   "source on the exact-feature grid paths (default: "
                   "reference per-source routing, lxmert_data.py:186-193)")
    p.add_argument("--vis_mask_predict", action="store_true")
    p.add_argument("--square_mask", action="store_true")
    p.add_argument("--vis_mask_COCO_only", action="store_true")
    p.add_argument("--vis_mask_COCOVG_only", action="store_true")
    # geometry (param.py:145-147)
    p.add_argument("--grid_model", action="store_true")
    p.add_argument("--grid_size", type=int, default=8)
    p.add_argument("--feat_dim", type=int, default=2048)
    p.add_argument("--n_boxes", type=int, default=36)
    # clustering (param.py:163-177)
    p.add_argument("--clustering", action="store_true")
    p.add_argument("--num_clusters", type=int, default=10000)
    p.add_argument("--encoder", default="maskrcnn")
    p.add_argument("--cluster_src", default="mscoco_train")
    # debug (param.py:142-143,214,237)
    p.add_argument("--train_topk", type=int, default=-1)
    p.add_argument("--valid_topk", type=int, default=-1)
    p.add_argument("--dry", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--test_only", action="store_true")
    # accepted-for-compat process plumbing (no-ops)
    p.add_argument("--multiGPU", action="store_true")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--mixed_precision", action="store_true",
                   help="accepted for compat; bf16 is already the default")
    p.add_argument("--fp32", action="store_true",
                   help="disable bf16 compute (parity/debugging)")
    p.add_argument("--serve_int8", action="store_true",
                   help="run eval/test prediction through the int8 "
                   "serving engine (finetune CLIs)")
    p.add_argument("--rng_impl", default=None,
                   choices=["rbg", "threefry2x32", "unsafe_rbg"],
                   help="the JAX package's PRNG choice; accepted without "
                   "effect (dropout draws from a torch.Generator)")
    p.add_argument("--train_attention", default="xla",
                   choices=["xla", "pallas_blhd", "auto"],
                   help="training-path attention "
                   "(models/lxmert.train_attention_mode): pallas_blhd "
                   "runs every training attention through the "
                   "mha_blhd_train CUDA kernel with the dropout mask as "
                   "an operand and a plain PyTorch recompute backward; "
                   "xla (and auto) the einsum formulation")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="pre-training: trace N training steps of the "
                   "first epoch (after up to 5 warm-up steps) with "
                   "torch.profiler into <output>/profile, a Chrome trace "
                   "for TensorBoard/Perfetto; fine-tuning accepts it "
                   "without effect")
    p.add_argument("--mesh_shape", default=None,
                   type=lambda v: tuple(int(x) for x in v.split(",")),
                   help="the ranks' mesh, e.g. 2,2 (default: every rank "
                   "on the first axis; parallel/mesh.make_mesh)")
    p.add_argument("--mesh_axis_names", default=None,
                   type=lambda v: tuple(v.split(",")),
                   help="data | data,model (pre-training's tensor "
                   "parallelism) | data,pipe")
    p.add_argument("--numWorkers", dest="num_workers", type=int, default=4)
    p.add_argument("--tqdm", action="store_true")
    # host paths (new, replaces hardcoded ../datasets routing)
    p.add_argument("--data_root", default="data")
    p.add_argument("--vocab", default="data/vocab.txt",
                   help="bert-base-uncased vocab.txt path")
    p.add_argument("--centroid_path", default=None,
                   help="override centroid .npy path")
    p.add_argument("--cluster_pkl", default=None,
                   help="img_id -> cluster ids pickle path")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) or cpu, where every kernel "
                   "takes its plain PyTorch version")
    return p


_TRAIN_FIELDS = {f.name for f in dataclasses.fields(TrainConfig)}
_FT_FIELDS = {f.name for f in dataclasses.fields(FinetuneConfig)}


def to_train_config(ns: argparse.Namespace) -> TrainConfig:
    d = {k: v for k, v in vars(ns).items()
         if k in _TRAIN_FIELDS and v is not None}
    # bf16 compute is the default; --fp32 opts out (parity/debugging)
    d["mixed_precision"] = not getattr(ns, "fp32", False)
    return TrainConfig(**d)


def to_finetune_config(ns: argparse.Namespace, task: str) -> FinetuneConfig:
    d = {k: v for k, v in vars(ns).items() if k in _FT_FIELDS and v is not None}
    d["task"] = task
    # bf16 compute is the default; --fp32 opts out (parity/debugging)
    d["mixed_precision"] = not getattr(ns, "fp32", False)
    return FinetuneConfig(**d)


def make_model_config(ns: argparse.Namespace, **overrides):
    """LxmertConfig from --model_config yaml or the shape flags."""
    from xlxmert_tpu_torch.core.config import LxmertConfig

    if getattr(ns, "model_config", None):
        cfg = LxmertConfig.from_yaml(ns.model_config)
        return cfg.replace(**overrides) if overrides else cfg
    return LxmertConfig(l_layers=ns.llayers, x_layers=ns.xlayers,
                        r_layers=ns.rlayers, **overrides)

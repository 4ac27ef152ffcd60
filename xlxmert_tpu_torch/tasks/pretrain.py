"""Pre-training engine (port of xlxmert_tpu/tasks/pretrain.py): per-task
train and eval steps over the task round-robin, bf16 compute.

The reference's behaviour, as the JAX package reproduces it
(lxmert_pretrain.py:45-686):
  - task = MASK_MODALITY[step % len(MASK_MODALITY)] (:295-298);
  - AdamW with linear warmup/decay and no-decay groups (:110-141), grad
    clipping (:343-353);
  - masks and labels built on the device inside the step
    (`build_inputs_and_labels`, ops/masking.py), or read from
    host-masked batches (masked_word_id / word_label / vis_mask);
  - torch's grad-is-None skip: a parameter that the task's loss does not
    reach keeps its moments and step count. Autograd gives such a
    parameter a None gradient (`torch.autograd.grad(...,
    allow_unused=True)`); `used_param_mask` says which parameters the
    task reaches, as the JAX package decides it from the parameter's
    path; the step checks that the two agree and passes the set to the
    optimizer (`ReferenceAdamW.step(grads, used=...)`).

The masks and the dropout draw from the state's `torch.Generator` on
the device, reseeded before every training step from the run's seed,
the step and the rank's data index (`step_seed`), as the JAX package
folds the step into its PRNG key (the bits differ): a run resumed from
a full-state checkpoint draws what the uninterrupted run draws, data
ranks draw different masks, and the ranks of one model group the same.

The mesh comes from cfg.mesh_shape / cfg.mesh_axis_names (parallel/
mesh): ("data",) is data parallelism, ("data", "model") adds Megatron
tensor parallelism (parallel/sharding: each rank holds its slices of
the q/k/v, intermediate and output projections and H/tp heads). The
gradients are averaged over the data group; the clip's global norm sums
the sharded leaves' squares over the model group and counts each
replicated leaf once. The losses are the global batch's.

A training step's stages are flat spans (utils/profiling.span), so each
launch falls in one: `xlt.train.inputs` (the batch's placement, the
masks and labels), `xlt.train.forward`, `xlt.train.loss`,
`xlt.train.backward` (autograd, and the data group's mean), then
`xlt.train.clip` (the global norm) and `xlt.train.optimizer` in
core/optim; `eval_step`'s forward takes the first three. Counters:
`xlt.train.steps.<task>` a step, and `xlt.train.params_skipped`, the
parameters the task's loss does not reach, which AdamW leaves.

`chained_train_step(task, k)` runs k steps with one fetch of their mean
loss at the end, on one placed batch or, with per_step_batches=True, on
the k slices of `place_stacked`'s stacked batches, as the JAX package's
lax.scan does. The steps are eager, each exactly a `train_step` on a
placed batch, so k chained steps compute what k sequential ones compute
(bit for bit on the CPU; on the card as closely as two sequential runs
agree, its atomics aside), and no host synchronization sits between
them. A CUDA graph of the step
would cut the host's dispatch, which bounds a step on the card, but its
replays would bypass the kernel wrappers' launch counts that show a run
went through `mha_blhd_train`: that is speed work for a later change.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Set, Tuple

import numpy as np
import torch

from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
from xlxmert_tpu_torch.core.convert import (
    convert_torch_state_dict, flax_to_state_dict,
)
from xlxmert_tpu_torch.core.optim import make_optimizer
from xlxmert_tpu_torch.models.xlxmert import (
    XLxmert, embed_clusters, get_word_embedding_matrix, pretrain_losses,
)
from xlxmert_tpu_torch.ops.masking import (
    random_word_mask, square_vis_mask, uniform_count_vis_mask,
)
from xlxmert_tpu_torch.parallel import mesh as pmesh
from xlxmert_tpu_torch.parallel.sharding import TensorParallel, shard_params
from xlxmert_tpu_torch.tasks.finetune import TrainState
from xlxmert_tpu_torch.utils.boxes import box_position
from xlxmert_tpu_torch.utils.device import resolve_device
from xlxmert_tpu_torch.utils.profiling import count, span

_LANG_TAILS = ("lang_self_att", "lang_inter", "lang_output")
_VISN_TAILS = ("visn_self_att", "visn_inter", "visn_output")


def _task_heads(task: str, cfg: TrainConfig) -> Tuple[str, ...]:
    """The heads one task computes (the JAX package's rule)."""
    heads = []
    if task == "word_mask":
        heads.append("lm")
    elif task == "matched":
        heads.append("matched")
    elif task == "vis_mask":
        for k in ("obj", "feat", "attr"):
            if k not in cfg.visual_loss_keys:
                continue
            # obj needs a label source: cluster ids or detector ids
            # (--target_obj_id); the reference computes no obj loss
            # otherwise (lxmert_pretrain.py:162-170)
            if k == "obj" and not (cfg.clustering or cfg.target_obj_id):
                continue
            # feat needs exact-feature labels, which only
            # --feed_exact_feat / --target_exact_feat load, or the bbox
            # path's features (lxmert_pretrain.py:733)
            if k == "feat" and not (cfg.feed_exact_feat
                                    or cfg.target_exact_feat
                                    or not cfg.grid_model):
                continue
            heads.append(k)
    if cfg.task_qa:
        heads.append("qa")
    return tuple(heads)


def run_heads(cfg: TrainConfig) -> Tuple[str, ...]:
    """Every head any task of the round-robin computes: the heads whose
    parameters the model holds (the JAX init's union)."""
    heads = set()
    for task in cfg.mask_modalities:
        heads.update(_task_heads(task, cfg))
    return tuple(sorted(heads))


def used_param_mask(names: Iterable[str], task: str,
                    cfg: TrainConfig) -> Set[str]:
    """The parameters (port names, "bert.encoder.x_layers.4....") that
    the task's loss reaches, decided from the name as the JAX package
    decides it from the flax path (lxmert_pretrain.py:334-366: the
    parameters torch's AdamW steps after loss.backward()):
      - the pooler feeds only the matched and QA heads;
      - the last cross layer's self-attention and FFN of one stream feed
        only that stream's output (the cross-attention reads the layer's
        inputs), so a loss on the other stream does not reach them;
      - cls.predictions is the LM head, cls.seq_relationship the matched
        head; the visual head, mask_feat and the QA head serve their
        tasks alone."""
    names = list(names)
    heads = _task_heads(task, cfg)
    lang_used = ("lm" in heads or "matched" in heads or task == "matched"
                 or cfg.task_qa)
    visn_used = any(k in heads for k in ("obj", "feat", "attr"))
    x_idx = [int(n.split(".")[3]) for n in names
             if n.startswith("bert.encoder.x_layers.")]
    last_x = f"bert.encoder.x_layers.{max(x_idx)}." if x_idx else None

    def used(name: str) -> bool:
        parts = name.split(".")
        top = parts[0]
        if top == "bert":
            if "pooler" in parts:
                return task == "matched" or cfg.task_qa
            if last_x and name.startswith(last_x):
                if any(p in _LANG_TAILS for p in parts):
                    return lang_used
                if any(p in _VISN_TAILS for p in parts):
                    return visn_used
            return True
        if top == "cls":
            return ("lm" if "predictions" in parts else "matched") in heads
        if top == "obj_predict_head":
            return visn_used
        if top == "mask_feat":
            return task == "vis_mask"
        if top == "answer_head":
            return "qa" in heads
        return True

    return {n for n in names if used(n)}


def build_inputs_and_labels(batch: Dict[str, torch.Tensor],
                            generator: Optional[torch.Generator], task: str,
                            cfg: TrainConfig, centroids: torch.Tensor,
                            compute_dtype, vocab_size: int = 30522,
                            mask_token_id: int = 103):
    """One task's model inputs and labels on the batch's device (the JAX
    package's rule, lxmert_pretrain.py:143-225 plus the collate-side
    masking): (input_ids, attention_mask, visual_feats, vis_mask or
    None, labels). Host-masked batches (masked_word_id + word_label,
    vis_mask) are used as given; otherwise the masks are drawn from
    `generator`."""
    labels: Dict[str, torch.Tensor] = {}
    cluster_id = batch.get("cluster_id")
    dev = batch["word_id"].device
    if task == "word_mask":
        if "masked_word_id" in batch:
            input_ids = batch["masked_word_id"]
            labels["word_labels"] = batch["word_label"]
        else:
            input_ids, labels["word_labels"] = random_word_mask(
                generator, batch["word_id"], cfg.word_mask_rate,
                vocab_size=vocab_size, mask_token_id=mask_token_id)
        vis_mask = None
    elif task == "matched":
        input_ids = batch["other_word_id"]
        labels["matched_labels"] = batch["matched_label"]
        vis_mask = None
    elif task == "vis_mask":
        # --vis_mask_COCO(VG)_only: a substitute example's caption, and
        # its cluster grid in clustering mode; feature and QA labels stay
        # the original example's, as in the reference
        # (lxmert_pretrain.py:594-599)
        if ((cfg.vis_mask_COCO_only or cfg.vis_mask_COCOVG_only)
                and "coco_word_id" in batch):
            input_ids = batch["coco_word_id"]
            if cfg.clustering:
                cluster_id = batch["coco_cluster_id"]
        else:
            input_ids = batch["word_id"]
        B = input_ids.shape[0]
        if "vis_mask" in batch:
            vis_mask = batch["vis_mask"].float()
        elif cfg.square_mask:
            vis_mask = square_vis_mask(generator, B, cfg.grid_size, dev)
        elif cfg.vis_mask_predict:
            vis_mask = uniform_count_vis_mask(generator, B, cfg.n_vis, dev)
        else:
            vis_mask = (torch.rand(B, cfg.n_vis, generator=generator,
                                   device=dev) < cfg.obj_mask_rate).float()
        ignore = torch.full((), -100, dtype=torch.long, device=dev)
        if "obj" in cfg.visual_loss_keys:
            obj_target = (cluster_id if cfg.clustering
                          else batch["obj_id"] if cfg.target_obj_id
                          else None)
            if obj_target is not None:
                labels["obj_labels"] = torch.where(vis_mask > 0,
                                                   obj_target.long(), ignore)
        # attr labels come only from an API caller's batch (no loader
        # emits them, in the reference either)
        if "attr" in cfg.visual_loss_keys and "attr_label" in batch:
            labels["attr_labels"] = torch.where(
                vis_mask > 0, batch["attr_label"].long(), ignore)
        if "feat" in cfg.visual_loss_keys and (
                cfg.feed_exact_feat or cfg.target_exact_feat
                or not cfg.grid_model):
            labels["feat_labels"] = batch["vis_feats"]
            labels["vis_mask"] = vis_mask
    else:
        raise ValueError(task)
    if cfg.task_qa:
        qa = batch["qa_label"]
        if task == "matched":
            # mismatched pairs cannot supervise QA (lxmert_pretrain.py:186)
            qa = torch.where(batch["matched_label"] == 0,
                             torch.full_like(qa, -100), qa)
        labels["qa_labels"] = qa
    if cfg.clustering:
        visual_feats = embed_clusters(cluster_id, centroids, compute_dtype)
    else:
        visual_feats = batch["vis_feats"].to(compute_dtype)
    return (input_ids, (input_ids > 0).float(), visual_feats, vis_mask,
            labels)


def step_seed(seed: int, step: int, data_index: int = 0) -> int:
    """The generator's seed for training step `step` of the run seeded
    with `seed`, on the ranks of data index `data_index` (0: the
    single-process stream)."""
    seed = seed ^ (data_index * 0x9E3779B1)
    return ((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF)


class PretrainEngine:
    """The model, its optimizer and the per-task steps. `train_attention`
    is the training attention route ("xla", "pallas_blhd" or "auto")."""

    def __init__(self, cfg: TrainConfig,
                 model_cfg: Optional[LxmertConfig] = None,
                 total_steps: int = 100_000, train_attention: str = "xla",
                 device="cuda", mesh: Optional[pmesh.Mesh] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg or LxmertConfig(
            num_clusters=cfg.num_clusters if cfg.clustering else 0)
        self.compute_dtype = (torch.bfloat16 if cfg.mixed_precision
                              else torch.float32)
        self.total_steps = total_steps
        self.train_attention = train_attention
        self.device = resolve_device(device)
        self.mesh = pmesh.only_axes(
            mesh or pmesh.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names),
            ("data", "model"), "pre-training")
        self.data_group = self.mesh.group("data")
        self.tp = TensorParallel.from_mesh(self.mesh)
        self.heads = run_heads(cfg)
        self.box_pos = torch.from_numpy(box_position(cfg.grid_size)).to(
            self.device)
        # the reference's [MASK] id, inside a small test vocabulary
        self.mask_token_id = min(103, self.model_cfg.vocab_size - 1)

    def build_model(self) -> XLxmert:
        """An fp32-parameter XLxmert with the run's heads
        (uninitialized)."""
        return XLxmert(self.model_cfg, self.compute_dtype, self.cfg.task_qa,
                       self.heads, train_attention=self.train_attention)

    # -- init ---------------------------------------------------------------
    def init_params(self, seed: int) -> Dict[str, Any]:
        """Fresh parameters as a flax tree, from numpy's generator: the
        flax initializers' distributions (normal(initializer_range)
        kernels and embeddings; zero biases, out_cluster_bias and
        mask_feat; unit LayerNorm scales)."""
        rng = np.random.default_rng(seed)
        std = np.float32(self.model_cfg.initializer_range)
        out = {}
        for name, t in self.build_model().state_dict().items():
            if name.endswith("bias") or name == "mask_feat":
                out[name] = torch.zeros(t.shape)
            elif t.dim() == 1:
                out[name] = torch.ones(t.shape)
            else:
                out[name] = torch.from_numpy(
                    rng.standard_normal(t.shape, dtype=np.float32) * std)
        return convert_torch_state_dict(out)

    def create_state(self, seed: int, params=None) -> TrainState:
        """The model on the engine's device holding `params` (a flax
        tree; init_params(seed) when None), its optimizer and the
        generator of the masks and the dropout, seeded with `seed` (and
        reseeded from it and the step before each training step)."""
        params = params if params is not None else self.init_params(seed)
        model = self.build_model()
        model.load_state_dict(flax_to_state_dict(params))
        model = model.to(self.device).train()
        if self.tp is not None:
            shard_params(model, self.tp)
        cfg = self.cfg
        opt = make_optimizer(dict(model.named_parameters()), cfg.lr,
                             self.total_steps, cfg.warmup_ratio,
                             cfg.weight_decay, cfg.clip_grad_norm,
                             cfg.adam_eps)
        if self.tp is not None:
            opt.norm = self.tp.global_norm
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(model, opt, gen, seed=seed, tp=self.tp)

    # -- steps --------------------------------------------------------------
    def place(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the engine's device (integers
        as int64, floats as fp32); uids and n_valid stay on the host."""
        out = {}
        for k, v in batch.items():
            if k in ("uids", "n_valid"):
                continue
            a = np.asarray(v)
            t = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                                 else a.astype(np.float32))
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def forward_losses(self, model: XLxmert, batch: Dict[str, torch.Tensor],
                       task: str, centroids: torch.Tensor,
                       generator: Optional[torch.Generator]
                       ) -> Dict[str, torch.Tensor]:
        """One task's forward on a placed batch: its losses (fp32), and
        qa_acc with the QA task. Dropout applies in train mode."""
        cfg = self.cfg
        with span("xlt.train.inputs"):
            input_ids, attn, feats, vis_mask, labels = \
                build_inputs_and_labels(
                    batch, generator, task, cfg, centroids,
                    self.compute_dtype, self.model_cfg.vocab_size,
                    self.mask_token_id)
            B = input_ids.shape[0]
            pos = (batch["boxes"] if "boxes" in batch
                   else self.box_pos[None].expand(B, *self.box_pos.shape))
        with span("xlt.train.forward"):
            out = model(input_ids, feats, pos, attention_mask=attn,
                        vis_mask=vis_mask, centroids=centroids,
                        word_embedding_matrix=get_word_embedding_matrix(
                            model),
                        heads=_task_heads(task, cfg),
                        generator=generator if model.training else None)
        with span("xlt.train.loss"):
            losses = pretrain_losses(out, labels, task,
                                     cfg.visual_loss_keys, cfg.task_qa)
            if "qa_pred" in losses:
                qa = labels["qa_labels"]
                valid = qa >= 0
                correct = (losses.pop("qa_pred") == qa) & valid
                losses["qa_acc"] = (correct.sum().float()
                                    / valid.sum().clamp(min=1))
        return losses

    def loss_and_grads(self, model: XLxmert, batch: Dict[str, torch.Tensor],
                       task: str, centroids: torch.Tensor,
                       generator: Optional[torch.Generator]):
        """One training forward and backward: (losses, {name: gradient or
        None}). A gradient is None exactly where the task's loss does not
        reach the parameter (checked against used_param_mask)."""
        model.train()
        losses = self.forward_losses(model, batch, task, centroids,
                                     generator)
        named = dict(model.named_parameters())
        with span("xlt.train.backward"):
            grads = dict(zip(named, torch.autograd.grad(
                losses["total_loss"], list(named.values()),
                allow_unused=True)))
        unused = {n for n, g in grads.items() if g is None}
        expected = set(named) - used_param_mask(named, task, self.cfg)
        if unused != expected:
            raise RuntimeError(
                f"{task}: autograd leaves {sorted(unused ^ expected)[:5]} "
                "otherwise than used_param_mask says (None gradients "
                f"{len(unused)}, expected {len(expected)})")
        return {k: v.detach() for k, v in losses.items()}, grads

    def train_step(self, state: TrainState, batch: Dict[str, Any], task: str,
                   centroids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One optimizer step of `task` on a host batch: the parameters
        its loss reaches are updated, the others keep their moments and
        counts. Returns the losses and the global gradient norm as
        device tensors."""
        with span("xlt.train.inputs"):
            placed = self.place(batch)
        return self.placed_train_step(state, placed, task, centroids)

    def placed_train_step(self, state: TrainState,
                          batch: Dict[str, torch.Tensor], task: str,
                          centroids: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
        """`train_step` on a batch already on the engine's device (as
        `place` gives it). The generator is reseeded from the run's
        seed, the step and the rank's data index first."""
        state.generator.manual_seed(step_seed(
            state.seed, state.step, self.mesh.index("data")))
        losses, grads = self.loss_and_grads(state.model, batch, task,
                                            centroids, state.generator)
        # the same set on every rank: used_param_mask decides it
        used = {n for n, g in grads.items() if g is not None}
        with span("xlt.train.backward"):
            grads = pmesh.all_reduce_mean(grads, self.data_group)
            losses = pmesh.mean_over(losses, self.data_group)
        with span("xlt.train.clip"):
            # in the parameters' order (a set's order differs between
            # processes, and so would the sum's rounding)
            losses["grad_norm"] = state.opt.norm(
                {n: g for n, g in grads.items() if n in used})
        # the clip's norm is this one: one global norm a step
        state.opt.step(grads, used=used, norm=losses["grad_norm"])
        state.step += 1
        count(f"xlt.train.steps.{task}")
        count("xlt.train.params_skipped", len(grads) - len(used))
        return losses

    def chained_train_step(self, task: str, k: int,
                           per_step_batches: bool = False):
        """k training steps of `task` with one result at the end (the
        JAX package's lax.scan of its step). Returns fn(state, batch,
        centroids) -> (state, the mean total_loss over the k steps as a
        device tensor); nothing in between waits for the card.

        per_step_batches=False: all k steps train on the same placed
        batch (only the generator's stream differs from step to step), a
        device-rate measurement and no substitute for k batches.
        per_step_batches=True: `batch` is `place_stacked`'s (k, B, ...)
        and step i trains on slice i, which equals k sequential
        train_step calls on the k host batches."""
        if k < 1:
            raise ValueError(f"chained_train_step: k = {k} < 1")

        def many(state: TrainState, batch: Dict[str, torch.Tensor],
                 centroids: torch.Tensor):
            losses = []
            for i in range(k):
                b = ({n: t[i] for n, t in batch.items()}
                     if per_step_batches else batch)
                losses.append(self.placed_train_step(
                    state, b, task, centroids)["total_loss"])
            return state, torch.stack(losses).mean()

        return many

    def place_stacked(self, batches) -> Dict[str, torch.Tensor]:
        """k host batches (this rank's own, as `place` takes them) stacked
        to (k, B, ...) tensors on the engine's device: the JAX package's
        per-process input of k chained steps."""
        placed = [self.place(b) for b in batches]
        return {k: torch.stack([p[k] for p in placed]) for k in placed[0]}

    @torch.no_grad()
    def eval_step(self, model: XLxmert, batch: Dict[str, Any], task: str,
                  centroids: torch.Tensor,
                  generator: Optional[torch.Generator]
                  ) -> Dict[str, torch.Tensor]:
        """`task`'s losses on a host batch without dropout; the masks draw
        from `generator`."""
        was_training = model.training
        model.eval()
        try:
            return self.forward_losses(model, self.place(batch), task,
                                       centroids, generator)
        finally:
            model.train(was_training)

    def task_for_step(self, step: int) -> str:
        mods = self.cfg.mask_modalities
        return mods[step % len(mods)]

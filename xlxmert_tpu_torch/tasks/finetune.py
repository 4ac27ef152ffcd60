"""Shared fine-tuning engine for VQA / GQA / NLVR2 (port of
xlxmert_tpu/tasks/finetune.py).

One engine covers the three tasks of the reference (tasks/vqa.py,
gqa.py, nlvr2.py), parameterized by:
  - loss: BCE-with-logits against soft targets (VQA/GQA, vqa.py:73,187)
    or CE against hard labels (NLVR2, nlvr2.py:72,171);
  - model: VQAModel (pooled [CLS] head) or NLVR2Model (2-image concat).

Optimization follows the reference as the JAX package does: the legacy
AdamW of core/optim.py, linear warmup/decay, grad clipping and the
`update_freq` accumulation of raw gradient SUMS (vqa.py:151-198): step
0 never updates, every update_freq-th step and the epoch's last one do,
the clip applies to the sum and the schedule steps only on updates.

The state (`TrainState`) holds the model, whose fp32 parameters the
optimizer updates in place, the optimizer, the accumulator and the
dropout generator. The model computes in bf16 with `mixed_precision`.
`predict` runs the eval forward, or the int8 engine calibrated on the
first `calib_batches` batches (`int8=True`, the CLI's --serve_int8).
One process: the JAX package's multi-host predict and its device mesh
come with distributed training.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.core.config import FinetuneConfig, LxmertConfig
from xlxmert_tpu_torch.core.convert import (
    convert_torch_state_dict, flax_to_state_dict,
)
from xlxmert_tpu_torch.core.optim import (
    ReferenceAdamW, global_norm, make_optimizer,
)
from xlxmert_tpu_torch.models.task_heads import NLVR2Model, VQAModel
from xlxmert_tpu_torch.utils.device import resolve_device


def should_update(step_i: int, n_batches: int, update_freq: int) -> bool:
    """The reference's update_freq gate (vqa.py:151-159): with
    accumulation, step 0 never updates (the first update at step k
    covers k+1 batches), then every k-th step does, plus the epoch's
    last batch."""
    if update_freq <= 1:
        return True
    if step_i == 0:
        return False
    return step_i % update_freq == 0 or step_i == n_batches - 1


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary CE with logits against soft targets, fp32, without the
    original LXMERT's `* num_answers` scaling (the reference's recipe,
    vqa.py:187)."""
    logits = logits.float()
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits)).mean()


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


@torch.no_grad()
def accumulate_or_apply(opt: ReferenceAdamW,
                        acc: Optional[Dict[str, torch.Tensor]],
                        grads: Dict[str, Optional[torch.Tensor]],
                        do_update: bool) -> None:
    """Without an accumulator, one optimizer step on `grads`. With one
    (update_freq > 1), the JAX package's AccumTrainState: add the raw
    gradients to the sum (loss.backward's semantics, not a mean), and
    when `do_update` step the optimizer on the sum and zero it."""
    if acc is None:
        opt.step(grads)
        return
    for name, g in grads.items():
        if g is not None:
            acc[name].add_(g)
    if do_update:
        opt.step(acc)
        for a in acc.values():
            a.zero_()


@dataclasses.dataclass
class TrainState:
    """The model (its fp32 parameters are the trained ones), the
    optimizer over them, the raw gradient-sum accumulator (update_freq
    > 1), the dropout generator, the step count, and the run's seed
    (pre-training reseeds the generator from it and the step)."""

    model: nn.Module
    opt: ReferenceAdamW
    generator: torch.Generator
    acc: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0
    seed: int = 0

    def params(self) -> Dict[str, Any]:
        """The parameters as the JAX package's flax tree (numpy)."""
        return convert_torch_state_dict(self.model.state_dict())

    def load_params(self, tree: Dict[str, Any]) -> None:
        with torch.no_grad():
            for name, t in flax_to_state_dict(tree).items():
                self.opt.params[name].copy_(t)


def _check_single_process() -> None:
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 or (torch.distributed.is_available()
                     and torch.distributed.is_initialized()
                     and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "fine-tuning runs in one process; the JAX package's multi-host "
            "training and predict are not ported yet")


class FinetuneEngine:
    """task in {"vqa", "gqa", "nlvr2"}. `train_attention` is the training
    attention route ("xla", "pallas_blhd" or "auto"; the JAX CLI's
    --train_attention)."""

    def __init__(self, cfg: FinetuneConfig, num_answers: int,
                 model_cfg: Optional[LxmertConfig] = None,
                 total_steps: int = 10_000, train_attention: str = "xla",
                 device="cuda"):
        _check_single_process()
        self.cfg = cfg
        self.task = cfg.task
        self.num_answers = num_answers
        self.model_cfg = model_cfg or LxmertConfig()
        self.compute_dtype = (torch.bfloat16 if cfg.mixed_precision
                              else torch.float32)
        self.total_steps = total_steps
        self.train_attention = train_attention
        self.update_freq = cfg.update_freq
        self.device = resolve_device(device)

    def build_model(self, train_attention: Optional[str] = None
                    ) -> nn.Module:
        """An fp32-parameter model of the task (uninitialized)."""
        cls = NLVR2Model if self.task == "nlvr2" else VQAModel
        return cls(self.model_cfg, self.num_answers, self.compute_dtype,
                   train_attention=train_attention or self.train_attention)

    # -- init ---------------------------------------------------------------
    def init_params(self, seed: int) -> Dict[str, Any]:
        """Fresh parameters as a flax tree, from numpy's generator: the
        flax initializers' distributions (normal(initializer_range)
        kernels and embeddings, zero biases, unit LayerNorm scales)."""
        rng = np.random.default_rng(seed)
        std = np.float32(self.model_cfg.initializer_range)
        out = {}
        for name, t in self.build_model().state_dict().items():
            if name.endswith(".bias"):
                out[name] = torch.zeros(t.shape)
            elif t.dim() == 1:
                out[name] = torch.ones(t.shape)
            else:
                out[name] = torch.from_numpy(
                    rng.standard_normal(t.shape, dtype=np.float32) * std)
        return convert_torch_state_dict(out)

    def create_state(self, seed: int, params=None) -> TrainState:
        """Model on the engine's device holding `params` (a flax tree;
        init_params(seed) when None), its optimizer, and a dropout
        generator seeded with `seed`."""
        params = params if params is not None else self.init_params(seed)
        model = self.build_model()
        model.load_state_dict(flax_to_state_dict(params))
        model = model.to(self.device).train()
        named = dict(model.named_parameters())
        cfg = self.cfg
        opt = make_optimizer(named, cfg.lr, self.total_steps,
                             cfg.warmup_ratio, cfg.weight_decay,
                             cfg.clip_grad_norm, cfg.adam_eps)
        acc = ({n: torch.zeros_like(p) for n, p in named.items()}
               if self.update_freq > 1 else None)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(model, opt, gen, acc)

    def load_pretrained(self, params, pretrain_params, label2ans=None,
                        answer_table=None):
        """Overlay converted pretrain weights (bert + optional QA-head
        surgery) onto fresh fine-tuning params (flax trees)."""
        from xlxmert_tpu_torch.core.checkpoint import merge_params

        new = dict(params)
        if "bert" in pretrain_params:
            new["bert"], _, _ = merge_params(params["bert"],
                                             pretrain_params["bert"])
        if (label2ans is not None and answer_table is not None
                and "answer_head" in pretrain_params):
            from xlxmert_tpu_torch.data.answer_table import (
                surgery_answer_head,
            )

            return surgery_answer_head(pretrain_params, new, answer_table,
                                       label2ans)
        return new, None

    # -- steps --------------------------------------------------------------
    def place(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host numpy batch -> tensors on the engine's device."""
        out = {}
        for k, v in batch.items():
            if k in ("question_ids", "n_valid"):
                continue
            t = torch.as_tensor(np.asarray(v))
            if k in ("word_ids", "labels"):
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def logits(self, model: nn.Module, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ids = batch["word_ids"]
        return model(ids, batch["vis_feats"], batch["boxes"],
                     attention_mask=(ids > 0).float(), generator=generator)

    def loss_and_grads(self, model: nn.Module,
                       batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator]):
        """One training forward and backward: (loss, argmax predictions,
        {name: gradient or None}); None where the loss does not reach
        the parameter."""
        model.train()
        logits = self.logits(model, batch, generator)
        if self.task == "nlvr2":
            loss = softmax_ce(logits, batch["labels"])
        else:
            loss = bce_with_logits(logits, batch["targets"])
        named = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        return loss.detach(), logits.argmax(-1), dict(zip(named, grads))

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   do_update: bool = True) -> Dict[str, torch.Tensor]:
        """One step on a host batch. With update_freq > 1 the gradients
        are summed into the accumulator and the optimizer steps on the
        sum only when `do_update` (should_update's gate); else it steps
        every call. Returns loss, pred and the batch's pre-clip global
        gradient norm, as device tensors."""
        loss, pred, grads = self.loss_and_grads(
            state.model, self.place(batch), state.generator)
        grad_norm = global_norm([g for g in grads.values() if g is not None])
        accumulate_or_apply(state.opt, state.acc, grads, do_update)
        state.step += 1
        return {"loss": loss, "pred": pred, "grad_norm": grad_norm}

    # -- prediction -----------------------------------------------------------
    def _make_int8_predict(self, model: nn.Module, calib_batches):
        """An int8 predict step (serving/lxmert_int8.py) statically
        calibrated on `calib_batches` (host batches), built from the
        model's current parameters."""
        from xlxmert_tpu_torch.serving import lxmert_int8 as engine

        tree = convert_torch_state_dict(model.state_dict())
        head = tree["logit_fc" if self.task == "nlvr2" else "answer_head"]
        qp = engine.prepare_params(tree["bert"], self.model_cfg, self.device)
        hqp = engine.prepare_answer_head(head, self.device)
        fwd = (engine.nlvr2_forward if self.task == "nlvr2"
               else engine.vqa_forward)

        def unpack(batch):
            b = self.place(batch)
            ids = b["word_ids"]
            return ids, b["vis_feats"], b["boxes"], (ids > 0).float()

        engine.calibrate(qp, hqp, [unpack(b) for b in calib_batches],
                         self.model_cfg, forward=fwd)
        engine.apply_calibration(qp, hqp)
        engine.assert_fully_calibrated(qp, hqp)
        n_heads = self.model_cfg.num_attention_heads

        @torch.inference_mode()
        def run(batch):
            ids, feats, pos, mask = unpack(batch)
            return fwd(qp, hqp, ids, feats, pos, attention_mask=mask,
                       n_heads=n_heads).argmax(-1)

        return run

    def predict(self, model: nn.Module, batches: Iterable[Dict[str, Any]],
                label2ans=None, int8: bool = False, calib_batches: int = 4
                ) -> Dict[Any, Any]:
        """quesid -> answer over host batches (mapped through label2ans
        when given, else label ids), as Trainer.predict (vqa.py:259-295).
        The eval forward of `model`, or with int8=True the int8 engine
        calibrated on the first `calib_batches` batches (held back, then
        served through the calibrated step)."""
        _check_single_process()
        quesid2ans: Dict[Any, Any] = {}

        def emit(qids, n_valid, preds):
            for qid, p in zip(qids[:n_valid], preds.tolist()):
                quesid2ans[qid] = label2ans[p] if label2ans is not None else p

        step, held = None, []
        was_training = model.training
        model.eval()
        try:
            for batch in batches:
                batch = dict(batch)
                qids = batch.pop("question_ids")
                n_valid = batch.pop("n_valid", len(qids))
                if not int8:
                    with torch.inference_mode():
                        preds = self.logits(model, self.place(batch)
                                            ).argmax(-1)
                    emit(qids, n_valid, preds.cpu())
                    continue
                if step is None:
                    held.append((qids, n_valid, batch))
                    if len(held) < calib_batches:
                        continue
                    step = self._make_int8_predict(
                        model, [b for _, _, b in held])
                    for hq, hn, hb in held:
                        emit(hq, hn, step(hb).cpu())
                    held = []
                    continue
                emit(qids, n_valid, step(batch).cpu())
            if held:  # a stream shorter than the calibration window
                step = self._make_int8_predict(model,
                                               [b for _, _, b in held])
                for hq, hn, hb in held:
                    emit(hq, hn, step(hb).cpu())
        finally:
            model.train(was_training)
        return quesid2ans

"""X-LXMERT pre-training model and losses (port of
xlxmert_tpu/models/xlxmert.py).

The reference's `XLxmertForPretraining` (x-lxmert/src/lxrt/
modeling.py:56-308): the visual input comes from a frozen centroid table
indexed by cluster ids, masked cells are replaced by a learned
`mask_feat` vector, and each task's loss (MLM CE, matched CE, visual
cluster CE, feature SmoothL1, QA CE) is computed from the backbone's
outputs. As in the JAX package:
  - weights are tied by value: the word-embedding matrix and the
    centroid table are passed to `forward`, and the centroid table is an
    input, not a parameter (it is frozen in the reference);
  - `heads` names the outputs a call computes ("lm", "matched", "obj",
    "feat", "attr", "qa"); a head left out gets no gradient, so
    autograd's None gradients are the JAX package's per-task
    optimizer mask (tasks/pretrain.used_param_mask);
  - the model holds only the heads' parameters that flax creates at
    init for the union of the run's tasks (`XLxmert(heads=...)`), so
    `core/convert.flax_to_state_dict` carries a JAX tree across.
Losses are computed in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.models.lxmert import (
    EXACT, LxmertModel, PreTrainingHeads, ServingOptions, VisualAnswerHead,
    VisualObjHead,
)

OBJ_KEYS = ("obj", "feat", "attr")


class XLxmert(nn.Module):
    """Backbone + pre-training heads + the learned `mask_feat`. `heads`:
    every head any of the run's tasks computes (the JAX init's union)."""

    def __init__(self, cfg: LxmertConfig, dtype=torch.float32,
                 task_qa: bool = False,
                 heads: Tuple[str, ...] = ("lm", "matched"),
                 options: ServingOptions = EXACT,
                 train_attention: str = "xla"):
        super().__init__()
        self.config, self.dtype, self.task_qa = cfg, dtype, task_qa
        self.bert = LxmertModel(cfg, dtype, options, train_attention)
        if "lm" in heads or "matched" in heads:
            self.cls = PreTrainingHeads(cfg, options)
        obj_keys = tuple(k for k in OBJ_KEYS if k in heads)
        if obj_keys:
            self.obj_predict_head = VisualObjHead(cfg, obj_keys, options)
        if task_qa:
            self.answer_head = VisualAnswerHead(cfg, cfg.num_qa_labels,
                                                options)
        # substituted at masked cells (reference modeling.py:92,190-193)
        self.mask_feat = nn.Parameter(torch.zeros(cfg.visual_feat_dim))

    def encode(self, input_ids, visual_feats, visual_pos,
               attention_mask=None, vis_mask=None, token_type_ids=None,
               generator: Optional[torch.Generator] = None):
        """Optional mask-feat substitution, then the backbone."""
        if vis_mask is not None:
            visual_feats = torch.where(
                vis_mask[..., None] > 0,
                self.mask_feat.to(visual_feats.dtype)[None, None, :],
                visual_feats)
        return self.bert(input_ids, visual_feats, visual_pos,
                         attention_mask=attention_mask,
                         token_type_ids=token_type_ids, generator=generator)

    def forward(self, input_ids, visual_feats, visual_pos,
                attention_mask=None, vis_mask=None, token_type_ids=None,
                centroids=None, word_embedding_matrix=None,
                heads: Tuple[str, ...] = ("lm", "matched"),
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The backbone and the requested heads: a dict of outputs."""
        lang, visn, pooled = self.encode(input_ids, visual_feats,
                                         visual_pos, attention_mask,
                                         vis_mask, token_type_ids, generator)
        out = {"lang_output": lang, "visual_output": visn,
               "pooled_output": pooled}
        if "lm" in heads or "matched" in heads:
            lm, matched = self.cls(lang, pooled, word_embedding_matrix,
                                   lm="lm" in heads,
                                   matched="matched" in heads)
            if lm is not None:
                out["lm_logits"] = lm
            if matched is not None:
                out["matched_logits"] = matched
        obj_keys = tuple(k for k in OBJ_KEYS if k in heads)
        if obj_keys:
            head_out = self.obj_predict_head(visn, centroids,
                                             out_keys=obj_keys)
            for key, name in (("obj", "obj_logits"), ("feat", "feat_pred"),
                              ("attr", "attr_logits")):
                if key in head_out:
                    out[name] = head_out[key]
        if "qa" in heads and self.task_qa:
            out["qa_logits"] = self.answer_head(pooled)
        return out


def embed_clusters(cluster_ids: torch.Tensor, centroids: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Cluster ids (B, V) -> visual features (B, V, D) from the frozen
    centroid table (reference modeling.py:185-186)."""
    return F.embedding(cluster_ids.long(), centroids).to(dtype)


def cross_entropy_ignore(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the positions with label >= 0 (the reference's
    ignore_index=-100 and its -1 MLM labels alike)."""
    logits = logits.float()
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    nll = -F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    n = valid.sum().clamp(min=1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / n


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise SmoothL1 (beta 1), torch's SmoothL1Loss."""
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_feat_loss(pred: torch.Tensor, target: torch.Tensor,
                     vis_mask: torch.Tensor) -> torch.Tensor:
    """SmoothL1, mean over the feature dim, masked mean over cells, mean
    over the batch (reference modeling.py:273-287)."""
    per_cell = smooth_l1(pred.float(), target.float()).mean(2)
    masked = (per_cell * vis_mask).sum(1)
    return (masked / vis_mask.sum(1).clamp(min=1)).mean()


def pretrain_losses(out: Dict[str, torch.Tensor],
                    labels: Dict[str, torch.Tensor], task: str,
                    visual_loss_keys: Tuple[str, ...] = ("obj",),
                    task_qa: bool = False) -> Dict[str, torch.Tensor]:
    """One task's losses and their total (reference modeling.py:216-304).
    labels: word_labels | matched_labels | obj_labels, attr_labels,
    feat_labels + vis_mask | qa_labels."""
    losses: Dict[str, torch.Tensor] = {}
    dev = next(iter(out.values())).device
    total = torch.zeros((), device=dev)
    if task == "word_mask":
        losses["lm_loss"] = cross_entropy_ignore(out["lm_logits"],
                                                 labels["word_labels"])
        total = total + losses["lm_loss"]
    elif task == "matched":
        losses["matched_loss"] = cross_entropy_ignore(
            out["matched_logits"], labels["matched_labels"])
        total = total + losses["matched_loss"]
    elif task == "vis_mask":
        vis_total = torch.zeros((), device=dev)
        if "obj" in visual_loss_keys and "obj_logits" in out:
            losses["obj_loss"] = cross_entropy_ignore(out["obj_logits"],
                                                      labels["obj_labels"])
            vis_total = vis_total + losses["obj_loss"]
        if "attr" in visual_loss_keys and "attr_labels" in labels:
            losses["attr_loss"] = cross_entropy_ignore(out["attr_logits"],
                                                       labels["attr_labels"])
            vis_total = vis_total + losses["attr_loss"]
        if "feat" in visual_loss_keys and "feat_labels" in labels:
            losses["feat_loss"] = masked_feat_loss(
                out["feat_pred"], labels["feat_labels"], labels["vis_mask"])
            vis_total = vis_total + losses["feat_loss"]
        losses["vis_loss"] = vis_total
        total = total + vis_total
    if task_qa and "qa_logits" in out:
        losses["qa_loss"] = cross_entropy_ignore(out["qa_logits"],
                                                 labels["qa_labels"])
        losses["qa_pred"] = out["qa_logits"].argmax(-1)
        total = total + losses["qa_loss"]
    losses["total_loss"] = total
    return losses


def get_word_embedding_matrix(model: XLxmert) -> torch.Tensor:
    """The tied word-embedding table (the parameter itself: the LM
    decoder's gradient adds to the embedding lookup's)."""
    return model.bert.embeddings.word_embeddings.weight

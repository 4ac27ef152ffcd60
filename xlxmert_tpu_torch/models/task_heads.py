"""Task models (port of xlxmert_tpu/models/task_heads.py).

`VQAModel` also serves GQA (the same shape): the backbone's pooled
[CLS] output through `VisualAnswerHead(num_answers)`. `NLVR2Model` takes
two images per example: (B, 2, V, D) features flattened to (2B, V, D),
the sentence repeated per image, the two pooled outputs concatenated
into a (B, 2*hidden) input of its `logit_fc` head. Both run the eval
forward in `model.eval()` and the training forward (dropout from
`generator`) in `model.train()`.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.core.convert import flax_to_state_dict
from xlxmert_tpu_torch.models.lxmert import (
    EXACT, LxmertModel, ServingOptions, VisualAnswerHead,
)
from xlxmert_tpu_torch.utils.device import resolve_device


class VQAModel(nn.Module):
    def __init__(self, cfg: LxmertConfig, num_answers: int,
                 dtype=torch.float32, options: ServingOptions = EXACT,
                 train_attention: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.bert = LxmertModel(cfg, dtype, options, train_attention)
        self.answer_head = VisualAnswerHead(cfg, num_answers, options)

    def forward(self, input_ids, visual_feats, visual_pos,
                attention_mask=None, token_type_ids=None, generator=None):
        _, _, pooled = self.bert(input_ids, visual_feats.to(self.dtype),
                                 visual_pos, attention_mask=attention_mask,
                                 token_type_ids=token_type_ids,
                                 generator=generator)
        return self.answer_head(pooled)


class NLVR2Model(nn.Module):
    """Two images per example (reference tasks/nlvr2_model.py:7-93, the
    original LXMERT NLVR2 head with a 2*hidden input)."""

    def __init__(self, cfg: LxmertConfig, num_answers: int = 2,
                 dtype=torch.float32, options: ServingOptions = EXACT,
                 train_attention: str = "xla"):
        super().__init__()
        self.dtype = dtype
        self.bert = LxmertModel(cfg, dtype, options, train_attention)
        self.logit_fc = VisualAnswerHead(cfg, num_answers, options,
                                         in_features=2 * cfg.hidden_size)

    def forward(self, input_ids, visual_feats, visual_pos,
                attention_mask=None, generator=None):
        """input_ids (B, L); visual_feats (B, 2, V, D); visual_pos
        (B, 2, V, 4)."""
        B, n_images, V, D = visual_feats.shape
        if n_images != 2:
            raise ValueError(f"NLVR2Model takes 2 images per example, got "
                             f"{n_images}")
        feats = visual_feats.reshape(B * 2, V, D).to(self.dtype)
        pos = visual_pos.reshape(B * 2, V, -1)
        # the sentence repeated per image (nlvr2.py:159)
        ids = input_ids.repeat_interleave(2, dim=0)
        mask = (attention_mask.repeat_interleave(2, dim=0)
                if attention_mask is not None else None)
        _, _, pooled = self.bert(ids, feats, pos, attention_mask=mask,
                                 generator=generator)
        return self.logit_fc(pooled.reshape(B, -1))


def vqa_model(params: Dict, cfg: LxmertConfig, num_answers: int, *,
              dtype=torch.float32, options: ServingOptions = EXACT,
              device="cuda") -> VQAModel:
    """A VQAModel on `device` holding the flax-layout tree `params`
    ({"bert": ..., "answer_head": ...}, numpy leaves), in eval mode.
    With dtype=bf16 every float parameter is cast to bf16, LayerNorm and
    bias vectors included, as cli/serve's --bf16 casts the tree."""
    dev = resolve_device(device)
    model = VQAModel(cfg, num_answers, dtype, options)
    model.load_state_dict(flax_to_state_dict(
        {"bert": params["bert"], "answer_head": params["answer_head"]}))
    return model.to(dev, dtype).eval()

"""Task models (port of xlxmert_tpu/models/task_heads.py).

`VQAModel` also serves GQA (the same shape): the backbone's pooled
[CLS] output through `VisualAnswerHead(num_answers)`. `NLVR2Model` is
not ported yet.
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
                 dtype=torch.float32, options: ServingOptions = EXACT):
        super().__init__()
        self.dtype = dtype
        self.bert = LxmertModel(cfg, dtype, options)
        self.answer_head = VisualAnswerHead(cfg, num_answers, options)

    def forward(self, input_ids, visual_feats, visual_pos,
                attention_mask=None, token_type_ids=None):
        _, _, pooled = self.bert(input_ids, visual_feats.to(self.dtype),
                                 visual_pos, attention_mask=attention_mask,
                                 token_type_ids=token_type_ids)
        return self.answer_head(pooled)


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

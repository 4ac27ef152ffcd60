"""Non-maximum suppression (port of xlxmert_tpu/ops/nms.py), the
building block of the bbox-feature path (the reference's per-class CUDA
NMS, feature_extraction/coco_extract_bbox_feature.py:91-129).

The JAX package's fixed-round semantics: exactly `max_out` rounds, each
committing the highest-scoring live box (the first on a tie, as argmax)
and suppressing its neighbours with IoU above the threshold. Slots past
the surviving boxes hold valid=False and the index argmax gives once
every box is suppressed. Batched over leading dimensions in place of the
JAX package's vmap. A Python loop of a few small ops a round on the card
(eager), plain PyTorch on either device.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e9


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xyxy -> (..., N, N) IoU."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    area = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    ix0 = torch.maximum(x0[..., :, None], x0[..., None, :])
    iy0 = torch.maximum(y0[..., :, None], y0[..., None, :])
    ix1 = torch.minimum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.minimum(y1[..., :, None], y1[..., None, :])
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def suppression_table(boxes: torch.Tensor, iou_threshold: float
                      ) -> torch.Tensor:
    """(..., N, N) bool: row i marks what committing box i suppresses,
    its neighbours with IoU above the threshold and itself."""
    sup = iou_matrix(boxes) > iou_threshold
    sup |= torch.eye(boxes.shape[-2], dtype=torch.bool, device=boxes.device)
    return sup


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5, max_out: int = 36
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over boxes (..., N, 4) and scores (..., N). Returns
    (indices (..., max_out) int64, valid (..., max_out) bool)."""
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    sup = suppression_table(boxes, iou_threshold).reshape(-1, n, n)
    live = scores.float().reshape(-1, n).clone()
    rows = torch.arange(live.shape[0], device=live.device)
    tops, oks = [], []
    for _ in range(max_out):
        top = live.argmax(dim=1)
        ok = live.gather(1, top[:, None])[:, 0] > NEG / 2
        tops.append(top)
        oks.append(ok)
        live.masked_fill_(sup[rows, top] & ok[:, None], NEG)
    idx = torch.stack(tops, dim=1) if tops else live.new_zeros(
        live.shape[0], 0, dtype=torch.long)
    valid = torch.stack(oks, dim=1) if oks else idx.bool()
    return idx.reshape(*lead, max_out), valid.reshape(*lead, max_out)


def batched_class_nms(boxes, scores, iou_threshold=0.5, max_out=36):
    """Per-class NMS over (C, N, 4) boxes and (C, N) scores, every class
    at once."""
    return nms(boxes, scores, iou_threshold, max_out)

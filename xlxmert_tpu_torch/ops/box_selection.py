"""Bbox-feature selection: per-class NMS and max-confidence top-N (port
of xlxmert_tpu/ops/box_selection.py, transcribing the reference's
_process_feature_extraction, feature_extraction/
coco_extract_bbox_feature.py:80-129).

Softmax class scores; for every foreground class greedy NMS (IoU 0.5)
over the proposals; a proposal's max_conf is the highest class
probability under which it survived its class's NMS (and exceeded
conf_thresh); the top `num_features` proposals by max_conf are kept,
each reporting its best foreground class as obj_id. As in the JAX
package, the IoU table is computed once and every class advances in
lockstep for P rounds over one (C, P) score table. Both functions take
one image or a batch (a leading dimension). Plain PyTorch: a Python loop
of a few small ops a round on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from xlxmert_tpu_torch.ops.nms import NEG, suppression_table


def multiclass_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                        iou_threshold: float = 0.5,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Greedy per-class NMS for all classes at once. boxes ([B,] P, 4)
    xyxy, scores ([B,] P, C), valid ([B,] P) bool (padded proposals).
    Returns the keep mask ([B,] P, C): True where the proposal survives
    that class's NMS."""
    single = scores.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    B, P, C = scores.shape
    sup = suppression_table(boxes, iou_threshold)        # (B, P, P)
    live = scores.float().transpose(1, 2).contiguous()   # (B, C, P)
    if valid is not None:
        live.masked_fill_(~valid[:, None, :], NEG)
    rows = torch.arange(B, device=live.device)[:, None]
    tops, oks = [], []
    for _ in range(P):
        top = live.argmax(dim=2)                          # (B, C)
        ok = live.gather(2, top[..., None])[..., 0] > NEG / 2
        tops.append(top)
        oks.append(ok)
        live.masked_fill_(sup[rows, top] & ok[..., None], NEG)
    keep = torch.zeros(B, C, P, dtype=torch.int32, device=live.device)
    if P:
        keep.scatter_add_(2, torch.stack(tops, dim=2),
                          torch.stack(oks, dim=2).int())
    keep = (keep > 0).transpose(1, 2)                     # (B, P, C)
    return keep[0] if single else keep


def top_k_lower_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dimension, ties
    to the lower index (jax.lax.top_k's order): a stable descending
    sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def select_top_features(proposals: torch.Tensor, cls_logits: torch.Tensor,
                        feats: torch.Tensor, im_scale,
                        valid: Optional[torch.Tensor] = None,
                        num_features: int = 36, conf_thresh: float = 0.0,
                        background: bool = False) -> Dict[str, torch.Tensor]:
    """Bbox-feature selection (reference :80-129) of one image or a
    batch. proposals ([B,] P, 4) in input-image coordinates; cls_logits
    ([B,] P, n_cls), background at column 0; feats ([B,] P, D); im_scale
    the resize factor (a number, or (B,) for a batch). Returns features
    ([B,] N, D), boxes ([B,] N, 4) in original image coordinates, obj_id
    ([B,] N) int32, cls_prob ([B,] N) and num_boxes ([B,]) int32, the
    count of nonzero-confidence keeps (the reference's `num_boxes`); also
    keep_boxes ([B,] N), the kept proposals' indices."""
    single = cls_logits.dim() == 2
    if single:
        proposals, cls_logits, feats = (proposals[None], cls_logits[None],
                                        feats[None])
        valid = None if valid is None else valid[None]
    scale = torch.as_tensor(im_scale, dtype=torch.float32,
                            device=proposals.device).reshape(-1, 1, 1)
    scores = torch.softmax(cls_logits.float(), dim=-1)
    dets = proposals / scale
    fg = scores[..., (0 if background else 1):]               # (B, P, C')
    keep = multiclass_nms_mask(dets, fg, 0.5, valid)
    contrib = torch.where(keep & (fg > conf_thresh), fg,
                          torch.zeros((), device=fg.device))
    max_conf = contrib.max(dim=-1).values                     # (B, P)
    if valid is not None:
        max_conf = torch.where(valid, max_conf,
                               torch.zeros((), device=fg.device))
    top_conf, keep_boxes = top_k_lower_index(max_conf, num_features)

    def take(t):
        return t.gather(1, keep_boxes[..., None].expand(
            -1, -1, t.shape[-1]))

    sel_scores = take(fg)
    out = {"features": take(feats), "boxes": take(dets),
           "obj_id": sel_scores.argmax(dim=-1).int(),
           "cls_prob": sel_scores.max(dim=-1).values,
           "num_boxes": (top_conf != 0).sum(dim=-1).int(),
           "keep_boxes": keep_boxes}
    return {k: v[0] for k, v in out.items()} if single else out

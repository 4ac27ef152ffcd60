"""Whole-block fused int8 LXMERT serving forward (port of
xlxmert_tpu/serving/lxmert_fused.py).

The same math, calibration and parameters as the static int8 engine
(serving/lxmert_int8.py), but the whole dense chain of every encoder
module runs in the fused kernel (ops/fused_block.py): between two
kernels there are only the attention cores (ops/attention.mha_blhd,
fast=True, as the reference's accelerator route), the embeddings, the
visual feature encoder, the pooler and the answer head, which reuse the
int8 engine's code.

Structure (that of lxmert_int8.lxmert_forward):

  lang/visn stacks: [attention core] -> fused(out + LN + FFN + LN +
  the next layer's QKV); the last block of each stack has as its tail
  the first x-layer's shared cross-attention q|kv projection (one
  (2304, 768) product: q(x) and kv(x) take the same activation);
  x-layers: cross cores -> fused(cross out + LN + self QKV) -> self
  cores -> fused(self out + LN + FFN + LN + the next x-layer's q|kv);
  the last x-layer's self blocks have no tail.

`prepare_fused` takes the calibrated engine (lxmert_int8.calibrate, then
apply_calibration), so both engines share one calibration. The fused
tree shares the engine's tensors and its embeddings, visual feature
encoder, pooler and first QKV modules: move the fused tree, not both.
A forward launches the fused kernel 34 times at full depth, the
attention kernel 34 times and the int8 dense kernel 3 times (visn_fc
and the two first QKVs; the answer head adds 2).
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops.attention import mha_blhd
from xlxmert_tpu_torch.ops.fused_block import (
    FusedWeight, concat_fused, fused_block, fused_weight,
)
from xlxmert_tpu_torch.serving.lxmert_int8 import (
    LxmertInt8, _extend_mask, pool, text_embeddings, visual_embeddings,
)
from xlxmert_tpu_torch.utils.profiling import span


class FusedBlock(nn.Module):
    """One self-attention module and its FFN as the kernel takes them:
    out, ln1, w1, w2, ln2, and `tail`, the next module's projection
    (None on a stack's last block)."""

    def __init__(self, att: nn.Module, ffn: nn.Module,
                 tail: Optional[FusedWeight]):
        super().__init__()
        self.out, self.ln1 = fused_weight(att.out), att.ln
        self.w1, self.w2 = fused_weight(ffn.w1), fused_weight(ffn.w2)
        self.ln2 = ffn.ln
        self.tail = tail


class FusedCross(nn.Module):
    """One x-layer: the shared cross-attention output (its tails are the
    self-attention QKVs) and the two self blocks."""

    def __init__(self, p: nn.Module, tail: Optional[FusedWeight]):
        super().__init__()
        self.cross_out, self.cross_ln = fused_weight(p.cross.out), p.cross.ln
        self.lang_self_qkv = fused_weight(p.lang_self.qkv)
        self.visn_self_qkv = fused_weight(p.visn_self.qkv)
        self.lang_self = FusedBlock(p.lang_self, p.lang_ffn, tail)
        self.visn_self = FusedBlock(p.visn_self, p.visn_ffn, tail)


class LxmertFused(nn.Module):
    def __init__(self, qp: LxmertInt8):
        super().__init__()
        # the shared cross-attention q|kv of each x-layer as one weight:
        # q and kv take the same activation, so their calibrated scales
        # are equal (concat_fused raises otherwise)
        xcat = [concat_fused(p.cross.q, p.cross.kv) for p in qp.x_layers]
        self.embeddings, self.visn_fc = qp.embeddings, qp.visn_fc
        self.pooler = qp.pooler
        self.lang_qkv0 = qp.lang_layers[0].att.qkv
        self.visn_qkv0 = qp.visn_layers[0].att.qkv

        def stack(layers):
            return nn.ModuleList(
                FusedBlock(p.att, p.ffn,
                           fused_weight(layers[i + 1].att.qkv)
                           if i + 1 < len(layers)
                           else (xcat[0] if xcat else None))
                for i, p in enumerate(layers))

        self.lang, self.visn = stack(qp.lang_layers), stack(qp.visn_layers)
        self.x = nn.ModuleList(
            FusedCross(p, xcat[i + 1] if i + 1 < len(xcat) else None)
            for i, p in enumerate(qp.x_layers))


def prepare_fused(qp: LxmertInt8, cfg: LxmertConfig) -> LxmertFused:
    """Calibrated int8 engine -> fused-layout tree on the same device
    (`cfg` is the reference's argument; the tree has the engine's
    depths)."""
    return LxmertFused(qp).eval()


def _run_block(ctx, x, blk: FusedBlock):
    """fused_block with a uniform (y, tail) return: tail is None on a
    stack's last block."""
    out = fused_block(ctx, x, blk.out, blk.ln1.scale, blk.ln1.bias,
                      blk.w1, blk.w2, blk.ln2.scale, blk.ln2.bias,
                      tail_w=blk.tail, has_ffn=True)
    return out if isinstance(out, tuple) else (out, None)


def _attn(qkv, bias, n_heads: int):
    q, k, v = qkv.chunk(3, dim=-1)
    return mha_blhd(q, k, v, bias, n_heads, fast=True)


def lxmert_forward_fused(fp: LxmertFused, input_ids, visual_feats,
                         visual_pos, attention_mask=None,
                         visual_attention_mask=None, n_heads: int = 12):
    """Returns (lang, visn, pooled), all bf16: the numerics of
    lxmert_int8.lxmert_forward on the static-calibrated engine, under
    the same spans "xlt.engine.language", "xlt.engine.visual" (the
    visual embedding and stack) and "xlt.engine.cross"."""
    with span("xlt.engine.language"):
        lang_bias = _extend_mask(attention_mask)
        lang = text_embeddings(fp.embeddings, input_ids)
        qkv = fp.lang_qkv0(lang)
        for blk in fp.lang:
            lang, qkv = _run_block(_attn(qkv, lang_bias, n_heads), lang,
                                   blk)
        lang_qkv_x = qkv  # q|kv of x-layer 0, language side
    with span("xlt.engine.visual"):
        visn_bias = _extend_mask(visual_attention_mask)
        visn = visual_embeddings(fp.visn_fc, visual_feats, visual_pos)
        qkv = fp.visn_qkv0(visn)
        for blk in fp.visn:
            visn, qkv = _run_block(_attn(qkv, visn_bias, n_heads), visn,
                                   blk)
        visn_qkv_x = qkv
    with span("xlt.engine.cross"):
        for xb in fp.x:
            ql, kl, vl = lang_qkv_x.chunk(3, dim=-1)
            qv, kv, vv = visn_qkv_x.chunk(3, dim=-1)
            # the shared cross-attention, both directions
            ctx_l = mha_blhd(ql, kv, vv, visn_bias, n_heads, fast=True)
            ctx_v = mha_blhd(qv, kl, vl, lang_bias, n_heads, fast=True)
            new_lang, sq_l = fused_block(
                ctx_l, lang, xb.cross_out, xb.cross_ln.scale,
                xb.cross_ln.bias, tail_w=xb.lang_self_qkv, has_ffn=False)
            new_visn, sq_v = fused_block(
                ctx_v, visn, xb.cross_out, xb.cross_ln.scale,
                xb.cross_ln.bias, tail_w=xb.visn_self_qkv, has_ffn=False)
            # tails are None on the last x-layer and go unused
            lang, lang_qkv_x = _run_block(_attn(sq_l, lang_bias, n_heads),
                                          new_lang, xb.lang_self)
            visn, visn_qkv_x = _run_block(_attn(sq_v, visn_bias, n_heads),
                                          new_visn, xb.visn_self)
        return lang, visn, pool(fp.pooler, lang)

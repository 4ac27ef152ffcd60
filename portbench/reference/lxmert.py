"""Plain fp32 LXMERT (arXiv:1908.07490; HF `unc-nlp/lxmert-base-uncased`)
with the VQA answer head and the X-LXMERT visual-cluster head
(arXiv:2009.11278), serving's int8 quantization worked out again.

Every large dense is emulated as the int8 serving engines state it:
weights per output channel, symmetric, `bits` wide (8: the served
precision; 4: the control); activations with a per-tensor static scale
from this module's own calibration, whose forwards quantize each row
dynamically while every site records the largest |x| it sees. Products
of the integer values are taken in fp32 with TF32 off. Everything else
is fp32: LayerNorm (eps 1e-12, population variance), the tanh gelu the
serving engines use, softmax attention with an additive -1e9 key mask,
box_fc and the pooler.

Weights are {flax path: fp32 tensor} as portbench/lib/weights.py makes
them ("bert/encoder/layer_0/attention/self/query/kernel", (in, out)).
Imports torch and numpy only.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Optional

import numpy as np
import torch

NEG_INF = -1e9


@contextlib.contextmanager
def tf32_off():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def box_position(grid: int) -> torch.Tensor:
    """(grid*grid, 4) normalized (x0, y0, x1, y1) cell boxes, row-major."""
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    boxes = np.stack([j / grid, i / grid, (j + 1) / grid, (i + 1) / grid],
                     -1).reshape(-1, 4)
    return torch.from_numpy(boxes.astype(np.float32))


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


class QuantLxmert:
    """The model over `w` at `bits`-wide quantization. `calibrate` runs
    forwards that record each site's amax; later forwards use the static
    scales."""

    def __init__(self, w: Dict[str, torch.Tensor], n_heads: int,
                 bits: int = 8):
        self.w, self.n_heads = w, n_heads
        self.qmax = float(2 ** (bits - 1) - 1)
        self.amax: Dict[str, torch.Tensor] = {}
        self.calibrating = False
        self._wq: Dict[str, tuple] = {}

    # -- quantized products ------------------------------------------------
    def _weight(self, name: str, kernel: Optional[torch.Tensor] = None):
        if name not in self._wq:
            k = self.w[f"{name}/kernel"] if kernel is None else kernel
            s = torch.clamp_min(k.abs().amax(0) / self.qmax, 1e-8)
            q = torch.clamp(torch.round(k / s), -self.qmax, self.qmax)
            self._wq[name] = (q, s)
        return self._wq[name]

    def dense(self, x: torch.Tensor, name: str,
              kernel: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, s = self._weight(name, kernel)
        b = self.w[f"{name}/bias"] if bias is None else bias
        if self.calibrating:
            a = x.abs().amax()
            self.amax[name] = (a if name not in self.amax
                               else torch.maximum(self.amax[name], a))
            sx = torch.clamp_min(x.abs().amax(-1, keepdim=True) / self.qmax,
                                 1e-8)
        else:
            sx = torch.clamp_min(self.amax[name] / self.qmax, 1e-8)
        xq = torch.clamp(torch.round(x / sx), -self.qmax, self.qmax)
        return (xq @ q) * (sx * s) + b

    def ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return ((x - mu) * torch.rsqrt(var + 1e-12) * self.w[f"{name}/scale"]
                + self.w[f"{name}/bias"])

    def attend(self, q, k, v, bias):
        B, Lq, HD = q.shape
        H = self.n_heads
        D = HD // H
        qh, kh, vh = (t.reshape(B, -1, H, D).transpose(1, 2)
                      for t in (q, k, v))
        s = qh @ kh.transpose(-1, -2) / math.sqrt(D)
        if bias is not None:
            s = s + bias
        ctx = torch.softmax(s, -1) @ vh
        return ctx.transpose(1, 2).reshape(B, Lq, HD)

    # -- the model -----------------------------------------------------------
    def self_attention(self, x, bias, p):
        q = self.dense(x, f"{p}/self/query")
        k = self.dense(x, f"{p}/self/key")
        v = self.dense(x, f"{p}/self/value")
        ctx = self.attend(q, k, v, bias)
        return self.ln(self.dense(ctx, f"{p}/output/dense") + x,
                       f"{p}/output/LayerNorm")

    def ffn(self, x, inter, out):
        h = gelu(self.dense(x, f"{inter}/dense"))
        return self.ln(self.dense(h, f"{out}/dense") + x, f"{out}/LayerNorm")

    def layer(self, x, bias, p):
        x = self.self_attention(x, bias, f"{p}/attention")
        return self.ffn(x, f"{p}/intermediate", f"{p}/output")

    def cross(self, x, ctx, ctx_bias, p):
        a = f"{p}/visual_attention"
        q = self.dense(x, f"{a}/att/query")
        k = self.dense(ctx, f"{a}/att/key")
        v = self.dense(ctx, f"{a}/att/value")
        out = self.attend(q, k, v, ctx_bias)
        return self.ln(self.dense(out, f"{a}/output/dense") + x,
                       f"{a}/output/LayerNorm")

    def lang_encode(self, ids, mask):
        e = "bert/embeddings"
        L = ids.shape[1]
        x = (self.w[f"{e}/word_embeddings/embedding"][ids]
             + self.w[f"{e}/position_embeddings/embedding"][:L][None]
             + self.w[f"{e}/token_type_embeddings/embedding"][0])
        x = self.ln(x, f"{e}/LayerNorm")
        bias = ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
        i = 0
        while f"bert/encoder/layer_{i}/attention/self/query/kernel" in self.w:
            x = self.layer(x, bias, f"bert/encoder/layer_{i}")
            i += 1
        return x, bias

    def visn_encode(self, feats, pos):
        v = "bert/encoder/visn_fc"
        x = self.ln(self.dense(feats.float(), f"{v}/visn_fc"),
                    f"{v}/visn_layer_norm")
        y = self.ln(pos @ self.w[f"{v}/box_fc/kernel"]
                    + self.w[f"{v}/box_fc/bias"], f"{v}/box_layer_norm")
        x = (x + y) * 0.5
        i = 0
        while f"bert/encoder/r_layers_{i}/attention/self/query/kernel" \
                in self.w:
            x = self.layer(x, None, f"bert/encoder/r_layers_{i}")
            i += 1
        return x

    def cross_encode(self, lang, visn, lang_bias):
        i = 0
        while f"bert/encoder/x_layers_{i}/visual_attention/att/query/kernel"\
                in self.w:
            p = f"bert/encoder/x_layers_{i}"
            new_lang = self.cross(lang, visn, None, p)
            new_visn = self.cross(visn, lang, lang_bias, p)
            lang = self.ffn(self.self_attention(
                new_lang, lang_bias, f"{p}/lang_self_att"),
                f"{p}/lang_inter", f"{p}/lang_output")
            visn = self.ffn(self.self_attention(
                new_visn, None, f"{p}/visn_self_att"),
                f"{p}/visn_inter", f"{p}/visn_output")
            i += 1
        return lang, visn

    def pooled(self, lang):
        return torch.tanh(lang[:, 0] @ self.w["bert/pooler/dense/kernel"]
                          + self.w["bert/pooler/dense/bias"])

    def vqa_logits(self, ids, feats, pos, mask):
        """(B, n_answers) answer logits of questions `ids` (B, L) with the
        key mask `mask`, over grid features `feats` (B, V, D) at the cell
        boxes `pos` (V, 4)."""
        lang, lang_bias = self.lang_encode(ids, mask)
        visn = self.visn_encode(feats, pos)
        lang, _ = self.cross_encode(lang, visn, lang_bias)
        h = gelu(self.dense(self.pooled(lang), "answer_head/logit_fc_0"))
        h = self.ln(h, "answer_head/logit_fc_2")
        return self.dense(h, "answer_head/logit_fc_3")

    def cluster_logits(self, lang, lang_bias, feats, pos):
        """(B, V, num_clusters) logits of the visual-cluster head over the
        code grid `feats`, from the language stack's output."""
        visn = self.visn_encode(feats, pos)
        _, visn = self.cross_encode(lang, visn, lang_bias)
        p = "obj_predict_head"
        h = gelu(self.dense(visn, f"{p}/transform/dense"))
        h = self.dense(self.ln(h, f"{p}/transform/LayerNorm"),
                       f"{p}/linear_feat")
        c = self.w["centroids"]
        return self.dense(h, f"{p}/cluster", kernel=c.t(),
                          bias=self.w[f"{p}/out_cluster_bias"])

    def calibrate(self, run, batches: Iterable) -> None:
        """Record every site's amax over `run(*batch)` for each batch."""
        self.calibrating = True
        try:
            with torch.inference_mode():
                for batch in batches:
                    run(*batch)
        finally:
            self.calibrating = False

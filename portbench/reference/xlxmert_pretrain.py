"""Plain fp32 X-LXMERT pre-training step (arXiv:2009.11278, on the
LXMERT backbone of arXiv:1908.07490): the three tasks' losses given
their masks and labels, the gradients by autograd, and one AdamW update
written out plainly.

Parameters are {name: fp32 tensor} under HF LXMERT's names
("bert.encoder.layer.0.attention.self.query.weight", (out, in)), with
the pre-training heads `cls.predictions` (the LM head; its decoder is
the word-embedding matrix, tied), `cls.seq_relationship` (the matching
head), `obj_predict_head` (the visual-cluster head; its output weight is
the frozen centroid table, passed in, not a parameter) and `mask_feat`.
The forward: embeddings (word + position + token type 0, LayerNorm),
the visual encoder ((LN(visn_fc(f)) + LN(box_fc(box))) / 2), 9 language
and 5 visual BERT layers, 5 cross layers (one cross-attention shared by
both directions, then each side's self-attention and FFN), the pooler.
LayerNorm eps 1e-12 with the population variance; erf gelu; softmax
attention with -1e9 on padded keys. The losses: cross entropy over the
labelled positions (label < 0 ignored), mean over them, one task a step:
`word_mask` (the LM head over the masked caption), `matched` (the
matching head over the pooled [CLS] of a caption that may be another
image's), `vis_mask` (the cluster head over the masked cells, whose
input is `mask_feat`). Only the task's head is computed, so autograd
leaves a parameter that the task's loss does not reach without a
gradient (None): the unused heads, the pooler outside `matched`, and the
last cross layer's self-attention and FFN on the side the task does not
read (computed, but not on the way to the loss).

Dropout (`Drop`): where the recipe drops (the embeddings' and the visual
encoder's outputs, each attention's probabilities before p·v, each
attention output's and FFN output's dense before its residual), a kept
element is multiplied by the mask's scale and a dropped one is 0. The
masks are given, one a dropout in the order the forward reaches them:
the embeddings, the visual encoder, each language then visual layer
(probabilities, attention output, FFN output), and in each cross layer
the shared cross-attention language-to-visual then visual-to-language,
the language then the visual self-attention, the language then the
visual FFN.

The update (`adamw`): the legacy BERT AdamW of lxmert_pretrain.py as the
port states it: the clip scales every gradient by max_norm / (norm +
1e-6) where the global norm over the gradients exceeds max_norm; moments
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2; a count per tensor;
the step -lr_t sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps), eps on
the uncorrected sqrt(v); weight decay on the updated value, p_new = p +
u - lr_t wd (p + u); lr_t the linear warm-up and decay at the update's
position; a parameter without a gradient is left as it is, moments and
count too.

Departures from the published recipe (scripts/pretrain.bash), each for
the comparison: the task's masks and labels and the dropout masks are
given, not drawn, and a dropout's scale is the one the program applies
(1 / keep_prob with keep_prob rounded to the compute type, as the port
divides); no weight decay for every bias and every LayerNorm weight,
visn_layer_norm's and box_layer_norm's included (the port's rule; the published torch rule
matches the substring "LayerNorm.weight" and decays those two); the
schedule is evaluated in float64.

The control of the cell's `correct` is this step a precision below the
recipe's: `products="fp8"`, every product (each dense, both attention
products, both tied logits), forward and backward, takes its operands
rounded to float8 e4m3 with one scale a tensor (amax to 448), below the
program's bf16, the rest fp32; and `adamw(dtype=torch.bfloat16)`, the
moments and the update's arithmetic in bf16, below its fp32. The step
is computed over row blocks of the batch, the gradients summed, so that
it fits beside the program on one card.
Imports torch, and `tf32_off` and `box_position` of reference/lxmert.py
(re-exported for the callers).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .lxmert import NEG_INF, box_position, tf32_off  # noqa: F401

LN_EPS = 1e-12
E4M3_MAX = 448.0
TASKS = ("vis_mask", "word_mask", "matched")


class Inputs(NamedTuple):
    """What one task's step reads, on the device: the caption the task
    encodes (B, L) (the masked one for word_mask, a maybe mismatched one
    for matched), the cluster ids of the grid (B, V), the masked cells
    (B, V) bool or None, and the labels: (B, L) words, (B,) match or
    (B, V) clusters, negative where unlabelled."""
    ids: torch.Tensor
    clusters: torch.Tensor
    vis_mask: Optional[torch.Tensor]
    labels: torch.Tensor


class Drop(NamedTuple):
    """One dropout of the forward: `keep` (bool, the shape of what it
    drops, the rows of the batch first) and the factor a kept element
    takes (1 / keep_prob)."""
    keep: torch.Tensor
    scale: float


class Hyper(NamedTuple):
    """The AdamW and schedule settings of the recipe."""
    lr: float
    total_steps: int
    warmup_ratio: float
    weight_decay: float
    clip: float
    eps: float
    b1: float = 0.9
    b2: float = 0.999


# -- products ----------------------------------------------------------------
def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale a tensor, back in fp32."""
    s = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


class _Fp8Grad(torch.autograd.Function):
    """The identity forward; the gradient rounded to e4m3 backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 for the product it enters (a straight-through
    rounding: the product's backward takes the rounded operand)."""
    return x + (_e4m3(x) - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    if products == "fp32":
        return a @ b
    if products == "fp8":
        # both operands rounded; the incoming gradient rounded before
        # either backward product
        return _Fp8Grad.apply(_fp8(a) @ _fp8(b))
    raise ValueError(f"products={products!r}")


# -- the model ------------------------------------------------------------------
class Model:
    """The forward over `p` ({name: tensor}), `n_heads` heads, products
    in `products` ("fp32" or "fp8"), the dropouts `drops` in order (None:
    no dropout)."""

    def __init__(self, p: Dict[str, torch.Tensor], n_heads: int,
                 products: str = "fp32",
                 drops: Optional[Sequence[Drop]] = None):
        self.p, self.n_heads, self.products = p, n_heads, products
        self.drops = None if drops is None else iter(drops)

    def drop(self, x):
        if self.drops is None:
            return x
        d = next(self.drops, None)
        if d is None or d.keep.shape != x.shape:
            given = None if d is None else tuple(d.keep.shape)
            raise ValueError(f"a dropout of {tuple(x.shape)}: the mask "
                             f"given is {given}")
        return torch.where(d.keep, x * d.scale, torch.zeros_like(x))

    def all_dropped(self) -> None:
        """Every given mask was taken."""
        if self.drops is not None and next(self.drops, None) is not None:
            raise ValueError("more dropout masks given than the forward "
                             "takes")

    def count(self, prefix: str) -> int:
        n = 0
        while f"{prefix}.{n}.attention.self.query.weight" in self.p or \
                f"{prefix}.{n}.visual_attention.att.query.weight" in self.p:
            n += 1
        return n

    def dense(self, x, name):
        return (matmul(x, self.p[f"{name}.weight"].t(), self.products)
                + self.p[f"{name}.bias"])

    def ln(self, x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) / torch.sqrt(var + LN_EPS)
                * self.p[f"{name}.weight"] + self.p[f"{name}.bias"])

    def attend(self, x, ctx, bias, name):
        q, k, v = (self.dense(t, f"{name}.{n}") for t, n in
                   ((x, "query"), (ctx, "key"), (ctx, "value")))
        B, Lq, HD = q.shape
        H = self.n_heads
        D = HD // H
        qh, kh, vh = (t.reshape(B, -1, H, D).transpose(1, 2)
                      for t in (q, k, v))
        s = matmul(qh, kh.transpose(-1, -2), self.products) / math.sqrt(D)
        if bias is not None:
            s = s + bias
        out = matmul(self.drop(torch.softmax(s, -1)), vh, self.products)
        return out.transpose(1, 2).reshape(B, Lq, HD)

    def self_block(self, x, bias, name):
        ctx = self.attend(x, x, bias, f"{name}.self")
        return self.ln(self.drop(self.dense(ctx, f"{name}.output.dense"))
                       + x, f"{name}.output.LayerNorm")

    def cross_block(self, x, ctx, ctx_bias, name):
        out = self.attend(x, ctx, ctx_bias, f"{name}.att")
        return self.ln(self.drop(self.dense(out, f"{name}.output.dense"))
                       + x, f"{name}.output.LayerNorm")

    def ffn(self, x, inter, out):
        h = torch.nn.functional.gelu(self.dense(x, f"{inter}.dense"))
        return self.ln(self.drop(self.dense(h, f"{out}.dense")) + x,
                       f"{out}.LayerNorm")

    def layer(self, x, bias, name):
        x = self.self_block(x, bias, f"{name}.attention")
        return self.ffn(x, f"{name}.intermediate", f"{name}.output")

    def encode(self, ids, feats, pos):
        """(lang, visn) after the last cross layer."""
        p, e = self.p, "bert.embeddings"
        L = ids.shape[1]
        x = (p[f"{e}.word_embeddings.weight"][ids]
             + p[f"{e}.position_embeddings.weight"][:L][None]
             + p[f"{e}.token_type_embeddings.weight"][0])
        lang = self.drop(self.ln(x, f"{e}.LayerNorm"))
        bias = ((1.0 - (ids > 0).float()) * NEG_INF)[:, None, None, :]
        v = "bert.encoder.visn_fc"
        visn = self.drop((self.ln(self.dense(feats, f"{v}.visn_fc"),
                                  f"{v}.visn_layer_norm")
                          + self.ln(self.dense(pos, f"{v}.box_fc"),
                                    f"{v}.box_layer_norm")) * 0.5)
        for i in range(self.count("bert.encoder.layer")):
            lang = self.layer(lang, bias, f"bert.encoder.layer.{i}")
        for i in range(self.count("bert.encoder.r_layers")):
            visn = self.layer(visn, None, f"bert.encoder.r_layers.{i}")
        for i in range(self.count("bert.encoder.x_layers")):
            n = f"bert.encoder.x_layers.{i}"
            new_lang = self.cross_block(lang, visn, None,
                                        f"{n}.visual_attention")
            new_visn = self.cross_block(visn, lang, bias,
                                        f"{n}.visual_attention")
            new_lang = self.self_block(new_lang, bias, f"{n}.lang_self_att")
            new_visn = self.self_block(new_visn, None, f"{n}.visn_self_att")
            lang = self.ffn(new_lang, f"{n}.lang_inter", f"{n}.lang_output")
            visn = self.ffn(new_visn, f"{n}.visn_inter", f"{n}.visn_output")
        return lang, visn

    def transform(self, x, name):
        h = torch.nn.functional.gelu(self.dense(x, f"{name}.dense"))
        return self.ln(h, f"{name}.LayerNorm")

    def logits(self, task: str, ids, clusters, vis_mask, centroids, pos):
        """The task's head: word (B, L, vocab), match (B, 2) or cluster
        (B, V, clusters) logits."""
        p = self.p
        feats = centroids[clusters]
        if vis_mask is not None:
            feats = torch.where(vis_mask[..., None], p["mask_feat"], feats)
        lang, visn = self.encode(ids, feats, pos)
        if task == "word_mask":
            h = self.transform(lang, "cls.predictions.transform")
            return (matmul(h, p["bert.embeddings.word_embeddings.weight"].t(),
                           self.products) + p["cls.predictions.bias"])
        if task == "matched":
            pooled = torch.tanh(self.dense(lang[:, 0], "bert.pooler.dense"))
            return self.dense(pooled, "cls.seq_relationship")
        if task == "vis_mask":
            h = self.transform(visn, "obj_predict_head.transform")
            f = self.dense(h, "obj_predict_head.linear_feat")
            return (matmul(f, centroids.t(), self.products)
                    + p["obj_predict_head.out_cluster_bias"])
        raise ValueError(task)


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed cross entropy over the labelled positions."""
    valid = labels >= 0
    lp = torch.log_softmax(logits[valid], -1)
    return -lp.gather(-1, labels[valid][:, None]).sum()


def loss_and_grads(params: Dict[str, torch.Tensor], task: str, x: Inputs,
                   centroids: torch.Tensor, pos: torch.Tensor, n_heads: int,
                   block: int, products: str = "fp32",
                   drops: Optional[Sequence[Drop]] = None
                   ) -> Tuple[float, Dict[str, Optional[torch.Tensor]]]:
    """The task's loss (the mean cross entropy over the batch's labelled
    positions) and each parameter's gradient, None where the loss does
    not reach it; computed over blocks of `block` rows, with the whole
    batch's dropout masks `drops` (None: no dropout)."""
    leaves = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    n = int((x.labels >= 0).sum())
    if n == 0:
        raise ValueError(f"{task}: no labelled position")
    total = 0.0
    for a in range(0, x.ids.shape[0], block):
        rows = slice(a, a + block)
        model = Model(leaves, n_heads, products, None if drops is None else
                      [Drop(d.keep[rows], d.scale) for d in drops])
        logits = model.logits(task, x.ids[rows], x.clusters[rows],
                              None if x.vis_mask is None else
                              x.vis_mask[rows], centroids, pos)
        model.all_dropped()
        part = nll_sum(logits, x.labels[rows]) / n
        part.backward()
        total += float(part.detach())
    return total, {k: t.grad for k, t in leaves.items()}


def schedule(h: Hyper, step: int) -> float:
    """The learning rate at update `step`: linear from 0 to lr over the
    warm-up's int(total * ratio) steps (at least 1), then linear to 0."""
    warm = max(int(h.total_steps * h.warmup_ratio), 1)
    if step < warm:
        return h.lr * step / warm
    decay = max(h.total_steps - warm, 1)
    return h.lr * (1.0 - min(step - warm, decay) / decay)


def decays(name: str) -> bool:
    """Weight decay: not for a bias or a LayerNorm weight."""
    last = name.rsplit(".", 1)[-1]
    return not (last.endswith("bias") or "LayerNorm." in name
                or "layer_norm." in name)


def adamw(params: Dict[str, torch.Tensor],
          grads: Dict[str, Optional[torch.Tensor]],
          m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor],
          counts: Dict[str, int], step: int, h: Hyper,
          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The parameters after one update from `grads` at schedule position
    `step`, moments `m`, `v` and per-tensor `counts` before it; a name
    whose gradient is None maps to its tensor unchanged. `dtype`: the
    type of the moments and the update's arithmetic: bfloat16 (the
    control's optimizer, a precision below the recipe's fp32) is added
    to the fp32 parameter; float64 returns the parameter and its update
    in float64, unrounded."""
    lr = schedule(h, step)
    given = [k for k, g in grads.items() if g is not None]
    norm = math.sqrt(sum(float((grads[k].double() ** 2).sum())
                         for k in given))
    clip = min(1.0, h.clip / (norm + 1e-6)) if h.clip > 0 else 1.0
    out = dict(params)
    for k in given:
        g = grads[k].to(dtype) * clip
        p = params[k].to(dtype)
        wide = dtype == torch.float64
        mk = h.b1 * m[k].to(dtype) + (1.0 - h.b1) * g
        vk = h.b2 * v[k].to(dtype) + (1.0 - h.b2) * g * g
        t = counts[k] + 1
        u = (-lr * math.sqrt(1.0 - h.b2 ** t) / (1.0 - h.b1 ** t)
             * mk / (torch.sqrt(vk) + h.eps))
        if decays(k) and h.weight_decay:
            u = u - lr * h.weight_decay * (p + u)
        out[k] = p + u if wide else params[k] + u.float()
    return out

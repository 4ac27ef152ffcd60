"""LXMERT backbone (port of xlxmert_tpu/models/lxmert.py).

Embeddings -> visual feature encoder -> l_layers language blocks ->
r_layers visual blocks -> x_layers cross-modality blocks (ONE shared
cross-attention applied in both directions) -> pooler, and the VQA
answer head. Modules keep HF LXMERT's attribute names, so
`core/convert.flax_to_state_dict` loads the reference's flax parameters
and `convert_torch_state_dict(model.state_dict())` gives them back.

Eval mode (`model.eval()`) is flax's `deterministic=True`: no dropout,
the serving and parity paths. Train mode is the training forward: a
`Dropout` wherever flax has `nn.Dropout` (attention probabilities,
AttentionOutput, FFOutput, the visual encoder's output, the
embeddings), each drawing from the `torch.Generator` passed to the
model's forward. `train_attention` is what the JAX
`train_attention_mode()` sets, held by the model (`TrainOptions`):
  - "xla" (and "auto"): the einsum route, flax's dropout
    `where(keep, p / keep_prob, 0)` on the probabilities;
  - "pallas_blhd": `ops/attention.mha_blhd_train`, the kernel route:
    the mask keep.to(dtype) / keep_prob in the compute type, drawn here,
    applied by the kernel (a different rounding from the einsum
    route's, as in the JAX package).
Parameters stay fp32 in training; `Dense` casts them to the compute
type, so gradients land in fp32.

`dtype` is the compute type (bf16 for serving, fp32 for the exact
path), as the flax modules' `dtype`. Each op rounds where flax does:
  - Dense: the product in the compute type, then + bias in the compute
    type (two roundings, as `nn.Dense(dtype=bf16)`);
  - LayerNorm: flax's `use_fast_variance` statistics in fp32 (var =
    max(E[x^2] - E[x]^2, 0)), then (x - mu) * (rsqrt(var + eps) * g) + b
    in fp32, cast to the compute type;
  - embeddings summed and the visual (x + y) * 0.5 in the compute type.
gelu and tanh take their input's type and round once (PyTorch computes
them in fp32 internally, as XLA's fused elementwise ops do).

The JAX module-level switches (`serving_mode()`) are a constructor
argument here, `ServingOptions`: `serving=False` is the exact path (erf
gelu, fp32 softmax, einsum attention). `serving=True` takes the tanh
gelu, the softmax in the compute type, and `attention`:
  - "einsum": the JAX "xla" route (the scores product rounded to the
    accumulator type before the scale);
  - "blhd": the packed-head kernel `ops/attention.mha_blhd`;
  - "pallas": the (B, H, L, D) kernel `ops/attention.fused_mha`;
  - "auto": einsum for CPU tensors, blhd for CUDA ones;
and `fused_ffn`, which routes each Intermediate -> FFOutput pair through
`ops/ffn.fused_ffn`. Both FFN routes read the same parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.ops.attention import (
    fused_mha, mha_blhd, mha_blhd_train, softmax_last,
)
from xlxmert_tpu_torch.ops.ffn import fused_ffn
from xlxmert_tpu_torch.parallel.sharding import (
    copy_to_model_group, reduce_from_model_group,
)

NEG_INF = -1e9  # additive key mask (fp32- and bf16-safe)
ATTENTION_ROUTES = ("auto", "einsum", "blhd", "pallas")


@dataclasses.dataclass(frozen=True)
class ServingOptions:
    """What `xlxmert_tpu.models.lxmert.serving_mode(serving, attention,
    fused_ffn)` sets, held by the model instead of module globals."""

    serving: bool = False
    attention: str = "auto"
    fused_ffn: bool = False

    def __post_init__(self):
        if self.attention not in ATTENTION_ROUTES:
            raise ValueError(f"attention={self.attention!r}: use one of "
                             f"{ATTENTION_ROUTES}")

    def attention_route(self, device: torch.device) -> str:
        if not self.serving:
            return "einsum"
        if self.attention == "auto":
            return "einsum" if device.type == "cpu" else "blhd"
        return self.attention

    @property
    def fast(self) -> bool:
        """Softmax in the compute type and the tanh gelu."""
        return self.serving

    @property
    def use_fused_ffn(self) -> bool:
        return self.fused_ffn and self.serving


EXACT = ServingOptions()
TRAIN_ATTENTION_ROUTES = ("xla", "pallas_blhd", "auto")


def train_attention_mode(impl: str = "auto") -> str:
    """The training attention route `impl` resolves to: "auto" is
    "xla", as in the JAX package (its kernel route measured slower on
    the TPU, which is no statement about the H100)."""
    if impl not in TRAIN_ATTENTION_ROUTES:
        raise ValueError(f"train_attention={impl!r}: use one of "
                         f"{TRAIN_ATTENTION_ROUTES}")
    return "xla" if impl == "auto" else impl


class TrainOptions:
    """What the training forward reads, shared by a model's modules: the
    training attention route and the generator of the current forward
    (set by `LxmertModel.forward`, None outside it)."""

    def __init__(self, attention: str = "xla"):
        self.attention = train_attention_mode(attention)
        self.generator: Optional[torch.Generator] = None

    def keep(self, shape, keep_prob: float, device, heads=None
             ) -> torch.Tensor:
        """keep ~ Bernoulli(keep_prob), boolean, from the generator.
        `heads` (first, total) of a tensor-parallel attention's (B, h, ...)
        probabilities: the mask of all `total` heads is drawn and heads
        first..first + h kept, as one process would draw them."""
        if self.generator is None:
            raise RuntimeError("a training forward with dropout needs a "
                               "torch.Generator: pass generator= to the "
                               "model, or call model.eval()")
        if heads is None:
            return torch.rand(shape, generator=self.generator,
                              device=device) < keep_prob
        first, total = heads
        full = (shape[0], total) + tuple(shape[2:])
        keep = torch.rand(full, generator=self.generator,
                          device=device) < keep_prob
        return keep[:, first:first + shape[1]]


class Dropout(nn.Module):
    """flax nn.Dropout: where(keep, x / keep_prob, 0) in x's type, keep
    drawn from the model's generator; the identity in eval mode."""

    heads = None  # (first, total): a tensor-parallel attention's heads

    def __init__(self, rate: float, train: TrainOptions):
        super().__init__()
        self.rate, self.train_opts = rate, train

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = self.train_opts.keep(x.shape, keep_prob, x.device,
                                    self.heads)
        # divided by keep_prob in x's type, as jnp divides by a weak
        # scalar; a device tensor, so the division is not a reciprocal,
        # made by a fill (a copy from the host would wait for the card)
        kp = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / kp, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def extend_attention_mask(mask: Optional[torch.Tensor], dtype
                          ) -> Optional[torch.Tensor]:
    """(B, L) {0, 1} mask -> (B, 1, 1, L) additive bias (0 keep, -1e9
    drop) in `dtype`."""
    if mask is None:
        return None
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :].to(dtype)


class Dense(nn.Module):
    """nn.Dense: the product, then the bias, each in the input's type.
    Parameters in nn.Linear's layout: weight (out, in), bias (out,). A
    row-parallel Dense (`reduce_group`, parallel/sharding) sums its
    partial products over the model group before the bias."""

    reduce_group = None

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.reduce_group is not None:
            y = reduce_from_model_group(y, self.reduce_group)
        return y + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (use_fast_variance) with HF's parameter names."""

    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(width))
        self.bias = nn.Parameter(torch.empty(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mu) * mul + self.bias.float()).to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, num: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, width))

    def forward(self, ids: torch.Tensor, dtype) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(dtype)


def einsum_attention(q, k, v, bias, fast: bool, dropout=None
                     ) -> torch.Tensor:
    """The JAX "xla" route over (B, H, L, D): the scores product in the
    accumulator type (the input type when `fast`, else fp32), times
    1/sqrt(D) rounded to that type, + bias, softmax, p in the input
    type, `dropout` on p (training), p.v in the input type."""
    acc = q.dtype if fast else torch.float32
    D = q.shape[-1]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    s = s * float(torch.tensor(1.0 / np.sqrt(D), dtype=acc))
    if bias is not None:
        s = s + bias.to(acc)
    p = softmax_last(s).to(q.dtype)
    if dropout is not None:
        p = dropout(p)
    return torch.matmul(p, v)


class Attention(nn.Module):
    """Multi-head attention core (HF LxmertAttention): (B, Lq, H*D)
    context of `hidden` attending to `context`. Tensor-parallel
    (`tp_group`, parallel/sharding): q/k/v hold this rank's `n_heads`
    heads and the inputs enter through copy_to_model_group."""

    tp_group = None

    def __init__(self, cfg: LxmertConfig, opts: ServingOptions,
                 train: TrainOptions):
        super().__init__()
        self.n_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.opts, self.train_opts = opts, train
        hid = cfg.hidden_size
        self.query = Dense(hid, hid)
        self.key = Dense(hid, hid)
        self.value = Dense(hid, hid)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob, train)

    def forward(self, hidden, context, bias=None):
        if self.tp_group is not None:
            same = context is hidden
            hidden = copy_to_model_group(hidden, self.tp_group)
            context = (hidden if same
                       else copy_to_model_group(context, self.tp_group))
        q, k, v = self.query(hidden), self.key(context), self.value(context)
        H, D = self.n_heads, self.head_dim
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        if self.training:
            route = ("blhd_train" if self.train_opts.attention
                     == "pallas_blhd" else "einsum")
        else:
            route = self.opts.attention_route(q.device)
        kbias = bias
        if bias is not None and route != "einsum":
            # the kernels take a bf16 (B, Lk) bias; the mask's 0 / -1e9
            # give the same softmax in either type
            kbias = bias.to(torch.bfloat16).reshape(B, Lk)
        if route == "blhd_train":
            # the dropout mask is drawn here, pre-scaled in the compute
            # type, and applied inside the kernel
            rate, mask = self.dropout.rate, None
            if rate > 0.0:
                keep = self.train_opts.keep((B, H, Lq, Lk), 1.0 - rate,
                                            q.device, self.dropout.heads)
                mask = keep.to(q.dtype) / torch.full(
                    (), 1.0 - rate, dtype=q.dtype, device=q.device)
            return mha_blhd_train(q, k, v, kbias, mask, H)
        fast = self.opts.fast
        if route == "blhd":
            return mha_blhd(q, k, v, kbias, H, fast)
        qh, kh, vh = (t.view(B, -1, H, D).transpose(1, 2) for t in (q, k, v))
        if route == "pallas":
            ctx = fused_mha(qh, kh, vh, kbias, fast)
        else:
            ctx = einsum_attention(qh, kh, vh, bias, fast,
                                   self.dropout if self.training else None)
        return ctx.transpose(1, 2).reshape(B, Lq, H * D)


class AttentionOutput(nn.Module):
    """Projection + residual + LayerNorm (HF LxmertAttentionOutput)."""

    def __init__(self, cfg: LxmertConfig, train: TrainOptions):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob, train)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, hidden, input_tensor):
        return self.LayerNorm(self.dropout(self.dense(hidden))
                              + input_tensor)


class SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: LxmertConfig, opts: ServingOptions,
                 train: TrainOptions):
        super().__init__()
        self.self = Attention(cfg, opts, train)
        self.output = AttentionOutput(cfg, train)

    def forward(self, x, bias=None):
        return self.output(self.self(x, x, bias), x)


class CrossAttentionLayer(nn.Module):
    def __init__(self, cfg: LxmertConfig, opts: ServingOptions,
                 train: TrainOptions):
        super().__init__()
        self.att = Attention(cfg, opts, train)
        self.output = AttentionOutput(cfg, train)

    def forward(self, x, ctx, ctx_bias=None):
        return self.output(self.att(x, ctx, ctx_bias), x)


class Intermediate(nn.Module):
    tp_group = None  # column-parallel: this rank's hidden units

    def __init__(self, cfg: LxmertConfig, opts: ServingOptions):
        super().__init__()
        self.opts = opts
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        if self.tp_group is not None:
            x = copy_to_model_group(x, self.tp_group)
        return gelu(self.dense(x), self.opts.fast)


class FFOutput(nn.Module):
    def __init__(self, cfg: LxmertConfig, train: TrainOptions):
        super().__init__()
        self.dense = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob, train)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, input_tensor):
        return self.LayerNorm(self.dropout(self.dense(x)) + input_tensor)


def ffn_block(inter: Intermediate, out: FFOutput, att: torch.Tensor,
              opts: ServingOptions) -> torch.Tensor:
    """Intermediate -> FFOutput, through the fused kernel when
    `opts.use_fused_ffn` in eval mode (models/lxmert.py::_ffn_block)."""
    if opts.use_fused_ffn and not out.training:
        return fused_ffn(att, inter.dense.weight, inter.dense.bias,
                         out.dense.weight, out.dense.bias,
                         out.LayerNorm.weight, out.LayerNorm.bias,
                         approx_gelu=opts.fast, eps=out.LayerNorm.eps)
    return out(inter(att), att)


class TransformerLayer(nn.Module):
    """Self-attention + FFN block (HF LxmertLayer)."""

    def __init__(self, cfg: LxmertConfig, opts: ServingOptions,
                 train: TrainOptions):
        super().__init__()
        self.opts = opts
        self.attention = SelfAttentionLayer(cfg, opts, train)
        self.intermediate = Intermediate(cfg, opts)
        self.output = FFOutput(cfg, train)

    def forward(self, x, bias=None):
        att = self.attention(x, bias)
        return ffn_block(self.intermediate, self.output, att, self.opts)


class XLayer(nn.Module):
    """Cross-modality block (HF LxmertXLayer): ONE `visual_attention`
    applied in both directions with shared weights."""

    def __init__(self, cfg: LxmertConfig, opts: ServingOptions,
                 train: TrainOptions):
        super().__init__()
        self.opts = opts
        self.visual_attention = CrossAttentionLayer(cfg, opts, train)
        self.lang_self_att = SelfAttentionLayer(cfg, opts, train)
        self.visn_self_att = SelfAttentionLayer(cfg, opts, train)
        self.lang_inter = Intermediate(cfg, opts)
        self.lang_output = FFOutput(cfg, train)
        self.visn_inter = Intermediate(cfg, opts)
        self.visn_output = FFOutput(cfg, train)

    def forward(self, lang, lang_bias, visn, visn_bias):
        lang_att = self.visual_attention(lang, visn, visn_bias)
        visn_att = self.visual_attention(visn, lang, lang_bias)
        lang_att = self.lang_self_att(lang_att, lang_bias)
        visn_att = self.visn_self_att(visn_att, visn_bias)
        return (ffn_block(self.lang_inter, self.lang_output, lang_att,
                          self.opts),
                ffn_block(self.visn_inter, self.visn_output, visn_att,
                          self.opts))


class VisualFeatureEncoder(nn.Module):
    """(feats, boxes) -> hidden (HF LxmertVisualFeatureEncoder):
    (LN(visn_fc(feats)) + LN(box_fc(boxes))) * 0.5, then dropout."""

    def __init__(self, cfg: LxmertConfig, train: TrainOptions):
        super().__init__()
        hid, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.visn_fc = Dense(cfg.visual_feat_dim, hid)
        self.visn_layer_norm = LayerNorm(hid, eps)
        self.box_fc = Dense(cfg.visual_pos_dim, hid)
        self.box_layer_norm = LayerNorm(hid, eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob, train)

    def forward(self, feats, pos, dtype):
        x = self.visn_layer_norm(self.visn_fc(feats.to(dtype)))
        y = self.box_layer_norm(self.box_fc(pos.to(dtype)))
        return self.dropout((x + y) * 0.5)


class Embeddings(nn.Module):
    """Word + position + token-type embeddings (HF LxmertEmbeddings),
    LayerNorm, dropout."""

    def __init__(self, cfg: LxmertConfig, train: TrainOptions):
        super().__init__()
        hid = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, hid)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             hid)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, hid)
        self.LayerNorm = LayerNorm(hid, cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob, train)

    def forward(self, input_ids, token_type_ids, dtype):
        L = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(L, device=input_ids.device)[None]
        h = (self.word_embeddings(input_ids, dtype)
             + self.position_embeddings(positions, dtype)
             + self.token_type_embeddings(token_type_ids, dtype))
        return self.dropout(self.LayerNorm(h))


class Encoder(nn.Module):
    """l_layers language -> r_layers visual -> x_layers cross blocks (HF
    LxmertEncoder; the language stack is named `layer`)."""

    def __init__(self, cfg: LxmertConfig, opts: ServingOptions,
                 train: TrainOptions):
        super().__init__()
        self.visn_fc = VisualFeatureEncoder(cfg, train)
        self.layer = nn.ModuleList(TransformerLayer(cfg, opts, train)
                                   for _ in range(cfg.l_layers))
        self.r_layers = nn.ModuleList(TransformerLayer(cfg, opts, train)
                                      for _ in range(cfg.r_layers))
        self.x_layers = nn.ModuleList(XLayer(cfg, opts, train)
                                      for _ in range(cfg.x_layers))

    def forward(self, lang, lang_bias, feats, pos, visn_bias, dtype):
        visn = self.visn_fc(feats, pos, dtype)
        for layer in self.layer:
            lang = layer(lang, lang_bias)
        for layer in self.r_layers:
            visn = layer(visn, visn_bias)
        for layer in self.x_layers:
            lang, visn = layer(lang, lang_bias, visn, visn_bias)
        return lang, visn


class Pooler(nn.Module):
    def __init__(self, cfg: LxmertConfig):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, lang):
        return torch.tanh(self.dense(lang[:, 0]))


class LxmertModel(nn.Module):
    """Embeddings -> encoder -> pooler (HF LxmertModel). Returns (lang,
    visn, pooled) in the compute type. In train mode every dropout, and
    the "pallas_blhd" attention mask, draws from `generator`."""

    def __init__(self, cfg: LxmertConfig, dtype=torch.float32,
                 options: ServingOptions = EXACT,
                 train_attention: str = "xla"):
        super().__init__()
        self.config, self.dtype, self.options = cfg, dtype, options
        self.train_opts = TrainOptions(train_attention)
        self.embeddings = Embeddings(cfg, self.train_opts)
        self.encoder = Encoder(cfg, options, self.train_opts)
        self.pooler = Pooler(cfg)

    def forward(self, input_ids, visual_feats, visual_pos,
                attention_mask=None, visual_attention_mask=None,
                token_type_ids=None,
                generator: Optional[torch.Generator] = None):
        self.train_opts.generator = generator
        try:
            lang_bias = extend_attention_mask(attention_mask, self.dtype)
            visn_bias = extend_attention_mask(visual_attention_mask,
                                              self.dtype)
            emb = self.embeddings(input_ids, token_type_ids, self.dtype)
            lang, visn = self.encoder(emb, lang_bias, visual_feats,
                                      visual_pos, visn_bias, self.dtype)
            return lang, visn, self.pooler(lang)
        finally:
            self.train_opts.generator = None


class VisualAnswerHead(nn.Module):
    """in_features (default hid) -> 2*hid -> gelu -> LN -> num_labels,
    fp32 logits (HF LxmertVisualAnswerHead; `logit_fc` indices 0, 2 and 3
    hold parameters, 1 is the gelu). NLVR2's head reads 2*hid."""

    def __init__(self, cfg: LxmertConfig, num_labels: int,
                 options: ServingOptions = EXACT,
                 in_features: Optional[int] = None):
        super().__init__()
        hid = cfg.hidden_size
        self.options = options
        self.logit_fc = nn.ModuleList([
            Dense(in_features or hid, 2 * hid), nn.Identity(),
            LayerNorm(2 * hid, cfg.layer_norm_eps),
            Dense(2 * hid, num_labels)])

    def forward(self, pooled):
        fc0, _, ln, fc3 = self.logit_fc
        h = ln(gelu(fc0(pooled), self.options.fast))
        return fc3(h).float()


# ---------------------------------------------------------------------------
# Pre-training heads (HF LXMERT's heads and the reference's cluster-output
# override, x-lxmert/src/lxrt/modeling.py:8-53). A product against a
# matrix passed at call time (the tied word embeddings, the centroid
# table) runs in the compute type and is returned in fp32; the JAX
# package keeps its fp32 accumulator (preferred_element_type), the port
# rounds it to the compute type first (exact in fp32; a relative 2^-9
# per logit in bf16), so the product stays one bf16 cuBLAS call.
# ---------------------------------------------------------------------------


def _tied_logits(h: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """h (..., F) against matrix (N, F) -> (..., N) fp32."""
    return torch.matmul(h, matrix.to(h.dtype).t()).float()


class PredictionHeadTransform(nn.Module):
    """dense -> gelu -> LayerNorm (HF LxmertPredictionHeadTransform)."""

    def __init__(self, cfg: LxmertConfig, options: ServingOptions = EXACT):
        super().__init__()
        self.options = options
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x):
        return self.LayerNorm(gelu(self.dense(x), self.options.fast))


class LMPredictionHead(nn.Module):
    """Transform, then the decoder: the word-embedding matrix passed at
    call time (tied by value), + an fp32 bias (HF LxmertLMPredictionHead)."""

    def __init__(self, cfg: LxmertConfig, options: ServingOptions = EXACT):
        super().__init__()
        self.transform = PredictionHeadTransform(cfg, options)
        self.bias = nn.Parameter(torch.empty(cfg.vocab_size))

    def forward(self, hidden, word_embedding_matrix):
        return _tied_logits(self.transform(hidden),
                            word_embedding_matrix) + self.bias


class PreTrainingHeads(nn.Module):
    """LM head + 2-way matched head (HF LxmertPreTrainingHeads). Each is
    computed only when asked for: a head left out gets no gradient,
    which is what the JAX package's per-task optimizer mask encodes."""

    def __init__(self, cfg: LxmertConfig, options: ServingOptions = EXACT):
        super().__init__()
        self.predictions = LMPredictionHead(cfg, options)
        self.seq_relationship = Dense(cfg.hidden_size, 2)

    def forward(self, sequence_output, pooled_output, word_embedding_matrix,
                lm: bool = True, matched: bool = True):
        return (self.predictions(sequence_output, word_embedding_matrix)
                if lm else None,
                self.seq_relationship(pooled_output).float()
                if matched else None)


class VisualObjHead(nn.Module):
    """The reference's visual prediction head: transform -> linear_feat
    (hidden -> visual_feat_dim), then
      - clustering mode (cfg.num_clusters > 0): logits against the frozen
        centroid table passed at call time + `out_cluster_bias`;
      - detector-vocabulary mode: `out_obj` (-> num_object_labels);
    and `out_attr` (-> num_attr_labels). `keys` are the outputs the
    model was built for ("obj", "feat", "attr"): as flax creates a
    parameter only when its branch runs at init, `out_obj`,
    `out_cluster_bias` and `out_attr` exist only for the keys that need
    them."""

    def __init__(self, cfg: LxmertConfig, keys=("obj",),
                 options: ServingOptions = EXACT):
        super().__init__()
        self.clustering = cfg.clustering
        self.transform = PredictionHeadTransform(cfg, options)
        self.linear_feat = Dense(cfg.hidden_size, cfg.visual_feat_dim)
        if "obj" in keys:
            if cfg.clustering:
                self.out_cluster_bias = nn.Parameter(
                    torch.empty(cfg.num_clusters))
            else:
                self.out_obj = Dense(cfg.visual_feat_dim,
                                     cfg.num_object_labels)
        if "attr" in keys:
            self.out_attr = Dense(cfg.visual_feat_dim, cfg.num_attr_labels)

    def forward(self, hidden, centroids=None, out_keys=("obj",)):
        feat = self.linear_feat(self.transform(hidden))
        out = {}
        if "feat" in out_keys:
            out["feat"] = feat
        if "obj" in out_keys:
            out["obj"] = (_tied_logits(feat, centroids)
                          + self.out_cluster_bias if self.clustering
                          else self.out_obj(feat).float())
        if "attr" in out_keys:
            out["attr"] = self.out_attr(feat).float()
        return out

"""Int8 LXMERT serving engine (port of xlxmert_tpu/serving/lxmert_int8.py).

The engine is a tree of `nn.Module`s holding the quantized weights as
buffers. `prepare_params` and `prepare_answer_head` take exactly the
nested flax parameter dict (numpy leaves) that the JAX engine takes, so
the reference's parameters become the port's through one function.

Numerics follow the reference:
  - every large dense is int8 x int8 -> int32 with per-output-channel
    weight scales (ops/quant.py, kernel ops/int8_matmul.py); QKV is one
    (768 -> 2304) product and cross-attention KV one (768 -> 1536)
    product, computed once per side and used in both directions;
  - attention is the packed-head kernel (ops/attention.py, fast=True:
    bf16 scores and softmax), or the einsum route (`attention_impl`);
  - LayerNorm takes fp32 statistics with the population variance and
    casts to bf16; residual adds, tanh gelu, the embedding sum (token
    type 0) and the visual (x + y) * 0.5 are bf16;
  - the key mask is an additive -1e9 bias in bf16, shape (B, 1, 1, Lk);
  - box_fc (4 -> 768) and the pooler stay bf16 torch.matmul, as the
    reference leaves them to XLA.

Calibration: every `QuantWeight` and attention `ActScale` records the
amax of its input during a calibration forward (the dynamic int8 path);
`apply_calibration` then gives each its static scale in place. This
replaces the reference's id()-keyed two-pass trace.

The whole-block fused engine (serving/lxmert_fused.py) runs on the
calibrated tree this module builds. `nlvr2_forward` serves the NLVR2
head (fine-tuning's `--serve_int8` eval). Not yet ported: the int8
attention einsums (with sampling).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.core.config import LxmertConfig
from xlxmert_tpu_torch.models.lxmert import einsum_attention
from xlxmert_tpu_torch.ops.attention import mha_blhd
from xlxmert_tpu_torch.ops.quant import (
    ActScale, AmaxObserver, QuantWeight, quantize_weight, with_act_scale,
    with_activation_scale,
)
from xlxmert_tpu_torch.utils.device import resolve_device

NEG_INF = -1e9

# Assumed VQA question-length distribution over WordPiece length
# buckets (the reference's one definition, kept here as a copy).
VQA_LENGTH_MIX = {8: 0.35, 12: 0.45, 16: 0.15, 20: 0.05}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _bf16(x) -> torch.Tensor:
    return _f32(x).to(torch.bfloat16)


class LayerNorm(nn.Module):
    def __init__(self, p: Dict):
        super().__init__()
        self.register_buffer("scale", _f32(p["scale"]))
        self.register_buffer("bias", _f32(p["bias"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self)


def layer_norm(x: torch.Tensor, ln: LayerNorm, eps: float = 1e-12):
    """fp32 statistics, population variance, bf16 out."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * ln.scale + ln.bias
    return out.to(torch.bfloat16)


def _qw(p: Dict, name: str) -> QuantWeight:
    return quantize_weight(p[name]["kernel"], p[name]["bias"])


def _qw_concat(p: Dict, names) -> QuantWeight:
    k = np.concatenate([np.asarray(p[n]["kernel"], np.float32)
                        for n in names], axis=1)
    b = np.concatenate([np.asarray(p[n]["bias"], np.float32)
                        for n in names])
    return quantize_weight(k, b)


def _att_scales() -> nn.ModuleDict:
    """q/k/v calibration sites of one attention (the int8 attention
    einsums that would use them are not ported yet)."""
    return nn.ModuleDict({"q": ActScale(), "k": ActScale(),
                          "v": ActScale()})


# The attention route of the engine (the JAX engine's attention_impl):
# "auto" and "pallas_blhd" are the packed-head kernel mha_blhd (fast:
# bf16 scores and softmax), which takes its plain version for CPU
# tensors; "einsum" is the JAX engine's bhqk einsum formulation in plain
# PyTorch. `_attention_core` is looked up at call time, so a driver may
# swap it (scripts/drive_attention_layout_torch.py).
ATTENTION_IMPLS = ("auto", "pallas_blhd", "einsum")
_ATTENTION_IMPL = "auto"


def attention_impl(name: str) -> None:
    global _ATTENTION_IMPL
    if name not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl({name!r}): use one of "
                         f"{ATTENTION_IMPLS}")
    _ATTENTION_IMPL = name


def einsum_core(q, k, v, bias, n_heads: int) -> torch.Tensor:
    """The JAX engine's einsum route, which is the bf16 model's
    (models.lxmert.einsum_attention, fast): bhqk scores in bf16, times
    1/sqrt(D), + bias, softmax in bf16, p.v in bf16."""
    B, Lq, HD = q.shape
    qh, kh, vh = (t.reshape(B, -1, n_heads, HD // n_heads).transpose(1, 2)
                  for t in (q, k, v))
    ctx = einsum_attention(qh, kh, vh, bias, fast=True)
    return ctx.transpose(1, 2).reshape(B, Lq, HD)


def _attention_core(q, k, v, bias, n_heads: int) -> torch.Tensor:
    if _ATTENTION_IMPL == "einsum":
        return einsum_core(q, k, v, bias, n_heads)
    return mha_blhd(q, k, v, bias, n_heads, fast=True)


def _core(q, k, v, bias, n_heads: int, act: nn.ModuleDict):
    act["q"].observe(q)
    act["k"].observe(k)
    act["v"].observe(v)
    return _attention_core(q, k, v, bias, n_heads)


class SelfAttention(nn.Module):
    """SelfAttentionLayer params {self: {query, key, value}, output}."""

    def __init__(self, p: Dict):
        super().__init__()
        self.qkv = _qw_concat(p["self"], ("query", "key", "value"))
        self.out = _qw(p["output"], "dense")
        self.ln = LayerNorm(p["output"]["LayerNorm"])
        self.act = _att_scales()

    def forward(self, x, bias, n_heads: int):
        q, k, v = self.qkv(x).split(x.shape[-1], dim=-1)
        ctx = _core(q, k, v, bias, n_heads, self.act)
        return self.ln(self.out(ctx) + x)


class CrossAttention(nn.Module):
    """CrossAttentionLayer params {att: {query, key, value}, output}."""

    def __init__(self, p: Dict):
        super().__init__()
        self.q = _qw(p["att"], "query")
        self.kv = _qw_concat(p["att"], ("key", "value"))
        self.out = _qw(p["output"], "dense")
        self.ln = LayerNorm(p["output"]["LayerNorm"])
        self.act = _att_scales()

    def forward(self, x, ctx_kv, ctx_bias, n_heads: int):
        """x attends to the context whose (k|v) projection is ctx_kv."""
        k, v = ctx_kv.split(x.shape[-1], dim=-1)
        ctx = _core(self.q(x), k, v, ctx_bias, n_heads, self.act)
        return self.ln(self.out(ctx) + x)


class FFN(nn.Module):
    def __init__(self, p: Dict, inter: str = "intermediate",
                 out: str = "output"):
        super().__init__()
        self.w1 = _qw(p[inter], "dense")
        self.w2 = _qw(p[out], "dense")
        self.ln = LayerNorm(p[out]["LayerNorm"])

    def forward(self, x):
        h = F.gelu(self.w1(x), approximate="tanh")
        return self.ln(self.w2(h) + x)


class EncoderLayer(nn.Module):
    def __init__(self, p: Dict):
        super().__init__()
        self.att = SelfAttention(p["attention"])
        self.ffn = FFN(p)

    def forward(self, x, bias, n_heads: int):
        return self.ffn(self.att(x, bias, n_heads))


class CrossLayer(nn.Module):
    def __init__(self, p: Dict):
        super().__init__()
        self.cross = CrossAttention(p["visual_attention"])
        self.lang_self = SelfAttention(p["lang_self_att"])
        self.visn_self = SelfAttention(p["visn_self_att"])
        self.lang_ffn = FFN(p, "lang_inter", "lang_output")
        self.visn_ffn = FFN(p, "visn_inter", "visn_output")


class Embeddings(nn.Module):
    def __init__(self, emb: Dict):
        super().__init__()
        self.register_buffer("word",
                             _bf16(emb["word_embeddings"]["embedding"]))
        self.register_buffer("pos",
                             _bf16(emb["position_embeddings"]["embedding"]))
        self.register_buffer(
            "token_type",
            _bf16(emb["token_type_embeddings"]["embedding"]))
        self.ln = LayerNorm(emb["LayerNorm"])


class VisualFeatEncoder(nn.Module):
    def __init__(self, p: Dict):
        super().__init__()
        self.feat = _qw(p, "visn_fc")
        self.feat_ln = LayerNorm(p["visn_layer_norm"])
        # box_fc is (4 -> 768): bf16, too small to quantize
        self.register_buffer("box_kernel", _bf16(p["box_fc"]["kernel"]))
        self.register_buffer("box_bias", _bf16(p["box_fc"]["bias"]))
        self.box_ln = LayerNorm(p["box_layer_norm"])


class Pooler(nn.Module):
    def __init__(self, p: Dict):
        super().__init__()
        self.register_buffer("kernel", _bf16(p["dense"]["kernel"]))
        self.register_buffer("bias", _bf16(p["dense"]["bias"]))


class LxmertInt8(nn.Module):
    """The quantized backbone: embeddings, visual feature encoder,
    language / visual / cross stacks and the pooler."""

    def __init__(self, params: Dict, cfg: LxmertConfig):
        super().__init__()
        enc = params["encoder"]
        self.embeddings = Embeddings(params["embeddings"])
        self.visn_fc = VisualFeatEncoder(enc["visn_fc"])
        self.lang_layers = nn.ModuleList(
            EncoderLayer(enc[f"layer_{i}"]) for i in range(cfg.l_layers))
        self.visn_layers = nn.ModuleList(
            EncoderLayer(enc[f"r_layers_{i}"]) for i in range(cfg.r_layers))
        self.x_layers = nn.ModuleList(
            CrossLayer(enc[f"x_layers_{i}"]) for i in range(cfg.x_layers))
        self.pooler = Pooler(params["pooler"])


class AnswerHead(nn.Module):
    """hid -> 2*hid (int8) -> tanh gelu -> LN -> num_labels (int8)."""

    def __init__(self, p: Dict):
        super().__init__()
        self.w1 = _qw(p, "logit_fc_0")
        self.ln = LayerNorm(p["logit_fc_2"])
        self.w2 = _qw(p, "logit_fc_3")


def prepare_params(params: Dict, cfg: LxmertConfig,
                   device="cuda") -> LxmertInt8:
    """flax LxmertModel param tree (numpy leaves) -> quantized engine on
    `device`."""
    dev = resolve_device(device)
    return LxmertInt8(params, cfg).to(dev).eval()


def prepare_answer_head(head_params: Dict, device="cuda") -> AnswerHead:
    dev = resolve_device(device)
    return AnswerHead(head_params).to(dev).eval()


def random_params(cfg: LxmertConfig, num_answers: int, seed: int = 0
                  ) -> Tuple[Dict, Dict]:
    """Random (bert, answer_head) parameter trees in the flax layout that
    prepare_params / prepare_answer_head read: normal(0, initializer_range)
    kernels and embeddings, zero biases, unit LayerNorm scales. Made with
    numpy from `seed`."""
    rng = np.random.default_rng(seed)
    std = cfg.initializer_range

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(k, n):
        return {"kernel": normal(k, n), "bias": np.zeros(n, np.float32)}

    def ln(n):
        return {"scale": np.ones(n, np.float32),
                "bias": np.zeros(n, np.float32)}

    H, I = cfg.hidden_size, cfg.intermediate_size

    def att_out():
        return {"dense": dense(H, H), "LayerNorm": ln(H)}

    def self_att():
        return {"self": {n: dense(H, H) for n in ("query", "key", "value")},
                "output": att_out()}

    def layer():
        return {"attention": self_att(),
                "intermediate": {"dense": dense(H, I)},
                "output": {"dense": dense(I, H), "LayerNorm": ln(H)}}

    enc: Dict = {"visn_fc": {
        "visn_fc": dense(cfg.visual_feat_dim, H), "visn_layer_norm": ln(H),
        "box_fc": dense(cfg.visual_pos_dim, H), "box_layer_norm": ln(H)}}
    for i in range(cfg.l_layers):
        enc[f"layer_{i}"] = layer()
    for i in range(cfg.r_layers):
        enc[f"r_layers_{i}"] = layer()
    for i in range(cfg.x_layers):
        enc[f"x_layers_{i}"] = {
            "visual_attention": {
                "att": {n: dense(H, H) for n in ("query", "key", "value")},
                "output": att_out()},
            "lang_self_att": self_att(), "visn_self_att": self_att(),
            "lang_inter": {"dense": dense(H, I)},
            "lang_output": {"dense": dense(I, H), "LayerNorm": ln(H)},
            "visn_inter": {"dense": dense(H, I)},
            "visn_output": {"dense": dense(I, H), "LayerNorm": ln(H)}}
    bert = {
        "embeddings": {
            "word_embeddings": {"embedding": normal(cfg.vocab_size, H)},
            "position_embeddings": {
                "embedding": normal(cfg.max_position_embeddings, H)},
            "token_type_embeddings": {
                "embedding": normal(cfg.type_vocab_size, H)},
            "LayerNorm": ln(H)},
        "encoder": enc,
        "pooler": {"dense": dense(H, H)},
    }
    head = {"logit_fc_0": dense(H, 2 * H), "logit_fc_2": ln(2 * H),
            "logit_fc_3": dense(2 * H, num_answers)}
    return bert, head


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _extend_mask(mask):
    if mask is None:
        return None
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :].to(
        torch.bfloat16)


def text_embeddings(emb: Embeddings, input_ids) -> torch.Tensor:
    """Word + position + token-type-0 embeddings (bf16), LayerNorm."""
    L = input_ids.shape[1]
    h = (F.embedding(input_ids, emb.word) + emb.pos[None, :L]
         + emb.token_type[0][None, None, :])
    return emb.ln(h)


def visual_embeddings(vf: VisualFeatEncoder, visual_feats,
                      visual_pos) -> torch.Tensor:
    """(LN(int8 visn_fc(feats)) + LN(box_fc(pos))) * 0.5, bf16."""
    x = vf.feat_ln(vf.feat(visual_feats.to(torch.bfloat16)))
    y = visual_pos.to(torch.bfloat16) @ vf.box_kernel + vf.box_bias
    return (x + vf.box_ln(y)) * 0.5


def pool(pooler: Pooler, lang) -> torch.Tensor:
    """tanh(dense(first token)), bf16."""
    return torch.tanh(lang[:, 0] @ pooler.kernel + pooler.bias)


def lang_encode(qp: LxmertInt8, input_ids, attention_mask=None,
                n_heads: int = 12):
    """Embeddings + the language self-attention stack."""
    lang_bias = _extend_mask(attention_mask)
    lang = text_embeddings(qp.embeddings, input_ids)
    for layer in qp.lang_layers:
        lang = layer(lang, lang_bias, n_heads)
    return lang, lang_bias


def visn_encode(qp: LxmertInt8, visual_feats, visual_pos,
                visual_attention_mask=None, n_heads: int = 12):
    """Visual feature encoder + the visual self-attention stack."""
    visn_bias = _extend_mask(visual_attention_mask)
    visn = visual_embeddings(qp.visn_fc, visual_feats, visual_pos)
    for layer in qp.visn_layers:
        visn = layer(visn, visn_bias, n_heads)
    return visn, visn_bias


def cross_encode(qp: LxmertInt8, lang, visn, lang_bias, visn_bias,
                 n_heads: int = 12):
    """The cross-modality layers + pooler -> (lang, visn, pooled)."""
    for p in qp.x_layers:
        # one cross-attention, both directions; each side's KV once
        lang_kv = p.cross.kv(lang)
        visn_kv = p.cross.kv(visn)
        new_lang = p.cross(lang, visn_kv, visn_bias, n_heads)
        new_visn = p.cross(visn, lang_kv, lang_bias, n_heads)
        lang = p.lang_ffn(p.lang_self(new_lang, lang_bias, n_heads))
        visn = p.visn_ffn(p.visn_self(new_visn, visn_bias, n_heads))
    return lang, visn, pool(qp.pooler, lang)


def lxmert_forward(qp: LxmertInt8, input_ids, visual_feats, visual_pos,
                   attention_mask=None, visual_attention_mask=None,
                   n_heads: int = 12):
    """Returns (lang, visn, pooled), all bf16."""
    lang, lang_bias = lang_encode(qp, input_ids, attention_mask, n_heads)
    visn, visn_bias = visn_encode(qp, visual_feats, visual_pos,
                                  visual_attention_mask, n_heads)
    return cross_encode(qp, lang, visn, lang_bias, visn_bias, n_heads)


def answer_head_forward(hp: AnswerHead, pooled):
    h = F.gelu(hp.w1(pooled), approximate="tanh")
    return hp.w2(hp.ln(h)).float()


def vqa_forward(qp: LxmertInt8, head_qp: AnswerHead, input_ids,
                visual_feats, visual_pos, attention_mask=None,
                n_heads: int = 12):
    """VQA/GQA logits: the backbone's pooled output through the head."""
    _, _, pooled = lxmert_forward(qp, input_ids, visual_feats, visual_pos,
                                  attention_mask=attention_mask,
                                  n_heads=n_heads)
    return answer_head_forward(head_qp, pooled)


def nlvr2_forward(qp: LxmertInt8, head_qp: AnswerHead, input_ids,
                  visual_feats, visual_pos, attention_mask=None,
                  n_heads: int = 12):
    """Int8 NLVR2 forward (models/task_heads.NLVR2Model's function): the
    (B, 2, V, D) features flattened to (2B, V, D), the two pooled outputs
    concatenated into the 2*hidden head input. The language stack works
    per row, so the sentence is encoded once on B rows and its output
    repeated per image (the JAX engine's serving optimization, exact);
    the cross layers run on 2B rows."""
    B, n_images, V, D = visual_feats.shape
    if n_images != 2:
        raise ValueError(f"nlvr2_forward takes 2 images per example, got "
                         f"{n_images}")
    feats = visual_feats.reshape(B * 2, V, D)
    pos = visual_pos.reshape(B * 2, V, -1)
    lang, lang_bias = lang_encode(qp, input_ids, attention_mask, n_heads)
    lang = lang.repeat_interleave(2, dim=0)
    if lang_bias is not None:
        lang_bias = lang_bias.repeat_interleave(2, dim=0)
    visn, visn_bias = visn_encode(qp, feats, pos, None, n_heads)
    _, _, pooled = cross_encode(qp, lang, visn, lang_bias, visn_bias,
                                n_heads)
    return answer_head_forward(head_qp, pooled.reshape(B, -1))


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def calibration_sites(*trees: nn.Module) -> List[Tuple[str, AmaxObserver]]:
    """(name, site) for every QuantWeight and ActScale; names are module
    paths, prefixed by the tree's position ("0.lang_layers.3.att.qkv")."""
    return [(f"{i}.{name}", m) for i, tree in enumerate(trees)
            for name, m in tree.named_modules()
            if isinstance(m, AmaxObserver)]


@torch.inference_mode()
def calibrate(qp: LxmertInt8, head_qp: AnswerHead, batches,
              cfg: LxmertConfig, forward=vqa_forward) -> Dict[str, float]:
    """Record per-site activation maxima over batches of (ids, feats,
    pos, mask) through `forward` (vqa_forward or nlvr2_forward) on the
    dynamic int8 path: store each site's amax on it and return {name:
    amax} (names of calibration_sites). Run it before
    apply_calibration."""
    sites = calibration_sites(qp, head_qp)
    for _, m in sites:
        m.start_observing()
    try:
        for ids, feats, pos, mask in batches:
            forward(qp, head_qp, ids, feats, pos, attention_mask=mask,
                    n_heads=cfg.num_attention_heads)
    finally:
        running = [m.stop_observing() for _, m in sites]
    seen = [(name, m, r) for (name, m), r in zip(sites, running)
            if r is not None]
    # one device-to-host copy for every site's amax
    values = torch.stack([r for *_, r in seen]).tolist() if seen else []
    for (_, m, _), v in zip(seen, values):
        m.amax = v
    return {name: m.amax for name, m, _ in seen}


def apply_calibration(*trees: nn.Module) -> None:
    """Give every site that recorded an amax its static scale, in place:
    QuantWeights switch to the static int8 path."""
    for _, m in calibration_sites(*trees):
        if m.amax is None:
            continue
        if isinstance(m, QuantWeight):
            with_activation_scale(m, m.amax)
        else:
            with_act_scale(m, m.amax)


def assert_fully_calibrated(*trees: nn.Module) -> None:
    """Fail loudly if any int8 dense would still take the dynamic path."""
    qws = [m for _, m in calibration_sites(*trees)
           if isinstance(m, QuantWeight)]
    n_cal = sum(m.calibrated for m in qws)
    if n_cal < len(qws):
        raise RuntimeError(f"int8 calibration gave static scales to only "
                           f"{n_cal}/{len(qws)} dense sites")

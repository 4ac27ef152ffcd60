"""Weights made from the seed, on the device, in a few large calls.

The LXMERT backbone, the VQA answer head, the X-LXMERT object head and
its mask feature are laid out as the published checkpoints' parameter
trees (the flax layout the program's `prepare_params` reads: dense
kernels (in, out)). One `torch.randn` fills every leaf; the program gets
numpy views of one host copy, the plain reference the device tensors.
The SPADE generator's leaves carry its published torch names.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

# leaf kinds: "w" N(0, std), "b" N(0, std), "g" 1 + N(0, std) (LayerNorm
# scale), "x" N(0, 1) (centroids, the mask feature, spectral-norm u, v),
# "c" N(0, 1/fan_in) (convolution kernels), "0" zeros
Spec = List[Tuple[str, Tuple[int, ...], str]]


def _dense(path: str, k: int, n: int) -> Spec:
    return [(f"{path}/kernel", (k, n), "w"), (f"{path}/bias", (n,), "b")]


def _ln(path: str, n: int) -> Spec:
    return [(f"{path}/scale", (n,), "g"), (f"{path}/bias", (n,), "b")]


def lxmert_spec(s: Dict) -> Spec:
    """The backbone ("bert/..."), as LxmertModel's parameter tree."""
    H, I = s["hidden_size"], s["intermediate_size"]
    out: Spec = []

    def self_att(p):
        for n in ("query", "key", "value"):
            out.extend(_dense(f"{p}/self/{n}", H, H))
        out.extend(_dense(f"{p}/output/dense", H, H))
        out.extend(_ln(f"{p}/output/LayerNorm", H))

    def layer(p):
        self_att(f"{p}/attention")
        out.extend(_dense(f"{p}/intermediate/dense", H, I))
        out.extend(_dense(f"{p}/output/dense", I, H))
        out.extend(_ln(f"{p}/output/LayerNorm", H))

    e = "bert/embeddings"
    out += [(f"{e}/word_embeddings/embedding", (s["vocab_size"], H), "w"),
            (f"{e}/position_embeddings/embedding",
             (s["max_position_embeddings"], H), "w"),
            (f"{e}/token_type_embeddings/embedding",
             (s["type_vocab_size"], H), "w")]
    out += _ln(f"{e}/LayerNorm", H)
    v = "bert/encoder/visn_fc"
    out += _dense(f"{v}/visn_fc", s["visual_feat_dim"], H)
    out += _ln(f"{v}/visn_layer_norm", H)
    out += _dense(f"{v}/box_fc", s["visual_pos_dim"], H)
    out += _ln(f"{v}/box_layer_norm", H)
    for i in range(s["l_layers"]):
        layer(f"bert/encoder/layer_{i}")
    for i in range(s["r_layers"]):
        layer(f"bert/encoder/r_layers_{i}")
    for i in range(s["x_layers"]):
        p = f"bert/encoder/x_layers_{i}"
        for n in ("query", "key", "value"):
            out.extend(_dense(f"{p}/visual_attention/att/{n}", H, H))
        out.extend(_dense(f"{p}/visual_attention/output/dense", H, H))
        out.extend(_ln(f"{p}/visual_attention/output/LayerNorm", H))
        self_att(f"{p}/lang_self_att")
        self_att(f"{p}/visn_self_att")
        for side in ("lang", "visn"):
            out.extend(_dense(f"{p}/{side}_inter/dense", H, I))
            out.extend(_dense(f"{p}/{side}_output/dense", I, H))
            out.extend(_ln(f"{p}/{side}_output/LayerNorm", H))
    out += _dense("bert/pooler/dense", H, H)
    return out


def answer_head_spec(s: Dict) -> Spec:
    H = s["hidden_size"]
    return (_dense("answer_head/logit_fc_0", H, 2 * H)
            + _ln("answer_head/logit_fc_2", 2 * H)
            + _dense("answer_head/logit_fc_3", 2 * H, s["num_answers"]))


def object_head_spec(s: Dict) -> Spec:
    """The X-LXMERT visual-cluster head, its mask feature and the
    centroid table (the head's tied output weight)."""
    H, F = s["hidden_size"], s["visual_feat_dim"]
    p = "obj_predict_head"
    return (_dense(f"{p}/transform/dense", H, H)
            + _ln(f"{p}/transform/LayerNorm", H)
            + _dense(f"{p}/linear_feat", H, F)
            + [(f"{p}/out_cluster_bias", (s["num_clusters"],), "b"),
               ("mask_feat", (F,), "x"),
               ("centroids", (s["num_clusters"], F), "x")])


def generator_spec(s: Dict) -> Spec:
    """The SPADE generator's leaves by their published torch names
    (image_generator/src/layers.py): conv weights (out, in/groups, k, k)
    N(0, 1/fan_in), biases N(0, std), spectral-norm u, v N(0, 1) (made
    converged by `converge_spectral_norms`), noise scales 0."""
    G, D, base = s["grid_size"], s["visual_feat_dim"], s["g_base_dim"]
    cb, S, nh = s["codebook_dim"], s["target_size"], s["spade_hidden"]
    out: Spec = []

    def conv(name, cin, cout, k, sn, groups=1):
        out.append((f"{name}.weight", (cout, cin // groups, k, k), "c"))
        out.append((f"{name}.bias", (cout,), "b"))
        if sn:
            out.append((f"{name}.u", (cout,), "x"))
            out.append((f"{name}.v", (cin // groups * k * k,), "x"))

    def chans(res):
        if res >= 224:
            return min(128, base)
        if res >= 112:
            return min(256, base)
        return min(512, base)

    conv("bottleneck_emb.0", D, cb, 1, False)
    conv("learned_init_conv.0", cb, base, 3, True, 4)
    conv("style_init_conv.0", cb, base, 3, True, 4)
    res, n_in = G, base
    for i in range(int(math.log2(S // G))):
        res *= 2
        n_out = chans(res)
        b = f"resblocks.{i}"
        for cbn, c in (("cbn1", n_in), ("cbn2", n_out)):
            conv(f"{b}.{cbn}.shared.0", base, nh, 3, False)
            conv(f"{b}.{cbn}.gamma", nh, c, 3, False)
            conv(f"{b}.{cbn}.beta", nh, c, 3, False)
        out.append((f"{b}.noise1.weight", (1,), "0"))
        out.append((f"{b}.noise2.weight", (1,), "0"))
        conv(f"{b}.conv1", n_in, n_out, 3, True)
        conv(f"{b}.conv2", n_out, n_out, 3, True)
        conv(f"{b}.res_branch.1", n_in, n_out, 1, True)
        conv(f"to_RGB_blocks.{i}.conv", n_out, 3, 3, False)
        n_in = n_out
    return out


def sub_seed(seed: int, stream: int) -> int:
    """A run's independent draws (catalog, generator, calibration rows,
    the check's sample) each from their own stream of `seed`."""
    return (int(seed) * 1000003 + stream) % (2 ** 63)


def make(spec: Spec, seed: int, std: float, device, torch):
    """Every leaf of `spec` from one N(0, 1) draw of a torch.Generator on
    `device` seeded with `seed`: {name: fp32 tensor on device}, views of
    one buffer."""
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    leaves, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        t = flat[at:at + n].view(shape)
        at += n
        if kind in ("w", "b"):
            t.mul_(std)
        elif kind == "g":
            t.mul_(std).add_(1.0)
        elif kind == "c":
            t.mul_(1.0 / math.sqrt(int(np.prod(shape[1:]))))
        elif kind == "0":
            t.zero_()
        leaves[name] = t
    return leaves, flat


def converge_spectral_norms(leaves: Dict, torch, iterations: int = 30):
    """u, v of every spectral-normed conv after power iterations on its
    weight matrix, as a trained checkpoint's are (models/gan's
    "converged" random generator)."""
    for name in [n for n in leaves if n.endswith(".u")]:
        base = name[:-2]
        w = leaves[f"{base}.weight"]
        mat = w.reshape(w.shape[0], -1)
        u = leaves[name]
        for _ in range(iterations):
            v = mat.t() @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
        leaves[name].copy_(u)
        leaves[f"{base}.v"].copy_(v)


def host_tree(leaves: Dict, flat, torch) -> Dict:
    """The nested numpy tree ("a/b/c" paths) of `leaves`, views of one
    host copy of `flat`."""
    host = flat.cpu().numpy()
    base = flat.data_ptr()
    tree: Dict = {}
    for name, t in leaves.items():
        at = (t.data_ptr() - base) // 4
        arr = host[at:at + t.numel()].reshape(tuple(t.shape))
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree

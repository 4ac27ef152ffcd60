"""The yardstick's arithmetic: the card's published peaks, the least time
a piece of work can take, and the work of each kernel launch and of
each model forward, computed from shapes alone.

Frozen copies: `bound` and the per-launch bytes of the int8 dense, the
packed-head attention and the fused block are chip_smoke.py's
(`bound`, `check_int8`, `check_attention`, `check_fused_block`); the
analytic operations of a VQA forward are bench.py's `flops_per_sample`,
split by the precision each product runs in, with the X-LXMERT object
head and the SPADE render's convolutions added. Nothing here imports the
program.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


class Launch(NamedTuple):
    """One kernel launch's work: which kernel, its bytes and operations,
    and the precision the operations run in."""
    kernel: str
    nbytes: float
    ops: float
    kind: str

    @property
    def bound_s(self) -> float:
        return bound_s(self.nbytes, self.ops, self.kind)


def dense_launch(M: int, K: int, N: int) -> Launch:
    """The int8 dense: x (M, K) bf16 in, w (N, K) int8, scale and bias
    (N,) fp32, out (M, N) bf16."""
    return Launch("int8_dense", M * K * 2 + N * K + M * N * 2 + N * 4 * 2,
                  2.0 * M * N * K, "int8")


def attention_launch(B: int, H: int, lq: int, lk: int, D: int,
                     bias: bool) -> Launch:
    """mha_blhd on bf16 packed heads: q and out (B, lq, H*D), k and v
    (B, lk, H*D), the key bias (B, lk) bf16; q.k and p.v."""
    nbytes = B * (2 * lq + 2 * lk) * H * D * 2 + (B * lk * 2 if bias else 0)
    return Launch("mha_blhd", nbytes, 4.0 * B * H * lq * lk * D, "bfloat16")


def fused_block_launch(M: int, Hd: int, I: int, ffn: bool,
                       Nq: int) -> Launch:
    """fused_block: the out projection, LayerNorm, with `ffn` the FFN and
    its LayerNorm, and a tail of Nq columns (0: none)."""
    n_w = Hd * Hd + (2 * Hd * I if ffn else 0) + Nq * Hd
    n_vec = 4 * Hd + (2 * I + 4 * Hd if ffn else 0) + 2 * Nq
    nbytes = 3 * M * Hd * 2 + n_w + 4 * n_vec + M * Nq * 2
    return Launch("fused_block", nbytes, 2.0 * M * n_w, "int8")


def _self_attention(B: int, T: int, H: int, D: int, bias: bool):
    return attention_launch(B, H, T, T, D, bias)


def vqa_forward_launches(sizes: Dict, B: int, L: int,
                         engine: str) -> List[Launch]:
    """Every port-kernel launch of one serving forward of B questions
    padded to L over the 8x8 grid: the int8 engine (`engine` "int8",
    serving/lxmert_int8) or the whole-block fused one ("fused")."""
    Hd, I, Fv = sizes["hidden_size"], sizes["intermediate_size"], \
        sizes["visual_feat_dim"]
    nh = sizes["num_attention_heads"]
    D = Hd // nh
    nl, nr, nx = sizes["l_layers"], sizes["r_layers"], sizes["x_layers"]
    V = sizes["visual_tokens"]
    n_ans = sizes["num_answers"]
    mt, mv = B * L, B * V
    att = ([_self_attention(B, L, nh, D, True)] * (nl + nx)
           + [_self_attention(B, V, nh, D, False)] * (nr + nx)
           + [attention_launch(B, nh, L, V, D, False)] * nx
           + [attention_launch(B, nh, V, L, D, True)] * nx)
    head = [dense_launch(B, Hd, 2 * Hd), dense_launch(B, 2 * Hd, n_ans)]
    if engine == "int8":
        dense = []
        for M, n_layers, first in ((mt, nl, []), (mv, nr,
                                                  [(Fv, Hd)])):
            groups = first + [(Hd, 3 * Hd)] * (n_layers + nx) \
                + [(Hd, Hd)] * (n_layers + 3 * nx) \
                + [(Hd, I)] * (n_layers + nx) + [(I, Hd)] * (n_layers + nx) \
                + [(Hd, 2 * Hd)] * nx
            dense += [dense_launch(M, K, N) for K, N in groups]
        return dense + att + head
    if engine == "fused":
        # visn_fc and the two stacks' first QKV run the int8 dense
        dense = [dense_launch(mv, Fv, Hd), dense_launch(mt, Hd, 3 * Hd),
                 dense_launch(mv, Hd, 3 * Hd)]
        blocks = []
        for M, n_layers in ((mt, nl), (mv, nr)):
            blocks += [fused_block_launch(M, Hd, I, True, 3 * Hd)] \
                * n_layers
        for j in range(nx):
            tail = 3 * Hd if j + 1 < nx else 0
            for M in (mt, mv):
                blocks += [fused_block_launch(M, Hd, I, False, 3 * Hd),
                           fused_block_launch(M, Hd, I, True, tail)]
        return dense + blocks + att + head
    raise ValueError(f"unknown engine {engine!r}")


def vqa_forward_ops(sizes: Dict, L: int) -> Dict[str, float]:
    """The analytic operations of one answer at text length L, by the
    precision they run in (bench.py's flops_per_sample, 2*M*K*N a
    product): int8 for every quantized dense, bfloat16 for the attention
    cores, box_fc and the pooler."""
    H, I, Fv = sizes["hidden_size"], sizes["intermediate_size"], \
        sizes["visual_feat_dim"]
    V, n_answers = sizes["visual_tokens"], sizes["num_answers"]
    nl, nr, nx = sizes["l_layers"], sizes["r_layers"], sizes["x_layers"]

    def dense(m, k, n):
        return 2.0 * m * k * n

    ops = {"int8": 0.0, "bfloat16": 0.0}

    def self_att(T):
        ops["int8"] += 3 * dense(T, H, H) + dense(T, H, H)
        ops["bfloat16"] += 2 * dense(T, T, H)

    def ffn(T):
        ops["int8"] += dense(T, H, I) + dense(T, I, H)

    ops["int8"] += dense(V, Fv, H)
    ops["bfloat16"] += dense(V, sizes["visual_pos_dim"], H)
    for _ in range(nl):
        self_att(L)
        ffn(L)
    for _ in range(nr):
        self_att(V)
        ffn(V)
    for _ in range(nx):
        ops["int8"] += 2 * dense(L, H, H) + 2 * dense(V, H, H)
        ops["int8"] += dense(L, H, H) + dense(V, H, H)
        ops["bfloat16"] += 2 * (2 * dense(L, V, H))
        ops["int8"] += dense(L, H, H) + dense(V, H, H)
        self_att(L)
        self_att(V)
        ffn(L)
        ffn(V)
    ops["bfloat16"] += dense(1, H, H)
    ops["int8"] += dense(1, H, 2 * H) + dense(1, 2 * H, n_answers)
    return ops


def sampler_launches(sizes: Dict, B: int, L: int, n_steps: int
                     ) -> List[Launch]:
    """Every port-kernel launch of one NAR batch through the int8
    sampler (serving/sampling_int8): the language stack once, then each
    decode step's visual stack, cross layers (the last one's language
    side skipped) and object head."""
    Hd, I, Fv = sizes["hidden_size"], sizes["intermediate_size"], \
        sizes["visual_feat_dim"]
    nh = sizes["num_attention_heads"]
    D = Hd // nh
    nl, nr, nx = sizes["l_layers"], sizes["r_layers"], sizes["x_layers"]
    V, K = sizes["visual_tokens"], sizes["num_clusters"]
    mt, mv = B * L, B * V

    def layer(M):
        return [dense_launch(M, Hd, 3 * Hd), dense_launch(M, Hd, Hd),
                dense_launch(M, Hd, I), dense_launch(M, I, Hd)]

    out = []
    for _ in range(nl):
        out += layer(mt) + [_self_attention(B, L, nh, D, True)]
    for _ in range(n_steps):
        out.append(dense_launch(mv, Fv, Hd))
        for _ in range(nr):
            out += layer(mv) + [_self_attention(B, V, nh, D, False)]
        for j in range(nx):
            last = j + 1 == nx
            out.append(dense_launch(mt, Hd, 2 * Hd))          # lang kv
            if not last:
                out += [dense_launch(mv, Hd, 2 * Hd),          # visn kv
                        dense_launch(mt, Hd, Hd),              # q(lang)
                        attention_launch(B, nh, L, V, D, False),
                        dense_launch(mt, Hd, Hd)]              # out(lang)
            out += [dense_launch(mv, Hd, Hd),                  # q(visn)
                    attention_launch(B, nh, V, L, D, True),
                    dense_launch(mv, Hd, Hd)]                  # out(visn)
            out += layer(mv) + [_self_attention(B, V, nh, D, False)]
            if not last:
                out += layer(mt) + [_self_attention(B, L, nh, D, True)]
        out += [dense_launch(mv, Hd, Hd), dense_launch(mv, Hd, Fv),
                dense_launch(mv, Fv, K)]
    return out


def generator_convs(sizes: Dict) -> List[Dict]:
    """Every convolution and resize product of one sample's SPADE render
    (models/gan.Generator at these sizes): dicts of cin, cout, k,
    groups, h, w (the output's size); resizes as ("resize", c, src,
    dst)."""
    G, D = sizes["grid_size"], sizes["visual_feat_dim"]
    base, S, cb = sizes["g_base_dim"], sizes["target_size"], \
        sizes["codebook_dim"]
    nhid = sizes["spade_hidden"]

    def chans(res):
        if res >= 224:
            return min(128, base)
        if res >= 112:
            return min(256, base)
        return min(512, base)

    convs = [dict(cin=D, cout=cb, k=1, groups=1, h=G, w=G),
             dict(cin=cb, cout=base, k=3, groups=4, h=G, w=G),
             dict(cin=cb, cout=base, k=3, groups=4, h=G, w=G)]
    resizes = []
    n_up = int(math.log2(S // G))
    res, n_in = G, base
    for i in range(n_up):
        src, res = res, res * 2
        n_out = chans(res)

        def spade(c, hw):
            resizes.append(("resize", base, G, hw))
            return [dict(cin=base, cout=nhid, k=3, groups=1, h=hw, w=hw),
                    dict(cin=nhid, cout=c, k=3, groups=1, h=hw, w=hw),
                    dict(cin=nhid, cout=c, k=3, groups=1, h=hw, w=hw)]

        convs += spade(n_in, src)
        resizes.append(("resize", n_in, src, res))
        convs.append(dict(cin=n_in, cout=n_out, k=3, groups=1, h=res, w=res))
        convs += spade(n_out, res)
        convs.append(dict(cin=n_out, cout=n_out, k=3, groups=1, h=res,
                          w=res))
        resizes.append(("resize", n_in, src, res))
        convs.append(dict(cin=n_in, cout=n_out, k=1, groups=1, h=res, w=res))
        convs.append(dict(cin=n_out, cout=3, k=3, groups=1, h=res, w=res))
        if i + 1 < n_up:
            resizes.append(("resize", 3, res, S))
        n_in = n_out
    return convs + [dict(resize=r) for r in resizes]


def render_ops(sizes: Dict) -> float:
    """The operations of one sample's render: 2 * cout * cin/groups *
    k*k * h*w a convolution; a bilinear resize of c channels from src to
    dst as its two interpolation products, 2*c*dst*src*src +
    2*c*dst*src*dst (models/gan.resize_bilinear)."""
    total = 0.0
    for c in generator_convs(sizes):
        if "resize" in c:
            _, ch, src, dst = c["resize"]
            total += 2.0 * ch * dst * src * src + 2.0 * ch * dst * src * dst
        else:
            total += (2.0 * c["cout"] * (c["cin"] // c["groups"])
                      * c["k"] * c["k"] * c["h"] * c["w"])
    return total


def sample_ops(sizes: Dict, L: int, n_steps: int) -> Dict[str, float]:
    """The analytic operations of one text-to-image sample, by precision:
    the int8 sampler's products (language stack once, n_steps decode
    steps, object head each step) at int8, its attention cores and
    box_fc at bfloat16, the render at bfloat16."""
    ops = {"int8": 0.0, "bfloat16": 0.0}
    for ln in sampler_launches(sizes, 1, L, n_steps):
        ops[ln.kind] += ln.ops
    V, H = sizes["visual_tokens"], sizes["hidden_size"]
    ops["bfloat16"] += n_steps * 2.0 * V * sizes["visual_pos_dim"] * H
    ops["bfloat16"] += render_ops(sizes)
    return ops


def peak_seconds(ops: Dict[str, float]) -> float:
    """Operations at the peak of the precision each runs in."""
    return sum(v / PEAK_OPS_PER_S[k] for k, v in ops.items())

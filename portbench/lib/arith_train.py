"""The yardstick's arithmetic for the pre-training cell: the operations of
one training step of each task, and the work of each launch of the
training attention kernel (csrc/mha_blhd_train.cu's bf16 forward on
csrc/attention_mma.cuh), computed from shapes alone. Nothing here
imports the program.

A step runs the whole X-LXMERT backbone forward (9 language, 5 visual
and 5 cross layers, the pooler) and the task's head, then the backward
of what its loss reaches. A product of M x K by K x N is 2 M K N
operations forward; its backward takes as many again for the weight's
gradient and as many for the input's, where the input has one. Left
out of the backward: the last cross layer's side the task does not read
(vis_mask reads the visual side; word_mask and matched the language
side), and the pooler outside `matched`. The inputs of visn_fc carry a
gradient only in `vis_mask` (the masked cells are the learned
`mask_feat`), those of box_fc never; the cluster logits' right operand
is the frozen centroid table (no weight gradient). The attention's
backward recomputes its forward in plain PyTorch: that recompute is not
counted (model operations, not the program's).
"""
from __future__ import annotations

from typing import Dict, List

from portbench.lib.arith import Launch

KERNEL = "mha_blhd_train"
# the kernel's __global__ function as the device trace names it (its
# bf16 inputs run csrc/attention_mma.cuh's tensor-core kernel)
TRACE_NAMES = ("attend_mma_kernel",)
TASKS = ("vis_mask", "word_mask", "matched")


def attention_launch(B: int, H: int, lq: int, lk: int, D: int, bias: bool,
                     mask: bool) -> Launch:
    """One forward of the training attention on bf16 packed heads: q and
    out (B, lq, H*D), k and v (B, lk, H*D), the key bias (B, lk) and the
    pre-scaled dropout mask (B, H, lq, lk), each read or written once;
    q.k and p.v."""
    nbytes = (B * (2 * lq + 2 * lk) * H * D * 2 + (B * lk * 2 if bias else 0)
              + (B * H * lq * lk * 2 if mask else 0))
    return Launch(KERNEL, nbytes, 4.0 * B * H * lq * lk * D, "bfloat16")


def attention_launches(sizes: Dict, B: int, L: int, dropout: bool
                       ) -> List[Launch]:
    """The 34 forward launches of one step: each language and cross
    layer's language self-attention (the caption's key bias), each visual
    and cross layer's visual one, and both directions of each cross
    layer (the language keys carry the bias)."""
    H = sizes["num_attention_heads"]
    D = sizes["hidden_size"] // H
    V = sizes["visual_tokens"]
    nl, nr, nx = sizes["l_layers"], sizes["r_layers"], sizes["x_layers"]
    lang = attention_launch(B, H, L, L, D, True, dropout)
    visn = attention_launch(B, H, V, V, D, False, dropout)
    return ([lang] * nl + [visn] * nr
            + [attention_launch(B, H, L, V, D, False, dropout),
               attention_launch(B, H, V, L, D, True, dropout),
               lang, visn] * nx)


def step_ops(sizes: Dict, task: str, B: int, L: int) -> float:
    """The model operations (bf16 products) of one training step of
    `task` at B examples of L tokens: forward plus backward, see the
    module docstring."""
    if task not in TASKS:
        raise ValueError(task)
    Hd, I = sizes["hidden_size"], sizes["intermediate_size"]
    F, V = sizes["visual_feat_dim"], sizes["visual_tokens"]
    nh = sizes["num_attention_heads"]
    D = Hd // nh
    nl, nr, nx = sizes["l_layers"], sizes["r_layers"], sizes["x_layers"]
    mt, mv = B * L, B * V
    total = 0.0

    def product(M, K, N, reached=True, input_grad=True):
        nonlocal total
        f = 2.0 * M * K * N
        total += f + (f + (f if input_grad else 0.0) if reached else 0.0)

    def attention(lq, lk, reached=True):
        nonlocal total
        f = 4.0 * B * nh * lq * lk * D
        total += 3 * f if reached else f

    def self_att_ffn(M, T, reached=True):
        for _ in range(4):              # q, k, v, out
            product(M, Hd, Hd, reached)
        attention(T, T, reached)
        product(M, Hd, I, reached)
        product(M, I, Hd, reached)

    vis = task == "vis_mask"
    product(mv, F, Hd, input_grad=vis)                 # visn_fc
    product(mv, sizes["visual_pos_dim"], Hd, input_grad=False)  # box_fc
    for _ in range(nl):
        self_att_ffn(mt, L)
    for _ in range(nr):
        self_att_ffn(mv, V)
    for j in range(nx):
        last = j + 1 == nx
        lang_side = not last or not vis
        visn_side = not last or vis
        # the shared cross-attention: language queries over the visual
        # keys, then visual queries over the language keys
        for M_q, M_kv, lq, lk, reached in ((mt, mv, L, V, lang_side),
                                           (mv, mt, V, L, visn_side)):
            product(M_q, Hd, Hd, reached)              # q
            product(M_kv, Hd, Hd, reached)             # k
            product(M_kv, Hd, Hd, reached)             # v
            attention(lq, lk, reached)
            product(M_q, Hd, Hd, reached)              # out
        self_att_ffn(mt, L, lang_side)
        self_att_ffn(mv, V, visn_side)
    product(B, Hd, Hd, task == "matched")              # the pooler
    if task == "word_mask":
        product(mt, Hd, Hd)                            # transform
        product(mt, Hd, sizes["vocab_size"])           # tied decoder
    elif task == "matched":
        product(B, Hd, 2)
    else:
        product(mv, Hd, Hd)                            # transform
        product(mv, Hd, F)                             # linear_feat
        # against the frozen centroids: the input's gradient only
        f = 2.0 * mv * F * sizes["num_clusters"]
        total += 2 * f
    return total

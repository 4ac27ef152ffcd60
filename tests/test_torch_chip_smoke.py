"""chip_smoke.py on the CPU: its kernel phase checks every shape that its
serving path launches a kernel at, as many times per forward as the path
does, and its path phase runs end to end at a small width.

The card itself is not needed: on the CPU the kernel wrappers take their
plain versions, and the test records the shapes they are called at.
"""
import math
import os
import sys
from collections import Counter

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from xlxmert_tpu_torch.cli import serve as serve_mod  # noqa: E402
from xlxmert_tpu_torch.core.config import LxmertConfig  # noqa: E402
from xlxmert_tpu_torch.ops import int8_matmul  # noqa: E402
from xlxmert_tpu_torch.serving import lxmert_int8 as engine  # noqa: E402


def test_kernel_cases_cover_every_launch_of_each_full_width_forward():
    cfg = LxmertConfig()
    att = list(chip_smoke.attention_cases(cfg, chip_smoke.BATCH))
    dense = list(chip_smoke.dense_cases(cfg, chip_smoke.BATCH, 3129))
    for kind in chip_smoke.forward_kinds():
        assert sum(c[-1].get(kind, 0) for c in att) \
            == chip_smoke.PER_FORWARD["mha_blhd"]
        assert sum(c[-1].get(kind, 0) for c in dense) \
            == chip_smoke.PER_FORWARD["int8_dense"]
    on_path = {(b, lq, lk) for b, lq, lk, _, _, _, uses in att if uses}
    for L in chip_smoke.BUCKETS:
        assert {(256, L, L), (256, L, 64), (256, 64, L)} <= on_path
    assert {(8, 20, 20), (8, 64, 64), (8, 20, 64), (8, 64, 20)} <= on_path


def test_path_phase_launches_exactly_the_kernel_phase_cases(monkeypatch):
    # intermediate_size != 2 * hidden_size, as at full width: the dense
    # cases are keyed by (K, N)
    cfg = LxmertConfig(vocab_size=4100, hidden_size=32,
                       num_attention_heads=2, intermediate_size=48,
                       l_layers=2, x_layers=1, r_layers=1,
                       visual_feat_dim=16)
    seen = {"mha_blhd": Counter(), "int8_dense": Counter()}
    recording = [False]
    forwards = Counter()
    mha, dense, serve = (engine.mha_blhd, int8_matmul.int8_dense_fused,
                         serve_mod.serve)

    def mha_rec(q, k, v, bias, n_heads, fast=True):
        if recording[0]:
            seen["mha_blhd"][q.shape[0], q.shape[1], k.shape[1],
                             bias is not None] += 1
        return mha(q, k, v, bias, n_heads, fast=fast)

    def dense_rec(x, w_i8, col_scale, bias=None, inv_a=None):
        if recording[0]:
            seen["int8_dense"][x.numel() // x.shape[-1], x.shape[-1],
                               w_i8.shape[0], inv_a is not None] += 1
        return dense(x, w_i8, col_scale, bias, inv_a)

    def serve_rec(questions, tokenizer, *args, **kw):
        # forwards of each kind, as serve() batches the stream
        ids = tokenizer.encode_batch([q["sent"] for q in questions],
                                     max(chip_smoke.BUCKETS))
        n_tok, low = (ids > 0).sum(axis=1), 0
        for L in chip_smoke.BUCKETS:
            n = int(((n_tok > low) & (n_tok <= L)).sum())
            forwards[f"L={L}"] = math.ceil(n / chip_smoke.BATCH)
            low = L
        forwards["calib"] = math.ceil(min(chip_smoke.CALIB_SAMPLES,
                                          len(questions))
                                      / chip_smoke.CALIB_BATCH)
        recording[0] = True
        try:
            return serve(questions, tokenizer, *args, **kw)
        finally:
            recording[0] = False

    monkeypatch.setattr(engine, "mha_blhd", mha_rec)
    monkeypatch.setattr(int8_matmul, "int8_dense_fused", dense_rec)
    monkeypatch.setattr(serve_mod, "serve", serve_rec)
    args = chip_smoke.parse_args(["--seed", "3"])
    path, (qp, _) = chip_smoke.run_path(torch, args, [], lambda m: None,
                                        cfg=cfg, device="cpu")

    assert all(forwards[k] > 0 for k in chip_smoke.forward_kinds())
    assert path["answers"] == chip_smoke.QUESTIONS
    assert path["forwards"] == sum(forwards.values())
    assert set(path["card_vs_cpu"]) == set(chip_smoke.BUCKETS)
    assert all(c["argmax_equal"] == c["queries"] == chip_smoke.CALIB_BATCH
               and c["cosine"] > 0.99 and not c["swap_margins_sd"]
               for c in path["card_vs_cpu"].values())
    assert qp.embeddings.word.device.type == "cpu"

    def expected(cases):
        out = Counter()
        for *shape, uses in cases:
            for kind, n in uses.items():
                out[tuple(shape)] += n * forwards[kind]
        return out

    att = expected((b, lq, lk, bias, uses) for b, lq, lk, bias, _, _, uses
                   in chip_smoke.attention_cases(cfg, chip_smoke.BATCH))
    dense_cases = expected(chip_smoke.dense_cases(cfg, chip_smoke.BATCH,
                                                  3129))
    assert seen["mha_blhd"] == att
    assert seen["int8_dense"] == dense_cases
    for name, calls in seen.items():
        assert sum(calls.values()) == sum(
            forwards.values()) * {"mha_blhd": cfg.l_layers + cfg.r_layers
                                  + 4 * cfg.x_layers,
                                  "int8_dense": 4 * cfg.l_layers
                                  + 4 * cfg.r_layers + 14 * cfg.x_layers
                                  + 3}[name]

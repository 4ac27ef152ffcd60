"""chip_smoke.py's phase (n), distributed training, on the CPU at small
widths with the card's work done on CPU tensors: the 2-rank torchrun-
style launch through cli/finetune on both routes with the int8
evaluation merged, tp = 2 pre-training per task against the single
process, the sharded feature table and the 3-stage pipeline against the
sequential stack, every rank its own process over gloo."""
import argparse
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SMALL_MODEL = dict(vocab_size=256, hidden_size=48, num_attention_heads=4,
                   intermediate_size=96, l_layers=3, x_layers=1, r_layers=1,
                   visual_feat_dim=24, num_clusters=50)
SMALL = dict(batch=4, steps=2, eval=8, images=6, answers=13, text=8,
             feat_dim=24, pt_batch=4, stages=3, micro=2,
             pipe_batch=4, table_images=7, table_batch=5, timeout=240)


def test_distributed_phase_runs_on_the_cpu():
    from xlxmert_tpu_torch.ops import attention

    log = []
    kernels = [attention.KERNEL, attention.TRAIN_KERNEL]
    out = chip_smoke.run_distributed_path(
        torch, argparse.Namespace(seed=0), kernels, log.append,
        device="cpu", sizes=SMALL, model_kw=SMALL_MODEL)
    assert out["backend"] == "gloo" and out["ranks"] == 2
    for route in chip_smoke.DIST_ROUTES:
        r = out["routes"][route]
        assert r["steps"] == SMALL["steps"] and r["step_ms"] > 0
        # the gradient all-reduce: every fp32 gradient once a step
        assert r["allreduce_bytes_per_step"] > 4 * 10_000
        assert 0.0 <= r["score_int8_merged"] <= 1.0
        assert r["eval_forwards_per_rank"] == [2, 2]
    assert set(out["tp"]["tasks"]) == set(chip_smoke.PT_TASKS)
    assert out["tp"]["heads_per_rank"] == 2
    for c in out["tp"]["tasks"].values():
        assert c["loss_rel_diff"] < 1e-5 and c["grad_cosine"] > 0.99999
    assert out["table"]["rows_per_rank"] == [4, 4]
    pl = out["pipeline"]
    assert pl["layers_per_stage"] == [1, 1, 1]
    assert pl["bubble_predicted"] == pytest.approx(0.5)
    assert all(0.0 <= b < 1.0 for b in pl["bubble_per_stage"])
    assert any("pipeline" in m for m in log)
    json.dumps(out)       # chip_smoke writes it to --out


def test_phase_b_covers_the_distributed_steps(monkeypatch):
    """Phase (b)'s mha_blhd_train cases cover (n)'s steps: a
    data-parallel rank's step at B=FT_BATCH (the VQA step's bf16 masked
    rows) and the tp = 2 step's H/2 heads (384 packed columns at full
    width) at PT_CHECK in fp32 without a mask, 34 launches each; the
    check runs those cases on CPU tensors at a small width."""
    import torch.nn.functional as F

    from test_torch_chip_smoke_phase_b import _CpuTorch
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.ops import attention

    full = LxmertConfig()
    per = chip_smoke.PER_FORWARD["pretrain pallas_blhd"]["mha_blhd_train"]
    dp = [c for c in chip_smoke.train_attention_cases(full)
          if "n dp step" in c[-1]]
    assert sum(c[-1]["n dp step"] for c in dp) == per == 34
    assert {(c[0], c[4], c[5]) for c in dp} == {
        (chip_smoke.DIST_SIZES["batch"], "bfloat16", True)}
    tp = list(chip_smoke.tp_train_attention_cases(full))
    assert sum(c[-1]["n tp check float32"] for c in tp) == per
    assert {(c[0], c[4], c[5], c[6] * 64) for c in tp} == {
        (chip_smoke.DIST_SIZES["pt_batch"], "float32", False, 384)}
    def queued(torch_, fns):
        for fn in fns.values():
            fn()
        return {**dict.fromkeys(fns, 1.0), "not_queued": []}

    class Cpu(_CpuTorch):
        """the card's tensors made on the CPU"""

        @staticmethod
        def randn(*shape, generator=None, device=None, **kw):
            return torch.randn(*shape, **kw)

    def qkv_bias(torch_, rng, B, lq, lk, HD, dtype, with_bias):
        qkv = torch.randn(B, lq, 3 * HD).to(dtype)
        kv = torch.randn(B, lk, 2 * HD).to(dtype)
        bias = None
        if with_bias:
            bias = torch.zeros(B, lk, dtype=torch.bfloat16)
            bias[0, lk // 2:] = -1e9
        return qkv[..., :HD], kv[..., :HD], kv[..., HD:], bias

    monkeypatch.setattr(chip_smoke, "queued_times", queued)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda torch_, fn: 1.0)
    monkeypatch.setattr(chip_smoke, "_qkv_bias", qkv_bias)
    small = LxmertConfig(hidden_size=128, num_attention_heads=4,
                         intermediate_size=96, l_layers=2, x_layers=1,
                         r_layers=1)
    monkeypatch.setattr(chip_smoke, "PT_CHECK", 2)
    rows = chip_smoke.check_train_attention(
        Cpu(), F, attention, small, None, lambda m: None,
        cases=chip_smoke.tp_train_attention_cases(small))
    assert {r["heads"] for r in rows} == {2} and len(rows) == 4
    assert all(r["max_abs_err"] <= r["tol"] for r in rows)
    times = chip_smoke.per_forward(rows, None, chip_smoke.TP_KINDS)
    assert times["n tp check float32"]["ms"] == (
        small.l_layers + small.r_layers + 4 * small.x_layers)

"""chip_smoke.py's text-to-image phase (j) on the CPU: its launch
arithmetic against the launches the int8 sampler makes (recorded at a
small width), its kernel cases covering each of them, the tie-aware
agreement, and the whole phase end to end at a small width with the
card's work done on CPU tensors. Apart from tests/test_torch_chip_smoke.py,
whose path phases take long, so that the files run on separate workers."""
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401
from xlxmert_tpu_torch.core.config import LxmertConfig  # noqa: E402
from xlxmert_tpu_torch.ops import int8_matmul  # noqa: E402
from xlxmert_tpu_torch.serving import lxmert_int8 as engine  # noqa: E402

# intermediate_size != 2 * hidden_size, as at full width: the dense
# cases are keyed by (K, N)
CFG = dict(vocab_size=4100, hidden_size=32, num_attention_heads=2,
           intermediate_size=48, l_layers=2, x_layers=2, r_layers=1,
           visual_feat_dim=16)
SIZES = dict(batch=3, text=8, batches=2, grid=4, nar_steps=3, clusters=30,
             check=2, base_dim=8, target_size=16, codebook_dim=8)

pytestmark = pytest.mark.usefixtures("share_the_cores")


class FakeKernel:
    def __init__(self, name):
        self.name, self.launches = name, 0


@pytest.fixture
def recorded(monkeypatch):
    """mha_blhd and the int8 dense replaced by recorders that count each
    call as a launch of a FakeKernel and record its shape."""
    kernels = {n: FakeKernel(n) for n in ("mha_blhd", "int8_dense",
                                          "fused_ffn")}
    seen = {"mha_blhd": Counter(), "int8_dense": Counter()}
    mha, dense = engine.mha_blhd, int8_matmul.int8_dense_fused

    def mha_rec(q, k, v, bias, n_heads, fast=True):
        kernels["mha_blhd"].launches += 1
        seen["mha_blhd"][q.shape[0], q.shape[1], k.shape[1],
                         bias is not None] += 1
        return mha(q, k, v, bias, n_heads, fast=fast)

    def dense_rec(x, w_i8, col_scale, bias=None, inv_a=None):
        kernels["int8_dense"].launches += 1
        seen["int8_dense"][x.numel() // x.shape[-1], x.shape[-1],
                           w_i8.shape[0], inv_a is not None] += 1
        return dense(x, w_i8, col_scale, bias, inv_a)

    monkeypatch.setattr(engine, "mha_blhd", mha_rec)
    monkeypatch.setattr(int8_matmul, "int8_dense_fused", dense_rec)
    return list(kernels.values()), seen


def test_launch_arithmetic_and_cases_match_the_int8_sampler(recorded):
    """A calibration, then one NAR batch and one AR batch of the port's
    int8 sampler: each phase's launches and shapes are what
    sampler_launches and the kernel cases say."""
    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.tasks import sampling

    kernels, seen = recorded
    cfg = LxmertConfig(**CFG, num_clusters=30)
    B, T, grid = 3, 8, 4
    params = sampling.random_params(cfg, seed=0)
    centroids = np.random.RandomState(0).randn(30, 16).astype(np.float32)
    sp = si.prepare_sampler_params(params, cfg, centroids, "cpu")
    ids = torch.randint(1, 50, (B, T))
    mask = torch.ones(B, T)
    table = torch.from_numpy(centroids)
    per = chip_smoke.sampler_launches(cfg)
    att = list(chip_smoke.sampler_attention_cases(cfg, B, T, grid * grid))
    dense = list(chip_smoke.sampler_dense_cases(cfg, B, T, 30, grid * grid))

    def expect(cases, kind, n=1):
        out = Counter()
        for case in cases:
            shape = ((case[0], case[1], case[2], case[3]) if len(case) == 7
                     else case[:4])
            if kind in case[-1]:
                out[shape] += n * case[-1][kind]
        return out

    def run(fn, kind, n=1):
        for k in kernels:
            k.launches = 0
        for c in seen.values():
            c.clear()
        fn()
        assert seen["mha_blhd"] == expect(att, kind, n)
        assert seen["int8_dense"] == expect(dense, kind, n)
        return {k.name: k.launches for k in kernels}

    got = run(lambda: si.calibrate_sampler(sp, table, ids, mask, cfg, grid),
              "sample calib", 3)
    assert got == {"mha_blhd": 3 * per["sample calib"]["mha_blhd"],
                   "int8_dense": 3 * per["sample calib"]["int8_dense"],
                   "fused_ffn": 0}
    engine.apply_calibration(sp)
    with torch.inference_mode():
        got = run(lambda: engine.lang_encode(sp.bert, ids, mask, 2),
                  "sample lang")
    assert got["mha_blhd"] == per["sample lang"]["mha_blhd"] == 2
    steps = {"NAR": 3, "AR": grid * grid}
    for mode, n_steps in steps.items():
        sampler = (si.make_nar_sampler_int8(cfg, n_steps, grid)
                   if mode == "NAR" else si.make_ar_sampler_int8(cfg, grid))
        for k in kernels:
            k.launches = 0
        for c in seen.values():
            c.clear()
        sampler(sp, table, ids, mask)
        for name, cases in (("mha_blhd", att), ("int8_dense", dense)):
            assert seen[name] == expect(cases, "sample lang") + expect(
                cases, "sample step", n_steps)
        want = chip_smoke.expected_sample_launches(cfg, True, 1,
                                                   n_steps)["loop"]
        assert {k.name: k.launches for k in kernels} == {**want,
                                                         "fused_ffn": 0}
    # one decode step alone: the language stack's launches subtracted
    lang = per["sample lang"]
    assert (want["int8_dense"] - lang["int8_dense"]) / steps["AR"] \
        == per["sample step"]["int8_dense"] == 1 + 4 + 14 * 2 - 7 + 3
    zero = {"mha_blhd": 0, "int8_dense": 0}
    assert chip_smoke.expected_sample_launches(cfg, False, 3, 4) == {
        "calib": zero, "loop": zero}
    assert chip_smoke.expected_sample_launches(cfg, True, 3, 4)["calib"] \
        == {k: 3 * n for k, n in per["sample calib"].items()}
    # the full-width counts PERF.md quotes
    full = chip_smoke.sampler_launches(LxmertConfig())
    assert full == {"sample calib": {"mha_blhd": 34, "int8_dense": 130},
                    "sample lang": {"mha_blhd": 9, "int8_dense": 36},
                    "sample step": {"mha_blhd": 23, "int8_dense": 87}}
    cases = list(chip_smoke.sampler_dense_cases(LxmertConfig(), 64, 20,
                                                10000))
    assert (4096, 2048, 10000, True) in {c[:4] for c in cases}
    for name, rows in (("mha_blhd", [{"uses": c[-1]} for c in
                                     chip_smoke.sampler_attention_cases(
                                         LxmertConfig(), 64, 20)]),
                       ("int8_dense", [{"uses": c[-1]} for c in cases])):
        chip_smoke.sampler_cases_cover_launches(name, rows, LxmertConfig())


def test_tie_aware_agreement():
    host = torch.tensor([[[1.0, 3.0, 3.0, 0.0],     # tie at 1 and 2
                          [2.0, 1.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0, 5.0]]])
    # picks 2 (a tied max: counts), 0 (the max), 2 (not the max)
    card = torch.tensor([[[0.0, 1.0, 2.0, 0.0],
                          [9.0, 1.0, 0.0, 0.0],
                          [0.0, 0.0, 7.0, 6.0]]])
    assert chip_smoke.tie_aware_agreement(card, host) == pytest.approx(2 / 3)
    assert chip_smoke.tie_aware_agreement(host, host) == 1.0
    # a card pick one step below the CPU's maximum does not count
    near = host.clone()
    near[0, 0, 2] -= 2.0 ** -7
    assert chip_smoke.tie_aware_agreement(card, near) == pytest.approx(1 / 3)


def test_sample_phase_runs_end_to_end_on_the_cpu(recorded, monkeypatch):
    """Phase (j) at a small width on the CPU: every run through
    cli/sample_images with its launches checked exactly, the semantics,
    the teacher-forced steps (CPU against CPU: equal) and the render
    check (bf16 against fp32)."""
    kernels, _ = recorded
    lines = []
    args = chip_smoke.parse_args(["--seed", "2"])
    out = chip_smoke.run_sample_path(torch, args, kernels, lines.append,
                                     cfg=LxmertConfig(**CFG),
                                     device="cpu", sizes=SIZES)
    assert set(out["runs"]) == set(chip_smoke.SAMPLE_RUNS)
    cfg = LxmertConfig(**CFG)
    for name, row in out["runs"].items():
        int8 = "--int8" in row["flags"]
        want = chip_smoke.expected_sample_launches(cfg, int8, 2,
                                                   row["steps"])
        assert row["calib_launches"] == {**want["calib"], "fused_ffn": 0}
        assert row["launches"] == {**want["loop"], "fused_ffn": 0}
        assert row["batches"] == 2 and row["samples_per_s"] > 0
    for name in chip_smoke.SAMPLE_CHECKED:
        check = out["runs"][name]["card_vs_cpu"]
        assert len(check["steps"]) == SIZES["nar_steps"]
        assert all(s["cosine"] > 0.9999 and s["argmax_agree"] == 1.0
                   for s in check["steps"])
        assert check["trajectory_ids_equal"] == 1.0
    units = [s["units"] for s in out["runs"]["NAR int8"]["card_vs_cpu"][
        "steps"]]
    names = ["language stack", "visual embeddings", "visual layer 0",
             "cross layer 0", "cross layer 1", "cluster head"]
    assert all([u["unit"] for u in step] == names for step in units)
    assert all(u["cosine"] > 0.9999 for step in units for u in step)
    assert all(step[-1]["argmax_agree"] == 1.0 for step in units)
    assert all(s["chain_equals_the_run"] for s in out["runs"]["NAR int8"][
        "card_vs_cpu"]["steps"])
    r = out["runs"]["NAR int8"]["render_card_vs_cpu"]
    assert r["mean_abs_diff"] <= chip_smoke.RENDER_MEAN_TOL
    assert "fast_vs_exact_mean_abs_diff" in out["runs"][
        "NAR int8 fast_render"]
    assert out["launches"]["mha_blhd"] == sum(
        row["launches"]["mha_blhd"] + row["calib_launches"]["mha_blhd"]
        for row in out["runs"].values()) > 0


def test_semantics_check_fails_on_a_wrong_commit(monkeypatch):
    """check_sample_semantics refuses final ids that are not the steps'
    commits, and an AR step that commits two cells."""
    B, n_cells = 2, 4
    vm = torch.ones(B, n_cells, dtype=torch.bool)
    pred = torch.arange(B * n_cells).reshape(B, n_cells) % 3
    rec = chip_smoke.StepRecorder()
    rec.batches = [[(vm, pred)]]
    table = torch.randn(3, 5)
    good = {"ids": pred.numpy(), "codes": table[pred]}
    assert chip_smoke.check_sample_semantics(
        torch, rec, good, table, "NAR", "confidence", 1, B, n_cells, 3) == 1
    bad = {"ids": (pred.numpy() + 1) % 3, "codes": table[(pred + 1) % 3]}
    with pytest.raises(SystemExit):
        chip_smoke.check_sample_semantics(
            torch, rec, bad, table, "NAR", "confidence", 1, B, n_cells, 3)
    with pytest.raises(SystemExit):
        chip_smoke.check_sample_semantics(
            torch, rec, good, table, "AR", "confidence", 1, B, n_cells, 3)

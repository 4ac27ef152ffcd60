"""chip_smoke.py's phase (o), int8-attention serving, on the CPU at a
small width: the kernel phase's mha_int8 cases cover every launch of a
full-width serving forward; the phase serves every question with the
switch on after calibration, calls mha_int8 at exactly those cases and
mha_blhd in no serving forward; and its launch-count, agreement and
refusal gates fail the run on doctored inputs."""
import math
import os
import sys
from collections import Counter

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from xlxmert_tpu_torch.cli import serve as serve_mod  # noqa: E402
from xlxmert_tpu_torch.core.config import LxmertConfig  # noqa: E402
from xlxmert_tpu_torch.serving import lxmert_int8 as engine  # noqa: E402

# weights drawn wider than BERT's 0.02: at this width and 0.02 every
# question gets nearly the same logits whatever the attention computes,
# and no agreement gate could tell a wrong attention from a right one
CFG = dict(vocab_size=4100, hidden_size=32, num_attention_heads=2,
           intermediate_size=48, l_layers=2, x_layers=1, r_layers=1,
           visual_feat_dim=16, initializer_range=0.3)


@pytest.fixture
def short_stream(monkeypatch):
    """tests/test_torch_chip_smoke.py's cut of the question stream."""
    monkeypatch.setattr(chip_smoke, "BATCH", 24)
    monkeypatch.setattr(chip_smoke, "QUESTIONS", 192)
    monkeypatch.setattr(chip_smoke, "IMAGES", 48)
    monkeypatch.setattr(chip_smoke, "CALIB_SAMPLES", 24)


def quiet(_):
    pass


def test_mha_int8_cases_cover_every_launch_of_a_full_width_forward():
    cfg = LxmertConfig()
    cases = list(chip_smoke.mha_int8_cases(cfg, chip_smoke.BATCH))
    per = chip_smoke.PER_FORWARD["int8+int8_attention"]
    assert per == {"mha_int8": 34, "int8_dense": 129}
    for kind in chip_smoke.KINDS["mha_int8"]:
        assert sum(c[-1].get(kind, 0) for c in cases) == per["mha_int8"]
    assert "calib" not in chip_smoke.KINDS["mha_int8"]
    shapes = {(b, lq, lk) for b in (256, 8) for L in chip_smoke.BUCKETS
              for lq, lk in ((L, L), (64, 64), (L, 64), (64, L))}
    path = [c for c in cases if c[:3] in shapes]
    assert {c[:3] for c in path} == shapes
    # every shape with and without a bias, the path's one marked
    assert len(path) == 2 * len(shapes)
    assert {(b, lq, lk, bias) for b, lq, lk, bias, uses in cases if uses} \
        == {(b, lq, lk, lq == lk != 64 or (lq == 64 and lk != 64))
            for b, lq, lk in shapes}
    kernels = chip_smoke.port_kernels()
    assert [k.name for k in kernels][-1] == "mha_int8"
    assert kernels[-1].source.endswith(os.path.join("csrc", "mha_int8.cu"))


def test_mha_int8_cases_hold_the_tile_edges_and_the_sampler_shapes():
    """Beside the path's cases, checked and never timed: the int8
    sampler's decode-step shapes at Config #2's B=64 and the new tiling's
    edges (16-row query tiles, 32-key chunks), each with a bias, without
    one and (the edges) with a bias that masks all keys of a batch row
    but one."""
    cfg = LxmertConfig()
    cases = list(chip_smoke.mha_int8_cases(cfg, chip_smoke.BATCH))
    assert len(set((b, lq, lk, str(bias)) for b, lq, lk, bias, _ in cases)) \
        == len(cases)
    path = {(b, lq, lk) for b, lq, lk, _, uses in cases if uses}
    assert {b for b, *_ in path} == {chip_smoke.BATCH, chip_smoke.CALIB_BATCH}
    others = [c for c in cases if c[:3] not in path]
    assert all(not uses for *_, uses in others)
    sampler = {(b, lq, lk, bias) for b, lq, lk, bias, _ in others
               if b == chip_smoke.SAMPLE_SIZES["batch"]}
    T = chip_smoke.SAMPLE_SIZES["text"]
    assert chip_smoke.SAMPLE_SIZES["batch"] == 64 and T == 20
    assert sampler == {(64, lq, lk, bias)
                       for lq, lk in ((T, T), (64, 64), (T, 64), (64, T))
                       for bias in (True, False)}
    # the sampler's decode step launches the attention at exactly these
    step = {c[1:3] for c in chip_smoke.sampler_attention_cases(cfg, 64, T)
            if "sample step" in c[-1]}
    assert step == {(lq, lk) for _, lq, lk, _ in sampler}
    edges = {(lq, lk, bias) for b, lq, lk, bias, _ in others
             if b == chip_smoke.CALIB_BATCH}
    assert edges == {(lq, lk, bias) for lq in (1, 15, 17)
                     for lk in (1, 31, 32, 33, 63)
                     for bias in (True, False, chip_smoke.ONE_KEY)}
    assert len(others) == len(sampler) + len(edges)
    # the timed rows are the path's: per_forward reads no other case
    rows = [{"uses": uses, "ms": 1.0, **chip_smoke.bound(1.0, 1.0, "int8")}
            for *_, uses in cases]
    t = chip_smoke.per_forward(rows, engine.VQA_LENGTH_MIX,
                               chip_smoke.KINDS["mha_int8"])
    for kind in chip_smoke.KINDS["mha_int8"]:
        assert t[kind]["ms"] == 34


def test_phase_o_serves_through_mha_int8_at_the_kernel_cases(monkeypatch,
                                                             short_stream):
    cfg = LxmertConfig(**CFG)
    serving, calls = [False], Counter()
    blhd_in_serving = [0]
    mha_int8, mha_blhd, serve = (engine.mha_int8, engine.mha_blhd,
                                 serve_mod.serve)

    def int8_rec(q, k, v, bias, n_heads, inv, scale):
        if serving[0]:
            calls[q.shape[0], q.shape[1], k.shape[1], bias is not None] += 1
        return mha_int8(q, k, v, bias, n_heads, inv, scale)

    def blhd_rec(q, k, v, bias, n_heads, fast=True):
        if serving[0] and engine._INT8_ATTENTION:
            blhd_in_serving[0] += 1
        return mha_blhd(q, k, v, bias, n_heads, fast=fast)

    def serve_rec(*a, **kw):
        serving[0] = True
        try:
            return serve(*a, **kw)
        finally:
            serving[0] = False

    monkeypatch.setattr(engine, "mha_int8", int8_rec)
    monkeypatch.setattr(engine, "mha_blhd", blhd_rec)
    monkeypatch.setattr(serve_mod, "serve", serve_rec)
    args = chip_smoke.parse_args(["--seed", "5"])
    setup = chip_smoke.Setup(torch, args, quiet, cfg, "cpu")
    assert setup.tokenizer.native and setup.encode_rates["rows"] == 4096
    path, _, answers = chip_smoke.run_path(torch, args, [], quiet,
                                           setup=setup, device="cpu")
    calls.clear()
    out = chip_smoke.run_int8_attention_path(
        torch, args, [], quiet, setup=setup, device="cpu", int8_path=path,
        int8_answers=answers)
    assert not engine._INT8_ATTENTION
    assert out["answers"] == chip_smoke.QUESTIONS
    assert out["answers_equal_to_int8"] >= 0.8 * chip_smoke.QUESTIONS
    assert out["argmax_agreement"] >= chip_smoke.INT8_ATT_AGREE
    assert all(c["cosine"] > 0.99
               for c in out["against_bf16_attention"].values())
    assert set(out["card_vs_cpu"]) == set(chip_smoke.BUCKETS)
    assert "calibrated" in out["uncalibrated_error"]
    assert blhd_in_serving[0] == 0
    # serving forwards of each bucket, as serve() batches the stream
    ids = setup.tokenizer.encode_batch([q["sent"] for q in setup.questions],
                                       max(chip_smoke.BUCKETS))
    n_tok, low, forwards = (ids > 0).sum(axis=1), 0, Counter()
    for L in chip_smoke.BUCKETS:
        n = int(((n_tok > low) & (n_tok <= L)).sum())
        forwards[f"L={L}"] = math.ceil(n / chip_smoke.BATCH)
        low = L
    assert out["serve_forwards"] == sum(forwards.values())
    want = Counter()
    for b, lq, lk, bias, uses in chip_smoke.mha_int8_cases(
            cfg, chip_smoke.BATCH):
        for kind, n in uses.items():
            want[b, lq, lk, bias] += n * forwards.get(kind, 0)
    assert calls == +want


def test_launch_gate_fails_on_a_doctored_count():
    n = 3
    good = {"mha_int8": 34 * n, "int8_dense": 129 * n, "mha_blhd": 0}
    chip_smoke.check_launches("int8+int8_attention", good, n)
    for doctored in ({**good, "mha_int8": 33 * n},
                     {**good, "mha_blhd": 34 * n},
                     {**good, "int8_dense": 128 * n}):
        with pytest.raises(SystemExit):
            chip_smoke.check_launches("int8+int8_attention", doctored, n)


def test_agreement_gate_fails_on_a_doctored_attention(monkeypatch,
                                                      short_stream):
    """An int8 attention that returns large noise: its logits leave the
    bf16 attention's, and the phase fails."""
    gen = torch.Generator().manual_seed(0)

    def noise(q, k, v, bias, n_heads, inv, scale):
        return (torch.randn(q.shape, generator=gen) * 100).to(q.dtype)

    monkeypatch.setattr(engine, "mha_int8", noise)
    args = chip_smoke.parse_args(["--seed", "5"])
    with pytest.raises(SystemExit):
        chip_smoke.run_int8_attention_path(
            torch, args, [], quiet, cfg=LxmertConfig(**CFG), device="cpu")
    assert not engine._INT8_ATTENTION


def test_refusal_gate_fails_when_an_uncalibrated_tree_serves(monkeypatch):
    """A _core that ignores the calibration serves an uncalibrated tree:
    the check fails the run."""
    def core(q, k, v, bias, n_heads, act):
        return engine._attention_core(q, k, v, bias, n_heads)

    monkeypatch.setattr(engine, "_core", core)
    with pytest.raises(SystemExit):
        chip_smoke.uncalibrated_refuses(torch, engine, "cpu")
    assert not engine._INT8_ATTENTION


def test_int8_attention_variants_script_edits_match_the_kernel_source():
    """scripts/time_int8_attention_variants.py times text edits of
    csrc/mha_int8.cu: each edit's text is in the source once, and the
    variants held to base's bits are the ones that keep its arithmetic."""
    import importlib.util

    path = os.path.join(ROOT, "scripts", "time_int8_attention_variants.py")
    spec = importlib.util.spec_from_file_location("int8_att_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(mod.SOURCE) as f:
        src = f.read()
    for name, edits in mod.EDITS.items():
        for old, new in edits:
            assert src.count(old) == 1, name
            assert old != new
    assert set(mod.EXACT) <= set(mod.EDITS)
    assert all(name.startswith("no_") for name in set(mod.EDITS)
               - set(mod.EXACT))

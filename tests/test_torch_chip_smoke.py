"""chip_smoke.py on the CPU: its kernel phase checks every shape that its
serving and fine-tuning paths launch a kernel at, as many times per
forward or training step as the paths do, and its path phases (int8,
bf16 in three configurations, the whole-block fused int8 engine and
fine-tuning) run end to end at a small width.

The card itself is not needed: on the CPU the kernel wrappers take their
plain versions, and the test records the shapes they are called at.
"""
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
from xlxmert_tpu_torch.models import lxmert  # noqa: E402
from xlxmert_tpu_torch.ops import int8_matmul  # noqa: E402
from xlxmert_tpu_torch.serving import lxmert_fused  # noqa: E402
from xlxmert_tpu_torch.serving import lxmert_int8 as engine  # noqa: E402


@pytest.fixture
def share_the_cores():
    """Torch's share of the CPU cores for the test: each pytest-xdist
    worker's torch would start a thread per core, and with several
    workers on one machine the many small ops of these tests wait on each
    other's spinning threads (a test took 25 times as long as alone)."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


pytestmark = pytest.mark.usefixtures("share_the_cores")


@pytest.fixture
def short_stream(monkeypatch):
    """chip_smoke's question stream cut for the path phases on the CPU:
    fewer questions in smaller batches over a smaller catalog, and fewer
    calibration samples. Every bucket still serves a batch, most of them
    several with a partial last one, and the launch arithmetic is the
    same at any size; a batch of 24 shares no shape with the checks' 8,
    the evaluations' 32 or NLVR2's 64."""
    monkeypatch.setattr(chip_smoke, "BATCH", 24)
    monkeypatch.setattr(chip_smoke, "QUESTIONS", 192)
    monkeypatch.setattr(chip_smoke, "IMAGES", 48)
    monkeypatch.setattr(chip_smoke, "CALIB_SAMPLES", 24)


def test_kernel_cases_cover_every_launch_of_each_full_width_forward():
    cfg = LxmertConfig()
    att = list(chip_smoke.attention_cases(cfg, chip_smoke.BATCH))
    dense = list(chip_smoke.dense_cases(cfg, chip_smoke.BATCH, 3129))
    fmha = list(chip_smoke.fused_mha_cases(cfg, chip_smoke.BATCH))
    ffn = chip_smoke.ffn_cases(cfg, chip_smoke.BATCH)
    per = chip_smoke.PER_FORWARD
    for kind in chip_smoke.forward_kinds():
        assert sum(c[-1].get(kind, 0) for c in att) \
            == per["int8"]["mha_blhd"]
        assert sum(c[-1].get(kind, 0) for c in dense) \
            == per["int8"]["int8_dense"]
    # the bf16 paths: serving and card-vs-CPU check forwards
    for kind in chip_smoke.KINDS["fused_ffn"]:
        assert sum(u.get(kind, 0) for _, u in ffn) \
            == per["bf16+fused_ffn"]["fused_ffn"] == 24
        assert sum(c[-1].get(kind, 0) for c in fmha) \
            == per["bf16+pallas+fused_ffn"]["fused_mha"] == 34
        assert sum(c[-1].get(kind, 0) for c in att) == per["bf16"][
            "mha_blhd"] == per["bf16+fused_ffn"]["mha_blhd"] == 34
    # the fused int8 path: 22 blocks with the FFN and a tail, the last
    # x-layer's 2 without a tail, the 10 cross-output blocks without FFN
    blocks = chip_smoke.fused_block_cases(cfg, chip_smoke.BATCH)
    for kind in chip_smoke.KINDS["fused_block"]:
        by_variant = Counter()
        for M, variant, uses in blocks:
            by_variant[variant] += uses.get(kind, 0)
        assert by_variant == {"ffn+tail": 22, "ffn": 2, "tail": 10}
        assert sum(by_variant.values()) \
            == per["int8+fused_block"]["fused_block"]
    assert {M for M, _, _ in blocks} == {256 * L for L in chip_smoke.BUCKETS} \
        | {8 * L for L in chip_smoke.BUCKETS} | {16384, 512}
    on_path = {(b, lq, lk) for b, lq, lk, _, _, _, uses in att
               if any(not k.startswith("ft") for k in uses)}
    assert on_path == {(b, lq, lk) for b, lq, lk, _, _, _, uses in fmha
                       if uses}
    # (g)'s int8 evaluations: VQA at B=32; NLVR2's language layers at 32
    # rows, the rest at 64
    assert {(b, lq, lk) for b, lq, lk, _, _, _, uses in att
            if "ft eval" in uses} == {(32, 20, 20), (32, 64, 64),
                                      (32, 20, 64), (32, 64, 20)}
    assert {(b, lq, lk) for b, lq, lk, _, _, _, uses in att
            if "ft nlvr2 eval" in uses} == {(32, 20, 20), (64, 20, 20),
                                            (64, 64, 64), (64, 20, 64),
                                            (64, 64, 20)}
    for L in chip_smoke.BUCKETS:
        assert {(256, L, L), (256, L, 64), (256, 64, L)} <= on_path
        assert {(8, L, L), (8, L, 64), (8, 64, L)} <= on_path
        assert {256 * L, 8 * L} <= {M for M, _ in ffn}
    assert {(8, 20, 20), (8, 64, 64), (8, 20, 64), (8, 64, 20)} <= on_path
    assert {16384, 512} <= {M for M, _ in ffn}
    # fine-tuning: 34 mha_blhd_train launches per training step, bf16
    # with the dropout mask in the VQA (B=32) and NLVR2 (B=64) steps, and
    # without it in each type of the card-vs-CPU step (B=8)
    train = list(chip_smoke.train_attention_cases(cfg))
    for kind in chip_smoke.KINDS["mha_blhd_train"]:
        assert sum(c[-1].get(kind, 0) for c in train) \
            == per["finetune pallas_blhd"]["mha_blhd_train"] == 34
    shapes = {(20, 20), (64, 64), (20, 64), (64, 20)}
    for b, dt, mask in ((32, "bfloat16", True), (64, "bfloat16", True),
                        (8, "float32", False), (8, "bfloat16", False)):
        assert {(lq, lk) for B, lq, lk, _, d, m, uses in train
                if uses and (B, d, m) == (b, dt, mask)} == shapes
    # pre-training: its B=256 steps, and its check steps at the
    # fine-tuning check's shapes
    for b, dt, mask, kind in ((256, "bfloat16", True, "pt step"),
                              (8, "float32", False, "pt check float32"),
                              (8, "bfloat16", False, "pt check bfloat16")):
        assert {(lq, lk) for B, lq, lk, _, d, m, uses in train
                if kind in uses and (B, d, m) == (b, dt, mask)} == shapes
    assert len(train) == 64 and len({c[:-1] for c in train}) == 64
    # the layout driver's hbatch forwards: 34 launches at B=256, L=20; the
    # calibration batch's shapes are checked too, with no path use
    hb = list(chip_smoke.hbatch_cases(cfg, chip_smoke.BATCH))
    for kind in chip_smoke.KINDS["mha_hbatch"]:
        assert sum(c[-1].get(kind, 0) for c in hb) \
            == per["layout hbatch"]["mha_hbatch"] == 34
    assert {(b, lq, lk, bias) for b, lq, lk, bias, uses in hb if uses} == {
        (256, 20, 20, True), (256, 64, 64, False), (256, 20, 64, False),
        (256, 64, 20, True)}
    assert {(b, lq, lk) for b, lq, lk, _, _ in hb} == {
        (b, lq, lk) for b in (256, 8) for lq, lk in shapes}
    assert len(hb) == 16


def test_path_phase_launches_exactly_the_kernel_phase_cases(monkeypatch,
                                                            short_stream):
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
    path, (qp, _), answers = chip_smoke.run_path(
        torch, args, [], lambda m: None, cfg=cfg, device="cpu")

    assert all(forwards[k] > 0 for k in chip_smoke.forward_kinds())
    assert path["answers"] == len(answers) == chip_smoke.QUESTIONS
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


def test_bf16_phase_launches_exactly_the_kernel_phase_cases(monkeypatch,
                                                            short_stream):
    """Phase (e) on the CPU at a small width, "auto" attention taken as
    the card resolves it ("blhd"): each configuration serves every
    question and calls each kernel wrapper at exactly the kernel phase's
    (shape, count) cases, in the serving forwards and in the batch-8
    forwards of the card-vs-CPU check (run twice there: "card" and
    CPU)."""
    cfg = LxmertConfig(vocab_size=4100, hidden_size=32,
                       num_attention_heads=2, intermediate_size=48,
                       l_layers=2, x_layers=1, r_layers=1,
                       visual_feat_dim=16)
    configs = {k: ("blhd" if a == "auto" else a, f, r)
               for k, (a, f, r) in chip_smoke.BF16_CONFIGS.items()}
    monkeypatch.setattr(chip_smoke, "BF16_CONFIGS", configs)
    calls = []          # (kernel, shape, inside serve)
    serving = [False]
    orig = {n: getattr(lxmert, n) for n in ("mha_blhd", "fused_mha",
                                             "fused_ffn")}

    def recorder(name, shape):
        def call(*a, **kw):
            calls.append((name, shape(*a), serving[0]))
            return orig[name](*a, **kw)
        return call

    monkeypatch.setattr(lxmert, "mha_blhd", recorder(
        "mha_blhd", lambda q, k, v, b, *_: (q.shape[0], q.shape[1],
                                             k.shape[1], b is not None)))
    monkeypatch.setattr(lxmert, "fused_mha", recorder(
        "fused_mha", lambda q, k, v, b, *_: (q.shape[0], q.shape[2],
                                              k.shape[2], b is not None)))
    monkeypatch.setattr(lxmert, "fused_ffn", recorder(
        "fused_ffn", lambda x, *_: (x.numel() // x.shape[-1],)))
    serve = serve_mod.serve

    def serve_rec(*a, **kw):
        serving[0] = True
        try:
            return serve(*a, **kw)
        finally:
            serving[0] = False

    monkeypatch.setattr(serve_mod, "serve", serve_rec)
    args = chip_smoke.parse_args(["--seed", "4"])
    paths = chip_smoke.run_bf16_paths(torch, args, [], lambda m: None,
                                      cfg=cfg, device="cpu")
    assert set(paths) == set(configs)
    # forwards of each kind, as serve() batches the stream
    setup = chip_smoke.Setup(torch, args, lambda m: None, cfg, "cpu")
    ids = setup.tokenizer.encode_batch([q["sent"] for q in setup.questions],
                                       max(chip_smoke.BUCKETS))
    n_tok, low, forwards = (ids > 0).sum(axis=1), 0, Counter()
    for L in chip_smoke.BUCKETS:
        n = int(((n_tok > low) & (n_tok <= L)).sum())
        forwards[f"L={L}"] = math.ceil(n / chip_smoke.BATCH)
        forwards[f"check L={L}"] = 2     # the "card" and the CPU copy
        low = L
    for path, p in paths.items():
        assert p["answers"] == chip_smoke.QUESTIONS
        assert p["forwards"] == sum(forwards[f"L={L}"]
                                    for L in chip_smoke.BUCKETS)
    checked = {p for p, (_, _, r) in configs.items() if r}
    assert {p for p, v in paths.items() if "card_vs_cpu" in v} == checked
    assert all(c["argmax_equal"] == c["queries"] and c["cosine"] > 0.99
               for p in checked for c in paths[p]["card_vs_cpu"].values())

    def expected(cases, runs):
        out = Counter()
        for *shape, uses in cases:
            for kind, n in uses.items():
                check = kind.startswith("check")
                out[tuple(shape), not check] += n * forwards[kind] * runs[
                    check]
        return out

    att = [(b, lq, lk, bias, uses) for b, lq, lk, bias, _, _, uses
           in chip_smoke.attention_cases(cfg, chip_smoke.BATCH)]
    fmha = [(b, lq, lk, bias, uses) for b, lq, lk, bias, _, _, uses
            in chip_smoke.fused_mha_cases(cfg, chip_smoke.BATCH)]
    ffn = chip_smoke.ffn_cases(cfg, chip_smoke.BATCH)
    seen = {n: Counter((shape, inside) for k, shape, inside in calls
                       if k == n)
            for n in ("mha_blhd", "fused_mha", "fused_ffn")}
    # mha_blhd: configurations 1 and 2 serve through it, 2 checks
    assert seen["mha_blhd"] == expected(att, {False: 2, True: 1})
    assert seen["fused_mha"] == expected(fmha, {False: 1, True: 1})
    assert seen["fused_ffn"] == expected(ffn, {False: 2, True: 2})


def test_fused_phase_launches_exactly_the_kernel_phase_cases(monkeypatch,
                                                             short_stream):
    """Phase (f) on the CPU at a small width: serve(fused=True) answers
    every question; its calibration forwards call the int8 engine's
    wrappers only (mha_blhd and the dynamic int8 dense), its serving
    forwards and the batch-8 card-vs-CPU forwards (run twice: "card" and
    CPU) call fused_block at exactly the kernel phase's (M, variant)
    cases, mha_blhd at the attention cases and the static int8 dense 5
    times each."""
    cfg = LxmertConfig(vocab_size=4100, hidden_size=32,
                       num_attention_heads=2, intermediate_size=48,
                       l_layers=2, x_layers=2, r_layers=1,
                       visual_feat_dim=16)
    calls = Counter()     # (wrapper, shape, inside serve)
    serving = [False]

    def recorder(module, name, shape, label=None):
        orig = getattr(module, name)

        def call(*a, **kw):
            calls[label or name, shape(*a, **kw), serving[0]] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(module, name, call)

    def block_shape(ctx, *a, tail_w=None, has_ffn=True):
        variant = ("ffn+tail" if tail_w is not None else "ffn") if has_ffn \
            else "tail"
        return ctx.numel() // ctx.shape[-1], variant

    def attention_shape(q, k, v, bias, *a, **kw):
        return q.shape[0], q.shape[1], k.shape[1], bias is not None

    recorder(lxmert_fused, "fused_block", block_shape)
    recorder(lxmert_fused, "mha_blhd", attention_shape)
    # the int8 engine's attention runs in the calibration forwards only
    recorder(engine, "mha_blhd", attention_shape, "calibration mha_blhd")
    recorder(int8_matmul, "int8_dense_fused",
             lambda x, w, s, b=None, inv_a=None: (
                 x.numel() // x.shape[-1], x.shape[-1], w.shape[0],
                 inv_a is not None))
    serve = serve_mod.serve

    def serve_rec(*a, **kw):
        serving[0] = True
        try:
            return serve(*a, **kw)
        finally:
            serving[0] = False

    monkeypatch.setattr(serve_mod, "serve", serve_rec)
    args = chip_smoke.parse_args(["--seed", "5"])
    setup = chip_smoke.Setup(torch, args, lambda m: None, cfg, "cpu")
    _, _, int8_answers = chip_smoke.run_path(torch, args, [], lambda m: None,
                                             setup=setup, device="cpu")
    calls.clear()
    path = chip_smoke.run_fused_path(torch, args, [], lambda m: None,
                                     setup=setup, device="cpu",
                                     int8_answers=int8_answers)
    ids = setup.tokenizer.encode_batch([q["sent"] for q in setup.questions],
                                       max(chip_smoke.BUCKETS))
    n_tok, low, forwards = (ids > 0).sum(axis=1), 0, Counter()
    for L in chip_smoke.BUCKETS:
        n = int(((n_tok > low) & (n_tok <= L)).sum())
        forwards[f"L={L}"] = math.ceil(n / chip_smoke.BATCH)
        forwards[f"check L={L}"] = 2     # the "card" and the CPU copy
        low = L
    n_calib = math.ceil(chip_smoke.CALIB_SAMPLES / chip_smoke.CALIB_BATCH)
    assert path["answers"] == chip_smoke.QUESTIONS
    assert path["calib_forwards"] == n_calib
    assert path["serve_forwards"] == sum(forwards[f"L={L}"]
                                         for L in chip_smoke.BUCKETS)
    assert set(path["card_vs_cpu"]) == set(chip_smoke.BUCKETS)
    assert all(c["argmax_equal"] == c["queries"] and c["cosine"] > 0.99
               for c in path["card_vs_cpu"].values())
    # bit-equal engines on the CPU: the fused path answers as the int8 one
    assert path["answers_equal_to_int8"] == chip_smoke.QUESTIONS

    def expected(cases):
        out = Counter()
        for *shape, uses in cases:
            for kind, n in uses.items():
                out[tuple(shape), not kind.startswith("check")] += \
                    n * forwards[kind]
        return out

    def seen(name, keep=lambda shape: True):
        return Counter({(shape, inside): n
                        for (k, shape, inside), n in calls.items()
                        if k == name and keep(shape)})

    assert seen("fused_block") == expected(
        chip_smoke.fused_block_cases(cfg, chip_smoke.BATCH))
    att = [(b, lq, lk, bias, {k: n for k, n in uses.items() if k != "calib"})
           for b, lq, lk, bias, _, _, uses
           in chip_smoke.attention_cases(cfg, chip_smoke.BATCH)]
    assert seen("mha_blhd") == expected(att)
    n_fwd = path["serve_forwards"] + 2 * len(chip_smoke.BUCKETS)
    static = seen("int8_dense_fused", lambda shape: shape[-1])
    assert sum(static.values()) == 5 * n_fwd
    # calibration: the int8 engine's forwards, inside serve, with the
    # dynamic int8 dense and the calibration batch's attention shapes
    dynamic = seen("int8_dense_fused", lambda shape: not shape[-1])
    assert all(inside for _, inside in dynamic)
    assert sum(dynamic.values()) == n_calib * (
        4 * cfg.l_layers + 4 * cfg.r_layers + 14 * cfg.x_layers + 3)
    assert seen("calibration mha_blhd") == Counter({
        ((b, lq, lk, bias), True): uses["calib"] * n_calib
        for b, lq, lk, bias, _, _, uses
        in chip_smoke.attention_cases(cfg, chip_smoke.BATCH)
        if "calib" in uses})


def test_finetune_phase_launches_exactly_the_kernel_phase_cases(monkeypatch):
    """Phase (g) on the CPU at a small width: both routes train FT_STEPS
    steps and evaluate, the int8 evaluation and NLVR2 run, the repeated
    batch's loss falls, and the card-vs-CPU step agrees (both sides on
    the CPU here). The training attention is called at exactly the
    kernel phase's (shape, type, mask) cases: 34 a full-width step, only
    on the "pallas_blhd" route. Fewer steps than on the card: the loop
    is the same at any count."""
    cfg = LxmertConfig(vocab_size=4100, hidden_size=64,
                       num_attention_heads=1, intermediate_size=96,
                       l_layers=2, x_layers=1, r_layers=1,
                       visual_feat_dim=16)
    monkeypatch.setattr(chip_smoke, "FT_STEPS", 4)
    monkeypatch.setattr(chip_smoke, "FT_REPEAT", 3)
    calls = Counter()
    orig = lxmert.mha_blhd_train

    def rec(q, k, v, bias, mask, n_heads, *a, **kw):
        dt = str(q.dtype).replace("torch.", "")
        calls[q.shape[0], q.shape[1], k.shape[1], bias is not None, dt,
              mask is not None] += 1
        return orig(q, k, v, bias, mask, n_heads, *a, **kw)

    monkeypatch.setattr(lxmert, "mha_blhd_train", rec)
    # the int8 evaluations' wrappers: (g)'s "ft ... eval" kernel cases
    evals = Counter()
    mha, dense = engine.mha_blhd, int8_matmul.int8_dense_fused

    def mha_rec(q, k, v, bias, n_heads, fast=True):
        evals["mha_blhd", q.shape[0], q.shape[1], k.shape[1],
              bias is not None] += 1
        return mha(q, k, v, bias, n_heads, fast=fast)

    def dense_rec(x, w_i8, col_scale, bias=None, inv_a=None):
        evals["int8_dense", x.numel() // x.shape[-1], x.shape[-1],
              w_i8.shape[0], inv_a is not None] += 1
        return dense(x, w_i8, col_scale, bias, inv_a)

    monkeypatch.setattr(engine, "mha_blhd", mha_rec)
    monkeypatch.setattr(int8_matmul, "int8_dense_fused", dense_rec)
    args = chip_smoke.parse_args(["--seed", "6"])
    out = chip_smoke.run_finetune_path(torch, args, [], lambda m: None,
                                       cfg=cfg, device="cpu")
    routes = out["routes"]
    assert set(routes) == set(chip_smoke.TRAIN_ROUTES)
    for res in (*routes.values(), out["nlvr2"]):
        assert all(math.isfinite(s["loss"]) for s in res["steps"])
    assert len(routes["pallas_blhd"]["steps"]) == chip_smoke.FT_STEPS
    assert routes["pallas_blhd"]["last_msgpack_read_back"]
    assert len(out["nlvr2"]["steps"]) == 2 and out["nlvr2"]["eval_int8"]
    losses = out["repeated_batch_losses"]
    assert len(losses) == chip_smoke.FT_REPEAT and losses[-1] < losses[0]
    assert all(out["step_parts"][k] > 0 for k in chip_smoke.STEP_PARTS)
    for dt, c in out["card_vs_cpu"].items():
        assert c["loss_rel_diff"] == 0.0 and c["grad_cosine"] > 0.9999999
    # steps of each kind: VQA on the pallas route, the repeated batch
    # and the timed parts, NLVR2, and the check step on "card" and CPU in
    # each type
    steps = {"ft vqa": (chip_smoke.FT_STEPS + chip_smoke.FT_REPEAT
                        + chip_smoke.FT_PARTS),
             "ft nlvr2": 2, "ft check float32": 2, "ft check bfloat16": 2}
    want = Counter()
    for *case, uses in chip_smoke.train_attention_cases(cfg):
        for kind, n in uses.items():
            # pre-training's kinds ("pt ...") run in phase (i)
            want[tuple(case)] += n * steps.get(kind, 0)
    assert calls == want
    # int8 evaluations: VQA calibrates on its 2 batches and serves them,
    # NLVR2 on its 1
    att_forwards = {"ft eval": 4, "ft nlvr2 eval": 2}
    dense_forwards = {"ft eval": 2, "ft eval calib": 2, "ft nlvr2 eval": 1,
                      "ft nlvr2 eval calib": 1}
    want = Counter()
    for b, lq, lk, bias, _, _, uses in chip_smoke.attention_cases(
            cfg, chip_smoke.BATCH):
        for kind, n in uses.items():
            want["mha_blhd", b, lq, lk, bias] += n * att_forwards.get(kind, 0)
    for M, K, N, static, uses in chip_smoke.dense_cases(
            cfg, chip_smoke.BATCH, chip_smoke.Setup.n_answers):
        for kind, n in uses.items():
            want["int8_dense", M, K, N, static] += \
                n * dense_forwards.get(kind, 0)
    assert evals == want


SMALL = dict(vocab_size=4100, hidden_size=128, num_attention_heads=2,
             intermediate_size=96, l_layers=2, x_layers=1, r_layers=1,
             visual_feat_dim=16, num_clusters=50)


def test_layout_phase_launches_exactly_the_kernel_phase_cases(monkeypatch):
    """Phase (h) on the CPU at a small width (fewer chained forwards of a
    smaller batch):
    every variant answers as base, and mha_hbatch is called at exactly
    the kernel phase's (shape, count) cases in the hbatch variant's
    forwards, and nowhere else."""
    from xlxmert_tpu_torch.ops import attention

    cfg = LxmertConfig(**SMALL)
    monkeypatch.setattr(chip_smoke, "LAYOUT_K", 2)
    monkeypatch.setattr(chip_smoke, "LAYOUT_REPEATS", 1)
    monkeypatch.setattr(chip_smoke, "BATCH", 24)
    calls = Counter()
    orig = attention.mha_hbatch

    def rec(q, k, v, bias, n_heads):
        calls[q.shape[0], q.shape[1], k.shape[1], bias is not None] += 1
        return orig(q, k, v, bias, n_heads)

    monkeypatch.setattr(attention, "mha_hbatch", rec)
    args = chip_smoke.parse_args(["--seed", "7"])
    out = chip_smoke.run_layout_path(torch, args, [], lambda m: None,
                                     cfg=cfg, device="cpu")
    assert list(out["variants"]) == list(chip_smoke.LAYOUT_VARIANTS)
    forwards = 1 + 2 * (1 + 1)
    for name, r in out["variants"].items():
        assert r["forwards"] == forwards and r["qps"] > 0
        if name != "base":
            assert r["argmax_agree"] == 1.0
    want = Counter()
    for b, lq, lk, bias, uses in chip_smoke.hbatch_cases(cfg,
                                                         chip_smoke.BATCH):
        for n in uses.values():
            want[b, lq, lk, bias] += n * forwards
    assert calls == want and sum(calls.values()) == forwards * (
        cfg.l_layers + cfg.r_layers + 4 * cfg.x_layers)


def test_pretrain_phase_launches_exactly_the_kernel_phase_cases(monkeypatch):
    """Phase (i) on the CPU at a small width and batch: both routes pre-train
    PT_STEPS round-robin steps, evaluate and save, the step's parts are
    timed, and each task's card-vs-CPU step agrees (both sides on the CPU
    here). The training attention is called at exactly the kernel phase's
    (shape, type, mask) cases: 34 a full-width step, only on the
    "pallas_blhd" route."""
    cfg = LxmertConfig(**SMALL)
    # a smaller pre-training batch, which no other training case shares
    monkeypatch.setattr(chip_smoke, "PT_BATCH", 16)
    calls = Counter()
    orig = lxmert.mha_blhd_train

    def rec(q, k, v, bias, mask, n_heads, *a, **kw):
        dt = str(q.dtype).replace("torch.", "")
        calls[q.shape[0], q.shape[1], k.shape[1], bias is not None, dt,
              mask is not None] += 1
        return orig(q, k, v, bias, mask, n_heads, *a, **kw)

    monkeypatch.setattr(lxmert, "mha_blhd_train", rec)
    args = chip_smoke.parse_args(["--seed", "8"])
    out = chip_smoke.run_pretrain_path(torch, args, [], lambda m: None,
                                       cfg=cfg, device="cpu")
    for route, res in out["routes"].items():
        assert [s["task"] for s in res["steps"]] == [
            chip_smoke.PT_TASKS[i % 3] for i in range(chip_smoke.PT_STEPS)]
        assert all(math.isfinite(s["loss"]) for s in res["steps"])
        assert set(res["tasks"]) == set(chip_smoke.PT_TASKS)
        assert res["checkpoint_read_back"] and len(res["valid"]) == 3
    assert set(out["step_parts"]) == set(chip_smoke.PT_TASKS)
    for dt, tasks in out["card_vs_cpu"].items():
        for c in tasks.values():
            assert c["loss_rel_diff"] == 0.0 and c["grad_cosine"] > 0.9999999
    # each task's check leaves other parameters without a gradient
    counts = {t: c["with_gradient"]
              for t, c in out["card_vs_cpu"]["float32"].items()}
    assert len(set(counts.values())) == 3
    # the exact resume: bit-equal on the CPU, where two runs do not
    # spread; the profiled run's trace names its steps
    fs = out["full_state"]
    assert fs["spread"] == 0.0 and fs["resumed_bit_equal"]
    assert fs["full_bytes"] > fs["lxrt_bytes"] > 0 and fs["leaves"] > 0
    assert out["profile"]["steps"] == ["train_step vis_mask",
                                       "train_step word_mask"]
    # steps of each kind: the pallas route's steps, the timed parts, the
    # full-state check's three runs and the profiled run; each task of
    # the check step on "card" and CPU in each type
    steps = {"pt step": chip_smoke.PT_STEPS
             + len(chip_smoke.PT_TASKS) * chip_smoke.PT_PARTS
             + 3 * chip_smoke.FULL_K + chip_smoke.PROFILE_STEPS,
             "pt check float32": 2 * len(chip_smoke.PT_TASKS),
             "pt check bfloat16": 2 * len(chip_smoke.PT_TASKS)}
    want = Counter()
    for *case, uses in chip_smoke.train_attention_cases(cfg):
        for kind, n in uses.items():
            want[tuple(case)] += n * steps.get(kind, 0)
    assert calls == want

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xlxmert_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out runs/chip_smoke.json]

Phases, each of which fails the script on error:
  (a) device and build: the card's name, count and power limit; both
      CUDA kernels built from csrc/ in parallel (nvcc, -Xptxas -v);
  (b) kernels: each kernel against its plain PyTorch version on the card
      at every shape the path gives it (serving at B=256 for each bucket
      length, calibration at batch 8), with its time (CUDA events), the
      plain version's time, a PyTorch library call's time where one
      computes the same function, and the least time the card could take
      (bytes over 3.35 TB/s or operations over the peak rate of their
      type, whichever is larger); the times summed per forward of each
      kind and per serving forward drawn from VQA_LENGTH_MIX;
  (c) the serving path at full width (LxmertConfig(): 9/5/5 layers, 768
      hidden, 2048-d grid features, 3,129 answers) with random weights
      from --seed: a 512-image bf16 catalog in device memory, 2,048
      synthetic questions whose token lengths follow VQA_LENGTH_MIX,
      calibration on 256 of them, bucketed serving (8,12,16,20) at
      B=256 through cli/serve.serve. Every kernel's launch count is
      reset before and read after, and must be 34 (attention) and 129
      (int8 dense) per forward. One batch of 8 queries per bucket, at
      its bucket length, then runs through the same engine moved to the
      CPU (plain versions): its logits must agree with the card's
      (cosine > 0.99 per bucket, the same answer for 90% of the
      queries, and a different one only where the CPU's top answers
      lie within 0.25 sd of the row's logits);
  (d) one JSON line listing the kernels (times per serving forward of
      the length mix), then the device line last.

Per-shape numbers go to --out. Without a CUDA device, or outside the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
MHA_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
INT8_TOL = 0.0                     # exact integer products, same epilogue
BUCKETS = (8, 12, 16, 20)
BATCH = 256
CALIB_BATCH = 8       # cli/serve calibrates on batches of 8
PER_FORWARD = {"mha_blhd": 34, "int8_dense": 129}   # launches, any forward
ARGMAX_AGREE = 0.9    # share of card answers equal to the CPU's
NEAR_TIE_SD = 0.25    # largest CPU margin (row sd) of an answer swapped
IMAGES = 512          # catalog rows in device memory (134 MB bf16)
QUESTIONS = 2048
CALIB_SAMPLES = 256
REPS = 10             # timed launches per shape, after 2 warm-up launches


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("runs", "chip_smoke.json"))
    return p.parse_args(argv)


def time_ms(torch, fn) -> float:
    """Mean device time of fn over REPS launches (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes moved over the memory
    rate or operations over the peak rate of their type, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# (b) kernels against their plain versions
# ---------------------------------------------------------------------------


def forward_kinds():
    """The forwards of the path: serving at each bucket length ("L=8"..,
    batch BATCH) and calibration ("calib": batch CALIB_BATCH, dynamic
    int8 dense, text padded to the longest bucket)."""
    return [f"L={L}" for L in BUCKETS] + ["calib"]


def attention_cases(cfg, B):
    """(batch, Lq, Lk, with_bias, dtype, fast, uses): `uses` maps each
    forward kind to this case's launches per forward of that kind."""
    vis, nl, nr, nx = 64, cfg.l_layers, cfg.r_layers, cfg.x_layers
    shapes = {}   # (batch, Lq, Lk) -> (bias on the path, uses)

    def add(kind, b, text):
        for lq, lk, bias, n in ((text, text, True, nl + nx),
                                (vis, vis, False, nr + nx),
                                (text, vis, False, nx),
                                (vis, text, True, nx)):
            shapes.setdefault((b, lq, lk), (bias, {}))[1][kind] = n

    for L in BUCKETS:
        add(f"L={L}", B, L)
    add("calib", CALIB_BATCH, max(BUCKETS))
    for (b, lq, lk), (path_bias, uses) in shapes.items():
        for bias in (True, False):
            for dtype, fast in (("bfloat16", True), ("float32", False)):
                on = fast and bias == path_bias
                yield b, lq, lk, bias, dtype, fast, uses if on else {}


def check_attention(torch, F, attention, cfg, rng, log):
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    D = HD // H
    rows = []
    for B, lq, lk, with_bias, dt, fast, uses in attention_cases(cfg, BATCH):
        dtype = getattr(torch, dt)
        qkv = torch.randn(B, lq, 3 * HD, generator=rng, device="cuda"
                          ).to(dtype)
        kv = torch.randn(B, lk, 2 * HD, generator=rng, device="cuda"
                         ).to(dtype)
        q, k, v = qkv[..., :HD], kv[..., :HD], kv[..., HD:]
        bias = None
        if with_bias:
            keep = torch.rand(B, lk, generator=rng, device="cuda") > 0.3
            keep[:, 0] = True
            bias = ((1.0 - keep.float()) * -1e9)[:, None, None, :].to(
                torch.bfloat16)
        out = attention.mha_blhd(q, k, v, bias, H, fast=fast)
        ref = attention.mha_blhd_reference(q, k, v, bias, H, fast=fast)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= MHA_TOL[dt]) or not torch.isfinite(out).all():
            fail(f"mha_blhd {lq}x{lk} bias={with_bias} {dt}: max abs err "
                 f"{err} > {MHA_TOL[dt]}")
        qh, kh, vh = (t.view(B, -1, H, D).transpose(1, 2) for t in (q, k, v))
        mask = None if bias is None else bias.to(dtype)
        kernel = time_ms(torch, lambda: attention.mha_blhd(
            q, k, v, bias, H, fast=fast))
        plain = time_ms(torch, lambda: attention.mha_blhd_reference(
            q, k, v, bias, H, fast=fast))
        library = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
        esize = q.element_size()
        nbytes = (B * (2 * lq + 2 * lk) * HD * esize
                  + (0 if bias is None else bias.numel() * 2))
        row = {"Lq": lq, "Lk": lk, "bias": with_bias, "dtype": dt,
               "fast": fast, "B": B, "max_abs_err": err, "tol": MHA_TOL[dt],
               "ms": kernel, "plain_ms": plain, "library_ms": library,
               "uses": uses,
               **bound(nbytes, 4.0 * B * H * lq * lk * D, dt)}
        rows.append(row)
        log(f"  mha_blhd B={B:3d} {lq:2d}x{lk:2d} bias={with_bias!s:5} "
            f"{dt:8} err {err:.2e} (tol {MHA_TOL[dt]:g})  kernel "
            f"{kernel:.4f} ms  plain {plain:.4f}  sdpa {library:.4f}  "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
    return rows


def dense_cases(cfg, B, n_answers):
    """(M, K, N, static, uses): `uses` maps each forward kind to this
    shape's launches per forward of that kind. Serving forwards run the
    static mode, calibration forwards the dynamic one."""
    Hd, I, Fv = cfg.hidden_size, cfg.intermediate_size, cfg.visual_feat_dim
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    text = {(Hd, 3 * Hd): nl + nx, (Hd, Hd): nl + 3 * nx, (Hd, I): nl + nx,
            (I, Hd): nl + nx, (Hd, 2 * Hd): nx}
    vis = {(Fv, Hd): 1, (Hd, 3 * Hd): nr + nx, (Hd, Hd): nr + 3 * nx,
           (Hd, I): nr + nx, (I, Hd): nr + nx, (Hd, 2 * Hd): nx}
    head = {(Hd, 2 * Hd): 1, (2 * Hd, n_answers): 1}
    shapes = {}   # (M, K, N, static) -> uses
    forwards = [(f"L={L}", True, B, L) for L in BUCKETS] + [
        ("calib", False, CALIB_BATCH, max(BUCKETS))]
    for kind, static, b, L in forwards:
        for group, M in ((text, b * L), (vis, b * 64), (head, b)):
            for (K, N), n in group.items():
                shapes.setdefault((M, K, N, static), {})[kind] = n
    for (M, K, N, static), uses in shapes.items():
        yield M, K, N, static, uses


def check_int8(torch, int8_matmul, quant, cfg, B, n_answers, rng, log):
    rows = []
    weights = {}
    for M, K, N, static, uses in dense_cases(cfg, B, n_answers):
        if (K, N) not in weights:
            w = torch.randn(K, N, generator=rng, device="cuda") * 0.02
            b = torch.randn(N, generator=rng, device="cuda") * 0.02
            weights[K, N] = quant.quantize_weight(
                w.cpu().numpy(), b.cpu().numpy()).to("cuda")
        qw = weights[K, N]
        x = torch.randn(M, K, generator=rng, device="cuda").to(
            torch.bfloat16)
        inv_a, col = None, qw.scale
        if static:
            quant.with_activation_scale(qw, 0.9 * x.float().abs().max()
                                        .item())
            inv_a, col = qw.inv_a, qw.out_scale
        out = int8_matmul.int8_dense_fused(x, qw.w_i8, col, qw.bias, inv_a)
        ref = int8_matmul.int8_dense_reference(x, qw.w_i8, col, qw.bias,
                                               inv_a)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= INT8_TOL) or not torch.isfinite(out).all():
            fail(f"int8_dense M={M} K={K} N={N} static={static}: max abs "
                 f"err {err} > {INT8_TOL}")
        kernel = time_ms(torch, lambda: int8_matmul.int8_dense_fused(
            x, qw.w_i8, col, qw.bias, inv_a))
        plain = time_ms(torch, lambda: int8_matmul.int8_dense_reference(
            x, qw.w_i8, col, qw.bias, inv_a))
        # torch._int_mm computes the int8 product alone (no quantization,
        # no dequantization): a yardstick, where it takes the shape
        int_mm = None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            x8 = (quant.quantize_static_values(x, inv_a) if static
                  else quant.quantize_rows(x)[0])
            wt = qw.w_i8.t()
            try:
                int_mm = time_ms(torch, lambda: torch._int_mm(x8, wt))
            except RuntimeError as e:
                log(f"  torch._int_mm refused M={M} K={K} N={N}: {e}")
        nbytes = M * K * 2 + N * K + M * N * 2 + N * 4 * 2
        row = {"M": M, "K": K, "N": N, "static": static,
               "max_abs_err": err, "tol": INT8_TOL, "ms": kernel,
               "plain_ms": plain, "library_ms": None, "int_mm_ms": int_mm,
               "uses": uses,
               **bound(nbytes, 2.0 * M * N * K, "int8")}
        rows.append(row)
        mm = "n/a" if int_mm is None else f"{int_mm:.4f}"
        log(f"  int8_dense {'static ' if static else 'dynamic'} M={M:5d} "
            f"K={K:4d} N={N:4d} err {err:.1e}  kernel {kernel:.4f} ms  "
            f"plain {plain:.4f}  _int_mm {mm}  bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})")
    return rows


def per_forward(rows, mix):
    """Each kernel's times summed over the launches of one forward of
    each kind, and over a serving forward drawn from `mix` (the share of
    questions, hence of full batches, at each bucket length)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")
    out = {}
    for kind in forward_kinds():
        used = [(r, r["uses"][kind]) for r in rows if kind in r["uses"]]
        out[kind] = {k: (None if any(r[k] is None for r, _ in used)
                         else sum(r[k] * n for r, n in used)) for k in keys}
    out["mix"] = {k: (None if any(out[f"L={L}"][k] is None for L in BUCKETS)
                      else sum(mix[L] * out[f"L={L}"][k] for L in BUCKETS))
                  for k in keys}
    for t in out.values():
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
    return out


# ---------------------------------------------------------------------------
# (c) the serving path
# ---------------------------------------------------------------------------


def synthetic_questions(n: int, n_images: int, vocab_words, mix, seed):
    """Questions whose WordPiece lengths ([CLS] + words + [SEP]) follow
    the bucket mix: a bucket by its share, a length inside it."""
    import numpy as np

    rng = np.random.RandomState(seed)
    buckets = sorted(mix)
    lows = [3] + [b + 1 for b in buckets[:-1]]
    picks = rng.choice(len(buckets), size=n, p=[mix[b] for b in buckets])
    out = []
    for i, j in enumerate(picks):
        n_tok = rng.randint(lows[j], buckets[j] + 1)
        words = rng.choice(vocab_words, size=n_tok - 2)
        out.append({"question_id": i,
                    "img_id": f"img_{rng.randint(n_images)}",
                    "sent": " ".join(words)})
    return out


def cosine(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm() + 1e-12))


def run_path(torch, args, kernels, log, cfg=None, device="cuda"):
    """Phase (c) at `cfg` (default: the full-width LxmertConfig()).
    Returns its numbers and the calibrated engine (qp, head_qp), left on
    the CPU. With device="cpu" and a narrow cfg it runs on the CPU, as
    its test does."""
    import numpy as np

    from xlxmert_tpu_torch.cli.serve import serve
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.data.tokenization import Tokenizer
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
    from xlxmert_tpu_torch.utils.boxes import box_position

    cfg = cfg or LxmertConfig()
    n_answers = 3129
    t0 = time.time()
    bert, head = engine.random_params(cfg, n_answers, seed=args.seed)
    log(f"  random full-width weights (seed {args.seed}): "
        f"{time.time() - t0:.1f}s")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    V = 64
    table = torch.randn(IMAGES, V, cfg.visual_feat_dim, generator=gen,
                        device=device, dtype=torch.bfloat16)
    cache = FeatureCache(table, {f"img_{i}": i for i in range(IMAGES)})
    log(f"  catalog: {IMAGES} images x {V} x {cfg.visual_feat_dim} "
        f"bf16 on the card, {cache.nbytes / 1e6:.1f} MB")
    words = [f"w{i}" for i in range(4000)]
    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                              + words) + "\n")
        tokenizer = Tokenizer(vocab)
        questions = synthetic_questions(QUESTIONS, IMAGES, words,
                                        engine.VQA_LENGTH_MIX, args.seed)
        label2ans = [f"answer_{i}" for i in range(n_answers)]
        output = os.path.join(tmp, "answers.jsonl")

        for k in kernels:
            k.launches = 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = serve(questions, tokenizer, cache,
                    {"bert": bert, "answer_head": head}, cfg, label2ans,
                    output, batch=BATCH, max_text_length=max(BUCKETS),
                    buckets=",".join(map(str, BUCKETS)),
                    calib_samples=CALIB_SAMPLES, device=device)
        wall = time.time() - t0
        launches = {k.name: k.launches for k in kernels}
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        with open(output) as f:
            answers = [json.loads(line) for line in f if line.strip()]
    for name, n in launches.items():
        if n <= 0 or n != PER_FORWARD[name] * res["forwards"]:
            fail(f"{name}: {n} launches in {res['forwards']} forwards, "
                 f"expected {PER_FORWARD[name]} per forward")
    if sorted(a["question_id"] for a in answers) != list(range(len(
            questions))) or not all(a["answer"] in label2ans
                                    for a in answers):
        fail("the answers file does not answer every question once")
    log(f"  served {res['answers']} answers in {res['forwards']} forwards "
        f"({res['calib_forwards']} calibration + {res['serve_forwards']} "
        f"serving), wall {wall:.1f}s incl. weight quantization")
    log(f"  steady-state {res['steady_qps']:.1f} q/s, total "
        f"{res['total_qps']:.1f} q/s, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log("  launches: " + ", ".join(f"{k} {n} ({n // res['forwards']} per "
                                   f"forward)" for k, n in launches.items()))

    # the same engine on the CPU (plain versions) against the card: one
    # batch of 8 per bucket, at the length the engine serves it
    qp, hqp = res["engine"]
    full = tokenizer.encode_batch([q["sent"] for q in questions],
                                  max(BUCKETS))
    n_tok = (full > 0).sum(axis=1)
    pos = torch.from_numpy(box_position(8)).to(torch.bfloat16)[None]
    batches = []
    low = 0
    for L in BUCKETS:
        rows = np.flatnonzero((n_tok > low) & (n_tok <= L))[:CALIB_BATCH]
        low = L
        ids = torch.from_numpy(full[rows, :L].astype(np.int64))
        picks = torch.from_numpy(cache.indices(
            [questions[i]["img_id"] for i in rows]))
        feats = FeatureCache.lookup(table, picks.to(device)).cpu()
        batches.append((L, ids, (ids > 0).float(), feats))

    def logits(device):
        out = []
        with torch.inference_mode():
            for _, ids, mask, feats in batches:
                _, _, pooled = engine.lxmert_forward(
                    qp, ids.to(device), feats.to(device),
                    pos.expand(len(ids), V, 4).to(device),
                    attention_mask=mask.to(device),
                    n_heads=cfg.num_attention_heads)
                out.append(engine.answer_head_forward(hqp, pooled).cpu())
        return out

    card = logits(device)
    qp.to("cpu")
    hqp.to("cpu")
    t0 = time.time()
    host = logits("cpu")
    log(f"  card vs CPU, {CALIB_BATCH} queries per bucket (CPU forwards "
        f"{time.time() - t0:.1f}s):")
    # random weights leave near-ties among 3,129 answers that the glue's
    # rounding (plain PyTorch on either side) can swap: the answers must
    # agree on ARGMAX_AGREE of the queries, the bar the CPU tests set
    # between the port and the JAX package, and each swap must be a
    # near-tie on the CPU (the top two of 3,129 normal draws lie ~0.25 sd
    # apart)
    checks, n_same, n_all = {}, 0, 0
    for (L, ids, _, _), c, h in zip(batches, card, host):
        cos = cosine(c, h)
        same = c.argmax(-1) == h.argmax(-1)
        n_same, n_all = n_same + int(same.sum()), n_all + len(same)
        # each swapped answer's CPU margin, in standard deviations of its
        # row's CPU logits
        margins = [float((h[i].max() - h[i, c[i].argmax()]) / h[i].std())
                   for i in np.flatnonzero(~same.numpy())]
        checks[L] = {"cosine": cos, "argmax_equal": int(same.sum()),
                     "queries": len(same), "swap_margins_sd": margins}
        log(f"    L={L}: cosine {cos:.6f}, argmax equal on "
            f"{int(same.sum())}/{len(same)}"
            + (f" (CPU margins of the swapped answers: "
               f"{', '.join(f'{m:.4f}' for m in margins)} sd)"
               if margins else ""))
        if not (len(ids) and torch.isfinite(c).all()
                and c.shape == (len(ids), n_answers)):
            fail(f"L={L}: card logits are not finite ({len(ids)}, "
                 f"{n_answers})")
        if not cos > 0.99:
            fail(f"L={L}: card and CPU logits disagree: cosine {cos}")
        if any(m > NEAR_TIE_SD for m in margins):
            fail(f"L={L}: the card swapped an answer that is no near-tie "
                 f"on the CPU (margins {margins} sd > {NEAR_TIE_SD})")
    if n_same < ARGMAX_AGREE * n_all:
        fail(f"card and CPU answers agree on {n_same}/{n_all} queries, "
             f"fewer than {ARGMAX_AGREE:.0%}")
    return {"launches": launches, "forwards": res["forwards"],
            "answers": res["answers"], "steady_qps": res["steady_qps"],
            "total_qps": res["total_qps"], "peak_bytes": peak,
            "card_vs_cpu": checks}, (qp, hqp)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import torch
        import torch.nn.functional as F

        from xlxmert_tpu_torch.core.config import LxmertConfig
        from xlxmert_tpu_torch.ops import _build, attention, int8_matmul
        from xlxmert_tpu_torch.ops import quant
        from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    except ImportError as e:
        fail(f"cannot import the port ({e}): run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")

    def log(msg):
        print(msg, flush=True)

    # (a) device and build
    device_name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"(a) device: {device_name} x{count}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    kernels = [attention.KERNEL, int8_matmul.KERNEL]
    build_s = _build.build_all(kernels, verbose=True)
    log(f"    kernels built in {build_s:.1f}s (parallel nvcc)")
    for k in kernels:
        if k.build_seconds is not None:
            log(f"    --- {k.name} ({k.build_seconds:.1f}s) ---\n"
                + k.build_log.strip())

    # (b) kernels against their plain versions
    cfg = LxmertConfig()
    mix = engine.VQA_LENGTH_MIX
    rng = torch.Generator(device="cuda").manual_seed(args.seed)
    log(f"(b) kernels vs plain versions at every shape of the path: "
        f"B={BATCH} at text {BUCKETS}, B={CALIB_BATCH} at calibration "
        f"({card})")
    rows = {"mha_blhd": check_attention(torch, F, attention, cfg, rng, log),
            "int8_dense": check_int8(torch, int8_matmul, quant, cfg, BATCH,
                                     3129, rng, log)}
    times = {}
    for name, kernel_rows in rows.items():
        times[name] = per_forward(kernel_rows, mix)
        for kind in forward_kinds():
            n = sum(r["uses"].get(kind, 0) for r in kernel_rows)
            if n != PER_FORWARD[name]:
                fail(f"{name}: the kernel phase covers {n} launches of a "
                     f"{kind} forward, the path makes {PER_FORWARD[name]}")
        log(f"  {name} per forward (ms):")
        for kind, t in times[name].items():
            lib = "none" if t["library_ms"] is None else \
                f"{t['library_ms']:.4f}"
            log(f"    {kind:6} kernel {t['ms']:.4f}  plain "
                f"{t['plain_ms']:.4f}  library {lib}  bound "
                f"{t['bound_ms']:.4f} ({t['bound_by']})")

    # (c) the serving path
    log("(c) serving path: full width, bucketed 8,12,16,20, B="
        f"{BATCH}, random weights")
    path, _ = run_path(torch, args, kernels, log)

    # (d) the kernels line and the device line: times per serving forward
    # drawn from VQA_LENGTH_MIX
    sources = {"mha_blhd": ("xlxmert_tpu_torch/csrc/mha_blhd.cu",
                            "xlxmert_tpu/ops/attention.py:159"),
               "int8_dense": ("xlxmert_tpu_torch/csrc/int8_dense.cu",
                              "xlxmert_tpu/ops/int8_matmul.py:27")}
    summary = []
    for name, (src, replaces) in sources.items():
        t = times[name]["mix"]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call quantizes, multiplies in int8 and
            # dequantizes: torch._int_mm's product-only times are in --out
            "library_ms": t["library_ms"]})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": device_name, "nvidia_smi": card,
                   "build_s": build_s,
                   "attention": rows["mha_blhd"],
                   "int8_dense": rows["int8_dense"], "per_forward": times,
                   "path": path, "kernels": summary,
                   "note": "times in 'kernels' are per serving forward at "
                           "B=256, weighted by VQA_LENGTH_MIX ('mix' in "
                           "'per_forward')"},
                  f, indent=1)
    log(f"(d) per-shape numbers in {args.out}; kernel times per serving "
        f"forward at B={BATCH}, weighted by VQA_LENGTH_MIX")
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device_name,
                                             "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

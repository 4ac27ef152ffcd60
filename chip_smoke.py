#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xlxmert_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out runs/chip_smoke.json]

Phases, each of which fails the script on error:
  (a) device and build: the card's name, count and power limit; the seven
      CUDA kernels built from csrc/ in parallel (nvcc, -Xptxas -v);
  (b) kernels: each kernel against its plain PyTorch version on the card
      at every shape the paths give it (serving at B=256 for each bucket
      length, calibration and the card-vs-CPU checks at batch 8), with
      its time (CUDA events), the plain version's time, a PyTorch library
      call's time where one computes the same function, and the least
      time the card could take (bytes over 3.35 TB/s or operations over
      the peak rate of their type, whichever is larger); the times summed
      per forward of each kind and per serving forward drawn from
      VQA_LENGTH_MIX. fused_block also gets a composed time: the same
      chain through the int8 engine (int8 dense kernel + eager glue), the
      launches it replaces; its library time is that chain with
      torch._int_mm for the products. mha_blhd_train is held to its
      plain version at the four attention shapes of a fine-tuning step
      (text FT_TEXT, visual 64, both cross directions) at the VQA batch,
      NLVR2's (two image rows per example) and the card-vs-CPU step's,
      bf16 and fp32, with and without the dropout mask; its library time
      is SDPA with dropout_p at the same rate (SDPA draws its own mask),
      and beside it the plain-PyTorch time of the backward's einsum
      recompute; its times are summed per training step (pre-training's
      B=256 step is among its cases). mha_hbatch is held to its plain
      version at (h)'s four attention shapes at B=256 and the
      calibration batch, with and without a bias, beside SDPA and
      mha_blhd (B1, the same function) at the same shapes;
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
  (e) the bf16 path at full width (models/, cli/serve --bf16), the same
      weights and the same 2,048 questions, in three configurations
      (BF16_CONFIGS): the default (packed-head attention, unfused FFN;
      34 mha_blhd launches per forward), fused_ffn=True (34 mha_blhd +
      24 fused_ffn) and attention="pallas", fused_ffn=True (34 fused_mha
      + 24 fused_ffn). Each configuration's launch counts are checked
      exactly, and the last two are held to the same model on the CPU
      (plain versions, the same attention route) as in (c);
  (f) the whole-block fused int8 path (cli/serve.serve(fused=True)) on
      the same weights and questions: calibration forwards must launch
      34 mha_blhd + 129 int8_dense each, serving forwards 34 fused_block
      + 34 mha_blhd + 5 int8_dense; the same fused engine on the CPU is
      held to the card as in (c), and its answers are counted against
      (c)'s;
  (g) fine-tuning at full width (LxmertConfig(), 3,129 answers, random
      weights from --seed, B=FT_BATCH, text FT_TEXT, an 8x8 grid, bf16
      mixed precision): cli/finetune.finetune() over an in-memory
      VQADataset of synthetic questions with soft targets on the
      catalog's images, FT_STEPS steps and an evaluation through the
      exact model, once with train_attention "pallas_blhd" (34
      mha_blhd_train launches per step) and once with "xla" (none);
      every loss finite, the loss on one repeated batch falling over
      FT_REPEAT steps, an evaluation through the int8 engine
      (--serve_int8: 34 mha_blhd + 129 int8_dense per forward),
      LAST.msgpack read back; NLVR2 for 2 steps and one int8 eval batch
      (NLVR2Model, nlvr2_forward); one dropout-free training step on a
      batch of FT_CHECK on the card (kernel route) and on the CPU (plain
      route) from the same weights, in fp32 and bf16, held to
      STEP_BARS (loss, gradient cosine). Per step: wall ms after the
      first, examples/s, peak memory and the kernel's share;
  (h) the attention-layout driver (scripts/drive_attention_layout_torch
      .run_int8) at full width, B=256, text 20, through base (einsum),
      bqhk, pallas32 (mha_blhd) and hbatch32 (mha_hbatch): launches per
      forward checked exactly (34 mha_hbatch per hbatch forward and 0
      elsewhere), max |d logits| and argmax agreement against base (at
      least LAYOUT_AGREE), q/s of chained forwards;
  (i) pre-training at the canonical recipe's widths (LxmertConfig(),
      10,000 random centroids, random cluster ids on the 8x8 grid,
      B=256, text 20, word_mask / matched / vis_mask round-robin,
      --visualLosses obj, --vis_mask_predict, bf16, dropout 0.1, lr 1e-4)
      through cli/pretrain.pretrain(): PT_STEPS steps on each training
      attention route (34 and 0 mha_blhd_train launches a step), the
      evaluation, the epoch checkpoint read back; per task the step ms
      after the first, examples/s, peak memory, the step's parts and the
      card's busy time; each task's dropout-free step on the card against
      the CPU with injected masks at B=8, held to STEP_BARS, with the same
      parameters left without a gradient;
  (d) one JSON line listing the kernels (times per serving forward of
      the length mix; mha_blhd_train's per training step, mha_hbatch's
      per layout forward), then the device line last.

Per-shape numbers go to --out. Without a CUDA device, or outside the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
MHA_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
INT8_TOL = 0.0                     # exact integer products, same epilogue
# fused_ffn: fp32 sums in another order can move a bf16 output across a
# rounding boundary: one bf16 step at the largest output
FFN_TOL_REL = 2.0 ** -7
# fused_block: exact int32 products, but LayerNorm sums in another order
# can move a bf16 y1 by a step, and so an int8 step downstream
BLOCK_TOL_REL = 2.0 ** -6
BLOCK_COSINE = 0.9999
BUCKETS = (8, 12, 16, 20)
BATCH = 256
CALIB_BATCH = 8       # cli/serve calibrates on batches of 8
# launches per forward of each path: the int8 engine (c), the three
# bf16 configurations (e) and the fused serving forwards (f), whose
# calibration forwards are the int8 engine's; the kernel phase covers a
# kernel's launches in the first path that runs it
PER_FORWARD = {
    "int8": {"mha_blhd": 34, "int8_dense": 129},
    "int8+fused_block": {"fused_block": 34, "mha_blhd": 34,
                         "int8_dense": 5},
    "bf16": {"mha_blhd": 34},
    "bf16+fused_ffn": {"mha_blhd": 34, "fused_ffn": 24},
    "bf16+pallas+fused_ffn": {"fused_mha": 34, "fused_ffn": 24},
    # (g): per training step of each route, per int8 eval forward
    "finetune pallas_blhd": {"mha_blhd_train": 34},
    "finetune xla": {},
    "finetune eval": {},          # the exact model: einsum attention
    "finetune serve_int8": {"mha_blhd": 34, "int8_dense": 129},
    # (h): per forward of each attention-layout variant (its calibration
    # forward is the int8 engine's "calib")
    "layout base": {"int8_dense": 129},
    "layout bqhk": {"int8_dense": 129},
    "layout pallas": {"mha_blhd": 34, "int8_dense": 129},
    "layout hbatch": {"mha_hbatch": 34, "int8_dense": 129},
    # (i): per pre-training step of each route
    "pretrain pallas_blhd": {"mha_blhd_train": 34},
    "pretrain xla": {},
}
# serve(bf16=True, attention=..., fused_ffn=...) of each bf16 path, and
# the attention route its CPU copy takes (None: no card-vs-CPU check)
BF16_CONFIGS = {"bf16": ("auto", False, None),
                "bf16+fused_ffn": ("auto", True, "blhd"),
                "bf16+pallas+fused_ffn": ("pallas", True, "pallas")}
ARGMAX_AGREE = 0.9    # share of card answers equal to the CPU's
NEAR_TIE_SD = 0.25    # largest CPU margin (row sd) of an answer swapped
IMAGES = 512          # catalog rows in device memory (134 MB bf16)
QUESTIONS = 2048
CALIB_SAMPLES = 256
REPS = 10             # timed launches per shape, after 2 warm-up launches
# (g) fine-tuning
FT_BATCH = 32         # the fine-tuning CLI's default batch
FT_TEXT = 20          # max_text_length: every batch pads to it
FT_STEPS = 10         # training steps of each route
FT_REPEAT = 6         # steps on one repeated batch: its loss must fall
FT_EVAL = 64          # evaluation questions (2 batches)
FT_LR = 1e-4
FT_CHECK = 8          # batch of the card-vs-CPU training step
FT_PARTS = 3          # steps timed part by part (then one profiled)
TRAIN_ROUTES = ("pallas_blhd", "xla")
# card-vs-CPU bars of one dropout-free training step: (largest relative
# difference of the loss, smallest cosine of the global gradient)
STEP_BARS = {"float32": (1e-4, 0.9999), "bfloat16": (2e-2, 0.99)}
# (h) the attention-layout driver over the int8 engine
LAYOUT_VARIANTS = ("base", "bqhk", "pallas32", "hbatch32")
LAYOUT_TEXT = 20      # the driver's --text_len
LAYOUT_K = 10         # forwards chained per timing (--scan_k)
LAYOUT_REPEATS = 2
LAYOUT_AGREE = 0.99   # hbatch's argmax agreement with "base" at B=256
# (i) pre-training, the canonical recipe's widths (scripts/pretrain.bash)
PT_BATCH = 256
PT_TEXT = 20
PT_STEPS = 6          # two round-robins of (vis_mask, word_mask, matched)
PT_LR = 1e-4
PT_CHECK = 8          # batch of the card-vs-CPU step
PT_PARTS = 2          # steps of each task timed part by part
PT_TASKS = ("vis_mask", "word_mask", "matched")


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


def queued_ms(torch, fn):
    """(ms, queued): the mean device time of fn over REPS launches with
    the queue kept full: a sleep kernel holds the card while the host
    enqueues them, so the host's own time per call (Python, autograd,
    ctypes), which exceeds a small kernel's, does not show as it does in
    time_ms. The sleep grows until the start event is still pending when
    the last launch has been enqueued; `queued` is False when it never
    was (fn waits for the card), and ms is then time_ms's."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2e9 * 2 * REPS * host_s) + 1_000_000  # ~2 GHz clock
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / REPS, True
        cycles *= 4
    return time_ms(torch, fn), False


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
    """The forwards of the int8 path: serving at each bucket length
    ("L=8"..., batch BATCH) and calibration ("calib": batch CALIB_BATCH,
    dynamic int8 dense, text padded to the longest bucket)."""
    return [f"L={L}" for L in BUCKETS] + ["calib"]


def check_kinds():
    """The batch-8 forwards of the card-vs-CPU checks, one per bucket
    length: their launches are not counted, their shapes are checked."""
    return [f"check L={L}" for L in BUCKETS]


# the forward kinds each kernel runs in: every kind of every path
# the forwards of (g)'s int8 evaluations: VQA ("ft eval", B=FT_BATCH)
# and NLVR2 ("ft nlvr2 eval"), calibration forwards apart for the int8
# dense (dynamic mode)
FT_EVAL_KINDS = ["ft eval", "ft nlvr2 eval"]
KINDS = {"mha_blhd": forward_kinds() + check_kinds() + FT_EVAL_KINDS,
         "int8_dense": forward_kinds() + FT_EVAL_KINDS
         + [f"{k} calib" for k in FT_EVAL_KINDS],
         "fused_ffn": forward_kinds()[:-1] + check_kinds(),
         "fused_mha": forward_kinds()[:-1] + check_kinds(),
         "fused_block": forward_kinds()[:-1] + check_kinds(),
         # training steps: VQA, NLVR2 and the card-vs-CPU step per type
         "mha_blhd_train": ["ft vqa", "ft nlvr2", "ft check float32",
                            "ft check bfloat16", "pt step",
                            "pt check float32", "pt check bfloat16"],
         # (h)'s hbatch forwards at B=BATCH, text LAYOUT_TEXT
         "mha_hbatch": [f"layout L={LAYOUT_TEXT}"]}


def attention_shapes(cfg, B):
    """{(batch, Lq, Lk): (bias on the path, uses)}: `uses` maps each
    forward kind to this shape's launches per forward of that kind."""
    vis, nl, nr, nx = 64, cfg.l_layers, cfg.r_layers, cfg.x_layers
    shapes = {}

    def add(kind, b, text):
        for lq, lk, bias, n in ((text, text, True, nl + nx),
                                (vis, vis, False, nr + nx),
                                (text, vis, False, nx),
                                (vis, text, True, nx)):
            shapes.setdefault((b, lq, lk), (bias, {}))[1][kind] = n

    for L in BUCKETS:
        add(f"L={L}", B, L)
        add(f"check L={L}", CALIB_BATCH, L)
    add("calib", CALIB_BATCH, max(BUCKETS))
    return shapes


def finetune_eval_attention_shapes(cfg, shapes=None):
    """attention_shapes' entries for the int8 engine in (g)'s
    evaluations: VQA at FT_BATCH rows, and NLVR2, whose sentence runs
    the language layers once on FT_BATCH rows and everything after on
    two rows per example (nlvr2_forward)."""
    vis, text = 64, FT_TEXT
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    shapes = {} if shapes is None else shapes
    b2 = 2 * FT_BATCH
    for kind, b, lq, lk, bias, n in (
            ("ft eval", FT_BATCH, text, text, True, nl + nx),
            ("ft eval", FT_BATCH, vis, vis, False, nr + nx),
            ("ft eval", FT_BATCH, text, vis, False, nx),
            ("ft eval", FT_BATCH, vis, text, True, nx),
            ("ft nlvr2 eval", FT_BATCH, text, text, True, nl),
            ("ft nlvr2 eval", b2, text, text, True, nx),
            ("ft nlvr2 eval", b2, vis, vis, False, nr + nx),
            ("ft nlvr2 eval", b2, text, vis, False, nx),
            ("ft nlvr2 eval", b2, vis, text, True, nx)):
        shapes.setdefault((b, lq, lk), (bias, {}))[1][kind] = n
    return shapes


def attention_cases(cfg, B):
    """(batch, Lq, Lk, with_bias, dtype, fast, uses) of mha_blhd: every
    shape of the serving paths and of (g)'s int8 evaluations, with and
    without bias, in bf16 (fast) and fp32; `uses` is empty but where the
    case is the path's."""
    shapes = finetune_eval_attention_shapes(cfg, attention_shapes(cfg, B))
    for (b, lq, lk), (path_bias, uses) in shapes.items():
        for bias in (True, False):
            for dtype, fast in (("bfloat16", True), ("float32", False)):
                on = fast and bias == path_bias
                yield b, lq, lk, bias, dtype, fast, uses if on else {}


def fused_mha_cases(cfg, B):
    """The same for fused_mha: every shape with and without bias in bf16
    (fast), and fp32 at one shape."""
    for (b, lq, lk), (path_bias, uses) in attention_shapes(cfg, B).items():
        for bias in (True, False):
            yield (b, lq, lk, bias, "bfloat16", True,
                   uses if bias == path_bias else {})
    yield B, 64, 64, False, "float32", False, {}


def ffn_cases(cfg, B):
    """(M, uses) of fused_ffn: text rows (batch x L; the language and
    cross layers) and visual rows (batch x 64; the visual and cross
    layers) of every serving and check forward."""
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    shapes = {}
    for L in BUCKETS:
        for kind, b in ((f"L={L}", B), (f"check L={L}", CALIB_BATCH)):
            for M, n in ((b * L, nl + nx), (b * 64, nr + nx)):
                uses = shapes.setdefault(M, {})
                uses[kind] = uses.get(kind, 0) + n
    return sorted(shapes.items())


def _qkv_bias(torch, rng, B, lq, lk, HD, dtype, with_bias):
    """q from a fused (B, Lq, 3*HD) projection, k/v from a fused
    (B, Lk, 2*HD) one (column slices, as the engine passes them), and a
    (B, Lk) bf16 key mask bias."""
    qkv = torch.randn(B, lq, 3 * HD, generator=rng, device="cuda").to(dtype)
    kv = torch.randn(B, lk, 2 * HD, generator=rng, device="cuda").to(dtype)
    bias = None
    if with_bias:
        keep = torch.rand(B, lk, generator=rng, device="cuda") > 0.3
        keep[:, 0] = True
        bias = ((1.0 - keep.float()) * -1e9).to(torch.bfloat16)
    return qkv[..., :HD], kv[..., :HD], kv[..., HD:], bias


def check_attention(torch, F, attention, cfg, rng, log, name="mha_blhd"):
    """mha_blhd on column slices of fused projections with a (B, 1, 1, Lk)
    bias, or fused_mha on contiguous (B, H, L, D) operands, as the TPU
    kernel takes them, with a (B, Lk) bias; SDPA on the same heads."""
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    D = HD // H
    packed = name == "mha_blhd"
    cases = (attention_cases if packed else fused_mha_cases)(cfg, BATCH)
    rows = []
    for B, lq, lk, with_bias, dt, fast, uses in cases:
        dtype = getattr(torch, dt)
        q, k, v, bias = _qkv_bias(torch, rng, B, lq, lk, HD, dtype,
                                  with_bias)
        heads = [t.view(B, -1, H, D).transpose(1, 2) for t in (q, k, v)]
        if packed:
            args = (q, k, v, None if bias is None else bias[:, None, None],
                    H, fast)
            kernel_fn, plain_fn = (attention.mha_blhd,
                                   attention.mha_blhd_reference)
        else:
            heads = [t.contiguous() for t in heads]
            args = (*heads, bias, fast)
            kernel_fn, plain_fn = (attention.fused_mha,
                                   attention.fused_mha_reference)
        out, ref = kernel_fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= MHA_TOL[dt]) or not torch.isfinite(out).all():
            fail(f"{name} {lq}x{lk} bias={with_bias} {dt}: max abs err "
                 f"{err} > {MHA_TOL[dt]}")
        mask = None if bias is None else bias[:, None, None].to(dtype)
        kernel = time_ms(torch, lambda: kernel_fn(*args))
        plain = time_ms(torch, lambda: plain_fn(*args))
        library = time_ms(torch, lambda: F.scaled_dot_product_attention(
            *heads, attn_mask=mask))
        nbytes = (B * (2 * lq + 2 * lk) * HD * q.element_size()
                  + (0 if bias is None else bias.numel() * 2))
        row = {"Lq": lq, "Lk": lk, "bias": with_bias, "dtype": dt,
               "fast": fast, "B": B, "max_abs_err": err, "tol": MHA_TOL[dt],
               "ms": kernel, "plain_ms": plain, "library_ms": library,
               "uses": uses,
               **bound(nbytes, 4.0 * B * H * lq * lk * D, dt)}
        rows.append(row)
        log(f"  {name} B={B:3d} {lq:2d}x{lk:2d} bias={with_bias!s:5} "
            f"{dt:8} err {err:.2e} (tol {MHA_TOL[dt]:g})  kernel "
            f"{kernel:.4f} ms  plain {plain:.4f}  sdpa {library:.4f}  "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
    return rows


def hbatch_cases(cfg, B):
    """(batch, Lq, Lk, with_bias, uses) of mha_hbatch: the four attention
    shapes of (h)'s forwards at B (text LAYOUT_TEXT, the text keys with
    the mask bias, the visual ones without) and at the calibration
    batch, each with and without a bias; `uses` is empty but where the
    case is the path's."""
    vis, text = 64, LAYOUT_TEXT
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    kind = f"layout L={text}"
    for b in (B, CALIB_BATCH):
        for lq, lk, path_bias, n in ((text, text, True, nl + nx),
                                     (vis, vis, False, nr + nx),
                                     (text, vis, False, nx),
                                     (vis, text, True, nx)):
            for bias in (True, False):
                on = b == B and bias == path_bias
                yield b, lq, lk, bias, {kind: n} if on else {}


def check_hbatch(torch, F, attention, cfg, rng, log):
    """mha_hbatch against its plain version on column slices of fused
    projections with a (B, 1, 1, Lk) bias or none, bf16; SDPA on the
    same heads as the library call, and mha_blhd (B1, the same function)
    at the same shapes."""
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    D = HD // H
    dt = "bfloat16"
    rows = []
    for B, lq, lk, with_bias, uses in hbatch_cases(cfg, BATCH):
        q, k, v, bias = _qkv_bias(torch, rng, B, lq, lk, HD, torch.bfloat16,
                                  with_bias)
        args = (q, k, v, None if bias is None else bias[:, None, None], H)
        out = attention.mha_hbatch(*args)
        ref = attention.mha_hbatch_reference(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= MHA_TOL[dt]) or not torch.isfinite(out).all():
            fail(f"mha_hbatch B={B} {lq}x{lk} bias={with_bias}: max abs "
                 f"err {err} > {MHA_TOL[dt]}")
        heads = [t.view(B, -1, H, D).transpose(1, 2) for t in (q, k, v)]
        mask = None if bias is None else bias[:, None, None]
        # a launch takes the host about as long as the card takes for
        # it: time the card with its queue kept full (enqueue_ms is the
        # back-to-back time)
        enqueue = time_ms(torch, lambda: attention.mha_hbatch(*args))
        timed = {
            "ms": queued_ms(torch, lambda: attention.mha_hbatch(*args)),
            "plain_ms": queued_ms(
                torch, lambda: attention.mha_hbatch_reference(*args)),
            "library_ms": queued_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=mask)),
            "b1_ms": queued_ms(
                torch, lambda: attention.mha_blhd(*args, True))}
        kernel, plain, library, b1 = (t for t, _ in timed.values())
        nbytes = (B * (2 * lq + 2 * lk) * HD * 2
                  + (0 if bias is None else bias.numel() * 2))
        row = {"Lq": lq, "Lk": lk, "bias": with_bias, "dtype": dt, "B": B,
               "max_abs_err": err, "tol": MHA_TOL[dt], "ms": kernel,
               "enqueue_ms": enqueue, "plain_ms": plain,
               "library_ms": library, "b1_ms": b1,
               "not_queued": [k for k, (_, ok) in timed.items() if not ok],
               "uses": uses, **bound(nbytes, 4.0 * B * H * lq * lk * D, dt)}
        rows.append(row)
        log(f"  mha_hbatch B={B:3d} {lq:2d}x{lk:2d} bias={with_bias!s:5} "
            f"err {err:.2e} (tol {MHA_TOL[dt]:g})  kernel {kernel:.4f} ms "
            f"(back to back {enqueue:.4f})  plain {plain:.4f}  sdpa "
            f"{library:.4f}  mha_blhd {b1:.4f}  bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})"
            + (f"  (not queued, waits for the card: "
               f"{', '.join(row['not_queued'])})" if row["not_queued"] else ""))
    return rows


def train_attention_cases(cfg):
    """(batch, Lq, Lk, with_bias, dtype, with_mask, uses) of
    mha_blhd_train: the four attention shapes of a training forward
    (text keys carry the padding bias) at the VQA batch, at NLVR2's (the
    sentence repeated per image: two rows per example) and at the
    card-vs-CPU step's, in bf16 and fp32, with and without the dropout
    mask, and at pre-training's batch (its check step's shapes are the
    fine-tuning check's). `uses` is empty but where the case is the
    path's: the bf16 steps with dropout ("ft vqa", "ft nlvr2", "pt
    step") and the dropout-free check steps in each type."""
    vis, text = 64, FT_TEXT
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    # pre-training's steps and its check step at the same text length
    assert PT_TEXT == FT_TEXT and PT_CHECK == FT_CHECK
    for kind, b in (("ft vqa", FT_BATCH), ("ft nlvr2", 2 * FT_BATCH),
                    ("ft check", FT_CHECK), ("pt step", PT_BATCH)):
        for lq, lk, bias, n in ((text, text, True, nl + nx),
                                (vis, vis, False, nr + nx),
                                (text, vis, False, nx),
                                (vis, text, True, nx)):
            for dt in ("bfloat16", "float32"):
                for mask in (True, False):
                    if kind == "ft check":
                        uses = {} if mask else {f"ft check {dt}": n,
                                                f"pt check {dt}": n}
                    else:
                        uses = {kind: n} if mask and dt == "bfloat16" else {}
                    yield b, lq, lk, bias, dt, mask, uses


def check_train_attention(torch, F, attention, cfg, rng, log):
    """mha_blhd_train against mha_blhd_train_reference on column slices
    of fused projections with a (B, Lk) bias and a pre-scaled dropout
    mask drawn at the model's rate; SDPA with dropout_p at that rate as
    the library call (it draws its own mask); and the plain-PyTorch time
    of the backward (blhd_einsum_reference recomputed, then its
    gradients for q, k and v)."""
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    D = HD // H
    rate = cfg.attention_probs_dropout_prob
    rows = []
    for B, lq, lk, with_bias, dt, with_mask, uses in \
            train_attention_cases(cfg):
        dtype = getattr(torch, dt)
        q, k, v, bias = _qkv_bias(torch, rng, B, lq, lk, HD, dtype,
                                  with_bias)
        mask = None
        if with_mask:
            keep = torch.rand(B, H, lq, lk, generator=rng,
                              device="cuda") >= rate
            mask = keep.to(dtype) / torch.tensor(1.0 - rate, dtype=dtype,
                                                 device="cuda")
        args = (q, k, v, bias, mask, H)
        out = attention.mha_blhd_train(*args)
        ref = attention.mha_blhd_train_reference(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= MHA_TOL[dt]) or not torch.isfinite(out).all():
            fail(f"mha_blhd_train B={B} {lq}x{lk} mask={with_mask} {dt}: "
                 f"max abs err {err} > {MHA_TOL[dt]}")
        heads = [t.view(B, -1, H, D).transpose(1, 2) for t in (q, k, v)]
        amask = None if bias is None else bias[:, None, None].to(dtype)
        grad = torch.randn(B, lq, HD, generator=rng, device="cuda").to(dtype)

        def recompute():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = attention.blhd_einsum_reference(*leaves, bias, mask, H)
            return torch.autograd.grad(o, leaves, grad)

        # at these batches a launch takes the host longer than the card
        # (the back-to-back time, kept as enqueue_ms): time the card
        enqueue = time_ms(torch, lambda: attention.mha_blhd_train(*args))
        timed = {
            "ms": queued_ms(torch, lambda: attention.mha_blhd_train(*args)),
            "plain_ms": queued_ms(
                torch, lambda: attention.mha_blhd_train_reference(*args)),
            "library_ms": queued_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=amask,
                    dropout_p=rate if with_mask else 0.0)),
            "recompute_ms": queued_ms(torch, recompute)}
        kernel, plain, library, back = (t for t, _ in timed.values())
        nbytes = (B * (2 * lq + 2 * lk) * HD * q.element_size()
                  + (0 if mask is None else mask.numel() * q.element_size())
                  + (0 if bias is None else bias.numel() * 2))
        row = {"B": B, "Lq": lq, "Lk": lk, "bias": with_bias, "dtype": dt,
               "mask": with_mask, "max_abs_err": err, "tol": MHA_TOL[dt],
               "ms": kernel, "enqueue_ms": enqueue, "plain_ms": plain,
               "library_ms": library, "recompute_ms": back,
               "not_queued": [k for k, (_, ok) in timed.items() if not ok],
               "uses": uses,
               **bound(nbytes, 4.0 * B * H * lq * lk * D, dt)}
        rows.append(row)
        log(f"  mha_blhd_train B={B:2d} {lq:2d}x{lk:2d} mask={with_mask!s:5} "
            f"{dt:8} err {err:.2e} (tol {MHA_TOL[dt]:g})  kernel "
            f"{kernel:.4f} ms (back to back {enqueue:.4f})  plain "
            f"{plain:.4f}  sdpa(dropout) "
            f"{library:.4f}  recompute {back:.4f}  bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})"
            + (f"  (not queued, waits for the card: "
               f"{', '.join(row['not_queued'])})" if row["not_queued"] else ""))
    return rows


def check_ffn(torch, F, ffn, cfg, rng, log):
    """fused_ffn (tanh gelu, as serving runs it) with bf16 rows and
    weights at the model's widths; the library call is the same math as
    bf16 PyTorch ops: linear, gelu, linear, residual add, layer_norm."""
    Hd, I = cfg.hidden_size, cfg.intermediate_size
    eps = cfg.layer_norm_eps

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=rng, device="cuda") * scale

    w1 = randn(I, Hd, scale=0.02).to(torch.bfloat16)
    w2 = randn(Hd, I, scale=0.02).to(torch.bfloat16)
    b1, b2, be = randn(I, scale=0.02), randn(Hd, scale=0.02), \
        randn(Hd, scale=0.02)
    g = 1.0 + randn(Hd, scale=0.1)
    lib = [t.to(torch.bfloat16) for t in (b1, b2, g, be)]
    rows = []
    for M, uses in ffn_cases(cfg, BATCH):
        x = randn(M, Hd).to(torch.bfloat16)
        args = (x, w1, b1, w2, b2, g, be)
        out = ffn.fused_ffn(*args, approx_gelu=True, eps=eps)
        ref = ffn.fused_ffn_reference(*args, approx_gelu=True, eps=eps)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = FFN_TOL_REL * ref.float().abs().max().item()
        if not (err <= tol) or not torch.isfinite(out).all():
            fail(f"fused_ffn M={M}: max abs err {err} > {tol}")
        kernel = time_ms(torch, lambda: ffn.fused_ffn(
            *args, approx_gelu=True, eps=eps))
        plain = time_ms(torch, lambda: ffn.fused_ffn_reference(
            *args, approx_gelu=True, eps=eps))
        library = time_ms(torch, lambda: F.layer_norm(
            F.linear(F.gelu(F.linear(x, w1, lib[0]), approximate="tanh"),
                     w2, lib[1]) + x, (Hd,), lib[2], lib[3], eps))
        nbytes = 2 * M * Hd * 2 + 2 * Hd * I * 2 + (I + 3 * Hd) * 4
        row = {"M": M, "H": Hd, "I": I, "max_abs_err": err, "tol": tol,
               "ms": kernel, "plain_ms": plain, "library_ms": library,
               "uses": uses,
               **bound(nbytes, 4.0 * M * Hd * I, "bfloat16")}
        rows.append(row)
        log(f"  fused_ffn M={M:5d} err {err:.2e} (tol {tol:.2e})  kernel "
            f"{kernel:.4f} ms  plain {plain:.4f}  library {library:.4f}  "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
    return rows


def fused_block_cases(cfg, B):
    """(M, variant, uses) of fused_block: "ffn+tail" (every language,
    visual and x-layer self block but the last x-layer's), "ffn" (the
    last x-layer's two self blocks) and "tail" (the x-layers' cross
    output blocks, whose tail is the self-attention QKV), at the text
    rows (batch x L) and visual rows (batch x 64) of every serving and
    check forward. Every tail is 3 x hidden wide."""
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    shapes = {}
    for L in BUCKETS:
        for kind, b in ((f"L={L}", B), (f"check L={L}", CALIB_BATCH)):
            for M, n_stack in ((b * L, nl), (b * 64, nr)):
                for variant, n in (("ffn+tail", n_stack + nx - 1),
                                   ("ffn", 1), ("tail", nx)):
                    if n:
                        uses = shapes.setdefault((M, variant), {})
                        uses[kind] = uses.get(kind, 0) + n
    return [(M, v, uses) for (M, v), uses in sorted(shapes.items())]


def check_fused_block(torch, fb, int8_matmul, quant, cfg, rng, log):
    """fused_block against fused_block_reference at every (M, variant)
    of the fused path, with random calibrated weights at the model's
    widths. Also times the chain it replaces: the reference's glue with
    the int8 dense kernel for the products ("composed") and with
    torch._int_mm ("library", a yardstick the port never calls)."""
    Hd, I = cfg.hidden_size, cfg.intermediate_size
    Nq = 3 * Hd

    def weight(k, n, amax):
        w = torch.randn(k, n, generator=rng, device="cuda") * 0.03
        b = torch.randn(n, generator=rng, device="cuda") * 0.05
        qw = quant.quantize_weight(w.cpu().numpy(), b.cpu().numpy())
        return fb.fused_weight(quant.with_activation_scale(qw, amax)).to(
            "cuda")

    def vec(scale, shift=0.0):
        return torch.randn(Hd, generator=rng, device="cuda") * scale + shift

    out_w, w1, w2 = weight(Hd, Hd, 4.0), weight(Hd, I, 4.5), \
        weight(I, Hd, 2.5)
    tail_w = weight(Hd, Nq, 4.5)
    ln1, ln2 = fb.LN(vec(0.1, 1.0), vec(0.05)), fb.LN(vec(0.1, 1.0),
                                                     vec(0.05))

    def kernel_dense(x, fw):
        return int8_matmul.int8_dense_fused(x, fw.w_i8, fw.out_scale.view(-1),
                                            fw.bias.view(-1), fw.inv_a)

    def int_mm_dense(x, fw):
        x8 = quant.quantize_static_values(x, fw.inv_a)
        acc = torch._int_mm(x8.reshape(-1, x8.shape[-1]), fw.w_i8.t())
        return (acc.float() * fw.out_scale + fw.bias).to(torch.bfloat16)

    rows = []
    for M, variant, uses in fused_block_cases(cfg, BATCH):
        ffn_on, tail_on = variant != "tail", variant != "ffn"
        ctx = torch.randn(M, Hd, generator=rng, device="cuda").to(
            torch.bfloat16)
        x = torch.randn(M, Hd, generator=rng, device="cuda").to(
            torch.bfloat16)
        ffn_args = (w1, w2, ln2) if ffn_on else (None,) * 3
        tail = tail_w if tail_on else None
        args = (ctx, x, out_w, ln1.scale, ln1.bias,
                *((w1, w2, ln2.scale, ln2.bias) if ffn_on else (None,) * 4))

        def kernel_fn():
            return fb.fused_block(*args, tail_w=tail, has_ffn=ffn_on)

        def chain(dense=fb.plain_dense):
            return fb.fused_block_reference(ctx, x, out_w, ln1, *ffn_args,
                                            tail, dense=dense)

        out, ref = kernel_fn(), chain()
        torch.cuda.synchronize()
        outs, refs = (out, ref) if tail_on else ((out,), (ref,))
        err, tol, cos = 0.0, 0.0, 1.0
        for name, o, r in zip(("y", "tail"), outs, refs):
            o, r = o.float(), r.float()
            e, t = (o - r).abs().max().item(), \
                BLOCK_TOL_REL * r.abs().max().item()
            c = cosine(o, r)
            if not (torch.isfinite(o).all() and c > BLOCK_COSINE and e <= t):
                fail(f"fused_block M={M} {variant} {name}: max abs err {e} "
                     f"(tol {t}), cosine {c} (> {BLOCK_COSINE})")
            err, tol, cos = max(err, e), max(tol, t), min(cos, c)
        kernel = time_ms(torch, kernel_fn)
        plain = time_ms(torch, chain)
        composed = time_ms(torch, lambda: chain(kernel_dense))
        library = None
        try:
            library = time_ms(torch, lambda: chain(int_mm_dense))
        except RuntimeError as e:
            log(f"  torch._int_mm refused fused_block M={M}: {e}")
        n_w = Hd * Hd + (2 * Hd * I if ffn_on else 0) + (
            Nq * Hd if tail_on else 0)
        n_vec = 4 * Hd + (2 * I + 4 * Hd if ffn_on else 0) + (
            2 * Nq if tail_on else 0)
        nbytes = 3 * M * Hd * 2 + n_w + 4 * n_vec + (
            M * Nq * 2 if tail_on else 0)
        row = {"M": M, "variant": variant, "I": I if ffn_on else 0,
               "Nq": Nq if tail_on else 0, "max_abs_err": err, "tol": tol,
               "cosine": cos, "ms": kernel, "plain_ms": plain,
               "library_ms": library, "composed_ms": composed,
               "uses": uses, **bound(nbytes, 2.0 * M * n_w, "int8")}
        rows.append(row)
        lib = "n/a" if library is None else f"{library:.4f}"
        log(f"  fused_block M={M:5d} {variant:8} err {err:.2e} (tol "
            f"{tol:.2e}) cos {cos:.7f}  kernel {kernel:.4f} ms  plain "
            f"{plain:.4f}  composed {composed:.4f}  _int_mm chain {lib}  "
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
    # (g)'s int8 evaluations, serving and calibration forwards: VQA, and
    # NLVR2 (language layers on FT_BATCH rows, the cross layers' text and
    # the visual rows on two rows per example, the head on the pooled
    # pair's 2 x hidden)
    b, b2, T = FT_BATCH, 2 * FT_BATCH, FT_TEXT
    lang = {(Hd, 3 * Hd): nl, (Hd, Hd): nl, (Hd, I): nl, (I, Hd): nl}
    cross = {(Hd, 3 * Hd): nx, (Hd, Hd): 3 * nx, (Hd, I): nx, (I, Hd): nx,
             (Hd, 2 * Hd): nx}
    for static, suffix in ((True, ""), (False, " calib")):
        for kind, group, M in (
                ("ft eval", text, b * T), ("ft eval", vis, b * 64),
                ("ft eval", head, b), ("ft nlvr2 eval", lang, b * T),
                ("ft nlvr2 eval", cross, b2 * T),
                ("ft nlvr2 eval", vis, b2 * 64),
                ("ft nlvr2 eval", {(2 * Hd, 2 * Hd): 1, (2 * Hd, 2): 1}, b)):
            for (K, N), n in group.items():
                uses = shapes.setdefault((M, K, N, static), {})
                uses[kind + suffix] = uses.get(kind + suffix, 0) + n
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


def per_forward(rows, mix, kinds):
    """A kernel's times summed over its launches in one forward of each
    kind, and over a serving forward drawn from `mix` (the share of
    questions, hence of full batches, at each bucket length)."""
    keys = ("ms", "enqueue_ms", "plain_ms", "library_ms", "composed_ms",
            "recompute_ms", "b1_ms", "bound_ms", "bytes_ms", "ops_ms")
    out = {}
    for kind in kinds:
        used = [(r, r["uses"][kind]) for r in rows if kind in r["uses"]]
        out[kind] = {k: (None if any(r.get(k) is None for r, _ in used)
                         else sum(r[k] * n for r, n in used)) for k in keys}
    if all(f"L={L}" in out for L in BUCKETS):
        out["mix"] = {k: (None if any(out[f"L={L}"][k] is None
                                      for L in BUCKETS)
                          else sum(mix[L] * out[f"L={L}"][k]
                                   for L in BUCKETS))
                      for k in keys}
    for t in out.values():
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
    return out


def launches_per_kind(name, rows):
    """{kind: launches the kernel phase covers}; fails unless they are
    the kernel's launches per forward in every kind it runs in."""
    want = next(p[name] for p in PER_FORWARD.values() if name in p)
    got = {kind: sum(r["uses"].get(kind, 0) for r in rows)
           for kind in KINDS[name]}
    for kind, n in got.items():
        if n != want:
            fail(f"{name}: the kernel phase covers {n} launches of a "
                 f"{kind} forward, the path makes {want}")
    return got


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


class Setup:
    """What every path phase serves: random weights in the flax layout
    from --seed (LxmertConfig() unless `cfg`, 3,129 answers), an
    IMAGES-image bf16 catalog on `device`, a synthetic vocabulary and
    QUESTIONS questions whose lengths follow VQA_LENGTH_MIX."""

    n_answers = 3129
    V = 64

    def __init__(self, torch, args, log, cfg=None, device="cuda"):
        from xlxmert_tpu_torch.core.config import LxmertConfig
        from xlxmert_tpu_torch.data.tokenization import Tokenizer
        from xlxmert_tpu_torch.serving import lxmert_int8 as engine
        from xlxmert_tpu_torch.serving.feature_cache import FeatureCache

        self.cfg = cfg = cfg or LxmertConfig()
        self.device = device
        t0 = time.time()
        self.bert, self.head = engine.random_params(cfg, self.n_answers,
                                                    seed=args.seed)
        log(f"  random full-width weights (seed {args.seed}): "
            f"{time.time() - t0:.1f}s")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        self.table = torch.randn(IMAGES, self.V, cfg.visual_feat_dim,
                                 generator=gen, device=device,
                                 dtype=torch.bfloat16)
        self.cache = FeatureCache(self.table,
                                  {f"img_{i}": i for i in range(IMAGES)})
        log(f"  catalog: {IMAGES} images x {self.V} x {cfg.visual_feat_dim}"
            f" bf16 on the card, {self.cache.nbytes / 1e6:.1f} MB")
        words = [f"w{i}" for i in range(4000)]
        with tempfile.TemporaryDirectory() as tmp:
            vocab = os.path.join(tmp, "vocab.txt")
            with open(vocab, "w") as f:
                f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                   "[MASK]"] + words) + "\n")
            self.tokenizer = Tokenizer(vocab)
        self.questions = synthetic_questions(QUESTIONS, IMAGES, words,
                                             engine.VQA_LENGTH_MIX,
                                             args.seed)
        self.label2ans = [f"answer_{i}" for i in range(self.n_answers)]

    def serve(self, torch, kernels, **kw):
        """cli/serve.serve over the questions, every kernel's count set to
        0 just before and read just after. Returns (serve's result, the
        launches, peak device bytes, wall seconds, {question_id:
        answer})."""
        from xlxmert_tpu_torch.cli.serve import serve

        with tempfile.TemporaryDirectory() as tmp:
            output = os.path.join(tmp, "answers.jsonl")
            for k in kernels:
                k.launches = 0
            if self.device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            res = serve(self.questions, self.tokenizer, self.cache,
                        {"bert": self.bert, "answer_head": self.head},
                        self.cfg, self.label2ans, output, batch=BATCH,
                        max_text_length=max(BUCKETS),
                        buckets=",".join(map(str, BUCKETS)),
                        device=self.device, **kw)
            wall = time.time() - t0
            launches = {k.name: k.launches for k in kernels}
            peak = (torch.cuda.max_memory_allocated()
                    if self.device == "cuda" else 0)
            with open(output) as f:
                answers = [json.loads(line) for line in f if line.strip()]
        if sorted(a["question_id"] for a in answers) != list(range(len(
                self.questions))) or not all(a["answer"] in self.label2ans
                                             for a in answers):
            fail("the answers file does not answer every question once")
        return res, launches, peak, wall, {a["question_id"]: a["answer"]
                                           for a in answers}

    def check_batches(self, torch):
        """One batch of CALIB_BATCH queries per bucket, at its bucket
        length: (L, ids, mask, feats, pos) on the CPU."""
        import numpy as np

        from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
        from xlxmert_tpu_torch.utils.boxes import box_position

        full = self.tokenizer.encode_batch(
            [q["sent"] for q in self.questions], max(BUCKETS))
        n_tok = (full > 0).sum(axis=1)
        pos = torch.from_numpy(box_position(8)).to(torch.bfloat16)[None]
        batches, low = [], 0
        for L in BUCKETS:
            rows = np.flatnonzero((n_tok > low) & (n_tok <= L))[:CALIB_BATCH]
            low = L
            ids = torch.from_numpy(full[rows, :L].astype(np.int64))
            picks = torch.from_numpy(self.cache.indices(
                [self.questions[i]["img_id"] for i in rows]))
            feats = FeatureCache.lookup(self.table,
                                        picks.to(self.device)).cpu()
            batches.append((L, ids, (ids > 0).float(), feats,
                            pos.expand(len(ids), self.V, 4)))
        return batches


def check_launches(path: str, launches, forwards: int) -> None:
    """Every kernel of `path` launched PER_FORWARD times per forward, and
    every other kernel not at all."""
    for name, n in launches.items():
        per = PER_FORWARD[path].get(name, 0)
        if n != per * forwards or (per and n <= 0):
            fail(f"{path}: {name} launched {n} times in {forwards} "
                 f"forwards, expected {per} per forward")


def card_vs_cpu(torch, batches, card, host, n_answers, log):
    """Holds the card's logits to the CPU's, one batch per bucket: random
    weights leave near-ties among 3,129 answers that the glue's rounding
    (plain PyTorch on either side) can swap, so the answers must agree on
    ARGMAX_AGREE of the queries, the bar the CPU tests set between the
    port and the JAX package, and each swap must be a near-tie on the CPU
    (the top two of 3,129 normal draws lie ~0.25 sd apart)."""
    import numpy as np

    checks, n_same, n_all = {}, 0, 0
    for (L, ids, *_), c, h in zip(batches, card, host):
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
    return checks


def run_path(torch, args, kernels, log, cfg=None, device="cuda",
             setup=None):
    """Phase (c) at `cfg` (default: the full-width LxmertConfig()).
    Returns its numbers, the calibrated engine (qp, head_qp), left on
    the CPU, and the answers. With device="cpu" and a narrow cfg it runs
    on the CPU, as its test does."""
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine

    setup = setup or Setup(torch, args, log, cfg, device)
    cfg = setup.cfg
    res, launches, peak, wall, answers = setup.serve(
        torch, kernels, calib_samples=CALIB_SAMPLES)
    check_launches("int8", launches, res["forwards"])
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
    batches = setup.check_batches(torch)

    def logits(device):
        out = []
        with torch.inference_mode():
            for _, ids, mask, feats, pos in batches:
                _, _, pooled = engine.lxmert_forward(
                    qp, ids.to(device), feats.to(device), pos.to(device),
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
    checks = card_vs_cpu(torch, batches, card, host, setup.n_answers, log)
    return {"launches": launches, "forwards": res["forwards"],
            "answers": res["answers"], "steady_qps": res["steady_qps"],
            "total_qps": res["total_qps"], "peak_bytes": peak,
            "card_vs_cpu": checks}, (qp, hqp), answers


def run_bf16_paths(torch, args, kernels, log, cfg=None, device="cuda",
                   setup=None):
    """Phase (e): cli/serve.serve(bf16=True) in each of BF16_CONFIGS,
    with launch counts checked exactly; the configurations whose CPU
    route is given are held to the same model on the CPU. Returns
    {configuration: numbers}."""
    from xlxmert_tpu_torch.models.lxmert import ServingOptions
    from xlxmert_tpu_torch.models.task_heads import VQAModel

    setup = setup or Setup(torch, args, log, cfg, device)
    out = {}
    for path, (attention, fused_ffn, cpu_route) in BF16_CONFIGS.items():
        res, launches, peak, wall, _ = setup.serve(
            torch, kernels, bf16=True, attention=attention,
            fused_ffn=fused_ffn)
        check_launches(path, launches, res["forwards"])
        log(f"  {path} (attention={attention}, fused_ffn={fused_ffn}): "
            f"{res['answers']} answers in {res['forwards']} forwards, "
            f"steady-state {res['steady_qps']:.1f} q/s, total "
            f"{res['total_qps']:.1f} q/s, wall {wall:.1f}s, peak device "
            f"memory {peak / 2**30:.2f} GiB; launches "
            + ", ".join(f"{k} {n}" for k, n in launches.items() if n))
        out[path] = {"attention": attention, "fused_ffn": fused_ffn,
                     "launches": launches, "forwards": res["forwards"],
                     "answers": res["answers"],
                     "steady_qps": res["steady_qps"],
                     "total_qps": res["total_qps"], "peak_bytes": peak}
        model = res["engine"]
        if cpu_route is None:
            continue
        # the same weights on the CPU, the same route through the
        # kernels' plain versions
        host_model = VQAModel(setup.cfg, setup.n_answers, torch.bfloat16,
                              ServingOptions(True, cpu_route, fused_ffn))
        host_model.load_state_dict(model.state_dict())
        host_model = host_model.to(torch.bfloat16).eval()
        batches = setup.check_batches(torch)

        def logits(m, device):
            with torch.inference_mode():
                return [m(ids.to(device), feats.to(device), pos.to(device),
                          attention_mask=mask.to(device)).cpu()
                        for _, ids, mask, feats, pos in batches]

        card = logits(model, device)
        t0 = time.time()
        host = logits(host_model, "cpu")
        log(f"  {path}: card vs CPU, {CALIB_BATCH} queries per bucket (CPU "
            f"forwards {time.time() - t0:.1f}s):")
        out[path]["card_vs_cpu"] = card_vs_cpu(torch, batches, card, host,
                                               setup.n_answers, log)
        del host_model
    return out


def run_fused_path(torch, args, kernels, log, cfg=None, device="cuda",
                   setup=None, int8_answers=None):
    """Phase (f): cli/serve.serve(fused=True), with the launches of its
    calibration forwards (the int8 engine's) and of its serving forwards
    checked apart; the same fused engine on the CPU (plain versions) held
    to the card as in (c); its answers counted against `int8_answers`
    ((c)'s, on the same questions) when given. Returns its numbers."""
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.lxmert_fused import lxmert_forward_fused

    setup = setup or Setup(torch, args, log, cfg, device)
    cfg = setup.cfg
    calib = {}

    def on_calibrated():
        calib.update((k.name, k.launches) for k in kernels)
        for k in kernels:
            k.launches = 0

    res, launches, peak, wall, answers = setup.serve(
        torch, kernels, calib_samples=CALIB_SAMPLES, fused=True,
        on_calibrated=on_calibrated)
    check_launches("int8", calib, res["calib_forwards"])
    check_launches("int8+fused_block", launches, res["serve_forwards"])
    log(f"  served {res['answers']} answers in {res['calib_forwards']} "
        f"calibration + {res['serve_forwards']} serving forwards, wall "
        f"{wall:.1f}s; steady-state {res['steady_qps']:.1f} q/s, total "
        f"{res['total_qps']:.1f} q/s, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    for what, got, n in (("calibration", calib, res["calib_forwards"]),
                         ("serving", launches, res["serve_forwards"])):
        log(f"  {what} launches: " + ", ".join(
            f"{k} {v} ({v // n} per forward)" for k, v in got.items() if v))

    fp, hqp = res["engine"]
    batches = setup.check_batches(torch)

    def logits(device):
        out = []
        with torch.inference_mode():
            for _, ids, mask, feats, pos in batches:
                _, _, pooled = lxmert_forward_fused(
                    fp, ids.to(device), feats.to(device), pos.to(device),
                    attention_mask=mask.to(device),
                    n_heads=cfg.num_attention_heads)
                out.append(engine.answer_head_forward(hqp, pooled).cpu())
        return out

    card = logits(device)
    fp.to("cpu")
    hqp.to("cpu")
    t0 = time.time()
    host = logits("cpu")
    log(f"  card vs CPU, {CALIB_BATCH} queries per bucket (CPU forwards "
        f"{time.time() - t0:.1f}s):")
    out = {"launches": {k: calib.get(k, 0) + n for k, n in launches.items()},
           "calibration_launches": calib, "serving_launches": launches,
           "forwards": res["forwards"],
           "calib_forwards": res["calib_forwards"],
           "serve_forwards": res["serve_forwards"],
           "answers": res["answers"], "steady_qps": res["steady_qps"],
           "total_qps": res["total_qps"], "peak_bytes": peak,
           "card_vs_cpu": card_vs_cpu(torch, batches, card, host,
                                      setup.n_answers, log)}
    if int8_answers is not None:
        same = sum(a == int8_answers[q] for q, a in answers.items())
        log(f"  fused answers equal to the int8 path's (c): "
            f"{same}/{len(answers)}")
        out["answers_equal_to_int8"] = same
    return out


# ---------------------------------------------------------------------------
# (g) fine-tuning
# ---------------------------------------------------------------------------

FT_CALIB_BATCHES = 4   # FinetuneEngine.predict's calibration window


class _Catalog:
    """The in-memory datasets' feature reader: `get(img_id)` gives the
    (64, D) fp32 row of Setup's catalog ("img_<i>"), from a host copy."""

    def __init__(self, table):
        self.rows = table.float().cpu().numpy()

    def get(self, img_id):
        return self.rows[int(str(img_id).rsplit("_", 1)[1])]


def finetune_data(setup, seed: int):
    """In-memory datasets over Setup's catalog and questions: VQA train
    (FT_STEPS batches) and eval (FT_EVAL questions), each question with
    a soft target on 1-3 random answers; NLVR2 train (2 batches) and
    eval (1 batch), each sentence over its question's image and a random
    second one with a random label."""
    import numpy as np

    from xlxmert_tpu_torch.data.datasets import NLVR2Dataset, VQADataset
    from xlxmert_tpu_torch.data.evaluators import VQAEvaluator

    rng = np.random.RandomState(seed + 1)
    reader = _Catalog(setup.table)
    n_train = FT_STEPS * FT_BATCH
    scores = (0.3, 0.6, 0.9, 1.0)
    vqa = []
    for q in setup.questions[:n_train + FT_EVAL]:
        picks = rng.choice(setup.n_answers, size=rng.randint(1, 4),
                           replace=False)
        vqa.append({**q, "label": {setup.label2ans[a]: scores[rng.randint(4)]
                                   for a in picks}})
    ans2label = {a: i for i, a in enumerate(setup.label2ans)}

    def vqa_set(part):
        ds = VQADataset(part, setup.tokenizer, reader, ans2label,
                        setup.label2ans, max_text_length=FT_TEXT,
                        grid_size=8)
        ds.evaluator = VQAEvaluator(ds.id2datum)
        return ds

    nlvr2 = [{"uid": f"nlvr2_{q['question_id']}", "identifier": f"id_{i}",
              "img0": q["img_id"], "img1": f"img_{rng.randint(IMAGES)}",
              "sent": q["sent"], "label": int(rng.randint(2))}
             for i, q in enumerate(setup.questions[:3 * FT_BATCH])]

    def nlvr2_set(part):
        return NLVR2Dataset(part, setup.tokenizer, reader,
                            max_text_length=FT_TEXT, grid_size=8)

    return {"vqa": (vqa_set(vqa[:n_train]), vqa_set(vqa[n_train:])),
            "nlvr2": (nlvr2_set(nlvr2[:2 * FT_BATCH]),
                      nlvr2_set(nlvr2[2 * FT_BATCH:]))}


def _finetune_config(task, out_dir, seed, **kw):
    from xlxmert_tpu_torch.core.config import FinetuneConfig

    return FinetuneConfig(task=task, batch_size=FT_BATCH, epochs=1,
                          lr=FT_LR, max_text_length=FT_TEXT, grid_size=8,
                          output=out_dir, seed=seed, **kw)


def finetune_once(torch, setup, kernels, route, datasets, task, params,
                  args, device, log, serve_int8=False):
    """cli/finetune.finetune() for one epoch of `task` with the training
    attention `route`, from the flax tree `params`, every kernel's count
    set to 0 just before. Checks the launches of each step (and of the
    int8 evaluation with serve_int8) and that every loss is finite.
    Returns (engine, state, numbers)."""
    from xlxmert_tpu_torch.cli.finetune import finetune
    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine

    train_ds, eval_ds = datasets
    n_steps = len(train_ds) // FT_BATCH
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = _finetune_config(task, out_dir, args.seed,
                               serve_int8=serve_int8)
        eng = FinetuneEngine(cfg, 2 if task == "nlvr2" else setup.n_answers,
                             setup.cfg, total_steps=n_steps,
                             train_attention=route, device=device)
        state = eng.create_state(args.seed, params)
        steps, last = [], {}

        def counts():
            return {k.name: k.launches for k in kernels}

        def on_step(i, metrics):
            loss = float(metrics["loss"])          # waits for the step
            now, seen = time.time(), counts()
            steps.append({
                "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                "ms": (now - last["t"]) * 1e3,
                "launches": {k: n - last["n"][k] for k, n in seen.items()},
                "peak_bytes": (torch.cuda.max_memory_allocated()
                               if device == "cuda" else 0)})
            last.update(t=now, n=seen)

        for k in kernels:
            k.launches = 0
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        last.update(t=time.time(), n=counts())
        logger = RunLogger(out_dir, cfg, use_tensorboard=False)
        score = finetune(eng, state, train_ds, eval_ds, cfg, logger,
                         None if task == "nlvr2" else setup.label2ans,
                         on_step=on_step)
        logger.close()
        launches = counts()
        last_tree = None
        if not serve_int8:
            from xlxmert_tpu_torch.core.checkpoint import load_any_checkpoint

            last_tree = load_any_checkpoint(os.path.join(out_dir,
                                                         "LAST.msgpack"))
    if len(steps) != n_steps:
        fail(f"{task} {route}: {len(steps)} steps, expected {n_steps}")
    for i, s in enumerate(steps):
        if not math.isfinite(s["loss"]) or not math.isfinite(s["grad_norm"]):
            fail(f"{task} {route}: step {i} loss {s['loss']}, gradient "
                 f"norm {s['grad_norm']}")
        check_launches(f"finetune {route}", s["launches"], 1)
    train_launches = {k: sum(s["launches"][k] for s in steps)
                      for k in launches}
    eval_launches = {k: n - train_launches[k] for k, n in launches.items()}
    n_eval = math.ceil(len(eval_ds) / FT_BATCH)
    eval_forwards = n_eval + min(n_eval, FT_CALIB_BATCHES)
    check_launches("finetune serve_int8" if serve_int8 else "finetune eval",
                   eval_launches, eval_forwards)
    if last_tree is not None:
        want = _flat(state.params())
        got = _flat(last_tree)
        if want.keys() != got.keys() or any(
                not (want[k] == got[k]).all() for k in want):
            fail(f"{task} {route}: LAST.msgpack does not read back as the "
                 "trained parameters")
    after_first = [s["ms"] for s in steps[1:]] or [steps[0]["ms"]]
    step_ms = sum(after_first) / len(after_first)
    out = {"task": task, "route": route, "steps": steps, "score": score,
           "step_ms": step_ms, "examples_per_s": FT_BATCH * 1e3 / step_ms,
           "peak_bytes": max(s["peak_bytes"] for s in steps),
           "launches": launches, "eval_forwards": eval_forwards,
           "eval_int8": serve_int8,
           "last_msgpack_read_back": last_tree is not None}
    log(f"  {task} {route}: {n_steps} steps, losses "
        + " ".join(f"{s['loss']:.4f}" for s in steps)
        + f"; step {step_ms:.1f} ms after the first ({out['examples_per_s']:.1f}"
        f" examples/s), peak device memory {out['peak_bytes'] / 2**30:.2f} "
        f"GiB; valid score {score:.4f} ({'int8' if serve_int8 else 'exact'}"
        f" model); launches "
        + (", ".join(f"{k} {n}" for k, n in launches.items() if n) or "none"))
    return eng, state, out


def _flat(tree, prefix=""):
    """{"a/b/c": numpy leaf} of a nested dict."""
    import numpy as np

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def grad_cosine(a, b) -> float:
    """Cosine of two gradients given as {name: tensor} with equal keys,
    each the concatenation of its tensors."""
    dot = sum(float((a[n] * b[n]).sum()) for n in a)
    na = sum(float((a[n] ** 2).sum()) for n in a)
    nb = sum(float((b[n] ** 2).sum()) for n in b)
    return dot / math.sqrt(na * nb + 1e-300)


def step_card_vs_cpu(torch, setup, batch, params, args, device, log):
    """One dropout-free training step (loss and gradients) from the same
    weights on `device` through the kernel route and on the CPU through
    its plain version, in fp32 and bf16, held to STEP_BARS."""
    from xlxmert_tpu_torch.ops import attention
    from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine

    mcfg = setup.cfg.replace(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    out = {}
    for dt, (rel_bar, cos_bar) in STEP_BARS.items():
        res = {}
        for dev in (device, "cpu"):
            cfg = _finetune_config("vqa", "unused", args.seed,
                                   mixed_precision=dt == "bfloat16")
            eng = FinetuneEngine(cfg, setup.n_answers, mcfg, total_steps=1,
                                 train_attention="pallas_blhd", device=dev)
            state = eng.create_state(args.seed, params)
            before = attention.TRAIN_KERNEL.launches
            t0 = time.time()
            loss, _, grads = eng.loss_and_grads(state.model, eng.place(batch),
                                                state.generator)
            res[dev] = (float(loss), {n: g.detach().double().cpu()
                                      for n, g in grads.items()
                                      if g is not None},
                        attention.TRAIN_KERNEL.launches - before,
                        time.time() - t0)
            del eng, state, grads
        (lc, gc, nc, _), (lh, gh, _, th) = res[device], res["cpu"]
        want = PER_FORWARD["finetune pallas_blhd"]["mha_blhd_train"]
        if device == "cuda" and nc != want:
            fail(f"card-vs-CPU step {dt}: {nc} mha_blhd_train launches, "
                 f"expected {want}")
        if gc.keys() != gh.keys() or not gc:
            fail(f"card-vs-CPU step {dt}: the two sides differ in which "
                 "parameters get a gradient")
        cos = grad_cosine(gc, gh)
        rel = abs(lc - lh) / max(abs(lh), 1e-12)
        out[dt] = {"loss_card": lc, "loss_cpu": lh, "loss_rel_diff": rel,
                   "grad_cosine": cos, "launches": nc, "cpu_s": th,
                   "bars": [rel_bar, cos_bar]}
        log(f"  card vs CPU, one dropout-free step on {FT_CHECK} examples, "
            f"{dt}: loss {lc:.6f} vs {lh:.6f} (relative {rel:.2e}, bar "
            f"{rel_bar:g}), gradient cosine {cos:.7f} (bar {cos_bar}); CPU "
            f"step {th:.1f}s")
        if not (math.isfinite(lc) and rel < rel_bar and cos > cos_bar):
            fail(f"card-vs-CPU step {dt}: loss relative difference {rel} "
                 f"(< {rel_bar}), gradient cosine {cos} (> {cos_bar})")
    return out


STEP_PARTS = ("place", "forward_backward", "grad_norm", "update")


def step_breakdown(torch, eng, state, batch, device, n=FT_PARTS):
    """Where a training step's time goes: the wall ms of train_step's
    parts (the batch to the device, forward and backward, the gradient
    norm, the optimizer update), each ended by a synchronize, averaged
    over n steps on `batch`; on the card, also its busy time in one
    train_step (the summed device time of the kernels and copies that
    torch.profiler records) and their number."""
    from xlxmert_tpu_torch.core.optim import global_norm
    from xlxmert_tpu_torch.tasks.finetune import accumulate_or_apply

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    parts = dict.fromkeys(STEP_PARTS, 0.0)
    for _ in range(n):
        sync()
        t = time.perf_counter()
        b = eng.place(batch)
        sync()
        parts["place"] += time.perf_counter() - t
        t = time.perf_counter()
        _, _, grads = eng.loss_and_grads(state.model, b, state.generator)
        sync()
        parts["forward_backward"] += time.perf_counter() - t
        t = time.perf_counter()
        global_norm([g for g in grads.values() if g is not None])
        sync()
        parts["grad_norm"] += time.perf_counter() - t
        t = time.perf_counter()
        accumulate_or_apply(state.opt, state.acc, grads, True)
        sync()
        parts["update"] += time.perf_counter() - t
    out = {k: v * 1e3 / n for k, v in parts.items()}
    out["device_busy_ms"] = out["device_kernels"] = None
    if device == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.train_step(state, batch)
            sync()
        on_card = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        out["device_kernels"] = len(on_card)
        if on_card:
            out["device_busy_ms"] = sum(e.time_range.elapsed_us()
                                        for e in on_card) / 1e3
    return out


def run_finetune_path(torch, args, kernels, log, cfg=None, device="cuda",
                      setup=None):
    """Phase (g): fine-tuning through cli/finetune.finetune() on
    in-memory datasets, both training attention routes, the int8
    evaluation, a repeated-batch loss check, NLVR2, and the card-vs-CPU
    step. With device="cpu" and a narrow cfg it runs on the CPU, as its
    test does. Returns its numbers."""
    from xlxmert_tpu_torch.cli.finetune import evaluate
    from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine

    setup = setup or Setup(torch, args, log, cfg, device)
    # fp32 products stay fp32 on the card (PyTorch's default, stated):
    # the fp32 card-vs-CPU bar is about the kernel, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    data = finetune_data(setup, args.seed)
    train_ds, eval_ds = data["vqa"]
    params = {task: FinetuneEngine(
        _finetune_config(task, "unused", args.seed),
        2 if task == "nlvr2" else setup.n_answers, setup.cfg,
        device="cpu").init_params(args.seed) for task in ("vqa", "nlvr2")}
    out = {"routes": {}}
    launches = {k.name: 0 for k in kernels}

    def add(got):
        for k, n in got.items():
            launches[k] += n

    for route in TRAIN_ROUTES:
        eng, state, res = finetune_once(torch, setup, kernels, route,
                                        data["vqa"], "vqa", params["vqa"],
                                        args, device, log)
        add(res["launches"])
        if route == "pallas_blhd":
            # the same trained model through the int8 engine
            for k in kernels:
                k.launches = 0
            score = evaluate(eng, state.model, eval_ds,
                             eng.cfg.replace(serve_int8=True),
                             setup.label2ans)
            got = {k.name: k.launches for k in kernels}
            n_eval = math.ceil(len(eval_ds) / FT_BATCH)
            forwards = n_eval + min(n_eval, FT_CALIB_BATCHES)
            check_launches("finetune serve_int8", got, forwards)
            add(got)
            res["int8_score"], res["int8_launches"] = score, got
            log(f"  vqa {route}: valid score {score:.4f} through the int8 "
                f"engine ({forwards} forwards: "
                + ", ".join(f"{k} {n}" for k, n in got.items() if n) + ")")
        out["routes"][route] = res
        del eng, state
        if device == "cuda":
            torch.cuda.empty_cache()

    # one batch, repeated: the loss must fall
    eng = FinetuneEngine(_finetune_config("vqa", "unused", args.seed),
                         setup.n_answers, setup.cfg, total_steps=FT_REPEAT,
                         train_attention="pallas_blhd", device=device)
    state = eng.create_state(args.seed, params["vqa"])
    batch = next(iter(train_ds.batches(FT_BATCH)))
    losses = [float(eng.train_step(state, batch)["loss"])
              for _ in range(FT_REPEAT)]
    log(f"  one batch repeated {FT_REPEAT} steps (pallas_blhd): losses "
        + " ".join(f"{x:.4f}" for x in losses))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        fail(f"the loss on a repeated batch did not fall: {losses}")
    out["repeated_batch_losses"] = losses
    out["step_parts"] = step_breakdown(torch, eng, state, batch, device)
    parts = out["step_parts"]
    busy = ("not measured" if parts["device_busy_ms"] is None else
            f"{parts['device_busy_ms']:.1f} ms in {parts['device_kernels']} "
            "kernels and copies")
    log("  where a pallas_blhd step's wall time goes (each part ended by a "
        "synchronize): " + ", ".join(f"{k} {parts[k]:.1f} ms" for k in
                                     STEP_PARTS)
        + f"; the card busy {busy} of one step (torch.profiler)")
    del eng, state

    _, _, res = finetune_once(torch, setup, kernels, "pallas_blhd",
                              data["nlvr2"], "nlvr2", params["nlvr2"], args,
                              device, log, serve_int8=True)
    add(res["launches"])
    out["nlvr2"] = res
    if device == "cuda":
        torch.cuda.empty_cache()

    check = next(iter(train_ds.batches(FT_CHECK)))
    out["card_vs_cpu"] = step_card_vs_cpu(torch, setup, check,
                                          params["vqa"], args, device, log)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# (h) the attention-layout driver
# ---------------------------------------------------------------------------


def _layout_driver():
    """scripts/drive_attention_layout_torch.py, loaded as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "drive_attention_layout_torch.py")
    spec = importlib.util.spec_from_file_location(
        "drive_attention_layout_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_layout_path(torch, args, kernels, log, cfg=None, device="cuda"):
    """Phase (h): the attention-layout driver's int8 run
    (scripts/drive_attention_layout_torch.run_int8) at B=BATCH, text
    LAYOUT_TEXT, through LAYOUT_VARIANTS: the calibration forward must
    launch as the int8 engine's and each variant's forwards exactly
    PER_FORWARD's. Every variant's answers are held to the first's
    (base): hbatch's on LAYOUT_AGREE of the batch, the others' on
    ARGMAX_AGREE, and an answer may differ only where base's top answers
    lie within NEAR_TIE_SD (the int8 engine quantizes each attention's
    output, so a one-step difference in a bf16 score can move a
    near-tie of random weights). With device="cpu" and a narrow cfg it
    runs on the CPU, as its test does."""
    drv = _layout_driver()
    dargs = drv.parse_args([
        "--batch", str(BATCH), "--scan_k", str(LAYOUT_K),
        "--repeats", str(LAYOUT_REPEATS),
        "--variants", ",".join(LAYOUT_VARIANTS),
        "--text_len", str(LAYOUT_TEXT), "--seed", str(args.seed),
        "--device", device])
    res = drv.run_int8(dargs, kernels, lambda m: log(f"  {m}"), cfg=cfg)
    calib = res["calib"]
    check_launches("int8", calib["launches"], calib["forwards"])
    launches = dict(calib["launches"])
    out = {"calib": calib, "variants": {}}
    base = res["variants"][LAYOUT_VARIANTS[0]]["logits"]
    for name, r in res["variants"].items():
        kind = name.rstrip("0123456789")
        check_launches("layout " + kind, r["launches"], r["forwards"])
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        logits = r.pop("logits")
        if not torch.isfinite(logits).all():
            fail(f"layout {name}: logits are not finite")
        swapped = (logits.argmax(-1) != base.argmax(-1)).nonzero()[:, 0]
        r["swap_margins_sd"] = [
            float((base[i].max() - base[i, logits[i].argmax()])
                  / base[i].std()) for i in swapped.tolist()]
        bar = LAYOUT_AGREE if kind == "hbatch" else ARGMAX_AGREE
        if name != LAYOUT_VARIANTS[0] and not r["argmax_agree"] >= bar:
            fail(f"layout {name}: answers agree with {LAYOUT_VARIANTS[0]} on "
                 f"{r['argmax_agree']}, fewer than {bar}")
        if any(m > NEAR_TIE_SD for m in r["swap_margins_sd"]):
            fail(f"layout {name}: an answer swapped against "
                 f"{LAYOUT_VARIANTS[0]} is no near-tie there (margins "
                 f"{r['swap_margins_sd']} sd > {NEAR_TIE_SD})")
        out["variants"][name] = r
        log(f"  {name}: {r['qps']:.1f} q/s, max|d| {r['max_abs_diff']:.4f} "
            f"and argmax agreement {r['argmax_agree']} against "
            f"{LAYOUT_VARIANTS[0]}"
            + (f" (margins of the swapped answers there: "
               f"{', '.join(f'{m:.4f}' for m in r['swap_margins_sd'])} sd)"
               if r["swap_margins_sd"] else "") + "; launches per forward: "
            + (", ".join(f"{k} {n // r['forwards']}"
                         for k, n in r["launches"].items() if n) or "none"))
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# (i) pre-training
# ---------------------------------------------------------------------------


def pretrain_config(setup, out_dir, seed, **kw):
    """The canonical recipe (scripts/pretrain.bash) at PT_BATCH: the
    three tasks round-robin, --visualLosses obj, --vis_mask_predict,
    clustering on the 8x8 grid, bf16, lr PT_LR."""
    from xlxmert_tpu_torch.core.config import TrainConfig

    cfg = setup.cfg
    return TrainConfig(batch_size=PT_BATCH, max_text_length=PT_TEXT,
                       grid_size=8, lr=PT_LR, epochs=1, output=out_dir,
                       seed=seed, clustering=True,
                       num_clusters=cfg.num_clusters,
                       feat_dim=cfg.visual_feat_dim, visual_losses="obj",
                       vis_mask_predict=True, **kw)


def pretrain_data(setup, tcfg, seed):
    """In-memory PretrainDatasets over Setup's questions as captions, each
    on one of IMAGES images with random cluster ids on the 8x8 grid:
    PT_STEPS batches to train on and one to evaluate."""
    import numpy as np

    from xlxmert_tpu_torch.data.datasets import PretrainDataset
    from xlxmert_tpu_torch.data.io import ClusterMap

    rng = np.random.RandomState(seed + 2)
    clusters = ClusterMap({f"img_{i}": rng.randint(0, tcfg.num_clusters, 64)
                           for i in range(IMAGES)})
    corpus = [{"img_id": q["img_id"], "img_source": "mscoco_train",
               "sentf": {"mscoco": [q["sent"]]}} for q in setup.questions]
    n_train = PT_STEPS * PT_BATCH
    kw = dict(max_text_length=tcfg.max_text_length,
              grid_size=tcfg.grid_size,
              vis_mask_sources={"mscoco", "vg"}
              if tcfg.vis_mask_COCOVG_only else None)
    return (PretrainDataset(corpus[:n_train], setup.tokenizer, clusters,
                            **kw),
            PretrainDataset(corpus[n_train:n_train + PT_BATCH],
                            setup.tokenizer, clusters, **kw))


def pretrain_once(torch, setup, kernels, route, data, params, centroids,
                  args, device, log):
    """cli/pretrain.pretrain() for one epoch of PT_STEPS steps on the
    training attention `route`, every kernel's count set to 0 just
    before. Checks each step's launches, the evaluation's (none: the
    exact model) and that every loss is finite, and reads the epoch
    checkpoint back. Returns (engine, state, numbers)."""
    from xlxmert_tpu_torch.cli.pretrain import pretrain
    from xlxmert_tpu_torch.core.checkpoint import (
        epoch_ckpt_name, load_any_checkpoint,
    )
    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    train_ds, valid_ds = data
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = pretrain_config(setup, out_dir, args.seed)
        eng = PretrainEngine(tcfg, setup.cfg, total_steps=PT_STEPS,
                             train_attention=route, device=device)
        state = eng.create_state(args.seed, params)
        steps, last = [], {}

        def counts():
            return {k.name: k.launches for k in kernels}

        def on_step(i, task, metrics):
            loss = float(metrics["total_loss"])      # waits for the step
            now, seen = time.time(), counts()
            peak = 0
            if device == "cuda":
                peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            steps.append({
                "task": task, "loss": loss,
                "grad_norm": float(metrics["grad_norm"]),
                "ms": (now - last["t"]) * 1e3,
                "launches": {k: n - last["n"][k] for k, n in seen.items()},
                "peak_bytes": peak})
            last.update(t=time.time(), n=counts())

        for k in kernels:
            k.launches = 0
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        last.update(t=time.time(), n=counts())
        logger = RunLogger(out_dir, tcfg, use_tensorboard=False)
        valid = pretrain(eng, state, train_ds, valid_ds, tcfg, centroids,
                         logger, on_step=on_step)
        logger.close()
        launches = counts()
        saved = load_any_checkpoint(os.path.join(out_dir,
                                                 epoch_ckpt_name(1)))
    if [s["task"] for s in steps] != [PT_TASKS[i % 3]
                                      for i in range(PT_STEPS)]:
        fail(f"pretrain {route}: tasks {[s['task'] for s in steps]}")
    for i, s in enumerate(steps):
        if not math.isfinite(s["loss"]) or not math.isfinite(s["grad_norm"]):
            fail(f"pretrain {route}: step {i} ({s['task']}) loss "
                 f"{s['loss']}, gradient norm {s['grad_norm']}")
        check_launches(f"pretrain {route}", s["launches"], 1)
    check_launches("pretrain xla", {k: n - sum(s["launches"][k]
                                               for s in steps)
                                    for k, n in launches.items()}, 1)
    if not all(math.isfinite(v) for v in valid.values()) or len(valid) != 3:
        fail(f"pretrain {route}: evaluation {valid}")
    want, got = _flat(state.params()), _flat(saved)
    if want.keys() != got.keys() or any(not (want[k] == got[k]).all()
                                        for k in want):
        fail(f"pretrain {route}: {epoch_ckpt_name(1)} does not read back as "
             "the trained parameters")
    per_task = {}
    for task in PT_TASKS:
        mine = [s for s in steps if s["task"] == task]
        after = [s["ms"] for s in mine[1:]]
        ms = sum(after) / len(after)
        per_task[task] = {"step_ms": ms,
                          "examples_per_s": PT_BATCH * 1e3 / ms,
                          "first_ms": mine[0]["ms"],
                          "peak_bytes": max(s["peak_bytes"] for s in mine),
                          "launches_per_step": mine[-1]["launches"]}
        log(f"  pretrain {route} {task}: step {ms:.1f} ms after the first "
            f"({PT_BATCH * 1e3 / ms:.1f} examples/s; first "
            f"{mine[0]['ms']:.1f} ms), peak device memory "
            f"{per_task[task]['peak_bytes'] / 2**30:.2f} GiB, launches a "
            "step: " + (", ".join(f"{k} {n}" for k, n in
                                  mine[-1]["launches"].items() if n)
                        or "none"))
    log(f"  pretrain {route}: losses " + " ".join(
        f"{s['task']} {s['loss']:.4f}" for s in steps)
        + "; valid " + ", ".join(f"{k} {v:.4f}" for k, v in valid.items()))
    return eng, state, {"route": route, "steps": steps, "valid": valid,
                        "tasks": per_task, "launches": launches,
                        "checkpoint_read_back": True}


def pretrain_step_parts(torch, eng, state, batch, centroids, device,
                        n=PT_PARTS):
    """Where a pre-training step's wall time goes, per task: the batch to
    the device, forward and backward, the gradient norm, the optimizer
    update, each ended by a synchronize and averaged over n steps; on the
    card also the busy time of one train_step (torch.profiler)."""
    from xlxmert_tpu_torch.core.optim import global_norm

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {}
    for task in PT_TASKS:
        parts = dict.fromkeys(STEP_PARTS, 0.0)
        for _ in range(n):
            sync()
            t = time.perf_counter()
            b = eng.place(batch)
            sync()
            parts["place"] += time.perf_counter() - t
            t = time.perf_counter()
            _, grads = eng.loss_and_grads(state.model, b, task, centroids,
                                          state.generator)
            sync()
            parts["forward_backward"] += time.perf_counter() - t
            t = time.perf_counter()
            used = {k: g for k, g in grads.items() if g is not None}
            global_norm(used.values())
            sync()
            parts["grad_norm"] += time.perf_counter() - t
            t = time.perf_counter()
            state.opt.step(grads, used=set(used))
            sync()
            parts["update"] += time.perf_counter() - t
        res = {k: v * 1e3 / n for k, v in parts.items()}
        res["device_busy_ms"] = res["device_kernels"] = None
        if device == "cuda":
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.train_step(state, batch, task, centroids)
                sync()
            on_card = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            res["device_kernels"] = len(on_card)
            if on_card:
                res["device_busy_ms"] = sum(e.time_range.elapsed_us()
                                            for e in on_card) / 1e3
        out[task] = res
    return out


def host_masked(batch, seed, vocab_size):
    """`batch` with injected masks (masked_word_id + word_label at 15 % of
    the words, never the first or last column or a pad; vis_mask at
    30 % of the cells, at least one): both sides of a comparison read
    the same masks."""
    import numpy as np

    rng = np.random.RandomState(seed)
    word = batch["word_id"]
    B, L = word.shape
    pos = (rng.rand(B, L) < 0.15) & (word > 0)
    pos[:, 0] = pos[:, -1] = False
    pos[:, 1] |= word[:, 1] > 0
    masked, label = word.copy(), np.full_like(word, -1)
    label[pos], masked[pos] = word[pos], min(103, vocab_size - 1)
    vis = (rng.rand(B, 64) < 0.3).astype(np.float32)
    vis[:, 0] = 1
    return {**batch, "masked_word_id": masked, "word_label": label,
            "vis_mask": vis}


def pretrain_step_card_vs_cpu(torch, setup, batch, params, centroids, args,
                              device, log):
    """Each task's dropout-free step (losses and gradients) from the same
    weights and injected masks on `device` through the kernel route and
    on the CPU through its plain version, in fp32 and bf16, held to
    STEP_BARS; the parameters without a gradient must be the same."""
    from xlxmert_tpu_torch.ops import attention
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    mcfg = setup.cfg.replace(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    out = {}
    for dt, (rel_bar, cos_bar) in STEP_BARS.items():
        res = {}
        for dev in (device, "cpu"):
            tcfg = pretrain_config(setup, "unused", args.seed,
                                   mixed_precision=dt == "bfloat16")
            eng = PretrainEngine(tcfg, mcfg, total_steps=1,
                                 train_attention="pallas_blhd", device=dev)
            state = eng.create_state(args.seed, params)
            placed, cent = eng.place(batch), centroids.to(dev)
            res[dev] = {}
            for task in PT_TASKS:
                before = attention.TRAIN_KERNEL.launches
                t0 = time.time()
                losses, grads = eng.loss_and_grads(state.model, placed, task,
                                                   cent, state.generator)
                res[dev][task] = (
                    float(losses["total_loss"]),
                    {n: g.detach().double().cpu() for n, g in grads.items()
                     if g is not None},
                    attention.TRAIN_KERNEL.launches - before,
                    time.time() - t0)
                del grads
            del eng, state
        out[dt] = {}
        for task in PT_TASKS:
            (lc, gc, nc, _), (lh, gh, _, th) = (res[device][task],
                                                res["cpu"][task])
            want = PER_FORWARD["pretrain pallas_blhd"]["mha_blhd_train"]
            if device == "cuda" and nc != want:
                fail(f"pretrain card-vs-CPU {task} {dt}: {nc} "
                     f"mha_blhd_train launches, expected {want}")
            if gc.keys() != gh.keys() or not gc:
                fail(f"pretrain card-vs-CPU {task} {dt}: the two sides "
                     "differ in which parameters get a gradient")
            cos = grad_cosine(gc, gh)
            rel = abs(lc - lh) / max(abs(lh), 1e-12)
            out[dt][task] = {"loss_card": lc, "loss_cpu": lh,
                             "loss_rel_diff": rel, "grad_cosine": cos,
                             "with_gradient": len(gc), "launches": nc,
                             "cpu_s": th, "bars": [rel_bar, cos_bar]}
            log(f"  card vs CPU, {task} on {PT_CHECK} examples, {dt}: loss "
                f"{lc:.6f} vs {lh:.6f} (relative {rel:.2e}, bar "
                f"{rel_bar:g}), gradient cosine {cos:.7f} (bar {cos_bar}), "
                f"{len(gc)} parameters with a gradient on both; CPU step "
                f"{th:.1f}s")
            if not (math.isfinite(lc) and rel < rel_bar and cos > cos_bar):
                fail(f"pretrain card-vs-CPU {task} {dt}: loss relative "
                     f"difference {rel} (< {rel_bar}), gradient cosine "
                     f"{cos} (> {cos_bar})")
    return out


def run_pretrain_path(torch, args, kernels, log, cfg=None, device="cuda",
                      setup=None):
    """Phase (i): pre-training through cli/pretrain.pretrain() on
    in-memory datasets, both training attention routes, the step's
    parts, and the card-vs-CPU steps. With device="cpu" and a narrow cfg
    it runs on the CPU, as its test does. Returns its numbers."""
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    setup = setup or Setup(torch, args, log, cfg, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = pretrain_config(setup, "unused", args.seed)
    data = pretrain_data(setup, tcfg, args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 3)
    centroids = torch.randn(tcfg.num_clusters, setup.cfg.visual_feat_dim,
                            generator=gen, device=device)
    params = PretrainEngine(tcfg, setup.cfg, device="cpu").init_params(
        args.seed)
    out = {"routes": {}}
    launches = {k.name: 0 for k in kernels}
    for route in TRAIN_ROUTES:
        eng, state, res = pretrain_once(torch, setup, kernels, route, data,
                                        params, centroids, args, device, log)
        for k, n in res["launches"].items():
            launches[k] += n
        if route == "pallas_blhd":
            batch = next(iter(data[0].batches(PT_BATCH)))
            out["step_parts"] = parts = pretrain_step_parts(
                torch, eng, state, batch, centroids, device)
            for task, p in parts.items():
                busy = ("not measured" if p["device_busy_ms"] is None else
                        f"{p['device_busy_ms']:.1f} ms in "
                        f"{p['device_kernels']} kernels and copies")
                log(f"  a pallas_blhd {task} step's parts (each ended by a "
                    "synchronize): " + ", ".join(
                        f"{k} {p[k]:.1f} ms" for k in STEP_PARTS)
                    + f"; the card busy {busy} of one step (torch.profiler)")
        out["routes"][route] = res
        del eng, state
        if device == "cuda":
            torch.cuda.empty_cache()
    check = host_masked(next(iter(data[0].batches(PT_CHECK))), args.seed,
                        setup.cfg.vocab_size)
    out["card_vs_cpu"] = pretrain_step_card_vs_cpu(
        torch, setup, check, params, centroids, args, device, log)
    out["launches"] = launches
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import torch
        import torch.nn.functional as F

        from xlxmert_tpu_torch.core.config import LxmertConfig
        from xlxmert_tpu_torch.ops import _build, attention, ffn, int8_matmul
        from xlxmert_tpu_torch.ops import fused_block, quant
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
    kernels = [attention.KERNEL, int8_matmul.KERNEL, ffn.KERNEL,
               attention.FUSED_MHA_KERNEL, fused_block.KERNEL,
               attention.TRAIN_KERNEL, attention.HBATCH_KERNEL]
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
    log(f"(b) kernels vs plain versions at every shape of the paths: "
        f"B={BATCH} at text {BUCKETS}, B={CALIB_BATCH} at calibration and "
        f"the card-vs-CPU checks; training attention at B={FT_BATCH}, "
        f"{2 * FT_BATCH} and {FT_CHECK} ({card})")
    rows = {"mha_blhd": check_attention(torch, F, attention, cfg, rng, log),
            "int8_dense": check_int8(torch, int8_matmul, quant, cfg, BATCH,
                                     3129, rng, log),
            "fused_ffn": check_ffn(torch, F, ffn, cfg, rng, log),
            "fused_mha": check_attention(torch, F, attention, cfg, rng,
                                         log, name="fused_mha"),
            "fused_block": check_fused_block(torch, fused_block, int8_matmul,
                                             quant, cfg, rng, log),
            "mha_blhd_train": check_train_attention(torch, F, attention, cfg,
                                                    rng, log),
            "mha_hbatch": check_hbatch(torch, F, attention, cfg, rng, log)}
    times = {}
    for name, kernel_rows in rows.items():
        launches_per_kind(name, kernel_rows)
        times[name] = per_forward(kernel_rows, mix, KINDS[name])
        log(f"  {name} per forward (ms):")
        for kind, t in times[name].items():
            lib = "none" if t["library_ms"] is None else \
                f"{t['library_ms']:.4f}"
            composed = "" if t["composed_ms"] is None else \
                f"  composed {t['composed_ms']:.4f}"
            if t["recompute_ms"] is not None:
                composed += f"  backward recompute {t['recompute_ms']:.4f}"
            if t["b1_ms"] is not None:
                composed += f"  mha_blhd {t['b1_ms']:.4f}"
            if t["enqueue_ms"] is not None:
                composed += f"  kernel back to back {t['enqueue_ms']:.4f}"
            log(f"    {kind:17} kernel {t['ms']:.4f}  plain "
                f"{t['plain_ms']:.4f}  library {lib}{composed}  bound "
                f"{t['bound_ms']:.4f} ({t['bound_by']})")

    # (c) the int8 serving path, (e) the bf16 paths, (f) the fused int8
    # path: one setup
    log("(c) int8 serving path: full width, bucketed 8,12,16,20, B="
        f"{BATCH}, random weights")
    setup = Setup(torch, args, log, cfg)
    path, _, int8_answers = run_path(torch, args, kernels, log, setup=setup)
    log("(e) bf16 serving paths: the same weights and questions")
    bf16_paths = run_bf16_paths(torch, args, kernels, log, setup=setup)
    log("(f) whole-block fused int8 path (serve(fused=True)): the same "
        "weights and questions")
    fused_path = run_fused_path(torch, args, kernels, log, setup=setup,
                                int8_answers=int8_answers)
    log(f"(g) fine-tuning: full width, {setup.n_answers} answers, B="
        f"{FT_BATCH}, text {FT_TEXT}, bf16 mixed precision, random weights")
    ft = run_finetune_path(torch, args, kernels, log, setup=setup)
    step = times["mha_blhd_train"]["ft vqa"]
    pallas = ft["routes"]["pallas_blhd"]
    ft["kernel_share"] = step["ms"] / pallas["step_ms"]
    ft["recompute_share"] = step["recompute_ms"] / pallas["step_ms"]
    log(f"  pallas_blhd step {pallas['step_ms']:.1f} ms: mha_blhd_train "
        f"{step['ms']:.4f} ms of it ({ft['kernel_share']:.2%}, phase (b)'s "
        f"times), the backward's einsum recompute {step['recompute_ms']:.4f}"
        f" ms ({ft['recompute_share']:.2%}); xla step "
        f"{ft['routes']['xla']['step_ms']:.1f} ms")
    log(f"(h) attention layout: the int8 engine at full width, B={BATCH}, "
        f"text {LAYOUT_TEXT}, through {', '.join(LAYOUT_VARIANTS)} "
        "(scripts/drive_attention_layout_torch.py)")
    layout = run_layout_path(torch, args, kernels, log)
    log(f"(i) pre-training: full width, {cfg.num_clusters} clusters, B="
        f"{PT_BATCH}, text {PT_TEXT}, {PT_STEPS} round-robin steps a route, "
        "bf16 mixed precision, dropout 0.1, random weights")
    pt = run_pretrain_path(torch, args, kernels, log, setup=setup)
    paths = {"int8": path, **bf16_paths, "int8+fused_block": fused_path,
             "finetune": ft, "layout": layout, "pretrain": pt}

    # (d) the kernels line and the device line: times per serving forward
    # drawn from VQA_LENGTH_MIX (mha_blhd_train: per VQA training step);
    # launches summed over the paths' runs
    sources = {"mha_blhd": ("xlxmert_tpu_torch/csrc/mha_blhd.cu",
                            "xlxmert_tpu/ops/attention.py:159"),
               "int8_dense": ("xlxmert_tpu_torch/csrc/int8_dense.cu",
                              "xlxmert_tpu/ops/int8_matmul.py:27"),
               "fused_ffn": ("xlxmert_tpu_torch/csrc/fused_ffn.cu",
                             "xlxmert_tpu/ops/ffn.py:28"),
               "fused_mha": ("xlxmert_tpu_torch/csrc/fused_mha.cu",
                             "xlxmert_tpu/ops/attention.py:36"),
               "fused_block": ("xlxmert_tpu_torch/csrc/fused_block.cu",
                               "xlxmert_tpu/ops/fused_block.py:135"),
               "mha_blhd_train": ("xlxmert_tpu_torch/csrc/mha_blhd_train.cu",
                                  "xlxmert_tpu/ops/attention.py:354"),
               "mha_hbatch": ("xlxmert_tpu_torch/csrc/mha_hbatch.cu",
                              "scripts/drive_attention_layout.py:183")}
    per = {"mha_blhd_train": "ft vqa", "mha_hbatch": f"layout L={LAYOUT_TEXT}"}
    summary = []
    for name, (src, replaces) in sources.items():
        t = times[name][per.get(name, "mix")]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(p["launches"].get(name, 0)
                            for p in paths.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call quantizes, multiplies in int8 and
            # dequantizes: torch._int_mm's product-only times are in
            # --out; fused_block's is its chain with torch._int_mm
            "library_ms": t["library_ms"]})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": device_name, "nvidia_smi": card,
                   "build_s": build_s, "kernel_rows": rows,
                   "per_forward": times, "paths": paths,
                   "kernels": summary,
                   "note": "times in 'kernels' are per serving forward at "
                           "B=256, weighted by VQA_LENGTH_MIX ('mix' in "
                           "'per_forward'), mha_blhd_train's per VQA "
                           "training step at B=32 ('ft vqa'; library: SDPA "
                           "with dropout_p, its own mask), mha_hbatch's per "
                           "int8 forward of the layout driver at B=256, "
                           "L=20; launches are summed over the path runs in "
                           "'paths'"},
                  f, indent=1)
    log(f"(d) per-shape numbers in {args.out}; kernel times per serving "
        f"forward at B={BATCH}, weighted by VQA_LENGTH_MIX; launches per "
        "path: " + "; ".join(
            f"{p}: " + ", ".join(f"{k} {n}" for k, n in
                                 v["launches"].items() if n)
            for p, v in paths.items()))
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": device_name,
                                             "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

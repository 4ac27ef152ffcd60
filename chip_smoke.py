#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (xlxmert_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out runs/chip_smoke.json]

Phases, each of which fails the script on error:
  (a) device and build: the card's name, count and power limit; the seven
      CUDA kernels built from csrc/ in parallel (nvcc, -Xptxas -v);
  (b) kernels: each kernel against its plain PyTorch version on the card
      at every shape the paths give it (serving at B=256 for each bucket
      length, calibration and the card-vs-CPU checks at batch 8), with
      its time (CUDA events; the attention kernels and their SDPA
      yardstick, the int8 dense kernel, its plain version and
      torch._int_mm, and fused_ffn and fused_block with their plain
      versions and library chains, with the card's queue kept full, the
      median of QUEUED_RUNS queued_ms runs, and back to back as
      enqueue_ms), the
      plain version's time, a PyTorch library
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
      version and bit for bit to mha_blhd(fast=True) (B1, the same
      function) at (h)'s four attention shapes at B=256 and the
      calibration batch, with and without a bias, beside SDPA and B1's
      times at the same shapes; each case logs its launch plan and the
      CTAs an SM holds (one wave at B=256, gated). fused_mha's
      gradients on the card (kernel forward, einsum backward) are held
      to the CPU's (the bf16 bias's gradient in the fp32 case element by
      element to 2^-7 |r| plus its sum's fp32 accumulation bound), and
      mha_blhd, mha_hbatch and fused_ffn must refuse a backward;
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
      card's busy time; the exact resume: FULL_K steps, one full-state
      save (train_state_to_tree + AsyncCheckpointer.save_full: the FULL's
      bytes, snapshot and write times), a fresh engine's restore equal to
      the saved state leaf for leaf, and its next step's loss within the
      spread of two uninterrupted runs; pretrain(profile=2) on the
      pallas_blhd route writes a trace that names the steps and holds
      every mha_blhd_train launch; each task's dropout-free step on the
      card against the CPU with injected masks at B=8, held to
      STEP_BARS, with the same parameters left without a gradient;
  (j) text-to-image at bench.py Config #2's widths (LxmertConfig(),
      10,000 random centroids randn x 0.1, B=64, text 20, an 8x8 grid,
      the SPADE generator at base 32, target 256, codebook 256, bf16),
      from JAX-format files made from --seed through
      cli/sample_images.sample_images(), 3 batches a run: NAR 4 steps
      int8 and bf16, each rendered exactly and with --fast_render; AR 64
      steps (confidence) int8 and bf16; AR TLBR int8. Launches checked
      exactly (the int8 sampler: its calibration forwards, a language
      stack a batch, a fixed count a decode step; the bf16 sampler
      none); NAR and AR semantics from the card's own steps (the masked
      counts, one commit a cell, the final ids the commits, the codes
      their centroids); the steps of one int8 and one bf16 NAR run for 2
      sentences through the same engine on the CPU, teacher-forced
      (cluster logits' cosine > 0.99, >= 90 % of cells with the card's
      argmax among the CPU's tied maxima); the card's bf16 render of the
      final grids against an fp32 render on the CPU (mean |d| <= 2e-2 of
      [0, 1], cosine > 0.99); samples/s, the render's ms, and one int8
      NAR and AR decode step's device time by kernel and glue, its busy
      share and wall time (torch.profiler). Phase (b) also holds
      mha_blhd and the int8 dense (N = 10,000 included) to their plain
      versions at every shape of the int8 sampler;
  (k) GAN training at bench.py measure_gan's widths (G base 32, D base
      64, codebook 256, an 8x8 grid of 2,048-d codes, 256 px, 10,000
      centroids randn x 0.2, B=32, bf16, no perceptual encoder) through
      cli/train_generator.train() for GAN_SIZES["pairs"] (D, G) pairs:
      every loss finite, no launch of a port kernel (cuDNN convolutions
      and cuBLAS products only), G_0.msgpack rendered through
      models/gan.render; chained_gd_step(4) timed as measure_gan times it
      ((D, G) pairs/s, images/s), a D-step's and a G-step's ms, the peak
      memory, and one pair profiled (torch.profiler: busy share, device
      time in convolutions, the ACGAN product and glue) with the
      convolutions' rate (their FLOPs counted from their shapes by
      torch.utils.flop_counter over that time); one fp32 D-step
      and G-step at B=2 on the card against the CPU from the same state
      and batch (GAN_STEP_BARS on the losses and the gradients' cosine,
      GAN_SN_TOL on the u, v written back);
  (l) the offline feature factory at bench.py measure_factory's widths,
      random weights from --seed, no port kernel (cuBLAS, cuDNN, plain
      PyTorch): k-means (vocab/kmeans) at N=131,072 randn rows, K=10,000,
      D=2,048, one chunked Lloyd step timed (rows/s beside its fp32
      bound, peak memory), then kmeans(init="random", n_iter=2) and
      assign as cli/run_kmeans calls them, and one Lloyd step at N=8,192,
      K=512 held to the CPU's (kmeans_agreement); the X-152-32x8d-FPN
      grid extractor (models/detectron) at B=8 on an 800x1344 canvas
      through cli/extract_features.extract_batch, bf16 and fp32
      (img/s, peak, a profiled batch's busy share, the convolutions'
      FLOPs counted from their shapes and their rate), bf16 held to fp32
      (BF16_COSINE, BF16_MAX_REL); fp32 with TF32 off against the CPU
      (cosine >= 0.99999, max |d| <= 1e-3 of max |ref|): the extractor
      at one 256x384 image, and ROIAlign and fc6 from the card's FPN of
      one 800x1333 image over grid boxes on every level P2..P5; the bbox
      path through cli/extract_bbox_features.extract_batch at B=4, 1,000
      proposals, 1,601 classes (img/s, its time split into the backbone
      with the RPN head, the proposal stage with its NMS, the box head
      and select_top_features), and at one 256x384 image the card
      against the CPU unit by unit from the card's own inputs (the RPN
      outputs by cosine, the proposal stage's ids but for near-tie
      swaps, the box head's class scores, fc6 and fc7 by cosine, the
      selection's kept indices and obj_id exactly);
  (m) FID at cli/eval_fid's widths, random weights from --seed, no port
      kernel (cuDNN convolutions, plain PyTorch, host numpy): InceptionV3
      (pt_inception's architecture, 1,008 classes, drawn BN statistics)
      and the ResNet-50 extractor in fp32 (cuDNN's default TF32) at B=64
      over 2,048 'real' and 2,048 'fake' host images at 256 px through
      eval_fid.fid_of_batches (FID, img/s of each extractor, peak
      memory, a profiled batch: busy share, convolutions with their
      counted FLOPs and rate, glue; InceptionV3's forward channels-last
      against NCHW); the host resize of 64 images at 480x640 and the
      Fréchet distance at D=2,048 timed apart; pool3 card vs CPU on 8
      images (TF32 off and on, POOL3_BARS) and the FID of 256 images'
      card features (TF32 off) against their CPU features (FID_REL_BAR);
  (n) distributed training (parallel/) at full width, every rank a
      process spawned after the kernels are built, the ranks sharing the
      one card over gloo (NCCL takes one rank a device): a 2-rank
      launch with torchrun's environment through cli/finetune (B=32 a
      rank, both training attention routes, the int8 evaluation merged
      over the ranks), then in the same group tp = 2 pre-training per
      task (6 heads a rank, fp32, dropout-free on injected masks) held to
      the single-process step on the card (STEP_BARS["float32"]) and
      timed, and the sharded feature table's lookup, bit-equal to the
      unsharded one; a 3-rank GPipe of the 9 language layers (M = 4)
      held to the sequential stack. Step ms, examples/s a rank and in
      all, the all-reduce MiB and ms a step, the pipeline's measured
      bubble; every rank's launches summed. Phase (b) holds
      mha_blhd_train to its plain version at the tp step's 6 heads;
  (d) one JSON line listing the kernels (times per serving forward of
      the length mix; mha_blhd_train's per training step, mha_hbatch's
      per layout forward), then the device line last.

Per-shape numbers go to --out. Without a CUDA device, or outside the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
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
    # (k): GAN training (cuDNN convolutions, cuBLAS): no port kernel
    "gan": {},
    # (l): the offline factory (cuDNN, cuBLAS, plain PyTorch): none
    "factory": {},
    # (m): FID (cuDNN convolutions, plain PyTorch, host numpy): none
    "fid": {},
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
QUEUED_RUNS = 3       # queued_ms runs per timed function; the median kept
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


def queued_times(torch, fns) -> dict:
    """For each function in `fns` ({key: fn}), under its key, the median
    of QUEUED_RUNS queued_ms runs (one run of 10 launches of a ~0.05 ms
    kernel can read twice its time); "not_queued": the keys whose
    function waits for the card."""
    out, not_queued = {}, []
    for key, fn in fns.items():
        runs = [queued_ms(torch, fn) for _ in range(QUEUED_RUNS)]
        out[key] = sorted(ms for ms, _ in runs)[QUEUED_RUNS // 2]
        if not all(ok for _, ok in runs):
            not_queued.append(key)
    return {**out, "not_queued": not_queued}


def not_queued_note(row) -> str:
    return (f"  (not queued, waits for the card: "
            f"{', '.join(row['not_queued'])})" if row["not_queued"] else "")


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: bytes moved over the memory
    rate or operations over the peak rate of their type, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@contextlib.contextmanager
def tf32_off(torch):
    """TF32 off for products and convolutions (cuDNN's default has it on
    for fp32 convolutions), the flags restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


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
                            "pt check float32", "pt check bfloat16",
                            "n dp step"],
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


def check_attention(torch, F, attention, cfg, rng, log, name="mha_blhd",
                    cases=None):
    """mha_blhd on column slices of fused projections with a (B, 1, 1, Lk)
    bias, or fused_mha on contiguous (B, H, L, D) operands, as the TPU
    kernel takes them, with a (B, Lk) bias; SDPA on the same heads. At
    `cases` (attention_cases' form; default: the serving paths')."""
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    D = HD // H
    packed = name == "mha_blhd"
    if cases is None:
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

        def sdpa():
            return F.scaled_dot_product_attention(*heads, attn_mask=mask)

        # the card's time with its queue kept full (a launch takes the
        # host about as long as the card takes for it); enqueue_ms and
        # library_enqueue_ms are the back-to-back times, as PR 5 took them
        times = {"enqueue_ms": time_ms(torch, lambda: kernel_fn(*args)),
                 "library_enqueue_ms": time_ms(torch, sdpa),
                 **queued_times(torch, {
                     "ms": lambda: kernel_fn(*args),
                     "plain_ms": lambda: plain_fn(*args),
                     "library_ms": sdpa})}
        nbytes = (B * (2 * lq + 2 * lk) * HD * q.element_size()
                  + (0 if bias is None else bias.numel() * 2))
        row = {"Lq": lq, "Lk": lk, "bias": with_bias, "dtype": dt,
               "fast": fast, "B": B, "max_abs_err": err, "tol": MHA_TOL[dt],
               **times, "uses": uses,
               **bound(nbytes, 4.0 * B * H * lq * lk * D, dt)}
        rows.append(row)
        log(f"  {name} B={B:3d} {lq:2d}x{lk:2d} bias={with_bias!s:5} "
            f"{dt:8} err {err:.2e} (tol {MHA_TOL[dt]:g})  kernel "
            f"{row['ms']:.4f} ms (back to back {row['enqueue_ms']:.4f})  "
            f"plain {row['plain_ms']:.4f}  sdpa {row['library_ms']:.4f} "
            f"(back to back {row['library_enqueue_ms']:.4f})  bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})"
            + not_queued_note(row))
    return rows


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at |x|: 2^(floor(log2 |x|) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


# the per-element bar of a bf16 bias gradient: one bf16 step at |r|
# (2^-7 |r| bounds the spacing between two neighbours) plus `t`
BIAS_GRAD_REL = 2.0 ** -7
FP32_UNIT = 2.0 ** -24


def bias_grad_sum_bound(torch, q, k, v, bias, grad):
    """t of each bias element's gradient: the fp32 accumulation bound of
    its sum over heads and queries, d bias[b, j] = sum_{h, i} ds[b, h, i,
    j], for the card and the CPU each summing in their own order: 2
    gamma_n * sum |ds| with n = H * Lq terms and gamma_n = n u / (1 - n
    u), u = 2^-24. ds, the scores' gradient p * (dp - rowsum(p * dp)),
    is computed here in float64 from the CPU inputs (q, k, v (B, H, L,
    D), the (B, Lk) bias, the output's gradient)."""
    q, k, v, g = (t.detach().cpu().double() for t in (q, k, v, grad))
    B, H, Lq, D = q.shape
    s = q @ k.transpose(-1, -2) / math.sqrt(D) \
        + bias.detach().cpu().double().reshape(B, 1, 1, -1)
    p = torch.softmax(s, dim=-1)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    n = H * Lq
    gamma = n * FP32_UNIT / (1 - n * FP32_UNIT)
    return 2 * gamma * ds.abs().sum(dim=(1, 2))


def bias_grad_excess(a, r, t) -> float:
    """The largest |a - r| - (2^-7 |r| + t) over the elements of two bf16
    bias gradients (the card's a, the CPU's r) and the bound t: > 0
    fails."""
    a, r, t = (x.double().cpu() for x in (a, r, t))
    return float(((a - r).abs() - (BIAS_GRAD_REL * r.abs() + t)).max())


def check_fused_mha_grad(torch, attention, ffn, cfg, rng, log,
                         device="cuda"):
    """C1 on the card: fused_mha's gradients (q, k, v and a bias that
    requires grad; the kernel forward, the einsum recomputed backward)
    against the einsum's gradients on the CPU at the model's widths, B=
    CALIB_BATCH, both cross-attention shapes, fp32 (1e-4) and bf16 (2e-2,
    the fp32 and the bf16 softmax); the bias, which the kernel takes in
    bf16 only, so that its gradient is bf16, in the fp32 case element by
    element to 2^-7 |r| + t (bias_grad_sum_bound); and mha_blhd,
    mha_hbatch and fused_ffn under grad: their backward raises."""
    H, HD = cfg.num_attention_heads, cfg.hidden_size
    D, B = HD // H, CALIB_BATCH
    rows = []
    for lq, lk in ((FT_TEXT, 64), (64, FT_TEXT)):
        for dt, fast in (("float32", False), ("bfloat16", False),
                         ("bfloat16", True)):
            dtype = getattr(torch, dt)
            q, k, v = (torch.randn(B, H, L, D, generator=rng,
                                   device=rng.device).to(device, dtype)
                       for L in (lq, lk, lk))
            bias = 0.5 * torch.randn(B, lk, generator=rng, device=rng.device)
            bias[1, lk // 2:] = -1e9
            grad = torch.randn(B, H, lq, D, generator=rng,
                               device=rng.device).to(device, dtype)
            got = {}
            for where, fn in ((device, attention.fused_mha),
                              ("cpu", attention.einsum_mha_reference)):
                leaves = [t.detach().to(where).requires_grad_()
                          for t in (q, k, v)]
                leaves.append(bias.to(where, torch.bfloat16)
                              .requires_grad_())
                out = fn(*leaves, fast)
                out.backward(grad.to(where))
                got[where] = [t.detach().cpu().float() for t in
                              (out, *(x.grad for x in leaves))]
            tol = 1e-4 if dt == "float32" else MHA_TOL[dt]
            errs = {}
            for name, a, r in zip(("out", "q", "k", "v", "bias"),
                                  got[device], got["cpu"]):
                errs[name] = (a - r).abs().max().item()
                if name == "bias" and dt == "float32":
                    # the kernel takes a bf16 bias, so its gradient is
                    # bf16: near a rounding tie the card and the CPU
                    # round one fp32 sum a bf16 step apart, below which
                    # a 1e-4 bar lies. The bar, per element: one bf16
                    # step at |r| plus the sum's fp32 accumulation bound
                    t = bias_grad_sum_bound(
                        torch, q, k, v, bias.to(torch.bfloat16), grad)
                    excess = bias_grad_excess(a, r, t)
                    bias_bar = {"rel": BIAS_GRAD_REL,
                                "t_max": float(t.max()),
                                "excess": excess,
                                "absolute_bar_before": bf16_step(
                                    r.abs().max().item())}
                    if not excess <= 0:
                        fail(f"fused_mha backward {lq}x{lk} {dt} fast="
                             f"{fast}: an element of the bias gradient "
                             f"differs from the CPU's by {excess} more "
                             f"than 2^-7 |r| + t (t up to "
                             f"{bias_bar['t_max']})")
                    continue
                # tol absolute and relative, as torch.testing.assert_close
                excess = ((a - r).abs() - tol * r.abs()).max().item()
                if not (excess <= tol):
                    fail(f"fused_mha backward {lq}x{lk} {dt} fast={fast}: "
                         f"{name} differs from the CPU's by "
                         f"{errs[name]} (tol {tol} + {tol} relative)")
            rows.append({"B": B, "Lq": lq, "Lk": lk, "dtype": dt,
                         "fast": fast, "tol": tol, "max_abs_err": errs,
                         **({"bias_bar": bias_bar} if dt == "float32"
                            else {})})
            log(f"  fused_mha backward B={B} {lq:2d}x{lk:2d} {dt:8} "
                f"fast={fast!s:5} max |card - CPU| " + "  ".join(
                    f"{n} {e:.2e}" for n, e in errs.items())
                + f" (tol {tol:g} + {tol:g} relative"
                + (f"; bias 2^-7 |r| + t, t <= {bias_bar['t_max']:.2e}, "
                   f"excess {bias_bar['excess']:.2e}" if dt == "float32"
                   else "") + ")")
    q, k, v = (torch.randn(B, FT_TEXT, HD, generator=rng, device=rng.device)
               .to(device, torch.bfloat16).requires_grad_() for _ in range(3))
    x = torch.randn(B * FT_TEXT, HD, generator=rng, device=rng.device).to(
        device, torch.bfloat16).requires_grad_()
    w1, w2 = (torch.zeros(*shape, device=device, dtype=torch.bfloat16)
              for shape in ((cfg.intermediate_size, HD),
                            (HD, cfg.intermediate_size)))
    vecs = [torch.zeros(n, device=device) for n in
            (cfg.intermediate_size, HD, HD, HD)]
    for name, fn in (
            ("mha_blhd", lambda: attention.mha_blhd(q, k, v, None, H)),
            ("mha_hbatch", lambda: attention.mha_hbatch(q, k, v, None, H)),
            ("fused_ffn", lambda: ffn.fused_ffn(x, w1, vecs[0], w2,
                                                *vecs[1:]))):
        try:
            fn().float().sum().backward()
        except RuntimeError as e:
            if f"{name} has no gradient" not in str(e):
                raise
        else:
            fail(f"{name}: a backward through the kernel did not raise")
        log(f"  {name} under grad: the backward raises, as the JAX "
            "package's has no vjp")
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


def hbatch_resident_on_card(attention, plan, lk: int) -> int:
    """CTAs of an mha_hbatch plan one SM holds at once, by the card's
    occupancy calculator (csrc/mha_hbatch.cu mha_hbatch_resident)."""
    import ctypes

    fn = attention.HBATCH_KERNEL.lib().mha_hbatch_resident
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn(lk, plan.warps, plan.smem)


def check_hbatch(torch, F, attention, cfg, rng, log):
    """mha_hbatch against its plain version on column slices of fused
    projections with a (B, 1, 1, Lk) bias or none, bf16, and bit for bit
    against mha_blhd(fast=True) (B1, whose per-tile body every head
    runs); SDPA on the same heads as the library call, and B1's time at
    the same shapes. Each case logs the plan it ran (ops/_plan
    .hbatch_plan) with the CTAs an SM holds by the card's occupancy
    calculator: at B=BATCH every CTA must be resident in one wave."""
    from xlxmert_tpu_torch.ops import _plan

    H, HD = cfg.num_attention_heads, cfg.hidden_size
    D = HD // H
    dt = "bfloat16"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for B, lq, lk, with_bias, uses in hbatch_cases(cfg, BATCH):
        q, k, v, bias = _qkv_bias(torch, rng, B, lq, lk, HD, torch.bfloat16,
                                  with_bias)
        args = (q, k, v, None if bias is None else bias[:, None, None], H)
        out = attention.mha_hbatch(*args)
        ref = attention.mha_hbatch_reference(*args)
        b1 = attention.mha_blhd(*args, True)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        what = f"mha_hbatch B={B} {lq}x{lk} bias={with_bias}"
        if not (err <= MHA_TOL[dt]) or not torch.isfinite(out).all():
            fail(f"{what}: max abs err {err} > {MHA_TOL[dt]}")
        if not torch.equal(out, b1):
            fail(f"{what}: not bit-equal to mha_blhd(fast=True): "
                 f"{(out != b1).sum().item()} elements differ, by up to "
                 f"{(out.float() - b1.float()).abs().max().item()}")
        plan = _plan.hbatch_plan(B, H, lq, lk)
        on_sm = hbatch_resident_on_card(attention, plan, lk)
        if on_sm < 1:
            fail(f"{what}: the card holds no CTA of the plan {plan}")
        waves = math.ceil(B * plan.grid[1] / (sms * on_sm))
        if B == BATCH and waves > 1:
            fail(f"{what}: the plan {plan} takes {waves} waves ({on_sm} "
                 f"CTAs an SM on {sms} SMs)")
        heads = [t.view(B, -1, H, D).transpose(1, 2) for t in (q, k, v)]
        mask = None if bias is None else bias[:, None, None]
        # a launch takes the host about as long as the card takes for
        # it: time the card with its queue kept full (enqueue_ms is the
        # back-to-back time)
        enqueue = time_ms(torch, lambda: attention.mha_hbatch(*args))
        times = queued_times(torch, {
            "ms": lambda: attention.mha_hbatch(*args),
            "plain_ms": lambda: attention.mha_hbatch_reference(*args),
            "library_ms": lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=mask),
            "b1_ms": lambda: attention.mha_blhd(*args, True)})
        nbytes = (B * (2 * lq + 2 * lk) * HD * 2
                  + (0 if bias is None else bias.numel() * 2))
        row = {"Lq": lq, "Lk": lk, "bias": with_bias, "dtype": dt, "B": B,
               "max_abs_err": err, "tol": MHA_TOL[dt], "enqueue_ms": enqueue,
               **times, "uses": uses,
               "plan": plan._asdict(), "resident": on_sm,
               "resident_model": _plan.hbatch_resident(plan, lk),
               "waves": waves,
               **bound(nbytes, 4.0 * B * H * lq * lk * D, dt)}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"  {what:37} err {err:.2e} (tol {MHA_TOL[dt]:g}), bit-equal to "
            f"mha_blhd  kernel {row['ms']:.4f} ms (back to back "
            f"{enqueue:.4f})  plain {row['plain_ms']:.4f}  sdpa "
            f"{row['library_ms']:.4f}  mha_blhd {row['b1_ms']:.4f}  bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}, "
            f"{row['bound_share']:.0%} of it)  plan: grid {plan.grid}, "
            f"{plan.heads} heads a CTA, {plan.lanes} lanes, {plan.slots} "
            f"slots, {plan.warps} warps, {plan.smem} B; {on_sm} CTAs an SM "
            f"(model {row['resident_model']}), {waves} wave(s)"
            + not_queued_note(row))
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
                    if kind == "ft vqa" and uses:
                        # (n)'s data-parallel steps: B=FT_BATCH a rank
                        uses["n dp step"] = n
                    yield b, lq, lk, bias, dt, mask, uses


# (n)'s tensor-parallel pre-training step: fp32, dropout-free, H/2 heads
TP_KINDS = ["n tp check float32"]


def tp_train_attention_cases(cfg):
    """(batch, Lq, Lk, with_bias, dtype, with_mask, heads, uses) of
    mha_blhd_train in (n)'s tp = 2 pre-training steps: each rank's
    H / 2 heads (384 packed columns at full width) at PT_CHECK, fp32,
    without the dropout mask."""
    vis, text = 64, FT_TEXT
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    for lq, lk, bias, n in ((text, text, True, nl + nx),
                            (vis, vis, False, nr + nx),
                            (text, vis, False, nx), (vis, text, True, nx)):
        yield (PT_CHECK, lq, lk, bias, "float32", False,
               cfg.num_attention_heads // 2, {"n tp check float32": n})


def check_train_attention(torch, F, attention, cfg, rng, log, cases=None):
    """mha_blhd_train against mha_blhd_train_reference on column slices
    of fused projections with a (B, Lk) bias and a pre-scaled dropout
    mask drawn at the model's rate; SDPA with dropout_p at that rate as
    the library call (it draws its own mask); and the plain-PyTorch time
    of the backward (blhd_einsum_reference recomputed, then its
    gradients for q, k and v). `cases` (tp_train_attention_cases) give
    their own head count; train_attention_cases' take the model's."""
    D = cfg.hidden_size // cfg.num_attention_heads
    rate = cfg.attention_probs_dropout_prob
    rows = []
    if cases is None:
        cases = ((*c[:-1], cfg.num_attention_heads, c[-1])
                 for c in train_attention_cases(cfg))
    for B, lq, lk, with_bias, dt, with_mask, H, uses in cases:
        HD = H * D
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
        times = queued_times(torch, {
            "ms": lambda: attention.mha_blhd_train(*args),
            "plain_ms": lambda: attention.mha_blhd_train_reference(*args),
            "library_ms": lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=amask,
                dropout_p=rate if with_mask else 0.0),
            "recompute_ms": recompute})
        nbytes = (B * (2 * lq + 2 * lk) * HD * q.element_size()
                  + (0 if mask is None else mask.numel() * q.element_size())
                  + (0 if bias is None else bias.numel() * 2))
        row = {"B": B, "Lq": lq, "Lk": lk, "bias": with_bias, "dtype": dt,
               "mask": with_mask, "heads": H, "max_abs_err": err,
               "tol": MHA_TOL[dt],
               "enqueue_ms": enqueue, **times, "uses": uses,
               **bound(nbytes, 4.0 * B * H * lq * lk * D, dt)}
        rows.append(row)
        log(f"  mha_blhd_train B={B:2d} H={H:2d} {lq:2d}x{lk:2d} "
            f"mask={with_mask!s:5} "
            f"{dt:8} err {err:.2e} (tol {MHA_TOL[dt]:g})  kernel "
            f"{row['ms']:.4f} ms (back to back {enqueue:.4f})  plain "
            f"{row['plain_ms']:.4f}  sdpa(dropout) "
            f"{row['library_ms']:.4f}  recompute {row['recompute_ms']:.4f}  "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']})"
            + not_queued_note(row))
    return rows


def check_ffn(torch, F, ffn, cfg, rng, log, device="cuda"):
    """fused_ffn (tanh gelu, as serving runs it) with bf16 rows and
    weights at the model's widths; the library call is the same math as
    bf16 PyTorch ops: linear, gelu, linear, residual add, layer_norm."""
    Hd, I = cfg.hidden_size, cfg.intermediate_size
    eps = cfg.layer_norm_eps

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=rng, device=device) * scale

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
        def kernel_fn():
            return ffn.fused_ffn(*args, approx_gelu=True, eps=eps)

        # the card's queue kept full (queued_times), the kernel also back
        # to back (enqueue_ms)
        enqueue = time_ms(torch, kernel_fn)
        times = queued_times(torch, {
            "ms": kernel_fn,
            "plain_ms": lambda: ffn.fused_ffn_reference(
                *args, approx_gelu=True, eps=eps),
            "library_ms": lambda: F.layer_norm(
                F.linear(F.gelu(F.linear(x, w1, lib[0]), approximate="tanh"),
                         w2, lib[1]) + x, (Hd,), lib[2], lib[3], eps)})
        nbytes = 2 * M * Hd * 2 + 2 * Hd * I * 2 + (I + 3 * Hd) * 4
        row = {"M": M, "H": Hd, "I": I, "max_abs_err": err, "tol": tol,
               "split": ffn.launch_plan(M, I), "enqueue_ms": enqueue,
               **times, "uses": uses,
               **bound(nbytes, 4.0 * M * Hd * I, "bfloat16")}
        rows.append(row)
        log(f"  fused_ffn M={M:5d} split {row['split']} err {err:.2e} (tol "
            f"{tol:.2e})  kernel {row['ms']:.4f} ms (back to back "
            f"{enqueue:.4f})  plain {row['plain_ms']:.4f}  library "
            f"{row['library_ms']:.4f}  bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})" + not_queued_note(row))
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


def check_fused_block(torch, fb, int8_matmul, quant, cfg, rng, log,
                      device="cuda"):
    """fused_block against fused_block_reference at every (M, variant)
    of the fused path, with random calibrated weights at the model's
    widths. Also times the chain it replaces: the reference's glue with
    the int8 dense kernel for the products ("composed") and with
    torch._int_mm ("library", a yardstick the port never calls)."""
    Hd, I = cfg.hidden_size, cfg.intermediate_size
    Nq = 3 * Hd

    def weight(k, n, amax):
        w = torch.randn(k, n, generator=rng, device=device) * 0.03
        b = torch.randn(n, generator=rng, device=device) * 0.05
        qw = quant.quantize_weight(w.cpu().numpy(), b.cpu().numpy())
        return fb.fused_weight(quant.with_activation_scale(qw, amax)).to(
            device)

    def vec(scale, shift=0.0):
        return torch.randn(Hd, generator=rng, device=device) * scale + shift

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
        ctx = torch.randn(M, Hd, generator=rng, device=device).to(
            torch.bfloat16)
        x = torch.randn(M, Hd, generator=rng, device=device).to(
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
        # the card's queue kept full (queued_times), the kernel also back
        # to back (enqueue_ms)
        fns = {"ms": kernel_fn, "plain_ms": chain,
               "composed_ms": lambda: chain(kernel_dense)}
        try:
            chain(int_mm_dense)
            fns["library_ms"] = lambda: chain(int_mm_dense)
        except RuntimeError as e:
            log(f"  torch._int_mm refused fused_block M={M}: {e}")
        enqueue = time_ms(torch, kernel_fn)
        times = queued_times(torch, fns)
        n_w = Hd * Hd + (2 * Hd * I if ffn_on else 0) + (
            Nq * Hd if tail_on else 0)
        n_vec = 4 * Hd + (2 * I + 4 * Hd if ffn_on else 0) + (
            2 * Nq if tail_on else 0)
        nbytes = 3 * M * Hd * 2 + n_w + 4 * n_vec + (
            M * Nq * 2 if tail_on else 0)
        row = {"M": M, "variant": variant, "I": I if ffn_on else 0,
               "Nq": Nq if tail_on else 0, "max_abs_err": err, "tol": tol,
               "cosine": cos, "split": fb.launch_plan(M, I if ffn_on else 0),
               "enqueue_ms": enqueue, "library_ms": None, **times,
               "uses": uses, **bound(nbytes, 2.0 * M * n_w, "int8")}
        rows.append(row)
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        log(f"  fused_block M={M:5d} {variant:8} split {row['split']} err "
            f"{err:.2e} (tol {tol:.2e}) cos {cos:.7f}  kernel "
            f"{row['ms']:.4f} ms (back to back {enqueue:.4f})  plain "
            f"{row['plain_ms']:.4f}  composed {row['composed_ms']:.4f}  "
            f"_int_mm chain {lib}  bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})" + not_queued_note(row))
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


def check_int8(torch, int8_matmul, quant, cfg, B, n_answers, rng, log,
               device="cuda", cases=None):
    """int8_dense against int8_dense_reference, bit for bit, at every
    shape of the paths (dense_cases). The kernel, its plain version and
    torch._int_mm (the int8 product alone: no quantization, no
    dequantization, an int32 output; a yardstick the port never calls,
    where it takes the shape) are timed with the card's queue kept full
    (queued_times: at the text shapes a call takes the host about as
    long as the card takes for it); the kernel also back to back
    (enqueue_ms). At `cases` (dense_cases' form; default: the serving
    and fine-tuning paths')."""
    rows = []
    weights = {}
    for M, K, N, static, uses in (dense_cases(cfg, B, n_answers)
                                  if cases is None else cases):
        if (K, N) not in weights:
            w = torch.randn(K, N, generator=rng, device=device) * 0.02
            b = torch.randn(N, generator=rng, device=device) * 0.02
            weights[K, N] = quant.quantize_weight(
                w.cpu().numpy(), b.cpu().numpy()).to(device)
        qw = weights[K, N]
        x = torch.randn(M, K, generator=rng, device=device).to(
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
        fns = {"ms": lambda: int8_matmul.int8_dense_fused(
                   x, qw.w_i8, col, qw.bias, inv_a),
               "plain_ms": lambda: int8_matmul.int8_dense_reference(
                   x, qw.w_i8, col, qw.bias, inv_a)}
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            x8 = (quant.quantize_static_values(x, inv_a) if static
                  else quant.quantize_rows(x)[0])
            wt = qw.w_i8.t()
            try:
                torch._int_mm(x8, wt)
                fns["int_mm_ms"] = lambda: torch._int_mm(x8, wt)
            except RuntimeError as e:
                log(f"  torch._int_mm refused M={M} K={K} N={N}: {e}")
        enqueue = time_ms(torch, fns["ms"])
        times = queued_times(torch, fns)
        nbytes = M * K * 2 + N * K + M * N * 2 + N * 4 * 2
        row = {"M": M, "K": K, "N": N, "static": static,
               "max_abs_err": err, "tol": INT8_TOL, "enqueue_ms": enqueue,
               "library_ms": None, "int_mm_ms": None, **times,
               "uses": uses, **bound(nbytes, 2.0 * M * N * K, "int8")}
        rows.append(row)
        mm = ("n/a" if row["int_mm_ms"] is None
              else f"{row['int_mm_ms']:.4f}")
        log(f"  int8_dense {'static ' if static else 'dynamic'} M={M:5d} "
            f"K={K:4d} N={N:4d} err {err:.1e}  kernel {row['ms']:.4f} ms "
            f"(back to back {enqueue:.4f})  plain {row['plain_ms']:.4f}  "
            f"_int_mm {mm}  bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})" + not_queued_note(row))
    return rows


def per_forward(rows, mix, kinds):
    """A kernel's times summed over its launches in one forward of each
    kind, and over a serving forward drawn from `mix` (the share of
    questions, hence of full batches, at each bucket length)."""
    keys = ("ms", "enqueue_ms", "plain_ms", "library_ms",
            "library_enqueue_ms", "composed_ms", "recompute_ms", "b1_ms",
            "bound_ms", "bytes_ms", "ops_ms")
    out = {}
    for kind in kinds:
        used = [(r, r["uses"][kind]) for r in rows if kind in r["uses"]]
        out[kind] = {k: (None if any(r.get(k) is None for r, _ in used)
                         else sum(r[k] * n for r, n in used)) for k in keys}
        # int8_dense: torch._int_mm refuses some shapes (the answer
        # heads): its time and the kernel's over the shapes it takes
        took = [(r, n) for r, n in used if r.get("int_mm_ms") is not None]
        out[kind]["int_mm_ms"] = (sum(r["int_mm_ms"] * n for r, n in took)
                                  if took else None)
        out[kind]["int_mm_kernel_ms"] = (sum(r["ms"] * n for r, n in took)
                                         if took else None)
    if all(f"L={L}" in out for L in BUCKETS):
        out["mix"] = {k: (None if any(out[f"L={L}"][k] is None
                                      for L in BUCKETS)
                          else sum(mix[L] * out[f"L={L}"][k]
                                   for L in BUCKETS))
                      for k in keys + ("int_mm_ms", "int_mm_kernel_ms")}
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


def pretrain_data(setup, tcfg, seed, steps=PT_STEPS):
    """In-memory PretrainDatasets over Setup's questions as captions, each
    on one of IMAGES images with random cluster ids on the 8x8 grid:
    `steps` batches to train on and one to evaluate."""
    import numpy as np

    from xlxmert_tpu_torch.data.datasets import PretrainDataset
    from xlxmert_tpu_torch.data.io import ClusterMap

    rng = np.random.RandomState(seed + 2)
    clusters = ClusterMap({f"img_{i}": rng.randint(0, tcfg.num_clusters, 64)
                           for i in range(IMAGES)})
    corpus = [{"img_id": q["img_id"], "img_source": "mscoco_train",
               "sentf": {"mscoco": [q["sent"]]}} for q in setup.questions]
    n_train = steps * PT_BATCH
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


FULL_K = 3           # steps before the full-state save (one of each task)
PROFILE_STEPS = 2    # --profile N of the traced pre-training run


def full_state_check(torch, setup, kernels, data, params, centroids, args,
                     device, log) -> dict:
    """The exact resume on the card: FULL_K steps of the pallas_blhd
    route, train_state_to_tree + AsyncCheckpointer.save_full (snapshot
    and write times, the files' bytes), the next step's loss (run 1);
    the same FULL_K + 1 steps again from the start (run 2: their spread);
    a fresh engine restores the FULL, every leaf of its state must equal
    the saved leaf bit for bit, and its next step's loss must lie within
    the two runs' spread of run 1's."""
    import numpy as np

    from xlxmert_tpu_torch.core.checkpoint import (
        AsyncCheckpointer, load_pytree, restore_train_state,
        train_state_to_tree,
    )
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    batches = [b for _, b in zip(range(FULL_K + 1), data[0].batches(
        PT_BATCH, shuffle=True, seed=args.seed))]
    before = {k.name: k.launches for k in kernels}
    out = {}

    def fresh():
        tcfg = pretrain_config(setup, "unused", args.seed)
        eng = PretrainEngine(tcfg, setup.cfg, total_steps=PT_STEPS,
                             train_attention="pallas_blhd", device=device)
        return eng, eng.create_state(args.seed, params)

    def step(eng, state, i):
        m = eng.train_step(state, batches[i], eng.task_for_step(i),
                           centroids)
        return float(m["total_loss"])

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        full = os.path.join(tmp, "Epoch01_FULL.msgpack")
        lxrt = os.path.join(tmp, "Epoch01_LXRT.msgpack")
        eng, state = fresh()
        for i in range(FULL_K):
            step(eng, state, i)
        writer = AsyncCheckpointer()
        sync()
        t0 = time.perf_counter()
        writer.save_full(train_state_to_tree(state, PT_STEPS), full, lxrt)
        out["snapshot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        writer.wait()
        out["write_s"] = time.perf_counter() - t0
        out["full_bytes"] = os.path.getsize(full)
        out["lxrt_bytes"] = os.path.getsize(lxrt)
        run1 = step(eng, state, FULL_K)
        del eng, state
        eng, state = fresh()
        run2 = [step(eng, state, i) for i in range(FULL_K + 1)][-1]
        del eng, state
        eng, state = fresh()
        sync()
        t0 = time.perf_counter()
        total = restore_train_state(state, full)
        sync()
        out["restore_s"] = time.perf_counter() - t0
        tree = load_pytree(full)
    back = train_state_to_tree(state, PT_STEPS)
    flat_back, flat_saved = _flat(back), _flat(tree)
    if total != PT_STEPS or flat_back.keys() != flat_saved.keys():
        fail(f"full state: restored horizon {total}, or the trees differ in "
             "their leaves")
    differ = [k for k in flat_saved
              if flat_back[k].dtype != flat_saved[k].dtype
              or not np.array_equal(flat_back[k], flat_saved[k])]
    if differ:
        fail(f"full state: {len(differ)} restored leaves differ from the "
             f"saved ones, e.g. {differ[:3]}")
    resumed = step(eng, state, FULL_K)
    del eng, state, tree, back
    spread, moved = abs(run2 - run1), abs(resumed - run1)
    out.update(leaves=len(flat_saved), losses={
        "run1": run1, "run2": run2, "resumed": resumed}, spread=spread,
        resumed_diff=moved, resumed_bit_equal=resumed == run1,
        launches={k.name: k.launches - before[k.name] for k in kernels})
    gib = {k: out[f"{k}_bytes"] / 2**30 for k in ("full", "lxrt")}
    log(f"  full state after {FULL_K} steps: FULL {gib['full']:.2f} GiB + "
        f"LXRT {gib['lxrt']:.2f} GiB, snapshot "
        f"{out['snapshot_s']:.2f}s (train_state_to_tree + save_full's host "
        f"copy), write {out['write_s']:.2f}s (both files, writer thread), "
        f"restore {out['restore_s']:.2f}s (read + load on the card); "
        f"{len(flat_saved)} leaves restored bit for bit; step {FULL_K + 1}'s "
        f"loss: run 1 {run1!r}, run 2 {run2!r} (spread {spread:.3e}), "
        f"resumed {resumed!r} (|d| {moved:.3e}"
        f"{', bit-equal to run 1' if resumed == run1 else ''})")
    if not (math.isfinite(resumed) and moved <= spread):
        fail(f"full state: the resumed step's loss {resumed} is {moved} from "
             f"run 1's {run1}, outside the two runs' spread {spread}")
    # runs 1 and 2: FULL_K + 1 steps each; the resumed run: one
    check_launches("pretrain pallas_blhd", out["launches"], 3 * FULL_K)
    return out


def profile_check(torch, setup, kernels, params, centroids, args, device,
                  log) -> dict:
    """cli/pretrain.pretrain(profile=PROFILE_STEPS) with --train_attention
    pallas_blhd over an epoch of PROFILE_STEPS batches (all traced): the
    trace under <output>/profile must name each step, and on the card
    hold as many mha_blhd_train kernels as the wrapper counted."""
    from xlxmert_tpu_torch.cli.pretrain import pretrain
    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    before = {k.name: k.launches for k in kernels}
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = pretrain_config(setup, out_dir, args.seed)
        data = pretrain_data(setup, tcfg, args.seed, steps=PROFILE_STEPS)
        eng = PretrainEngine(tcfg, setup.cfg, total_steps=PROFILE_STEPS,
                             train_attention="pallas_blhd", device=device)
        state = eng.create_state(args.seed, params)
        logger = RunLogger(out_dir, tcfg, use_tensorboard=False)
        t0 = time.perf_counter()
        pretrain(eng, state, data[0], data[1], tcfg, centroids, logger,
                 profile=PROFILE_STEPS)
        wall = time.perf_counter() - t0
        logger.close()
        del eng, state
        files = [os.path.join(out_dir, "profile", n) for n in
                 sorted(os.listdir(os.path.join(out_dir, "profile")))]
        if len(files) != 1:
            fail(f"pretrain --profile: {len(files)} trace files")
        nbytes = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    launches = {k.name: k.launches - before[k.name] for k in kernels}
    check_launches("pretrain pallas_blhd", launches, PROFILE_STEPS)
    names = [e.get("name", "") for e in events]
    steps = sorted({n for n in names if n.startswith("train_step ")})
    kernels_seen = sum(1 for e in events if e.get("cat") == "kernel" and (
        "attend_mma_kernel" in e.get("name", "")
        or "mha_blhd_masked_kernel" in e.get("name", "")))
    want_steps = sorted(f"train_step {PT_TASKS[i % 3]}"
                        for i in range(PROFILE_STEPS))
    counted = launches.get("mha_blhd_train", 0)
    out = {"trace_bytes": nbytes, "events": len(events), "steps": steps,
           "mha_blhd_train_in_trace": kernels_seen,
           "mha_blhd_train_counted": counted, "wall_s": wall,
           "launches": launches}
    log(f"  --profile {PROFILE_STEPS}: a trace of {len(events)} events "
        f"({nbytes / 2**20:.1f} MiB) naming {', '.join(steps)}; "
        f"mha_blhd_train kernels in it {kernels_seen}, launches counted "
        f"{counted}; the run {wall:.1f}s")
    if steps != want_steps:
        fail(f"pretrain --profile: the trace names {steps}, not "
             f"{want_steps}")
    if device == "cuda" and kernels_seen != counted:
        fail(f"pretrain --profile: {kernels_seen} mha_blhd_train kernels in "
             f"the trace, {counted} launches counted")
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
    out["full_state"] = full_state_check(torch, setup, kernels, data, params,
                                         centroids, args, device, log)
    out["profile"] = profile_check(torch, setup, kernels, params, centroids,
                                   args, device, log)
    for part in ("full_state", "profile"):
        for k, n in out[part]["launches"].items():
            launches[k] += n
    check = host_masked(next(iter(data[0].batches(PT_CHECK))), args.seed,
                        setup.cfg.vocab_size)
    out["card_vs_cpu"] = pretrain_step_card_vs_cpu(
        torch, setup, check, params, centroids, args, device, log)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# (j) text-to-image
# ---------------------------------------------------------------------------

# bench.py's Config #2: NAR mask-predict, 4 steps, an 8x8 grid, 10,000
# codes, B=64, text 20, a 256-pixel SPADE render (base 32, codebook 256)
SAMPLE_SIZES = dict(batch=64, text=20, batches=3, grid=8, nar_steps=4,
                    clusters=10000, check=2, base_dim=32, target_size=256,
                    codebook_dim=256)
# each run of cli/sample_images.sample_images: its flags; "NAR int8" is
# Config #2's shape (the int8 sampler and the exact render)
SAMPLE_RUNS = {
    "NAR int8": ["--int8"],
    "NAR int8 fast_render": ["--int8", "--fast_render"],
    "NAR bf16": [],
    "NAR bf16 fast_render": ["--fast_render"],
    "AR int8": ["--int8", "--sample_mode", "AR"],
    "AR bf16": ["--sample_mode", "AR"],
    "AR int8 TLBR": ["--int8", "--sample_mode", "AR", "--position_strategy",
                     "TLBR"],
}
# the runs whose steps are held to the CPU's, teacher-forced
SAMPLE_CHECKED = ("NAR int8", "NAR bf16")
SAMPLE_COSINE = 0.99   # a step's cluster logits, card against CPU
SAMPLE_AGREE = 0.9     # share of cells whose card argmax the CPU ties
RENDER_MEAN_TOL = 2e-2  # mean |d| of [0, 1] pixels, card bf16 vs CPU fp32
RENDER_COSINE = 0.99   # of the [-1, 1] images


def sampler_launches(cfg):
    """mha_blhd and int8_dense launches of the int8 sampler: a
    calibration forward (the whole model and the cluster head), a batch's
    language stack, and a decode step (the visual and cross layers
    without the last cross layer's language side, and the head)."""
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    return {"sample calib": {"mha_blhd": nl + nr + 4 * nx,
                             "int8_dense": 4 * nl + 1 + 4 * nr + 14 * nx
                             + 3},
            "sample lang": {"mha_blhd": nl, "int8_dense": 4 * nl},
            "sample step": {"mha_blhd": nr + 4 * nx - 2,
                            "int8_dense": 1 + 4 * nr + 14 * nx - 7 + 3}}


def expected_sample_launches(cfg, int8: bool, batches: int, steps: int):
    """Every kernel's launches in one sample_images run, {"calib": the
    int8 sampler's 3 calibration forwards, "loop": per batch its language
    stack and `steps` decode steps}; none for the bf16 sampler (the exact
    model's einsum attention), none of any other kernel."""
    per = sampler_launches(cfg)
    names = ("mha_blhd", "int8_dense")
    return {"calib": {n: 3 * per["sample calib"][n] * int8 for n in names},
            "loop": {n: batches * (per["sample lang"][n]
                                   + steps * per["sample step"][n]) * int8
                     for n in names}}


def sampler_attention_cases(cfg, B, T, vis=64):
    """(batch, Lq, Lk, with_bias, dtype, fast, uses) of mha_blhd in the
    int8 sampler at batch B, text T, `vis` grid cells (its calibration
    batch is B too): `uses` maps "sample calib", "sample lang" and
    "sample step" to the shape's launches in one of each."""
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    uses = {(T, T, True): {"sample calib": nl + nx, "sample lang": nl,
                           "sample step": nx - 1},
            (vis, vis, False): {"sample calib": nr + nx,
                                "sample step": nr + nx},
            (T, vis, False): {"sample calib": nx, "sample step": nx - 1},
            (vis, T, True): {"sample calib": nx, "sample step": nx}}
    for (lq, lk, bias), u in uses.items():
        yield B, lq, lk, bias, "bfloat16", True, {
            k: n for k, n in u.items() if n}


def sampler_dense_cases(cfg, B, T, n_clusters, vis=64):
    """(M, K, N, static, uses) of the int8 dense in the int8 sampler
    (`vis` grid cells): calibration forwards run the dynamic mode, the
    language stack and the decode steps the static one."""
    Hd, I, Fv = cfg.hidden_size, cfg.intermediate_size, cfg.visual_feat_dim
    nl, nr, nx = cfg.l_layers, cfg.r_layers, cfg.x_layers
    layer = {(Hd, 3 * Hd): 1, (Hd, Hd): 1, (Hd, I): 1, (I, Hd): 1}
    head = {(Hd, Hd): 1, (Hd, Fv): 1, (Fv, n_clusters): 1}
    # one side of a cross layer: the kv of its hidden states (which the
    # other side attends to), the q and out of its attention, its
    # self-attention (qkv, out) and its FFN
    cross = {(Hd, 2 * Hd): 1, (Hd, 3 * Hd): 1, (Hd, Hd): 3, (Hd, I): 1,
             (I, Hd): 1}

    def times(group, n):
        return {k: n * v for k, v in group.items()}

    groups = [  # (kind, M, {(K, N): launches})
        ("sample calib", B * T, times(layer, nl)),
        ("sample calib", B * vis, {(Fv, Hd): 1, **times(layer, nr)}),
        ("sample calib", B * T, times(cross, nx)),
        ("sample calib", B * vis, times(cross, nx)),
        ("sample calib", B * vis, head),
        ("sample lang", B * T, times(layer, nl)),
        ("sample step", B * vis, {(Fv, Hd): 1, **times(layer, nr)}),
        # the last cross layer: of the language side only its kv, which
        # the visual side's attention reads; the visual side's kv unread
        ("sample step", B * T, times(cross, nx - 1)),
        ("sample step", B * T, {(Hd, 2 * Hd): 1}),
        ("sample step", B * vis, times(cross, nx - 1)),
        ("sample step", B * vis, {k: n for k, n in cross.items()
                                  if k != (Hd, 2 * Hd)}),
        ("sample step", B * vis, head)]
    shapes = {}
    for kind, M, group in groups:
        for (K, N), n in group.items():
            if n:
                uses = shapes.setdefault((M, K, N, kind != "sample calib"),
                                         {})
                uses[kind] = uses.get(kind, 0) + n
    for (M, K, N, static), uses in shapes.items():
        yield M, K, N, static, uses


def sampler_cases_cover_launches(name, rows, cfg) -> dict:
    """{kind: launches the kernel phase covers} of the sampler's kinds;
    fails unless they are sampler_launches'."""
    got = {}
    for kind, want in sampler_launches(cfg).items():
        got[kind] = sum(r["uses"].get(kind, 0) for r in rows)
        if got[kind] != want[name]:
            fail(f"{name}: the kernel phase covers {got[kind]} launches of "
                 f"a {kind}, the sampler makes {want[name]}")
    return got


def tie_aware_agreement(card, host) -> float:
    """Share of cells whose card argmax is one of the host's tied maxima
    (logits (..., C) on the CPU)."""
    pick = card.float().argmax(-1, keepdim=True)
    host = host.float()
    return float((host.gather(-1, pick)[..., 0] == host.amax(-1))
                 .float().mean())


class StepRecorder:
    """The samplers' on_step hook: per batch, each step's (vis_mask,
    argmax of the logits) left on the device; and for the first batch's
    first `check` rows the step's inputs and logits on the CPU."""

    def __init__(self, check: int = 0):
        self.check, self.batches, self.inputs = check, [], []

    def __call__(self, i, inputs, logits):
        if i == 0:
            self.batches.append([])
        self.batches[-1].append((inputs["vis_mask"].clone(),
                                 logits.argmax(-1)))
        if self.check and len(self.batches) == 1:
            c = self.check
            self.inputs.append(({k: v[:c].cpu() for k, v in inputs.items()},
                                logits[:c].float().cpu()))


def check_sample_semantics(torch, rec, res, table, mode, strategy, n_steps,
                           B, n_cells, n_clusters) -> int:
    """From the card's own steps: NAR masks the schedule's count of cells
    each step (all at step 0) and commits exactly the masked cells; AR
    commits one cell a step, each cell once (TLBR in order); the final
    ids are those commits and the codes their centroids. Fails
    otherwise. Returns the number of batches checked."""
    ids = torch.from_numpy(res["ids"])
    if not ((ids >= 0) & (ids < n_clusters)).all():
        fail(f"{mode}: cluster ids outside [0, {n_clusters})")
    if not torch.equal(res["codes"].cpu(),
                       table[ids].to(res["codes"].dtype)):
        fail(f"{mode}: the final codes are not their ids' centroids")
    for b, steps in enumerate(rec.batches):
        if len(steps) != n_steps:
            fail(f"{mode}: batch {b} ran {len(steps)} steps, not {n_steps}")
        sim = torch.zeros(B, n_cells, dtype=torch.long)
        seen = torch.zeros(B, n_cells, dtype=torch.long)
        for i, (vm, pred) in enumerate(steps):
            vm, pred = vm.cpu(), pred.cpu()
            if mode == "NAR":
                upd = vm
                want = ((n_steps - i) * n_cells) // n_steps
                if not (vm.sum(-1) == want).all():
                    fail(f"NAR step {i} masked {vm.sum(-1).tolist()} "
                         f"cells, not {want}")
            else:
                upd = vm if i + 1 == n_steps else vm & ~steps[i + 1][0].cpu()
                if not (upd.sum(-1) == 1).all():
                    fail(f"AR step {i} committed {upd.sum(-1).tolist()} "
                         "cells, not 1")
                if strategy == "TLBR" and not upd[:, i % n_cells].all():
                    fail(f"AR TLBR step {i} did not commit cell {i}")
            sim = torch.where(upd, pred, sim)
            seen += upd.long()
        if mode == "AR" and not (seen == 1).all():
            fail(f"AR batch {b}: a cell was committed {int(seen.max())} "
                 f"or {int(seen.min())} times, not once")
        rows = ids[b * B:(b + 1) * B]
        if not torch.equal(sim[:len(rows)], rows):
            fail(f"{mode} batch {b}: the final ids are not the steps' "
                 "commits")
    return len(rec.batches)


def int8_step_units(sp, ids, mask, pos, n_heads):
    """The int8 sampler's decode step, with the language stack it reads,
    as units on (lang, visn) states: the language stack, the visual
    embeddings, each visual layer, each cross layer (the last without its
    language side) and the cluster head (visn -> logits). [(name, fn)],
    fn(state) -> state; the first state is (None, the step's feats)."""
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving import sampling_int8 as si

    qp = sp.bert
    lang_bias = engine._extend_mask(mask)
    units = [("language stack", lambda s: (engine.lang_encode(
        qp, ids, mask, n_heads)[0], s[1])),
             ("visual embeddings", lambda s: (s[0], engine.visual_embeddings(
                 qp.visn_fc, s[1], pos)))]
    for i, layer in enumerate(qp.visn_layers):
        units.append((f"visual layer {i}", lambda s, layer=layer: (
            s[0], layer(s[1], None, n_heads))))
    last = len(qp.x_layers) - 1
    for j, p in enumerate(qp.x_layers):
        units.append((f"cross layer {j}", lambda s, p=p, j=j: si.cross_layer(
            p, s[0], s[1], lang_bias, None, n_heads, j < last)))
    units.append(("cluster head", lambda s: (
        s[0], si.obj_head_forward(sp.obj_head, s[1]))))
    return units


def int8_units_card_vs_cpu(torch, card_sp, host_sp, ids, mask, feats, cfg,
                           sz):
    """Each unit of an int8 decode step (int8_step_units) on the CPU from
    the card's input to that unit, against the card's output: the
    cosine of what the unit changed, and for the cluster head the tie-
    aware argmax agreement. Returns [(name, cosine, agreement or None)]
    and the card's logits."""
    from xlxmert_tpu_torch.tasks import sampling

    def units(sp, dev):
        pos = sampling.grid_positions(sz["grid"], len(ids), dev,
                                      torch.bfloat16)
        return int8_step_units(sp, ids.to(dev), mask.to(dev), pos,
                               cfg.num_attention_heads)

    out = []
    dev = next(card_sp.buffers()).device
    state = (None, feats.to(dev))
    with torch.inference_mode():
        for (name, card), (_, host) in zip(units(card_sp, dev),
                                           units(host_sp, "cpu")):
            got = card(state)
            ref = host(tuple(None if t is None else t.cpu()
                             for t in state))
            changed = [k for k in (0, 1) if got[k] is not state[k]]
            a = torch.cat([got[k].float().cpu().ravel() for k in changed])
            b = torch.cat([ref[k].float().ravel() for k in changed])
            agree = (tie_aware_agreement(got[1].cpu(), ref[1])
                     if name == "cluster head" else None)
            out.append((name, cosine(a, b), agree))
            state = got
    return out, state[1].float().cpu()


def sample_card_vs_cpu(torch, rec, res, inputs, ids, mask, int8, cfg, sz,
                       log):
    """The recorded steps (the first `check` sentences of the first
    batch) through the same engine on the CPU (plain versions), teacher-
    forced. bf16: each step from the card's inputs to it, gated on the
    cluster logits' cosine and the tie-aware argmax agreement. int8: each
    unit of each step (int8_step_units) from the card's input to that
    unit, every unit's cosine and the cluster head's agreement gated; the
    whole step from the card's inputs to the step gated on the logits'
    cosine, its agreement reported (the int8 step is chaotic: one bf16
    step moved anywhere re-rolls its quantization noise, so its argmax
    agreement with another computation is that of two int8 noise
    draws). Then the whole NAR run on the CPU for those sentences, whose
    share of equal final ids is reported."""
    import copy

    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.tasks import sampling

    host = copy.deepcopy(res["engine"]).to("cpu")
    centroids = torch.from_numpy(inputs["centroids"])
    pos = sampling.grid_positions(sz["grid"], len(ids), "cpu",
                                  torch.bfloat16 if int8 else torch.float32)
    kind = "int8" if int8 else "bf16"
    steps = []
    with torch.inference_mode():
        for i, (step_in, card) in enumerate(rec.inputs):
            if int8:
                got = si._predict_forward(host, ids, step_in["feats"], pos,
                                          mask, cfg.num_attention_heads)
            else:
                got = host(ids, step_in["code"], pos, attention_mask=mask,
                           vis_mask=step_in["vis_mask"].float(),
                           centroids=centroids.to(host.dtype),
                           heads=("obj",))["obj_logits"]
            c, agree = cosine(card, got), tie_aware_agreement(card, got)
            row = {"cosine": c, "argmax_agree": agree}
            log(f"    step {i}: the whole step from the card's inputs: "
                f"logits cosine {c:.6f}, argmax agreement (ties counted) "
                f"{agree:.3f}" + (" (reported)" if int8 else ""))
            if not c > SAMPLE_COSINE or (not int8 and agree < SAMPLE_AGREE):
                fail(f"{kind} NAR step {i}: card vs CPU cosine {c} (> "
                     f"{SAMPLE_COSINE}) or argmax agreement {agree} (>= "
                     f"{SAMPLE_AGREE}) missed")
            if int8:
                units, chain = int8_units_card_vs_cpu(
                    torch, res["engine"], host, ids, mask,
                    step_in["feats"], cfg, sz)
                row["units"] = [{"unit": n, "cosine": uc,
                                 "argmax_agree": ua} for n, uc, ua in units]
                row["chain_equals_the_run"] = bool(torch.equal(chain, card))
                worst = min(units, key=lambda u: u[1])
                head = units[-1]
                log(f"      unit by unit from the card's input to each: "
                    f"smallest cosine {worst[1]:.6f} ({worst[0]}); cluster "
                    f"head cosine {head[1]:.6f}, argmax agreement (ties "
                    f"counted) {head[2]:.3f}")
                for name, uc, ua in units:
                    if not uc > SAMPLE_COSINE or (ua is not None
                                                  and ua < SAMPLE_AGREE):
                        fail(f"int8 NAR step {i}, {name}: card vs CPU "
                             f"cosine {uc} (> {SAMPLE_COSINE}) or argmax "
                             f"agreement {ua} (>= {SAMPLE_AGREE}) missed")
            steps.append(row)
        if int8:
            cpu = si.make_nar_sampler_int8(cfg, sz["nar_steps"], sz["grid"])(
                host, centroids, ids, mask)
        else:
            cpu = sampling.make_nar_sampler(host, sz["nar_steps"],
                                            sz["grid"])(centroids, ids, mask)
    same = float((cpu[1] == torch.from_numpy(res["ids"][:len(ids)]))
                 .float().mean())
    log(f"    the whole NAR run on the CPU, {len(ids)} sentences: final ids "
        f"equal to the card's on {same:.3f} of the cells (reported only)")
    return {"steps": steps, "trajectory_ids_equal": same}


def render_card_vs_cpu(torch, res, inputs, sz, n):
    """The card's first n final code grids rendered on the CPU in fp32
    against the card's bf16 render: mean |d| of the [0, 1] pixels and the
    cosine of the [-1, 1] images, gated."""
    from xlxmert_tpu_torch.models import gan

    params, sn, _ = inputs["generator"]
    host = gan.load_variables(gan.Generator(
        emb_dim=inputs["centroids"].shape[1], base_dim=sz["base_dim"],
        target_size=sz["target_size"], init_H=sz["grid"],
        init_W=sz["grid"], codebook_dim=sz["codebook_dim"]), params, sn)
    with torch.inference_mode():
        raw = host.eval()(res["codes"][:n].float().cpu())
    card = torch.from_numpy(res["images"][:n])
    mean_d = float((card - torch.clamp((raw + 1) / 2, 0, 1)).abs().mean())
    cos = cosine(card * 2 - 1, raw)
    if not (mean_d <= RENDER_MEAN_TOL and cos > RENDER_COSINE):
        fail(f"render: card bf16 vs CPU fp32 mean |d| {mean_d} (<= "
             f"{RENDER_MEAN_TOL}) or cosine {cos} (> {RENDER_COSINE}) "
             "missed")
    return {"mean_abs_diff": mean_d, "cosine": cos, "images": n}


def profile_sampler(torch, sample, n_steps, lang):
    """One sampler batch and its language stack alone (`lang`), each
    timed on the host clock (profiler off) and traced by torch.profiler:
    device time by group (mha_blhd's kernel, the int8 dense kernel, the
    rest: glue). A decode step is (batch - language stack) / n_steps; its
    busy share is its device time over its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def group(name):
        return ("mha_blhd" if "attend_mma_kernel" in name
                else "int8_dense" if "int8_dense_kernel" in name
                else "glue")

    def measure(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups = {"mha_blhd": 0.0, "int8_dense": 0.0, "glue": 0.0}
        n = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                groups[group(e.name)] += e.time_range.elapsed_us() / 1e3
                n += 1
        if not n:
            fail("the sampler's trace holds no device time")
        return wall, groups

    wall, groups = measure(sample)
    lang_wall, lang_groups = measure(lang)
    step = {k: (groups[k] - lang_groups[k]) / n_steps for k in groups}
    step_wall = (wall - lang_wall) / n_steps
    return {"batch_wall_ms": wall, "batch_device_ms": groups,
            "lang_wall_ms": lang_wall, "lang_device_ms": lang_groups,
            "step_wall_ms": step_wall, "step_device_ms": step,
            "step_busy_share": sum(step.values()) / step_wall}


def write_sample_files(cfg, sz, seed, sentences, words, tmp):
    """The CLI's inputs as files in `tmp`, made from `seed`: the random
    X-LXMERT and generator as JAX-format msgpack checkpoints, the
    centroids (randn x 0.1, bench.py's) as .npy, the vocabulary, the
    sentences and the model config. Returns the CLI's arguments."""
    import numpy as np

    from xlxmert_tpu_torch.core.checkpoint import save_pytree
    from xlxmert_tpu_torch.models import gan
    from xlxmert_tpu_torch.tasks import sampling

    f = {n: os.path.join(tmp, n) for n in (
        "x.msgpack", "centroids.npy", "g.msgpack", "vocab.txt",
        "sentences.txt", "model.yaml")}
    save_pytree(sampling.random_params(cfg, seed), f["x.msgpack"])
    np.save(f["centroids.npy"], np.random.RandomState(seed).randn(
        sz["clusters"], cfg.visual_feat_dim).astype(np.float32) * 0.1)
    save_pytree(gan.random_variables(
        cfg.visual_feat_dim, sz["base_dim"], sz["target_size"], sz["grid"],
        sz["codebook_dim"], seed), f["g.msgpack"])
    with open(f["vocab.txt"], "w") as fh:
        fh.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                           + words) + "\n")
    with open(f["sentences.txt"], "w") as fh:
        fh.write("\n".join(sentences) + "\n")
    cfg.save(f["model.yaml"])
    return ["--load", f["x.msgpack"], "--centroids", f["centroids.npy"],
            "--generator", f["g.msgpack"], "--vocab", f["vocab.txt"],
            "--sentences", f["sentences.txt"],
            "--model_config", f["model.yaml"],
            "--batch_size", str(sz["batch"]),
            "--max_text_length", str(sz["text"]),
            "--grid_size", str(sz["grid"]),
            "--sample_steps", str(sz["nar_steps"]),
            "--target_size", str(sz["target_size"]),
            "--g_base_dim", str(sz["base_dim"]),
            "--codebook_dim", str(sz["codebook_dim"])]


def run_sample_path(torch, args, kernels, log, cfg=None, device="cuda",
                    sizes=None, card=""):
    """Phase (j): cli/sample_images.sample_images() over JAX-format files
    made from --seed (write_sample_files; the model at `cfg`, default
    LxmertConfig()) in each of SAMPLE_RUNS, with the launches checked
    exactly, the NAR/AR semantics checked from the card's own steps,
    SAMPLE_CHECKED's steps held to the CPU teacher-forced, the render held
    to an fp32 render on the CPU, and the int8 NAR and AR batches
    profiled (on the card). `sizes` overrides SAMPLE_SIZES (the CPU test
    runs a small one); `card` (nvidia-smi's name and power limit) goes
    beside every number logged. Returns its numbers."""
    import numpy as np

    from xlxmert_tpu_torch.cli import sample_images as cli
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.models.gan import render
    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.serving.lxmert_int8 import lang_encode

    sz = dict(SAMPLE_SIZES, **(sizes or {}))
    cfg = (cfg or LxmertConfig()).replace(num_clusters=sz["clusters"])
    B, T, n_cells = sz["batch"], sz["text"], sz["grid"] ** 2
    rng = np.random.RandomState(args.seed)
    words = [f"w{i}" for i in range(4000)]
    sentences = [" ".join(rng.choice(words, rng.randint(1, T - 1)))
                 for _ in range(sz["batches"] * B)]
    out = {"runs": {}, "launches": {k.name: 0 for k in kernels}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        common = write_sample_files(cfg, sz, args.seed, sentences, words,
                                    tmp) + ["--device", device]
        inputs = cli.load_inputs(cli.parse_args(common))
        log(f"  files written and read back in {time.time() - t0:.1f}s "
            f"({len(sentences)} sentences, {sz['clusters']} x "
            f"{cfg.visual_feat_dim} centroids)")
        tok, check = inputs["tokenizer"], sz["check"]
        ids_c = torch.from_numpy(tok.encode_batch(sentences[:check], T)
                                 .astype(np.int64))
        mask_c = (ids_c > 0).float()
        exact = None
        for name, flags in SAMPLE_RUNS.items():
            ns = cli.parse_args(common + flags + ["--output",
                                                  os.path.join(tmp, name)])
            rec = StepRecorder(check if name in SAMPLE_CHECKED else 0)
            calib = {}

            def ready():
                # calibration's launches apart from the decode loops'
                calib.update((k.name, k.launches) for k in kernels)
                for k in kernels:
                    k.launches = 0
                if device == "cuda":
                    torch.cuda.reset_peak_memory_stats()

            for k in kernels:
                k.launches = 0
            t0 = time.time()
            res = cli.sample_images(ns, inputs, on_ready=ready, on_step=rec)
            wall = time.time() - t0
            launches = {k.name: k.launches for k in kernels}
            n_steps = sz["nar_steps"] if ns.sample_mode == "NAR" else n_cells
            want = expected_sample_launches(cfg, ns.int8, sz["batches"],
                                            n_steps)
            for part, got in (("calib", calib), ("loop", launches)):
                for k, n in got.items():
                    out["launches"][k] += n
                    if n != want[part].get(k, 0):
                        fail(f"{name}: {k} launched {n} times in the "
                             f"{part}, expected {want[part].get(k, 0)} "
                             f"({sz['batches']} batches of {n_steps} "
                             "steps)")
            table = torch.from_numpy(inputs["centroids"])
            check_sample_semantics(
                torch, rec, res, table.to(torch.bfloat16) if ns.int8
                else table, ns.sample_mode, ns.position_strategy, n_steps, B,
                n_cells, sz["clusters"])
            steady = slice(1, None) if sz["batches"] > 1 else slice(None)
            n_b = len(res["sample_s"][steady])
            samp = sum(res["sample_s"][steady])
            rend = sum(res["render_s"][steady])
            row = {"flags": flags, "calib_launches": calib,
                   "launches": launches, "steps": n_steps,
                   "batches": len(res["sample_s"]), "wall_s": wall,
                   "sample_s": res["sample_s"], "render_s": res["render_s"],
                   "sampling_samples_per_s": B * n_b / samp,
                   "samples_per_s": B * n_b / (samp + rend),
                   "render_ms_per_batch": rend * 1e3 / n_b,
                   "step_wall_ms": samp * 1e3 / (n_b * n_steps),
                   "peak_bytes": (torch.cuda.max_memory_allocated()
                                  if device == "cuda" else 0)}
            log(f"  {name}: {row['samples_per_s']:.1f} samples/s with the "
                f"render ({row['sampling_samples_per_s']:.1f} sampling "
                f"only, {row['step_wall_ms']:.2f} ms a step), render "
                f"{row['render_ms_per_batch']:.2f} ms a batch of {B}; "
                "launches in the loops " + (", ".join(
                    f"{k} {v}" for k, v in launches.items() if v) or "none")
                + f"; peak {row['peak_bytes'] / 2**30:.2f} GiB ({card})")
            if name in SAMPLE_CHECKED:
                log(f"  {name}: card vs CPU, teacher-forced, {check} "
                    "sentences:")
                row["card_vs_cpu"] = sample_card_vs_cpu(
                    torch, rec, res, inputs, ids_c, mask_c, ns.int8, cfg,
                    sz, log)
            if name == "NAR int8":
                row["render_card_vs_cpu"] = r = render_card_vs_cpu(
                    torch, res, inputs, sz, check)
                log(f"  render: card bf16 vs CPU fp32 mean |d| "
                    f"{r['mean_abs_diff']:.2e}, cosine {r['cosine']:.6f}")
                log(f"  bench Config #2 (NAR 4 int8 + exact 256-px render, "
                    f"B={B}): {row['samples_per_s']:.1f} samples/s, render "
                    f"{row['render_ms_per_batch']:.2f} ms a batch ({card})")
                exact = res
            if name == "NAR int8 fast_render" and exact is not None:
                # the exact run's codes through the capped render
                fast = render(res["generator"], exact["codes"][:B])
                row["fast_vs_exact_mean_abs_diff"] = float(
                    (fast.float().cpu() - torch.from_numpy(
                        exact["images"][:B])).abs().mean())
                log("  fast_render vs exact, the same codes: mean |d| "
                    f"{row['fast_vs_exact_mean_abs_diff']:.2e} (reported)")
                exact = None
            if name in ("NAR int8", "AR int8") and device == "cuda":
                sp = res["engine"]
                ids = torch.from_numpy(tok.encode_batch(sentences[:B], T)
                                       .astype(np.int64)).to(device)
                mask = (ids > 0).float()
                centroids = torch.from_numpy(inputs["centroids"]).to(device)
                sampler = (si.make_nar_sampler_int8(cfg, n_steps, sz["grid"])
                           if ns.sample_mode == "NAR" else
                           si.make_ar_sampler_int8(cfg, sz["grid"]))

                def lang():
                    with torch.inference_mode():
                        lang_encode(sp.bert, ids, mask,
                                    cfg.num_attention_heads)

                row["profile"] = p = profile_sampler(
                    torch, lambda: sampler(sp, centroids, ids, mask),
                    n_steps, lang)
                log(f"  {name}, one decode step ((batch - language stack) "
                    f"/ {n_steps}, profiled): host wall "
                    f"{p['step_wall_ms']:.3f} ms, card busy "
                    f"{p['step_busy_share']:.2f}; device "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                p["step_device_ms"].items()) + f" ({card})")
            out["runs"][name] = row
            del res, rec
            if device == "cuda":
                torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# (k) GAN training
# ---------------------------------------------------------------------------

# bench.py measure_gan's widths: G base 32, D base 64, codebook 256, an
# 8x8 grid of 2,048-d codes, 256 px, 10,000 centroids, B=32, bf16; the
# CLI's in-memory loop runs `pairs` (D, G) pairs, chained_gd_step
# `chain`; the card-vs-CPU steps run in fp32 at batch `check`
GAN_SIZES = dict(batch=32, target=256, grid=8, emb=2048, classes=10000,
                 g_base=32, d_base=64, codebook=256, pairs=3, chain=4,
                 check=2)
# fp32 card vs CPU, one D-step and one G-step from one state and batch:
# (largest relative difference of a loss component, smallest cosine of
# the gradient (Adam's first moment: b1 = 0), the noise scales left out)
GAN_STEP_BARS = (1e-4, 0.9999)
GAN_SN_TOL = 1e-5      # u, v written back: of the CPU's largest |value|


def gan_inputs(sz, seed):
    """measure_gan's batch: centroids randn x 0.2, random cluster ids,
    their codes, images uniform in [-1, 1] (numpy, from `seed`)."""
    import numpy as np

    r = np.random.RandomState(seed)
    centroids = (r.randn(sz["classes"], sz["emb"]) * 0.2).astype(np.float32)
    ids = r.randint(0, sz["classes"], (sz["batch"], sz["grid"] ** 2)
                    ).astype(np.int32)
    codes = centroids[ids].reshape(sz["batch"], sz["grid"], sz["grid"],
                                   sz["emb"])
    images = (r.rand(sz["batch"], sz["target"], sz["target"], 3)
              * 2.0 - 1.0).astype(np.float32)
    return {"image": images, "code": codes, "cluster_id": ids}, centroids


def gan_config(sz, seed, out_dir, fp32=False):
    """The GanConfig cli/train_generator builds from its flags at
    `sz`'s widths (its data flags unused: the loop runs in memory)."""
    from xlxmert_tpu_torch.cli import train_generator as cli

    ns = cli.parse_args([
        "--images_dir", out_dir, "--centroids", "-", "--cluster_pkl", "-",
        "--output", out_dir, "--epochs", "1",
        "--batch_size", str(sz["batch"]), "--g_base_dim", str(sz["g_base"]),
        "--d_base_dim", str(sz["d_base"]),
        "--codebook_dim", str(sz["codebook"]), "--emb_dim", str(sz["emb"]),
        "--n_grid", str(sz["grid"]), "--resize_target_size",
        str(sz["target"]), "--seed", str(seed)] + (["--fp32"] if fp32
                                                   else []))
    return cli.gan_config(ns, sz["classes"])


def max_rel_diff(got, ref) -> float:
    """The largest |got - ref| / max |ref| over the leaves of two nested
    dicts of numpy arrays."""
    import numpy as np

    if isinstance(ref, dict):
        return max((max_rel_diff(got[k], v) for k, v in ref.items()),
                   default=0.0)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def gan_steps_card_vs_cpu(torch, cfg, batch, centroids, seed, device, log):
    """One D-step and one G-step in fp32 (TF32 off) on `device` and on
    the CPU from the same fresh state and batch: each loss component's
    relative difference, the gradient's cosine (Adam's mu; the noise
    scales, whose gradients come from each device's own draw, left out)
    and the u, v each step writes back, gated (GAN_STEP_BARS,
    GAN_SN_TOL)."""
    from xlxmert_tpu_torch.models.gan import variables_of
    from xlxmert_tpu_torch.tasks.train_generator import GanEngine

    with tf32_off(torch):
        runs = {}
        for where in (device, "cpu"):
            eng = GanEngine(cfg, device=where)
            state = eng.create_state(seed, centroids)
            b = eng.place(batch)
            table = torch.from_numpy(centroids).to(where)
            t0 = time.time()
            state, dm = eng.d_step(state, b, table)
            sn_d = variables_of(state.D)["sn"]
            state, gm = eng.g_step(state, b, table)
            runs[where] = {
                "metrics": {k: float(v) for k, v in {**dm, **gm}.items()},
                "mu": {side: {n: t.detach().cpu().double()
                              for n, t in opt.mu.items()
                              if ".noise" not in n}
                       for side, opt in (("d", state.opt_d),
                                         ("g", state.opt_g))},
                "sn": {"d": sn_d, "g": variables_of(state.G)["sn"]},
                "s": time.time() - t0}
            del eng, state
    card, host = runs[device], runs["cpu"]
    loss_bar, cos_bar = GAN_STEP_BARS
    out = {"loss_rel_diff": {}, "grad_cosine": {}, "sn_rel_diff": {},
           "cpu_s": host["s"]}
    for k, r in host["metrics"].items():
        d = abs(card["metrics"][k] - r) / max(abs(r), 1e-12)
        out["loss_rel_diff"][k] = d
        if not (math.isfinite(card["metrics"][k]) and d <= loss_bar):
            fail(f"GAN step card vs CPU: {k} {card['metrics'][k]} against "
                 f"{r} (relative difference {d} > {loss_bar})")
    for side in ("d", "g"):
        names = sorted(host["mu"][side])
        cos = cosine(torch.cat([card["mu"][side][n].ravel() for n in names]),
                     torch.cat([host["mu"][side][n].ravel() for n in names]))
        out["grad_cosine"][side] = cos
        if not cos > cos_bar:
            fail(f"GAN {side.upper()}-step card vs CPU: gradient cosine "
                 f"{cos} (bar {cos_bar})")
        worst = max_rel_diff(card["sn"][side], host["sn"][side])
        out["sn_rel_diff"][side] = worst
        if not worst <= GAN_SN_TOL:
            fail(f"GAN {side.upper()}-step card vs CPU: the u, v written "
                 f"back differ by {worst} relative (bar {GAN_SN_TOL})")
    log("  card vs CPU, fp32, one D-step and one G-step at B="
        f"{len(batch['image'])} (CPU {host['s']:.1f}s): losses within "
        f"{max(out['loss_rel_diff'].values()):.2e} relative, gradient "
        "cosine " + ", ".join(f"{k.upper()} {v:.7f}" for k, v in
                               out["grad_cosine"].items())
        + ", u/v within " + ", ".join(
            f"{k.upper()} {v:.1e}" for k, v in out["sn_rel_diff"].items())
        + " relative")
    return out


def profile_groups(torch, fn, groups) -> dict:
    """fn timed once on the host clock (profiler off), then traced by
    torch.profiler: its device time, the busy share (device over wall),
    the device time of each group ({name: substring of an op's or an
    ancestor's name}, the first that matches), the rest as "glue", and
    the glue's largest ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, by, other = 0.0, {g: 0.0 for g in groups}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total += e.time_range.elapsed_us() / 1e3
            continue
        own = getattr(e, "self_device_time_total", 0) / 1e3
        # the profiler's own record around a copy it also gives aten::copy_
        if not own or e.name == "Activity Buffer Request":
            continue
        names, p = [e.name], e.cpu_parent
        while p is not None:
            names.append(p.name)
            p = p.cpu_parent
        group = next((g for g, pat in groups.items()
                      if any(pat in n for n in names)), None)
        if group is None:
            other[e.name] = other.get(e.name, 0.0) + own
        else:
            by[group] += own
    if not total:
        fail("a profiled run holds no device time")
    by["glue"] = total - sum(by.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "device_ms": total, "busy_share": total / wall,
            "device_ms_by_group": by, "glue_top_ops_ms": dict(top)}


def conv_flops(torch, fn) -> float:
    """The floating-point operations of fn's convolutions, forward and
    backward, counted from their shapes by torch.utils.flop_counter
    (aten.convolution and aten.convolution_backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return float(sum(v for k, v in fc.get_flop_counts()["Global"].items()
                     if str(k) in ("aten.convolution",
                                   "aten.convolution_backward")))


def run_gan_path(torch, args, kernels, log, device="cuda", sizes=None,
                 card=""):
    """Phase (k): GAN training at measure_gan's widths through
    cli/train_generator's in-memory loop (`train`) for `pairs` (D, G)
    pairs, every loss finite, G_0.msgpack written and rendered through
    models/gan.render; chained_gd_step(`chain`) timed as measure_gan
    times it ((D, G) pairs/s, images/s); a D-step's and a G-step's time,
    the convolutions' FLOPs in a pair (conv_flops), the peak
    memory and (on the card) a profiled pair's busy share, device time
    by group and the convolutions' rate; one fp32 D-step and G-step held to the CPU's
    (gan_steps_card_vs_cpu). No kernel of the port lies on this path:
    every launch count must stay 0. `sizes` overrides GAN_SIZES (the CPU
    test runs a small one). Returns its numbers."""
    import numpy as np

    from xlxmert_tpu_torch.cli import sample_images
    from xlxmert_tpu_torch.cli import train_generator as cli
    from xlxmert_tpu_torch.core.checkpoint import load_pytree
    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.models.gan import Generator, load_variables, render
    from xlxmert_tpu_torch.tasks.train_generator import GanEngine

    sz = dict(GAN_SIZES, **(sizes or {}))
    B = sz["batch"]
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    batch, centroids = gan_inputs(sz, args.seed)
    out = {"sizes": sz}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = gan_config(sz, args.seed, tmp)
        eng = GanEngine(cfg, device=device)
        state = eng.create_state(cfg.seed, centroids)
        logger = RunLogger(tmp, cfg, use_tensorboard=False)
        losses = []

        def on_pair(step, dm, gm):
            losses.append({k: float(v) for k, v in {**dm, **gm}.items()})

        for k in kernels:
            k.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            res = cli.train(eng, state, centroids,
                            lambda epoch: (batch for _ in range(sz["pairs"])),
                            logger, log_step=1, on_pair=on_pair)
        finally:
            logger.close()
        sync()
        out["loop_s"] = time.time() - t0
        out["launches"] = {k.name: k.launches for k in kernels}
        check_launches("gan", out["launches"], res["pairs"])
        bad = [(i, k, v) for i, m in enumerate(losses) for k, v in m.items()
               if not math.isfinite(v)]
        if len(losses) != sz["pairs"] or bad:
            fail(f"GAN training: {len(losses)} pairs, non-finite losses "
                 f"{bad}")
        out["losses"] = losses
        log(f"  cli/train_generator.train: {res['pairs']} (D, G) pairs in "
            f"{out['loop_s']:.1f}s (first pair included), every loss "
            f"finite; last pair: D {losses[-1]['d_total']:.4f}, G "
            f"{losses[-1]['g_total']:.4f}; launches of the port's kernels: "
            "none")
        # the epoch's generator checkpoint renders through models/gan
        tree = load_pytree(os.path.join(tmp, "G_0.msgpack"))
        params, sn, stats = sample_images.split_generator_ckpt(tree)
        gen = load_variables(Generator(
            emb_dim=sz["emb"], base_dim=sz["g_base"], target_size=sz["target"],
            init_H=sz["grid"], init_W=sz["grid"], codebook_dim=sz["codebook"],
            dtype=eng.dtype), params, sn, stats or None).to(device)
        img = render(gen, torch.from_numpy(batch["code"][:2]).to(device))
        if not (img.shape == (2, sz["target"], sz["target"], 3)
                and bool(torch.isfinite(img).all())
                and 0 <= float(img.min()) <= float(img.max()) <= 1):
            fail("G_0.msgpack does not render to finite [0, 1] images")
        out["g0_renders"] = True
        del gen

        placed = eng.place(batch)
        table = torch.from_numpy(centroids).to(device)
        fn = eng.chained_gd_step(sz["chain"])
        state, dl, gl = fn(state, placed, table)   # warm
        float(dl)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state, dl, gl = fn(state, placed, table)
            float(dl)
            best = min(best, time.perf_counter() - t0)
        if not (math.isfinite(float(dl)) and math.isfinite(float(gl))):
            fail(f"chained_gd_step: losses {float(dl)}, {float(gl)}")
        out["chain_s"] = best
        out["pairs_per_s"] = sz["chain"] / best
        out["images_per_s"] = B * sz["chain"] / best
        steps = {}
        for name, step in (("d_step", eng.d_step), ("g_step", eng.g_step)):
            times = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                step(state, placed, table)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            steps[name] = sorted(times)[1]
        out["step_ms"] = steps
        out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        log(f"  chained_gd_step({sz['chain']}), B={B}: "
            f"{out['pairs_per_s']:.2f} (D, G) pairs/s, "
            f"{out['images_per_s']:.1f} images/s; D-step "
            f"{steps['d_step']:.2f} ms, G-step {steps['g_step']:.2f} ms "
            f"(host clock, median of 3); peak "
            f"{out['peak_bytes'] / 2**30:.2f} GiB ({card})")

        def pair():
            eng.d_step(state, placed, table)
            eng.g_step(state, placed, table)

        out["conv_flop_per_pair"] = flop = conv_flops(torch, pair)
        if not flop > 0:
            fail("no convolution counted in a GAN pair")
        if cuda:
            pair()
            out["profile"] = p = profile_groups(
                torch, pair, {"acgan_product": "acgan_product",
                              "convolutions": "conv"})
            conv_ms = p["device_ms_by_group"]["convolutions"]
            p["conv_tflop_per_s"] = flop / conv_ms / 1e9
            log(f"  one pair profiled: wall {p['wall_ms']:.2f} ms, device "
                f"{p['device_ms']:.2f} ms, busy {p['busy_share']:.2f}; "
                + ", ".join(f"{k} {v:.2f} ms" for k, v in
                            p["device_ms_by_group"].items()) + f" ({card})")
            log(f"  the pair's convolutions: {flop / 1e12:.4f} TFLOP "
                "(torch.utils.flop_counter, from their shapes) in "
                f"{conv_ms:.2f} ms of device time, "
                f"{p['conv_tflop_per_s']:.1f} TFLOP/s ({card})")
            log("  the glue's largest ops (device ms): " + ", ".join(
                f"{k} {v:.2f}" for k, v in p["glue_top_ops_ms"].items()))
        del eng, state, placed, table, fn
        if cuda:
            torch.cuda.empty_cache()
    check = dict(sz, batch=sz["check"])
    cb, cc = gan_inputs(check, args.seed + 1)
    out["card_vs_cpu"] = gan_steps_card_vs_cpu(
        torch, gan_config(check, args.seed, ".", fp32=True), cb, cc,
        args.seed, device, log)
    return out


# ---------------------------------------------------------------------------
# (l) the offline feature factory
# ---------------------------------------------------------------------------

# bench.py measure_factory's widths: one Lloyd iteration at N=131,072,
# K=10,000, D=2,048 (tiles of 65,536 rows); X-152-32x8d-FPN grid
# extraction at 800x1344 (images of 800x1333), B=8. The bbox path at the
# CLI's B=4, 1,000 proposals, 1,601 classes, 36 features. The card-vs-CPU
# checks: one Lloyd step at N=8,192, K=512; one image on a 256x384
# canvas; ROIAlign and fc6 at the grid canvas, from the card's FPN of one
# image, over grid boxes of LEVEL_GRIDS (P2..P5). `config` overrides
# DetectronConfig's fields (the CPU test's tiny one)
FACTORY_SIZES = dict(rows=131072, clusters=10000, dim=2048, chunk=65536,
                     check_rows=8192, check_clusters=512, grid_batch=8,
                     canvas=(800, 1344), image=(800, 1333), grid=8,
                     timed=3, check_canvas=(256, 384), bbox_batch=4,
                     proposals=1000, classes=1601, num_features=36,
                     config=None)
KMEANS_AGREE = 0.999   # share of ids equal, card against CPU
KMEANS_TOL = 1e-5      # distances, centroids, inertia (see kmeans_agreement)
GRID_COSINE = 0.99999  # fp32 features (and RPN outputs), card against CPU
GRID_MAX_REL = 1e-3    # max |d| over the CPU's max |value|
# bf16 grid features against fp32 on the card: 0.999960 and 1.13e-2
# measured at measure_factory's widths (H100, chip_smoke (l)); the bars
# leave 2.5x and 2.8x of that
BF16_COSINE = 0.9999
BF16_MAX_REL = 2.0 ** -5
# grid sizes whose boxes over an 800x1333 image fall on P2, P3 (the
# extractor's 8x8), P4, P5 and P5
LEVEL_GRIDS = (16, 8, 4, 2, 1)


def kmeans_agreement(x, c0, card, host, tol=KMEANS_TOL,
                     agree_bar=KMEANS_AGREE) -> dict:
    """One Lloyd step from centroids c0 on two devices, `card` and
    `host` each {"ids", "centroids", "inertia"} (numpy), held to the
    bars: at least agree_bar of the ids equal; on every row that differs
    the two chosen centroids' distances (float64, from c0) within tol *
    (|x|^2 + |c|^2); the centroids of clusters whose members agree
    within tol * max |x|; the inertia within tol relative. Returns the
    numbers and "failures", the bars missed."""
    import numpy as np

    x = np.asarray(x, np.float64)
    c0 = np.asarray(c0, np.float64)
    ia, ib = np.asarray(card["ids"]), np.asarray(host["ids"])
    diff = np.nonzero(ia != ib)[0]
    ca, cb = c0[ia[diff]], c0[ib[diff]]
    da = ((x[diff] - ca) ** 2).sum(axis=1)
    db = ((x[diff] - cb) ** 2).sum(axis=1)
    scale = (x[diff] ** 2).sum(axis=1) + np.maximum(
        (ca ** 2).sum(axis=1), (cb ** 2).sum(axis=1))
    dist_excess = float((np.abs(da - db) - tol * scale).max()) \
        if len(diff) else 0.0
    clean = np.ones(len(c0), bool)
    clean[ia[diff]] = False
    clean[ib[diff]] = False
    cent_err = float(np.abs(np.asarray(card["centroids"], np.float64)[clean]
                            - np.asarray(host["centroids"], np.float64)[clean]
                            ).max(initial=0.0))
    cent_bar = tol * float(np.abs(x).max())
    inertia_rel = abs(float(card["inertia"]) - float(host["inertia"])) / \
        max(abs(float(host["inertia"])), 1e-30)
    out = {"agree": float((ia == ib).mean()), "differing_rows": len(diff),
           "distance_excess": dist_excess, "clean_clusters":
           int(clean.sum()), "centroid_max_err": cent_err,
           "centroid_bar": cent_bar, "inertia_rel_diff": inertia_rel}
    out["failures"] = [msg for ok, msg in (
        (out["agree"] >= agree_bar,
         f"{out['agree']:.5f} of the ids agree (bar {agree_bar})"),
        (dist_excess <= 0, "a differing row's two distances differ by "
         f"{dist_excess} more than {tol} (|x|^2 + |c|^2)"),
        (cent_err <= cent_bar, f"centroids differ by {cent_err} (bar "
         f"{cent_bar})"),
        (inertia_rel <= tol, f"inertia differs by {inertia_rel} relative"))
        if not ok]
    return out


def factory_images(B, canvas, image, seed):
    """A preprocessed batch (BGR minus the means): randn x 50 inside the
    valid (h, w), zeros in the canvas's padding; and the (B, 2) sizes
    (numpy, from `seed`)."""
    import numpy as np

    r = np.random.RandomState(seed)
    imgs = np.zeros((B, *canvas, 3), np.float32)
    imgs[:, :image[0], :image[1]] = r.standard_normal(
        (B, image[0], image[1], 3)).astype(np.float32) * 50
    return imgs, np.tile(np.asarray(image, np.int32), (B, 1))


def agreement(torch, got, ref) -> dict:
    """Cosine and max |d| / max |ref| of two tensors (or lists of them,
    flattened and concatenated)."""
    if isinstance(ref, (list, tuple)):
        got = torch.cat([t.detach().cpu().double().ravel() for t in got])
        ref = torch.cat([t.detach().cpu().double().ravel() for t in ref])
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return {"cosine": cosine(got, ref),
            "max_rel": float((got - ref).abs().max() / ref.abs().max())}


def gate_agreement(what, a, cos_bar=GRID_COSINE, rel_bar=GRID_MAX_REL,
                   against="card vs CPU") -> None:
    if not (a["cosine"] >= cos_bar and a["max_rel"] <= rel_bar):
        fail(f"{what}, {against}: cosine {a['cosine']:.7f} (bar "
             f"{cos_bar}), max |d| {a['max_rel']:.2e} of max |ref| "
             f"(bar {rel_bar})")


def run_kmeans_phase(torch, args, log, device, sz, card) -> dict:
    """k-means at sz's widths: the chunked Lloyd step timed (one warm-up,
    the best of 2: rows/s, its fp32 bound, the peak memory); kmeans(...,
    init="random", n_iter=2) and assign, as cli/run_kmeans calls them;
    one Lloyd step at the check's widths on the card and the CPU from
    the same centroids (kmeans_agreement)."""
    import numpy as np

    from xlxmert_tpu_torch.vocab import kmeans as km

    cuda = str(device).startswith("cuda")
    N, K, D, chunk = sz["rows"], sz["clusters"], sz["dim"], sz["chunk"]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn(N, D, generator=gen, device=device)
    pick = np.random.RandomState(args.seed).choice(N, K, replace=False)
    c0 = x[torch.from_numpy(pick).to(device)]
    w = torch.ones(N, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    new, inertia = km.lloyd_step_chunked(x, w, c0, K, chunk)   # warm-up
    float(inertia)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        new, inertia = km.lloyd_step_chunked(x, w, c0, K, chunk)
        float(inertia)
        times.append(time.perf_counter() - t0)
    best = min(times)
    ops = 2.0 * N * K * D
    out = {"step_s": times, "rows_per_s": N / best,
           "tflop_per_s": ops / best / 1e12,
           "bound": bound(4.0 * (N * D + 2 * K * D), ops, "float32"),
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if not (bool(torch.isfinite(new).all()) and math.isfinite(
            float(inertia))):
        fail("k-means: the Lloyd step gave non-finite centroids or inertia")
    log(f"  k-means Lloyd step, N={N}, K={K}, D={D}, tiles of {chunk}: "
        f"{best * 1e3:.1f} ms, {out['rows_per_s']:,.0f} rows/s, "
        f"{out['tflop_per_s']:.1f} TFLOP/s (2 N K D = {ops / 1e12:.2f} "
        f"TFLOP; the fp32 bound {out['bound']['bound_ms']:.1f} ms at "
        f"{PEAK_OPS_PER_S['float32'] / 1e12:.0f} TFLOP/s, "
        f"{out['bound']['bound_by']}); peak "
        f"{out['peak_bytes'] / 2**30:.2f} GiB ({card})")
    t0 = time.perf_counter()
    cents, final = km.kmeans(x, K, n_iter=2, seed=args.seed, init="random",
                             device=device)
    out["kmeans_s"] = time.perf_counter() - t0
    ids = km.assign(x, cents, device=device)
    if not (cents.shape == (K, D) and np.isfinite(cents).all()
            and np.array_equal(ids, final) and 0 <= ids.min()
            and ids.max() < K):
        fail("k-means: kmeans(n_iter=2) and assign disagree or give "
             "non-finite centroids")
    log(f"  kmeans(init='random', n_iter=2) with its final assign: "
        f"{out['kmeans_s']:.2f} s; assign gives its ids again; "
        f"{len(np.unique(final))} clusters used")
    del x, c0, w, new
    if cuda:
        torch.cuda.empty_cache()

    n, k = sz["check_rows"], sz["check_clusters"]
    x = torch.randn(n, D, generator=gen, device=device)
    c0 = x[torch.from_numpy(np.random.RandomState(args.seed + 1).choice(
        n, k, replace=False)).to(device)]
    runs = {}
    with tf32_off(torch):
        for where in (device, "cpu"):
            xs, cs = x.to(where), c0.to(where)
            ids, _ = km._assign_chunk(xs, cs)
            cent, inert = km.lloyd_step(xs, cs, k)
            runs[where] = {"ids": ids.cpu().numpy(),
                           "centroids": cent.cpu().numpy(),
                           "inertia": float(inert)}
    chk = kmeans_agreement(x.cpu().numpy(), c0.cpu().numpy(), runs[device],
                           runs["cpu"])
    out["card_vs_cpu"] = chk
    if chk["failures"]:
        fail("k-means card vs CPU: " + "; ".join(chk["failures"]))
    log(f"  k-means card vs CPU, one Lloyd step at N={n}, K={k}: ids "
        f"{chk['agree']:.5f} equal ({chk['differing_rows']} rows differ, "
        f"their distances within the bar), centroids of "
        f"{chk['clean_clusters']} clusters within "
        f"{chk['centroid_max_err']:.2e} (bar {chk['centroid_bar']:.2e}), "
        f"inertia within {chk['inertia_rel_diff']:.2e} relative")
    return out


def run_grid_phase(torch, args, log, device, sz, card, cfg) -> dict:
    """The grid extractor at sz's widths through
    cli/extract_features.extract_batch: bf16 and fp32, one warm-up and
    `timed` batches each (img/s, peak memory), the output (B, G*G,
    mlp_dim) and finite, bf16 held to fp32 (BF16_COSINE, BF16_MAX_REL);
    on the card each run's profiled batch (busy share, the convolutions'
    device time, their FLOPs and rate). Then card against CPU in fp32
    with TF32 off: the whole extractor on one image on the check's
    canvas; and ROIAlign (pool_levels) and fc6, both sides fed the
    card's FPN of the timed batch's first image and grid boxes of
    LEVEL_GRIDS, which must reach every level P2..P5."""
    import numpy as np

    from xlxmert_tpu_torch.cli import extract_features as ef
    from xlxmert_tpu_torch.models import detectron as det

    cuda = str(device).startswith("cuda")
    tree = det.random_params(cfg, args.seed)
    B, G = sz["grid_batch"], sz["grid"]

    def model_of(dtype, where=device):
        return det.load_params(det.DetectronGridExtractor(
            cfg, G, dtype=dtype), tree).to(where).eval()

    imgs, sizes = factory_images(B, sz["canvas"], sz["image"], args.seed)
    out, feats = {"runs": {}}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        model = model_of(dtype)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ef.extract_batch(model, imgs, sizes, device)    # warm-up
        t0 = time.perf_counter()
        for _ in range(sz["timed"]):
            f = ef.extract_batch(model, imgs, sizes, device)
        sec = (time.perf_counter() - t0) / sz["timed"]
        if not (f.shape == (B, G * G, cfg.mlp_dim) and np.isfinite(f).all()):
            fail(f"grid extraction {name}: features of shape {f.shape}, "
                 "or not finite")
        feats[name] = f
        run = {"batch_s": sec, "images_per_s": B / sec,
               "peak_bytes": torch.cuda.max_memory_allocated() if cuda
               else 0}
        out["runs"][name] = run
        log(f"  grid extraction {name}, B={B}, canvas {sz['canvas']}: "
            f"{sec * 1e3:.1f} ms a batch, {run['images_per_s']:.1f} img/s "
            f"(host arrays in, features out); peak "
            f"{run['peak_bytes'] / 2**30:.2f} GiB ({card})")
        if name == "fp32":
            out["bf16_vs_fp32"] = agreement(
                torch, torch.from_numpy(feats["bf16"]), torch.from_numpy(f))
        if cuda:
            if "conv_flop" not in out:
                out["conv_flop"] = conv_flops(torch, lambda: ef.extract_batch(
                    model, imgs, sizes, device))
            flop = out["conv_flop"]
            run["profile"] = p = profile_groups(
                torch, lambda: ef.extract_batch(model, imgs, sizes, device),
                {"convolutions": "conv"})
            conv_ms = p["device_ms_by_group"]["convolutions"]
            run["conv_tflop_per_s"] = flop / conv_ms / 1e9
            log(f"    profiled: wall {p['wall_ms']:.1f} ms, device "
                f"{p['device_ms']:.1f} ms, busy {p['busy_share']:.2f}; "
                f"convolutions {conv_ms:.1f} ms ({flop / 1e12:.2f} TFLOP "
                "counted from their shapes, "
                f"{run['conv_tflop_per_s']:.1f} TFLOP/s), glue "
                f"{p['device_ms_by_group']['glue']:.1f} ms: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in p["glue_top_ops_ms"].items()))
        del model
        if cuda:
            torch.cuda.empty_cache()
    a = out["bf16_vs_fp32"]
    gate_agreement("grid features bf16", a, BF16_COSINE, BF16_MAX_REL,
                   "against fp32")
    log(f"  bf16 features against fp32: cosine {a['cosine']:.6f} (bar "
        f"{BF16_COSINE}), max |d| {a['max_rel']:.2e} of max |fp32| (bar "
        f"{BF16_MAX_REL:.2e})")

    img, size1 = factory_images(1, sz["check_canvas"], sz["check_canvas"],
                                args.seed + 1)
    card_model = model_of(torch.float32)
    host = model_of(torch.float32, where="cpu")
    with tf32_off(torch):
        got = ef.extract_batch(card_model, img, size1, device)
        ref = ef.extract_batch(host, img, size1, "cpu")
        out["card_vs_cpu"] = a = agreement(torch, torch.from_numpy(got),
                                           torch.from_numpy(ref))
        gate_agreement("grid features (fp32, TF32 off)", a)
        log(f"  grid features card vs CPU, fp32 (TF32 off), one image on "
            f"{sz['check_canvas']}: cosine {a['cosine']:.7f}, max |d| "
            f"{a['max_rel']:.2e} of max |ref|")
        out["levels_card_vs_cpu"] = pool_levels_card_vs_cpu(
            torch, card_model, host, imgs[:1], sizes[:1], device, log)
    return out


def pool_levels_card_vs_cpu(torch, card_model, host, img, size, device,
                            log) -> dict:
    """ROIAlign and fc6 card against CPU on one image at the timed
    canvas: the card's FPN of `img` is pooled on both devices over the
    grid boxes of LEVEL_GRIDS (which must fall on every level P2..P5),
    then fc6 runs on both from the card's pooled values; each gated by
    gate_agreement."""
    from xlxmert_tpu_torch.models import detectron as det

    cfg = card_model.cfg
    h, w = (int(v) for v in size[0])
    rois = torch.cat([det.grid_boxes(h, w, g) for g in LEVEL_GRIDS])[None]
    levels = sorted(set(det.fpn_level_assignment(
        rois[0], cfg.canonical_scale, cfg.canonical_level).tolist()))
    if levels != [0, 1, 2, 3]:
        fail(f"the level check's rois over a {h}x{w} image fall on P"
             f"{[l + 2 for l in levels]}, not on every level P2..P5")
    with torch.inference_mode():
        fpn = card_model.backbone(torch.from_numpy(img).to(device))[:4]
        pool = (cfg.pooler_resolution, cfg.sampling_ratio,
                cfg.canonical_scale, cfg.canonical_level)
        pa = det.pool_levels(fpn, rois.to(device), *pool)
        pr = det.pool_levels([f.cpu() for f in fpn], rois, *pool)
        fe = "feature_extractor"
        fa = card_model.roi_heads["box"][fe](pa)["fc6"]
        fr = host.roi_heads["box"][fe](pa.cpu())["fc6"]
    out = {"levels": [l + 2 for l in levels], "rois": int(rois.shape[1]),
           "pooled": agreement(torch, pa, pr),
           "fc6": agreement(torch, fa, fr)}
    gate_agreement("ROIAlign over P2..P5 (fp32, the card's FPN)",
                   out["pooled"])
    gate_agreement("fc6 over P2..P5 (fp32, the card's pooled values)",
                   out["fc6"])
    log(f"  ROIAlign and fc6 card vs CPU, one {h}x{w} image, "
        f"{out['rois']} grid boxes on P{out['levels']} from the card's "
        f"FPN: pooled cosine {out['pooled']['cosine']:.7f}, max |d| "
        f"{out['pooled']['max_rel']:.2e}; fc6 cosine "
        f"{out['fc6']['cosine']:.7f}, max |d| {out['fc6']['max_rel']:.2e}")
    return out


def _proposal_ids_agree(card, host) -> dict:
    """The proposal stage's ids (B, P) on two devices from the same RPN
    outputs: equal at every valid slot, except where the card's id is
    the CPU's at a neighbouring slot whose score lies within one fp32
    ulp (a near-tie's swap). Returns the counts."""
    import numpy as np

    ia, ib = card["ids"].cpu().numpy(), host["ids"].cpu().numpy()
    sb = host["scores"].float().cpu().numpy()
    va = np.isfinite(card["scores"].float().cpu().numpy())
    vb = np.isfinite(sb)
    bad, ties = [], 0
    for b, i in zip(*np.nonzero((ia != ib) & vb)):
        near = [j for j in (i - 1, i + 1) if 0 <= j < sb.shape[1]
                and ia[b, i] == ib[b, j]
                and abs(sb[b, i] - sb[b, j]) <= np.spacing(abs(sb[b, i]))]
        if near:
            ties += 1
        else:
            bad.append((int(b), int(i)))
    return {"valid_equal": bool((va == vb).all()), "near_tie_swaps": ties,
            "mismatches": bad, "valid": int(vb.sum())}


def run_bbox_phase(torch, args, log, device, sz, card, cfg) -> dict:
    """The bbox path through cli/extract_bbox_features.extract_batch at
    sz's widths, fp32: one warm-up and `timed` batches (img/s, peak
    memory), one batch split into the backbone with the RPN head, the
    proposal stage with its NMS, the box head and select_top_features;
    then, at one image on the check's canvas with TF32 off, the card
    against the CPU unit by unit from the card's own inputs: the
    backbone and RPN outputs, the proposal stage, the selection."""
    import numpy as np

    from xlxmert_tpu_torch.cli import extract_bbox_features as eb
    from xlxmert_tpu_torch.models import detectron as det
    from xlxmert_tpu_torch.ops.box_selection import select_top_features

    cuda = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tree = det.random_params(cfg, args.seed, n_classes=sz["classes"])
    P, N = sz["proposals"], sz["num_features"]

    def model_of(where):
        return det.load_params(det.DetectronDetector(
            cfg, n_classes=sz["classes"], pre_nms_top_n=P, post_nms_top_n=P,
            fpn_post_nms_top_n=P), tree).to(where).eval()

    B = sz["bbox_batch"]
    imgs, sizes = factory_images(B, sz["canvas"], sz["image"], args.seed + 2)
    scales = np.full(B, 1.5, np.float32)
    model = model_of(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    eb.extract_batch(model, imgs, sizes, scales, device, N)   # warm-up
    t0 = time.perf_counter()
    for _ in range(sz["timed"]):
        res = eb.extract_batch(model, imgs, sizes, scales, device, N)
    sec = (time.perf_counter() - t0) / sz["timed"]
    out = {"batch_s": sec, "images_per_s": B / sec,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    if not (res["features"].shape == (B, N, cfg.mlp_dim)
            and np.isfinite(res["features"]).all()
            and np.isfinite(res["boxes"]).all()
            and 0 <= res["obj_id"].min()
            and res["obj_id"].max() < sz["classes"] - 1):
        fail("bbox extraction: features, boxes or obj_id out of range")
    parts = {}
    with torch.inference_mode():
        x = torch.as_tensor(imgs).to(device)
        s = torch.as_tensor(sizes).to(device)
        sync()
        t0 = time.perf_counter()
        fpn, lg, dl = model.rpn_outputs(x)
        sync()
        parts["backbone_rpn_head"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prop = model.propose(lg, dl, s)
        sync()
        parts["proposals_nms"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cls, feats = model.box_head(fpn, prop["boxes"])
        sync()
        parts["box_head"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        select_top_features(prop["boxes"], cls, feats["fc6"],
                            torch.as_tensor(scales).to(device),
                            valid=torch.isfinite(prop["scores"]),
                            num_features=N)
        sync()
        parts["select_top_features"] = time.perf_counter() - t0
    out["parts_s"] = parts
    log(f"  bbox extraction fp32, B={B}, canvas {sz['canvas']}, {P} "
        f"proposals, {sz['classes']} classes: {sec * 1e3:.1f} ms a batch, "
        f"{out['images_per_s']:.2f} img/s; peak "
        f"{out['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log("    one batch's parts (host clock, synchronized): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in parts.items()))
    del fpn, lg, dl, prop, cls, feats, x
    if cuda:
        torch.cuda.empty_cache()

    img, size1 = factory_images(1, sz["check_canvas"], sz["check_canvas"],
                                args.seed + 3)
    host = model_of("cpu")
    scale1 = torch.ones(1)
    with tf32_off(torch), torch.inference_mode():
        xa = torch.from_numpy(img)
        sa = torch.from_numpy(size1)
        fa, la, da = model.rpn_outputs(xa.to(device))
        fr, lr, dr = host.rpn_outputs(xa)
        units = {"fpn": agreement(torch, fa, fr),
                 "objectness": agreement(torch, la, lr),
                 "deltas": agreement(torch, da, dr)}
        for name, a in units.items():
            gate_agreement(f"bbox {name}", a)
        pa = model.propose(la, da, sa.to(device))
        pr = host.propose([t.cpu() for t in la], [t.cpu() for t in da],
                          sa)
        units["proposals"] = pc = _proposal_ids_agree(pa, pr)
        if pc["mismatches"] or not pc["valid_equal"]:
            fail(f"bbox proposal stage, card vs CPU from the card's RPN "
                 f"outputs: ids differ at {pc['mismatches'][:5]} "
                 f"(valid slots equal: {pc['valid_equal']})")
        cls, feats = model.box_head(fa, pa["boxes"])
        cr, fr_ = host.box_head([t.cpu() for t in fa], pa["boxes"].cpu())
        for name, got, ref in (("cls", cls, cr),
                               ("fc6", feats["fc6"], fr_["fc6"]),
                               ("fc7", feats["fc7"], fr_["fc7"])):
            units[name] = agreement(torch, got, ref)
            gate_agreement(f"bbox box head {name} (the card's FPN and "
                           "proposals)", units[name])
        units["proposal_levels"] = sorted(
            l + 2 for l in set(det.fpn_level_assignment(
                pa["boxes"][0].cpu(), cfg.canonical_scale,
                cfg.canonical_level).tolist()))
        inputs = (pa["boxes"], cls, feats["fc6"], scale1.to(device),
                  torch.isfinite(pa["scores"]))
        sel = {}
        for where in (device, "cpu"):
            p_, c_, f_, s_, v_ = (t.to(where) for t in inputs)
            sel[where] = select_top_features(p_, c_, f_, s_, valid=v_,
                                             num_features=N)
    same_keep = torch.equal(sel[device]["keep_boxes"].cpu(),
                            sel["cpu"]["keep_boxes"])
    same_obj = torch.equal(sel[device]["obj_id"].cpu(), sel["cpu"]["obj_id"])
    units["select"] = {"keep_boxes_equal": same_keep,
                       "obj_id_equal": same_obj}
    if not (same_keep and same_obj):
        fail("bbox select_top_features, card vs CPU from the card's "
             f"detector outputs: kept indices equal {same_keep}, obj_id "
             f"equal {same_obj}")
    out["card_vs_cpu"] = units
    log(f"  bbox card vs CPU, fp32 (TF32 off), one image on "
        f"{sz['check_canvas']}, unit by unit from the card's inputs: "
        + ", ".join(f"{k} cosine {units[k]['cosine']:.7f}"
                    for k in ("fpn", "objectness", "deltas"))
        + f"; proposals: {pc['valid']} valid, ids equal but "
        f"{pc['near_tie_swaps']} near-tie swaps; box head over P"
        f"{units['proposal_levels']}: "
        + ", ".join(f"{k} cosine {units[k]['cosine']:.7f}"
                    for k in ("cls", "fc6", "fc7"))
        + "; select_top_features: kept indices and obj_id equal")
    return out


def run_factory_path(torch, args, kernels, log, device="cuda", sizes=None,
                     card="") -> dict:
    """Phase (l): the offline feature factory at measure_factory's widths
    (FACTORY_SIZES; `sizes` overrides them, the CPU test runs a small
    one): k-means (run_kmeans_phase), the grid extractor
    (run_grid_phase), the bbox path (run_bbox_phase). No kernel of the
    port lies on this path: every launch count must stay 0."""
    from xlxmert_tpu_torch.models.detectron import DetectronConfig

    sz = dict(FACTORY_SIZES, **(sizes or {}))
    cfg = DetectronConfig(**(sz["config"] or {}))
    for k in kernels:
        k.launches = 0
    out = {"sizes": {k: v for k, v in sz.items() if k != "config"}}
    t0 = time.time()
    out["kmeans"] = run_kmeans_phase(torch, args, log, device, sz, card)
    out["kmeans"]["wall_s"] = time.time() - t0
    t0 = time.time()
    out["grid"] = run_grid_phase(torch, args, log, device, sz, card, cfg)
    out["grid"]["wall_s"] = time.time() - t0
    t0 = time.time()
    out["bbox"] = run_bbox_phase(torch, args, log, device, sz, card, cfg)
    out["bbox"]["wall_s"] = time.time() - t0
    out["launches"] = {k.name: k.launches for k in kernels}
    check_launches("factory", out["launches"], 1)
    log("  phase (l) parts: " + ", ".join(
        f"{k} {out[k]['wall_s']:.1f}s" for k in ("kmeans", "grid", "bbox"))
        + "; launches of the port's kernels: none")
    return out


# ---------------------------------------------------------------------------
# (m) FID
# ---------------------------------------------------------------------------

# eval_fid's default batch; cli/sample_images' 256-px images; COCO's
# common native size for the host resize
FID_SIZES = dict(batch=64, images=2048, size=256, coco=(480, 640),
                 check=8, fid_check=256, layout_reps=5)
# card against CPU (bars written before the first chip run). TF32 off:
# fp32 sums in another order; TF32 on (cuDNN's default for fp32
# convolutions, as eval_fid runs): 10-bit products through ~20 layers.
# The FID gate holds TF32-off features: FID adds up feature differences
# over 2,048 dimensions (i.i.d. noise of 1e-3 of the features' scale
# moved a 64-image FID by 2.4 % on the CPU), so the TF32 FID is reported.
POOL3_BARS = {"tf32_off": (0.999999, 1e-4), "tf32": (0.9999, 2e-2)}
FID_REL_BAR = 1e-3


def fid_images(n, size, seed, shift=0.0):
    """n host images (n, size, size, 3) in [0, 1], float32, from `seed`:
    smooth random fields (an 8x8 grid of colors bilinearly upsampled)
    plus pixel noise; `shift` brightens them (the 'fake' set)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    coarse = torch.rand(n, 3, 8, 8, generator=g)
    img = torch.nn.functional.interpolate(
        coarse, size=(size, size), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).contiguous()
    img.mul_(0.8).add_(torch.rand(n, size, size, 3, generator=g), alpha=0.2)
    return img.add_(shift).clamp_(0.0, 1.0).numpy()


def fid_extractor_run(torch, kind, variables, real, fake, sz, device, log,
                      card) -> dict:
    """One extractor through eval_fid's path below its file reading:
    fid_of_batches over the real and fake batches (FID, wall s), then the
    same feature function over every batch again, warm (img/s, peak
    memory, the features), and on the card one profiled batch (busy
    share, the convolutions' device time, FLOPs and rate, glue)."""
    import numpy as np

    from xlxmert_tpu_torch.cli import eval_fid

    cuda = str(device).startswith("cuda")
    B = sz["batch"]
    batches = [a[j:j + B] for a in (real, fake)
               for j in range(0, len(a), B)]
    n_real = -(-len(real) // B)
    t0 = time.perf_counter()
    fid = eval_fid.fid_of_batches(batches[:n_real], batches[n_real:], kind,
                                  variables, device)
    wall = time.perf_counter() - t0
    fn = eval_fid.feature_fn(kind, variables, device)
    fn(batches[0])                                          # warm-up
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats = np.concatenate([fn(b) for b in batches])        # host arrays
    sec = time.perf_counter() - t0
    n = len(real) + len(fake)
    if not (feats.shape == (n, 2048) and np.isfinite(feats).all()
            and math.isfinite(fid) and fid > 0):
        fail(f"FID {kind}: features {feats.shape} (finite: "
             f"{np.isfinite(feats).all()}), FID {fid}")
    out = {"fid": fid, "fid_of_batches_s": wall, "features_s": sec,
           "images_per_s": n / sec,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
           "profile": None}
    log(f"  {kind}: FID {fid:.4f} through eval_fid.fid_of_batches "
        f"({n} images, {wall:.2f}s); features {n / sec:.1f} img/s (B={B}, "
        f"host batches in, host features out), peak "
        f"{out['peak_bytes'] / 2**30:.2f} GiB ({card})")
    if cuda:
        from xlxmert_tpu_torch.models.inception import preprocess_for_fid

        flop = conv_flops(torch, lambda: fn(batches[0]))
        out["profile"] = p = profile_groups(
            torch, lambda: fn(batches[0]), {"convolutions": "conv"})
        conv_ms = p["device_ms_by_group"]["convolutions"]
        out["conv_tflop"] = flop / 1e12
        out["conv_tflop_per_s"] = flop / conv_ms / 1e9
        log(f"    a profiled batch: wall {p['wall_ms']:.1f} ms, device "
            f"{p['device_ms']:.1f} ms, busy {p['busy_share']:.2f}; "
            f"convolutions {conv_ms:.1f} ms ({flop / 1e12:.3f} TFLOP "
            f"counted, {out['conv_tflop_per_s']:.1f} TFLOP/s), glue "
            f"{p['device_ms_by_group']['glue']:.1f} ms: " + ", ".join(
                f"{k} {v:.2f}" for k, v in p["glue_top_ops_ms"].items()))
        if kind == "inception":
            out["layout_ms"] = layout_ms(
                torch, variables, preprocess_for_fid(torch.from_numpy(
                    batches[0]).to(device)), device, sz["layout_reps"])
            log("    InceptionV3 forward at B={} from device input "
                "(CUDA events, best of {}): channels-last {:.2f} ms, NCHW "
                "{:.2f} ms".format(B, sz["layout_reps"],
                                   out["layout_ms"]["channels_last"],
                                   out["layout_ms"]["nchw"]))
    return out, feats


def layout_ms(torch, variables, x, device, reps) -> dict:
    """InceptionV3's forward device time from an NHWC batch `x` as the
    module runs it (channels-last kernels and activations) and converted
    to NCHW (kernels and input), in turns (cl, nchw, nchw, cl, ...), the
    best of `reps` each."""
    from xlxmert_tpu_torch.models.inception import inception_from_variables

    runs = {"channels_last": (inception_from_variables(variables).to(
                device), x),
            "nchw": (inception_from_variables(variables).to(
                device, memory_format=torch.contiguous_format),
                x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))}
    best = dict.fromkeys(runs, float("inf"))
    with torch.inference_mode():
        for i in range(reps):
            for name in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                model, inp = runs[name]
                model(inp)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(inp)
                end.record()
                end.synchronize()
                best[name] = min(best[name], start.elapsed_time(end))
    return best


def run_fid_path(torch, args, kernels, log, device="cuda", sizes=None,
                 card="") -> dict:
    """Phase (m): FID at eval_fid's widths (FID_SIZES; `sizes` overrides
    them, the CPU test runs a small one). InceptionV3 (pt_inception's
    architecture, 1,008 classes, random weights from --seed with drawn
    BN statistics) and the ResNet-50 extractor, fp32 as eval_fid runs
    them, each through eval_fid's path below its file reading over
    `images` 'real' and as many 'fake' host images at `size` px in [0, 1]
    (fid_extractor_run); the host resize of a batch at COCO's size
    (bilinear_resize_np), apart; the Fréchet distance's host time at
    D=2,048; card-vs-CPU gates: pool3 on `check` images (POOL3_BARS,
    TF32 off and on) and the FID of `fid_check` images' features
    (FID_REL_BAR, TF32 off; the TF32 FID reported), the check images
    among them. No kernel of the port lies on this path: every launch
    count must stay 0."""
    import numpy as np

    from xlxmert_tpu_torch.cli import eval_fid
    from xlxmert_tpu_torch.core.convert import (
        convert_torch_state_dict, split_variables,
    )
    from xlxmert_tpu_torch.models.inception import (
        inception_from_variables, random_variables,
    )
    from xlxmert_tpu_torch.models.resnet import random_init, resnet50
    from xlxmert_tpu_torch.utils.fid import (
        fid_from_features, inception_feature_fn,
    )

    sz = dict(FID_SIZES, **(sizes or {}))
    for k in kernels:
        k.launches = 0
    t0 = time.time()
    real = fid_images(sz["images"], sz["size"], args.seed)
    fake = fid_images(sz["images"], sz["size"], args.seed + 1, shift=0.1)
    out = {"sizes": sz, "data_s": time.time() - t0, "extractors": {}}
    tree = split_variables(convert_torch_state_dict(
        random_init(resnet50(), args.seed).state_dict()))
    variables = {"inception": random_variables(args.seed),
                 "resnet": {"params": tree["params"],
                            "batch_stats": tree["batch_stats"]}}
    feats = {}
    for kind in ("inception", "resnet"):
        out["extractors"][kind], feats[kind] = fid_extractor_run(
            torch, kind, variables[kind], real, fake, sz, device, log, card)
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()
    n = sz["images"]
    f = feats["inception"]
    t0 = time.perf_counter()
    fid = fid_from_features(f[:n], f[n:])
    out["frechet_s"] = time.perf_counter() - t0
    if abs(fid - out["extractors"]["inception"]["fid"]) > FID_REL_BAR * fid:
        fail(f"FID: the timed pass's features give {fid}, fid_of_batches "
             f"{out['extractors']['inception']['fid']}")
    coco = np.random.default_rng(args.seed + 2).random(
        (sz["batch"], *sz["coco"], 3), dtype=np.float32)
    resize = []
    for _ in range(2):
        t0 = time.perf_counter()
        np.stack([eval_fid.bilinear_resize_np(img) for img in coco])
        resize.append(time.perf_counter() - t0)
    out["resize_ms"] = min(resize) * 1e3
    log(f"  host: bilinear_resize_np of {sz['batch']} images at "
        f"{sz['coco'][0]}x{sz['coco'][1]} -> 299: {out['resize_ms']:.1f} ms "
        f"({sz['batch'] * 1e3 / out['resize_ms']:.1f} img/s, one thread); "
        f"the Fréchet distance at D=2048 over {n} + {n} features: "
        f"{out['frechet_s']:.2f}s")

    # card against CPU: the features of fid_check images (the first half
    # real, the rest fake) on the CPU and on the card with TF32 off; the
    # timed pass's (TF32 as cuDNN's default has it) are the third side
    h, m, B = sz["fid_check"] // 2, sz["check"], sz["batch"]
    check = np.concatenate([real[:h], fake[:h]])

    def features(where):
        fn = inception_feature_fn(inception_from_variables(
            variables["inception"]), where)
        return np.concatenate([fn(check[j:j + B])
                               for j in range(0, len(check), B)])

    t0 = time.perf_counter()
    ref = features("cpu")
    cpu_s = time.perf_counter() - t0
    with tf32_off(torch):
        exact = features(device)
    timed = np.concatenate([f[:h], f[n:n + h]])
    out["tf32_default"] = bool(torch.backends.cudnn.allow_tf32)
    out["pool3_card_vs_cpu"] = {}
    for mode, got in (("tf32_off", exact), ("tf32", timed)):
        cos_bar, rel_bar = POOL3_BARS[mode]
        a = agreement(torch, torch.from_numpy(got[:m]),
                      torch.from_numpy(ref[:m]))
        out["pool3_card_vs_cpu"][mode] = dict(a, bars=[cos_bar, rel_bar])
        gate_agreement(f"pool3 ({mode})", a, cos_bar, rel_bar)
        log(f"  pool3 card vs CPU on {m} images, {mode}: cosine "
            f"{a['cosine']:.7f} (bar {cos_bar}), max |d| {a['max_rel']:.2e} "
            f"of max |ref| (bar {rel_bar:g})")
    fids = {k: fid_from_features(v[:h], v[h:]) for k, v in
            (("cpu", ref), ("tf32_off", exact), ("tf32", timed))}
    rel = {k: abs(v - fids["cpu"]) / fids["cpu"] for k, v in fids.items()
           if k != "cpu"}
    out["fid_card_vs_cpu"] = {"fid": fids, "rel_diff": rel,
                              "bar": FID_REL_BAR, "images": 2 * h,
                              "cpu_s": cpu_s}
    log(f"  FID of {h} + {h} images: CPU {fids['cpu']:.6f}, card TF32 off "
        f"{fids['tf32_off']:.6f} (relative {rel['tf32_off']:.2e}, bar "
        f"{FID_REL_BAR:g}), card TF32 (the timed features) "
        f"{fids['tf32']:.6f} (relative {rel['tf32']:.2e}, reported); CPU "
        f"features {cpu_s:.1f}s; cuDNN's TF32 for fp32 convolutions: "
        f"{'on' if out['tf32_default'] else 'off'} in the timed runs")
    if not rel["tf32_off"] <= FID_REL_BAR:
        fail(f"FID card vs CPU (TF32 off): {fids['tf32_off']} against "
             f"{fids['cpu']} (relative {rel['tf32_off']} > {FID_REL_BAR})")
    out["launches"] = {k.name: k.launches for k in kernels}
    check_launches("fid", out["launches"], 1)
    log("  launches of the port's kernels: none")
    return out


# ---------------------------------------------------------------------------
# (n) distributed training: several ranks on the card
# ---------------------------------------------------------------------------

# two ranks share the one card over gloo (NCCL takes one rank a device);
# the pipeline runs three stages
DIST_SIZES = dict(ranks=2, batch=FT_BATCH, steps=3, eval=2 * FT_BATCH,
                  images=64, answers=3129, text=FT_TEXT, feat_dim=2048,
                  pt_batch=PT_CHECK, stages=3, micro=4,
                  pipe_batch=FT_BATCH, table_images=IMAGES,
                  table_batch=BATCH, timeout=600)
DIST_ROUTES = ("pallas_blhd", "xla")
PIPE_RTOL = 2e-5          # the JAX pipeline test's forward bar
PIPE_GRAD_COSINE = 0.99999
PIPE_GRAD_REL = 5e-4      # max |d| of the gradients over their max |value|


def _after_first(values):
    rest = values[1:] or values
    return sum(rest) / len(rest)


# phase (n)'s rank bodies: each runs in a process of its own, which
# parallel/launch.spawn starts after the parent built the kernels. A
# spawned rank re-imports this file, whose top level imports only the
# standard library; weights and data come from `seed`, made on every rank
# alike.


def rank_cases(rank: int, calls) -> list:
    """Several rank bodies in one spawn: [(name, kwargs), ...] run in
    order, their results in a list."""
    return [globals()[name](rank, **kw) for name, kw in calls]


def port_kernels() -> list:
    """The port's seven kernels, in the kernels line's order."""
    from xlxmert_tpu_torch.ops import attention, ffn, fused_block, int8_matmul

    return [attention.KERNEL, int8_matmul.KERNEL, ffn.KERNEL,
            attention.FUSED_MHA_KERNEL, fused_block.KERNEL,
            attention.TRAIN_KERNEL, attention.HBATCH_KERNEL]


def launch_counts(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def synthetic_vqa(seed: int, n_train: int, n_eval: int, n_images: int,
                  n_answers: int, text: int, feat_dim: int):
    """In-memory VQA train and eval sets: questions of 3..text-2 random
    words over a small vocabulary, each on one of `n_images` random
    (64, feat_dim) feature rows, with a soft target on 1-3 of
    `n_answers` answers. Returns (train, eval, label2ans)."""
    import numpy as np

    from xlxmert_tpu_torch.data.datasets import VQADataset
    from xlxmert_tpu_torch.data.evaluators import VQAEvaluator
    from xlxmert_tpu_torch.data.tokenization import Tokenizer

    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(200)]
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)}
    rows = rng.randn(n_images, 64, feat_dim).astype(np.float32)

    class Reader:
        def get(self, img_id):
            return rows[int(str(img_id).rsplit("_", 1)[1])]

    label2ans = [f"ans{i}" for i in range(n_answers)]
    ans2label = {a: i for i, a in enumerate(label2ans)}
    data = []
    for q in range(n_train + n_eval):
        n = rng.randint(3, max(text - 2, 4))
        picks = rng.choice(n_answers, size=rng.randint(1, 4), replace=False)
        data.append({"question_id": q, "img_id": f"img_{rng.randint(n_images)}",
                     "sent": " ".join(rng.choice(words, n)),
                     "label": {label2ans[a]: float(rng.choice(
                         (0.3, 0.6, 0.9, 1.0))) for a in picks}})
    tok = Tokenizer(vocab)

    def build(part):
        ds = VQADataset(part, tok, Reader(), ans2label, label2ans,
                        max_text_length=text, grid_size=8)
        ds.evaluator = VQAEvaluator(ds.id2datum)
        return ds

    return build(data[:n_train]), build(data[n_train:]), label2ans


def finetune_launch(rank: int, routes: tuple, seed: int,
                    sizes: dict, out_dir: str, device: str = "cuda",
                    model_kw: dict | None = None) -> dict:
    """A rank of a torchrun-style launch of cli/finetune: the process
    group from the environment (maybe_initialize_multihost, as the CLI's
    `run` starts it), this rank's shard of an in-memory VQA set,
    cli/finetune.finetune() for one epoch on each training attention
    route with the int8 evaluation merged over the ranks. Returns per
    route every step's ms, loss, gradient norm, launches and collective
    bytes and seconds, the launches of the evaluation, its forwards on
    this rank and the merged score."""
    import torch

    from xlxmert_tpu_torch.cli.finetune import finetune
    from xlxmert_tpu_torch.core.config import FinetuneConfig, LxmertConfig
    from xlxmert_tpu_torch.core.metrics import RunLogger
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.finetune import FinetuneEngine

    backend = pmesh.maybe_initialize_multihost(device)
    world = pmesh.world_size()
    B = sizes["batch"]
    train, evals, label2ans = synthetic_vqa(
        seed, sizes["steps"] * B * world, sizes["eval"], sizes["images"],
        sizes["answers"], sizes["text"], sizes["feat_dim"])
    train.shard(pmesh.rank(), world)
    kernels = port_kernels()
    out: dict = {"backend": backend, "world": world}
    params = None
    for route in routes:
        cfg = FinetuneConfig(task="vqa", batch_size=B, epochs=1,
                             lr=1e-4, max_text_length=sizes["text"],
                             grid_size=8, output=f"{out_dir}/{route}",
                             seed=seed, serve_int8=True)
        eng = FinetuneEngine(cfg, sizes["answers"],
                             LxmertConfig(**(model_kw or {})),
                             total_steps=sizes["steps"],
                             train_attention=route, device=device)
        if params is None:      # every route starts from the same weights
            params = eng.init_params(seed)
        state = eng.create_state(seed, params)
        steps: list = []
        last: dict = {}

        def on_step(i, metrics):
            loss = float(metrics["loss"])           # waits for the step
            _sync(device)
            now, seen = time.perf_counter(), launch_counts(kernels)
            steps.append({"loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "ms": (now - last["t"]) * 1e3,
                          "launches": {k: n - last["n"][k]
                                       for k, n in seen.items()},
                          "comm": dict(pmesh.COMM)})
            pmesh.reset_comm()
            last.update(t=time.perf_counter(), n=launch_counts(kernels))

        for k in kernels:
            k.launches = 0
        logger = RunLogger(cfg.output, cfg, enabled=pmesh.is_main(),
                           use_tensorboard=False)
        _sync(device)
        pmesh.barrier()
        pmesh.reset_comm()
        last.update(t=time.perf_counter(), n=launch_counts(kernels))
        score = finetune(eng, state, train, evals, cfg, logger, label2ans,
                         on_step=on_step)
        logger.close()
        total = launch_counts(kernels)
        trained = {k: sum(s["launches"][k] for s in steps) for k in total}
        n_eval = -(-len(evals) // B)
        mine = len(range(pmesh.rank(), n_eval, world))
        out[route] = {"steps": steps, "score": score,
                      "launches": total,
                      "eval_launches": {k: total[k] - trained[k]
                                        for k in total},
                      "eval_forwards": mine + min(mine, 4),
                      "peak_bytes": (torch.cuda.max_memory_allocated()
                                     if torch.device(device).type == "cuda"
                                     else 0)}
        del eng, state
    return out


def tp_check(rank: int, seed: int, batch: dict, tasks: tuple,
             centroids_seed: int, n_clusters: int, train_kw: dict,
             model_kw: dict, device: str = "cuda") -> dict:
    """tp = 2 pre-training on a ("data", "model") mesh of this process
    group on the pallas_blhd route, dropout-free from init_params(seed) on
    an injected-mask batch: per task the gathered loss and gradients
    against the single-process step of rank 0 on the same device (a
    one-rank mesh: no collective), then one timed train_step of each
    task. Launches count the tensor-parallel work only."""
    import numpy as np
    import torch

    from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    world = pmesh.world_size()
    cfg = TrainConfig(**train_kw, mesh_shape=(world // 2, 2),
                      mesh_axis_names=("data", "model"))
    mcfg = LxmertConfig(**model_kw)
    cents = torch.from_numpy(np.random.RandomState(centroids_seed).randn(
        n_clusters, mcfg.visual_feat_dim).astype(np.float32)).to(device)
    eng = PretrainEngine(cfg, mcfg, total_steps=100,
                         train_attention="pallas_blhd", device=device)
    state = eng.create_state(seed)
    ref = None
    if rank == 0:
        ref = PretrainEngine(cfg, mcfg, total_steps=100,
                             train_attention="pallas_blhd", device=device,
                             mesh=pmesh.Mesh({"data": 1}))
        ref_state = ref.create_state(seed)
    kernels = port_kernels()
    for k in kernels:
        k.launches = 0
    counted = {k.name: 0 for k in kernels}
    placed = eng.place(batch)
    out: dict = {"tasks": {}, "heads_per_rank":
                           mcfg.num_attention_heads // 2}
    for task in tasks:
        before = launch_counts(kernels)
        losses, grads = eng.loss_and_grads(state.model, placed, task, cents,
                                           state.generator)
        got = eng.tp.gather_dict({n: g for n, g in grads.items()
                                  if g is not None})
        _sync(device)
        for k, n in launch_counts(kernels).items():
            counted[k] += n - before[k]
        if rank == 0:
            rl, rg = ref.loss_and_grads(ref_state.model, ref.place(batch),
                                        task, cents, ref_state.generator)
            want = {n: g for n, g in rg.items() if g is not None}
            dot = sum(float((got[n].double() * want[n].double()).sum())
                      for n in want)
            na = sum(float((got[n].double() ** 2).sum()) for n in want)
            nb = sum(float((want[n].double() ** 2).sum()) for n in want)
            lt, lr_ = float(losses["total_loss"]), float(rl["total_loss"])
            out["tasks"][task] = {
                "loss_tp": lt, "loss_single": lr_,
                "loss_rel_diff": abs(lt - lr_) / max(abs(lr_), 1e-12),
                "grad_cosine": dot / max(np.sqrt(na * nb), 1e-300),
                "same_params": sorted(got) == sorted(want),
                "with_gradient": len(want)}
            del rg, want
        del grads, got
    if rank == 0:
        del ref, ref_state
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    timed = []
    for task in tasks:
        before = launch_counts(kernels)
        _sync(device)
        pmesh.reset_comm()
        t0 = time.perf_counter()
        loss = float(eng.train_step(state, batch, task, cents)["total_loss"])
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        for k, n in launch_counts(kernels).items():
            counted[k] += n - before[k]
        timed.append({"task": task, "ms": ms, "loss": loss,
                      "comm": dict(pmesh.COMM)})
    out["steps"] = timed
    out["launches"] = counted
    return out


def pipeline_check(rank: int, seed: int, model_kw: dict, batch: int,
                   text: int, n_micro: int,
                   device: str = "cuda") -> dict:
    """The `l_layers` language layers of LxmertConfig(**model_kw) from
    `seed` (every rank draws the same stack), pipelined over a ("data",
    "pipe") mesh of the whole group at data 1, in fp32, forward and
    backward (loss mean(h^2)) twice, the first a warm-up, against the
    sequential stack on rank 0 on the same device. Returns the
    comparison (rank 0), each rank's timings and its bubble."""
    import numpy as np
    import torch

    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.models.lxmert import (
        EXACT, TrainOptions, TransformerLayer, extend_attention_mask,
    )
    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.parallel.pipeline import (
        PIPE_STATS, pipeline_apply, place_pipeline,
    )

    cfg = LxmertConfig(**model_kw)
    L = cfg.l_layers
    rng = np.random.default_rng(seed)

    def layer():
        return TransformerLayer(cfg, EXACT, TrainOptions())

    shapes = layer().state_dict()
    stacked = {}
    for k, v in shapes.items():
        shape = (L,) + tuple(v.shape)
        if k.endswith("bias"):
            a = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        elif v.dim() == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32)
        else:
            a = cfg.initializer_range * rng.standard_normal(
                shape, dtype=np.float32)
        stacked[k] = torch.from_numpy(a)
    x = torch.from_numpy(rng.standard_normal(
        (batch, text, cfg.hidden_size), dtype=np.float32)).to(device)
    mask = (rng.random((batch, text)) > 0.2).astype(np.float32)
    mask[:, 0] = 1
    bias = extend_attention_mask(torch.from_numpy(mask).to(device),
                                 torch.float32)
    world = pmesh.world_size()
    mesh = pmesh.make_mesh((1, world), ("data", "pipe"))
    stage = place_pipeline(stacked, layer, mesh, device=device).eval()

    def layer_fn(m, carry):
        h, b = carry
        return m(h, b), b

    out: dict = {"stage": mesh.index("pipe"),
                           "layers_here": len(stage)}
    times = []
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        h, _ = pipeline_apply(layer_fn, stage, (x, bias), mesh=mesh,
                              n_micro=n_micro)
        loss = (h ** 2).mean()
        grads = torch.autograd.grad(loss, list(stage.parameters()))
        _sync(device)
        times.append({"forward_ms": PIPE_STATS["wall_s"] * 1e3,
                      "busy_ms": PIPE_STATS["busy_s"] * 1e3,
                      "bubble": 1.0 - PIPE_STATS["busy_s"]
                      / PIPE_STATS["wall_s"],
                      "forward_backward_ms":
                      (time.perf_counter() - t0) * 1e3})
    out["timings"] = times
    per = len(stage)
    names = [n for n, _ in stage.named_parameters()]

    def global_name(stage_index, name):
        i, rest = name.split(".", 1)
        return f"{stage_index * per + int(i)}.{rest}"

    # rank 0 gathers every stage's gradients through the group, one
    # tensor at a time (the stages hold different layers)
    parts = {}
    for s in range(world):
        for name, g in zip(names, grads):
            t = g if s == mesh.index("pipe") else torch.empty_like(g)
            pmesh.broadcast(t, mesh.ranks("pipe")[s], mesh.group("pipe"))
            if rank == 0:
                parts[global_name(s, name)] = t
    if rank == 0:
        seq = [layer() for _ in range(L)]
        for i, m in enumerate(seq):
            m.load_state_dict({k: v[i] for k, v in stacked.items()})
            m.to(device).eval()
        hr = x
        for m in seq:
            hr = m(hr, bias)
        named = [(f"{i}.{n}", p) for i, m in enumerate(seq)
                 for n, p in m.named_parameters()]
        ref = dict(zip((k for k, _ in named), torch.autograd.grad(
            (hr ** 2).mean(), [p for _, p in named])))
        dot = sum(float((parts[k].double() * ref[k].double()).sum())
                  for k in ref)
        na = sum(float((parts[k].double() ** 2).sum()) for k in ref)
        nb = sum(float((ref[k].double() ** 2).sum()) for k in ref)
        out["out_max_abs_err"] = float((h - hr).detach().abs().max())
        out["out_max_abs"] = float(hr.detach().abs().max())
        out["grad_cosine"] = dot / max(np.sqrt(na * nb), 1e-300)
        # over the largest gradient: a key bias's gradient is 0 but for
        # rounding, so its own largest value is no scale
        out["grad_max_rel_err"] = max(
            float((parts[k] - ref[k]).abs().max()) for k in ref) / max(
            max(float(ref[k].abs().max()) for k in ref), 1e-30)
        out["same_params"] = sorted(parts) == sorted(ref)
    return out


def table_check(rank: int, seed: int, n_images: int, batch: int,
                feat_dim: int, device: str = "cuda", reps: int = 10) -> dict:
    """A catalog of `n_images` random (8, 8, feat_dim) rows from `seed`
    sharded over every rank on "data"; a lookup of `batch` random images
    on each rank against the unsharded table's, bit for bit, and its
    mean ms over `reps` lookups."""
    import numpy as np
    import torch

    from xlxmert_tpu_torch.parallel import mesh as pmesh
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache

    rng = np.random.RandomState(seed)
    rows = rng.randn(n_images, 8, 8, feat_dim).astype(np.float32)
    idx = [str(i) for i in rng.randint(0, n_images, batch)]

    class Reader:
        def get(self, i):
            return rows[int(i)]

    ids = [str(i) for i in range(n_images)]
    cache = FeatureCache.build(Reader(), ids, device=device,
                               mesh=pmesh.make_mesh())
    picks = torch.from_numpy(cache.indices(idx)).to(device)
    got = FeatureCache.lookup(cache.table, picks, cache.shard)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        FeatureCache.lookup(cache.table, picks, cache.shard)
    _sync(device)
    lookup_ms = (time.perf_counter() - t0) * 1e3 / reps
    full = FeatureCache.build(Reader(), ids, device=device)
    want = FeatureCache.lookup(full.table, torch.from_numpy(
        full.indices(idx)).to(device))
    return {"bit_equal": bool(torch.equal(got, want)),
            "rows_here": int(cache.table.shape[0]), "lookup_ms": lookup_ms,
            "unsharded_bytes": full.nbytes}


def run_distributed_path(torch, args, kernels, log, device="cuda",
                         sizes=None, model_kw=None, card="") -> dict:
    """Phase (n): the distribution layer (parallel/) at full width
    (LxmertConfig(), or `model_kw`; DIST_SIZES, or `sizes` for the CPU
    test), every rank a process of its own spawned after the parent
    built the kernels:
      - a 2-rank launch with torchrun's environment (RANK, WORLD_SIZE,
        LOCAL_RANK, MASTER_ADDR=localhost, ...) through cli/finetune:
        the process group from maybe_initialize_multihost, each rank its
        shard of an in-memory VQA set at `batch` a rank, finetune() on
        both training attention routes with the int8 evaluation merged
        over the ranks (every rank calibrates on its own batches); then,
        in the same group, tp = 2 pre-training per task (pallas_blhd,
        H/2 heads a rank, fp32, dropout-free on injected masks) held to
        the single-process step on the same card (STEP_BARS), and timed
        train_steps; and the sharded feature table's lookup, bit-equal
        to the unsharded one;
      - a 3-rank GPipe of the language layers (S = 3, M = `micro`),
        forward and backward in fp32, held to the sequential stack
        (PIPE_RTOL, PIPE_GRAD_COSINE, PIPE_GRAD_REL), with its measured
        bubble beside (S - 1) / (M + S - 1).
    Launches are counted in each rank, reported back and summed. The
    ranks share one card: examples/s in all is not multi-card
    scaling."""
    import tempfile

    import numpy as np

    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.parallel.launch import spawn

    sz = dict(DIST_SIZES, **(sizes or {}))
    mkw = dict(model_kw or {})
    mcfg = LxmertConfig(**mkw)
    world = sz["ranks"]
    for k in kernels:
        k.launches = 0
    t_all = time.time()
    # the pre-training check's batch: injected masks on random captions
    rng = np.random.RandomState(args.seed + 14)
    B, T, V = sz["pt_batch"], sz["text"], 64
    word = rng.randint(5, min(mcfg.vocab_size, 200), (B, T)).astype(np.int32)
    word[:, 0] = min(101, mcfg.vocab_size - 1)
    word[0, T - 3:] = 0
    pt_batch = host_masked({
        "word_id": word,
        "other_word_id": rng.randint(5, min(mcfg.vocab_size, 200), (B, T)
                                     ).astype(np.int32),
        "matched_label": rng.randint(0, 2, B).astype(np.int32),
        "cluster_id": rng.randint(0, mcfg.num_clusters, (B, V)
                                  ).astype(np.int32)}, args.seed,
        mcfg.vocab_size)
    pt_kw = dict(batch_size=B, max_text_length=T, grid_size=8, lr=PT_LR,
                 clustering=True, num_clusters=mcfg.num_clusters,
                 feat_dim=mcfg.visual_feat_dim, visual_losses="obj",
                 vis_mask_predict=True, mixed_precision=False)
    check_kw = dict(mkw, hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)
    ft_sizes = {k: sz[k] for k in ("batch", "steps", "eval", "images",
                                   "answers", "text", "feat_dim")}
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.time()
        calls = [("finetune_launch", dict(
                     routes=DIST_ROUTES, seed=args.seed, sizes=ft_sizes,
                     out_dir=out_dir, device=device, model_kw=mkw)),
                 ("tp_check", dict(
                     seed=args.seed, batch=pt_batch, tasks=PT_TASKS,
                     centroids_seed=args.seed + 15,
                     n_clusters=mcfg.num_clusters, train_kw=pt_kw,
                     model_kw=check_kw, device=device)),
                 ("table_check", dict(
                     seed=args.seed + 16, n_images=sz["table_images"],
                     batch=sz["table_batch"], feat_dim=sz["feat_dim"],
                     device=device))]
        ranks = spawn(rank_cases, world, (calls,), timeout=sz["timeout"],
                      init="env", threads=2, device=device)
        launch_s = time.time() - t0
        t0 = time.time()
        pipe = spawn(pipeline_check, sz["stages"], (
            args.seed + 17, dict(mkw), sz["pipe_batch"], T, sz["micro"],
            device), timeout=sz["timeout"], threads=2, device=device)
        pipe_s = time.time() - t0
    # every rank's counts of every kernel, summed
    launches = dict.fromkeys(ranks[0][0][DIST_ROUTES[0]]["launches"], 0)
    out = {"ranks": world, "backend": ranks[0][0]["backend"],
           "launch_s": launch_s, "pipeline_s": pipe_s, "routes": {}}
    log(f"  {world} ranks on one card, backend {out['backend']} ({card}); "
        f"the launch took {launch_s:.1f}s, the pipeline {pipe_s:.1f}s")
    # fine-tuning through cli/finetune on each route
    for route in DIST_ROUTES:
        per_rank = [r[0][route] for r in ranks]
        for i, rr in enumerate(per_rank):
            for k, n in rr["launches"].items():
                launches[k] += n
            for j, st in enumerate(rr["steps"]):
                if not math.isfinite(st["loss"]):
                    fail(f"(n) finetune {route} rank {i} step {j}: loss "
                         f"{st['loss']}")
                if device == "cuda":
                    check_launches(f"finetune {route}", st["launches"], 1)
            if device == "cuda":
                check_launches("finetune serve_int8", rr["eval_launches"],
                               rr["eval_forwards"])
        steps = per_rank[0]["steps"]
        losses = [[st["loss"] for st in rr["steps"]] for rr in per_rank]
        if any(x != losses[0] for x in losses):
            fail(f"(n) finetune {route}: the ranks logged different "
                 f"global losses {losses}")
        score = per_rank[0]["score"]
        if not all(rr["score"] == score for rr in per_rank):
            fail(f"(n) finetune {route}: the merged scores differ")
        step_ms = _after_first([max(rr["steps"][j]["ms"] for rr in per_rank)
                                for j in range(len(steps))])
        comm = per_rank[0]["steps"][1:] or per_rank[0]["steps"]
        ar_bytes = sum(c["comm"]["bytes"] for c in comm) / len(comm)
        ar_ms = 1e3 * sum(c["comm"]["seconds"] for c in comm) / len(comm)
        r = {"steps": len(steps), "losses": losses[0],
             "step_ms": step_ms,
             "examples_per_s_rank": sz["batch"] * 1e3 / step_ms,
             "examples_per_s_all": world * sz["batch"] * 1e3 / step_ms,
             "allreduce_bytes_per_step": ar_bytes,
             "allreduce_ms_per_step": ar_ms,
             "score_int8_merged": score,
             "eval_forwards_per_rank": [rr["eval_forwards"]
                                        for rr in per_rank],
             "peak_bytes_per_rank": [rr["peak_bytes"] for rr in per_rank]}
        out["routes"][route] = r
        log(f"  cli/finetune {route}: {len(steps)} steps of {sz['batch']} "
            f"a rank, losses " + " ".join(f"{x:.4f}" for x in losses[0])
            + f"; step {step_ms:.1f} ms after the first, "
            f"{r['examples_per_s_rank']:.1f} examples/s a rank, "
            f"{r['examples_per_s_all']:.1f} in all (the ranks share one "
            f"card: no multi-card scaling); all-reduce "
            f"{ar_bytes / 2**20:.1f} MiB and {ar_ms:.1f} ms a step; int8 "
            f"evaluation merged over the ranks, score {score:.4f}")
    # tensor parallelism
    tp = [r[1] for r in ranks]
    rel_bar, cos_bar = STEP_BARS["float32"]
    for i, tr in enumerate(tp):
        for k, n in tr["launches"].items():
            launches[k] += n
        n_calls = 2 * len(PT_TASKS)        # the check, then a step
        if device == "cuda":
            check_launches("pretrain pallas_blhd", tr["launches"], n_calls)
    out["tp"] = {"heads_per_rank": tp[0]["heads_per_rank"], "tasks": {}}
    for task, c in tp[0]["tasks"].items():
        ok = (math.isfinite(c["loss_tp"]) and c["loss_rel_diff"] < rel_bar
              and c["grad_cosine"] > cos_bar and c["same_params"])
        log(f"  tp=2 pre-training {task} (B={B}, fp32, {tp[0]['heads_per_rank']}"
            f" heads a rank): loss {c['loss_tp']:.6f} vs one process "
            f"{c['loss_single']:.6f} (relative {c['loss_rel_diff']:.2e}, "
            f"bar {rel_bar:g}), gradient cosine {c['grad_cosine']:.7f} "
            f"(bar {cos_bar}), {c['with_gradient']} parameters")
        if not ok:
            fail(f"(n) tp=2 {task}: {c}")
        out["tp"]["tasks"][task] = c
    tsteps = tp[0]["steps"]
    out["tp"]["step_ms"] = {s["task"]: max(t["steps"][j]["ms"] for t in tp)
                            for j, s in enumerate(tsteps)}
    out["tp"]["allreduce_bytes_per_step"] = {
        s["task"]: s["comm"]["bytes"] for s in tsteps}
    out["tp"]["allreduce_ms_per_step"] = {
        s["task"]: 1e3 * s["comm"]["seconds"] for s in tsteps}
    log("  tp=2 train_step ms (first step of each task, warm after the "
        "check): " + ", ".join(f"{t} {v:.1f} ({out['tp']['allreduce_bytes_per_step'][t] / 2**20:.1f} MiB all-reduced in "
                               f"{out['tp']['allreduce_ms_per_step'][t]:.1f} ms)"
                               for t, v in out["tp"]["step_ms"].items()))
    # the sharded feature table
    tables = [r[2] for r in ranks]
    if not all(t["bit_equal"] for t in tables):
        fail("(n) the sharded feature table's lookup differs from the "
             "unsharded one")
    out["table"] = {"rows_per_rank": [t["rows_here"] for t in tables],
                    "lookup_ms": max(t["lookup_ms"] for t in tables),
                    "unsharded_bytes": tables[0]["unsharded_bytes"]}
    log(f"  feature table: {sz['table_images']} images over {world} ranks "
        f"({out['table']['rows_per_rank']} rows), a lookup of "
        f"{sz['table_batch']} bit-equal to the unsharded table, "
        f"{out['table']['lookup_ms']:.2f} ms")
    # the pipeline
    p0 = pipe[0]
    S, M = sz["stages"], sz["micro"]
    err_bar = PIPE_RTOL + PIPE_RTOL * p0["out_max_abs"]
    if not (p0["out_max_abs_err"] <= err_bar and p0["same_params"]
            and p0["grad_cosine"] > PIPE_GRAD_COSINE
            and p0["grad_max_rel_err"] <= PIPE_GRAD_REL):
        fail(f"(n) pipeline against the sequential stack: {p0}")
    bubbles = [q["timings"][-1]["bubble"] for q in pipe]
    out["pipeline"] = {
        "stages": S, "micro": M, "layers_per_stage":
        [q["layers_here"] for q in pipe],
        "out_max_abs_err": p0["out_max_abs_err"],
        "grad_cosine": p0["grad_cosine"],
        "grad_max_rel_err": p0["grad_max_rel_err"],
        "forward_ms": max(q["timings"][-1]["forward_ms"] for q in pipe),
        "forward_backward_ms": max(q["timings"][-1]["forward_backward_ms"]
                                   for q in pipe),
        "bubble_per_stage": bubbles,
        "bubble_mean": sum(bubbles) / len(bubbles),
        "bubble_predicted": (S - 1) / (M + S - 1)}
    pl = out["pipeline"]
    log(f"  pipeline: {mcfg.l_layers} language layers over {S} stages, "
        f"M={M}, B={sz['pipe_batch']}, fp32: output max |d| "
        f"{pl['out_max_abs_err']:.2e}, gradient cosine "
        f"{pl['grad_cosine']:.7f} (max rel {pl['grad_max_rel_err']:.2e}); "
        f"forward {pl['forward_ms']:.1f} ms, forward+backward "
        f"{pl['forward_backward_ms']:.1f} ms; bubble measured "
        + ", ".join(f"{b:.3f}" for b in bubbles)
        + f" (mean {pl['bubble_mean']:.3f}) against (S-1)/(M+S-1) = "
        f"{pl['bubble_predicted']:.3f}, the stages sharing one card")
    out["launches"] = launches
    out["wall_s"] = time.time() - t_all
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
    kernels = port_kernels()
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
    # (n)'s tensor-parallel steps: H/2 heads a rank, with a generator of
    # their own (the cases above draw as they did before these existed)
    tp_rng = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    rows["mha_blhd_train"] += check_train_attention(
        torch, F, attention, cfg, tp_rng, log,
        cases=tp_train_attention_cases(cfg))
    for kind in TP_KINDS:
        n = sum(r["uses"].get(kind, 0) for r in rows["mha_blhd_train"])
        want = PER_FORWARD["pretrain pallas_blhd"]["mha_blhd_train"]
        if n != want:
            fail(f"mha_blhd_train: the kernel phase covers {n} launches of "
                 f"a {kind} step, the path makes {want}")
    log("  C1: fused_mha's gradients on the card against the CPU's; the "
        "forward-only kernels refuse a backward")
    grad_rows = check_fused_mha_grad(torch, attention, ffn, cfg, rng, log)
    sz = SAMPLE_SIZES
    log(f"  the int8 sampler's shapes (B={sz['batch']}, text {sz['text']}, "
        f"{sz['clusters']} clusters):")
    # after the checks above (as they ran before these cases existed),
    # with a generator of their own
    sample_rng = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    sample_rows = {
        "mha_blhd": check_attention(
            torch, F, attention, cfg, sample_rng, log,
            cases=sampler_attention_cases(cfg, sz["batch"], sz["text"])),
        "int8_dense": check_int8(
            torch, int8_matmul, quant, cfg, BATCH, 3129, sample_rng, log,
            cases=sampler_dense_cases(cfg, sz["batch"], sz["text"],
                                      sz["clusters"]))}
    sample_times = {}
    for name, kernel_rows in sample_rows.items():
        sampler_cases_cover_launches(name, kernel_rows, cfg)
        sample_times[name] = t = per_forward(
            kernel_rows, mix, tuple(sampler_launches(cfg)))
        log(f"  {name} in the int8 sampler (ms): " + "; ".join(
            f"{kind} kernel {v['ms']:.4f} plain {v['plain_ms']:.4f} bound "
            f"{v['bound_ms']:.4f}" for kind, v in t.items()))
    times = {}
    for name, kernel_rows in rows.items():
        launches_per_kind(name, kernel_rows)
        times[name] = per_forward(kernel_rows, mix, KINDS[name] + (
            TP_KINDS if name == "mha_blhd_train" else []))
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
            if t["library_enqueue_ms"] is not None:
                composed += ("  library back to back "
                             f"{t['library_enqueue_ms']:.4f}")
            if t["int_mm_ms"] is not None:
                composed += (f"  _int_mm {t['int_mm_ms']:.4f} (kernel "
                             f"{t['int_mm_kernel_ms']:.4f} at its shapes)")
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
    del setup
    torch.cuda.empty_cache()
    log(f"(j) text-to-image: full width, {sz['clusters']} random centroids, "
        f"B={sz['batch']}, text {sz['text']}, {sz['batches']} batches a run "
        f"through cli/sample_images ({card})")
    t0 = time.time()
    sample = run_sample_path(torch, args, kernels, log, card=card)
    sample["wall_s"] = time.time() - t0
    log(f"  phase (j) took {sample['wall_s']:.1f}s")
    torch.cuda.empty_cache()
    gz = GAN_SIZES
    log(f"(k) GAN training: measure_gan's widths (G base {gz['g_base']}, D "
        f"base {gz['d_base']}, {gz['target']} px, {gz['classes']} "
        f"centroids, B={gz['batch']}, bf16) through cli/train_generator "
        f"({card})")
    t0 = time.time()
    gan = run_gan_path(torch, args, kernels, log, card=card)
    gan["wall_s"] = time.time() - t0
    log(f"  phase (k) took {gan['wall_s']:.1f}s")
    torch.cuda.empty_cache()
    fz = FACTORY_SIZES
    log(f"(l) the offline feature factory: k-means at N={fz['rows']}, "
        f"K={fz['clusters']}, D={fz['dim']}; the X-152-32x8d-FPN grid "
        f"extractor at B={fz['grid_batch']}, {fz['canvas']}; the bbox path "
        f"at B={fz['bbox_batch']}, {fz['proposals']} proposals, "
        f"{fz['classes']} classes; random weights ({card})")
    t0 = time.time()
    factory = run_factory_path(torch, args, kernels, log, card=card)
    factory["wall_s"] = time.time() - t0
    log(f"  phase (l) took {factory['wall_s']:.1f}s")
    torch.cuda.empty_cache()
    mz = FID_SIZES
    log(f"(m) FID: InceptionV3 (1,008 classes) and ResNet-50 in fp32 "
        f"through cli/eval_fid at B={mz['batch']}, {mz['images']} + "
        f"{mz['images']} host images at {mz['size']} px; random weights "
        f"({card})")
    t0 = time.time()
    fid = run_fid_path(torch, args, kernels, log, card=card)
    fid["wall_s"] = time.time() - t0
    log(f"  phase (m) took {fid['wall_s']:.1f}s")
    torch.cuda.empty_cache()
    dz = DIST_SIZES
    log(f"(n) distributed training: {dz['ranks']} ranks through "
        f"cli/finetune (B={dz['batch']} a rank, both routes, int8 eval "
        f"merged), tp=2 pre-training per task, the sharded feature table; "
        f"a {dz['stages']}-stage pipeline of the language layers "
        f"(M={dz['micro']}); full width, random weights ({card})")
    dist = run_distributed_path(torch, args, kernels, log, card=card)
    log(f"  phase (n) took {dist['wall_s']:.1f}s")
    paths = {"int8": path, **bf16_paths, "int8+fused_block": fused_path,
             "finetune": ft, "layout": layout, "pretrain": pt,
             "sample": sample, "gan": gan, "factory": factory, "fid": fid,
             "distributed": dist}

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
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                               + sample_rows.get(name, [])),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            # no single PyTorch call quantizes, multiplies in int8 and
            # dequantizes; fused_block's is its chain with torch._int_mm
            "library_ms": t["library_ms"],
            # int8_dense: torch._int_mm's product alone, over the shapes
            # it takes (not the answer heads)
            **({"int_mm_ms": t["int_mm_ms"]} if name == "int8_dense"
               else {})})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": device_name, "nvidia_smi": card,
                   "build_s": build_s, "kernel_rows": rows,
                   "fused_mha_grad": grad_rows,
                   "per_forward": times, "paths": paths,
                   "sample_kernel_rows": sample_rows,
                   "per_sample_kind": sample_times,
                   "kernels": summary,
                   "note": "times in 'kernels' are per serving forward at "
                           "B=256, weighted by VQA_LENGTH_MIX ('mix' in "
                           "'per_forward'; the attention kernels, SDPA, "
                           "int8_dense, its plain version and _int_mm, "
                           "fused_ffn, fused_block, their plain versions "
                           "and library chains with the queue kept full, "
                           "the kernels' back-to-back "
                           "times as enqueue_ms, SDPA's as "
                           "library_enqueue_ms; int8_dense's int_mm_ms "
                           "over the shapes _int_mm takes), "
                           "mha_blhd_train's per VQA "
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

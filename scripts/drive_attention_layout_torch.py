"""Attention-core layout variants in the port's int8 serving engine (port
of scripts/drive_attention_layout.py), timed on one GPU.

Variants, each swapped in for `serving/lxmert_int8._attention_core`:
  base     the engine's einsum route (bhqk scores), plain PyTorch
  bqhk     reordered einsums (bqhk scores), plain PyTorch
  pallasN  ops/attention.mha_blhd (csrc/mha_blhd.cu): one CTA per
           (batch row, head)
  hbatchN  ops/attention.mha_hbatch (csrc/mha_hbatch.cu): every head of
           a batch row in one CTA, the TPU kernel's batched contraction
N is the TPU kernels' VMEM batch block. It has no counterpart on the
card, where each kernel picks its own CTA shape: it is accepted, so the
variant names match the JAX driver's, and ignored.

Random full-width weights from --seed (LxmertConfig(), 3,129 answers),
static int8 calibration on a batch of 8 through the default route, then
for each variant: its logits on one batch against the first variant's
(max |d| and argmax agreement), and the best of --repeats timings of
--scan_k forwards chained on the device (each forward's features depend
on the previous forward's logits, as the JAX driver's lax.scan chains
them), ended by one torch.cuda.synchronize().

    python scripts/drive_attention_layout_torch.py --variants base,hbatch32
    python scripts/drive_attention_layout_torch.py --bf16

--bf16 times the port's bf16 model (models.lxmert.ServingOptions) on its
einsum route and its packed-head kernel route instead.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_ANSWERS = 3129
CALIB_BATCH = 8
V = 64


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--scan_k", type=int, default=20)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--variants", default="base,bqhk,pallas32,hbatch32")
    p.add_argument("--bf16", action="store_true",
                   help="time the bf16 model instead: its einsum route "
                        "against its packed-head kernel route")
    p.add_argument("--text_len", type=int, default=20,
                   help="question length (bucketed-serving shapes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def bqhk_core(q, k, v, bias, n_heads):
    """The reordered einsums: bqhk scores, the bias broadcast over
    (B, Lq, H, Lk), softmax in bf16, p.v in bf16."""
    import numpy as np
    import torch

    from xlxmert_tpu_torch.ops.attention import softmax_last

    B, Lq, HD = q.shape
    Lk = k.shape[1]
    D = HD // n_heads
    qh = q.reshape(B, Lq, n_heads, D)
    kh = k.reshape(B, Lk, n_heads, D)
    vh = v.reshape(B, Lk, n_heads, D)
    s = torch.einsum("bqhd,bkhd->bqhk", qh, kh)
    s = s * torch.full((), 1.0 / np.sqrt(D), dtype=s.dtype, device=s.device)
    if bias is not None:
        s = s + bias  # (B, 1, 1, Lk) broadcasts over (B, Lq, H, Lk) too
    p = softmax_last(s).to(torch.bfloat16)
    return torch.einsum("bqhk,bkhd->bqhd", p, vh).reshape(B, Lq, HD)


def variant_core(name: str):
    """The attention core of a variant name."""
    from xlxmert_tpu_torch.ops.attention import mha_blhd, mha_hbatch
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine

    if name == "base":
        return engine.einsum_core
    if name == "bqhk":
        return bqhk_core
    for prefix, fn in (("pallas", None), ("hbatch", mha_hbatch)):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            if fn is None:
                return lambda q, k, v, bias, n_heads: mha_blhd(
                    q, k, v, bias, n_heads, fast=True)
            return fn
    raise ValueError(f"unknown variant {name!r}: base, bqhk, pallasN or "
                     "hbatchN")


def _inputs(torch, cfg, B, L, K, seed, device):
    """(ids, mask, feats, pos, stacked): all-ones questions of length L,
    normal(0, 0.1) bf16 grid features for one batch and for K chained
    forwards, the 8x8 grid's boxes."""
    from xlxmert_tpu_torch.utils.boxes import box_position

    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.ones(B, L, dtype=torch.long, device=device)
    mask = torch.ones(B, L, device=device)
    feats = torch.randn(B, V, cfg.visual_feat_dim, generator=gen,
                        device=device).to(torch.bfloat16) * 0.1
    pos = torch.from_numpy(box_position(8)).to(device, torch.bfloat16)[
        None].expand(B, V, 4)
    stacked = torch.randn(K, B, V, cfg.visual_feat_dim, generator=gen,
                          device=device).to(torch.bfloat16) * 0.1
    return ids, mask, feats, pos, stacked


def _best_qps(torch, run, B, K, repeats, device):
    """run(seed) chains K forwards; the best of `repeats` timed runs
    after one warm-up, each ended by one synchronize."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    run(0.0)
    sync()
    best = 0.0
    for r in range(repeats):
        t0 = time.perf_counter()
        run(r + 1.0)
        sync()
        best = max(best, B * K / (time.perf_counter() - t0))
    return best


def run_int8(args, kernels=(), log=print, cfg=None):
    """The int8 engine through each of args.variants. Returns {"calib":
    {"forwards", "launches"}, "variants": {name: {"max_abs_diff",
    "argmax_agree", "qps", "forwards", "launches"}}}; launches are each
    kernel of `kernels`' count over the variant's forwards (counts set
    to 0 just before)."""
    import torch

    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = cfg or LxmertConfig()
    B, L, K, H = args.batch, args.text_len, args.scan_k, \
        cfg.num_attention_heads
    names = [n.strip() for n in args.variants.split(",") if n.strip()]
    cores = {n: variant_core(n) for n in names}
    log("variants: the N of pallasN/hbatchN is the TPU kernels' VMEM "
        "batch block; on the card each kernel picks its own CTA shape, "
        "so N is ignored")
    t0 = time.time()
    bert, head = engine.random_params(cfg, N_ANSWERS, seed=args.seed)
    qp = engine.prepare_params(bert, cfg, device)
    hqp = engine.prepare_answer_head(head, device)
    ids, mask, feats, pos, stacked = _inputs(torch, cfg, B, L, K, args.seed,
                                             device)
    log(f"random weights and inputs {time.time() - t0:.1f}s")

    def counts():
        return {k.name: k.launches for k in kernels}

    def reset():
        for k in kernels:
            k.launches = 0

    reset()
    calib = [(ids[:CALIB_BATCH], feats[:CALIB_BATCH].float(),
              pos[:CALIB_BATCH], mask[:CALIB_BATCH])]
    sites = engine.calibrate(qp, hqp, calib, cfg)
    engine.apply_calibration(qp, hqp)
    engine.assert_fully_calibrated(qp, hqp)
    out = {"calib": {"forwards": len(calib), "launches": counts()},
           "variants": {}}
    log(f"calibrated {len(sites)} sites on a batch of {CALIB_BATCH}")

    @torch.inference_mode()
    def logits_once():
        _, _, pooled = engine.lxmert_forward(qp, ids, feats, pos,
                                             attention_mask=mask, n_heads=H)
        return engine.answer_head_forward(hqp, pooled)

    @torch.inference_mode()
    def chained(seed):
        carry = torch.full((), seed, dtype=torch.bfloat16, device=device)
        for f in stacked:
            _, _, pooled = engine.lxmert_forward(
                qp, ids, f + carry * 1e-6, pos, attention_mask=mask,
                n_heads=H)
            logits = engine.answer_head_forward(hqp, pooled)
            carry = carry + logits.mean().to(torch.bfloat16)
        return carry

    default_core, ref = engine._attention_core, None
    for name in names:
        engine._attention_core = cores[name]
        try:
            reset()
            t0 = time.time()
            lg = logits_once().cpu()
            if ref is None:
                ref, dev, agree = lg, 0.0, None
            else:
                dev = float((lg - ref).abs().max())
                agree = float((lg.argmax(-1) == ref.argmax(-1)).float()
                              .mean())
            log(f"[{name}] logits check {time.time() - t0:.1f}s "
                f"max|d|={dev:.4f} argmax-agree={agree}")
            qps = _best_qps(torch, chained, B, K, args.repeats, device)
            forwards = 1 + K * (args.repeats + 1)
            log(f"[{name}] {qps:.1f} q/s (best of {args.repeats}, K={K}, "
                f"B={B}, L={L})")
        finally:
            engine._attention_core = default_core
        out["variants"][name] = {"max_abs_diff": dev, "argmax_agree": agree,
                                 "qps": qps, "forwards": forwards,
                                 "launches": counts(), "logits": lg}
    log("== summary ==")
    for name, r in sorted(out["variants"].items(), key=lambda kv: -kv[1][
            "qps"]):
        log(f"  {name:<10} {r['qps']:10.1f} q/s")
    return out


def run_bf16(args, log=print, cfg=None):
    """The bf16 model on its einsum route and its packed-head kernel
    route: {route: q/s}."""
    import torch

    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.models.lxmert import ServingOptions
    from xlxmert_tpu_torch.models.task_heads import vqa_model
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = cfg or LxmertConfig()
    B, L, K = args.batch, args.text_len, args.scan_k
    bert, head = engine.random_params(cfg, N_ANSWERS, seed=args.seed)
    ids, mask, _, pos, stacked = _inputs(torch, cfg, B, L, K, args.seed,
                                         device)
    out = {}
    for route in ("einsum", "blhd"):
        model = vqa_model({"bert": bert, "answer_head": head}, cfg,
                          N_ANSWERS, dtype=torch.bfloat16,
                          options=ServingOptions(True, route),
                          device=device)

        @torch.inference_mode()
        def chained(seed):
            carry = torch.full((), seed, dtype=torch.bfloat16,
                               device=device)
            for f in stacked:
                logits = model(ids, f + carry * 1e-6, pos,
                               attention_mask=mask)
                carry = carry + logits.mean().to(torch.bfloat16)
            return carry

        out[route] = _best_qps(torch, chained, B, K, args.repeats, device)
        log(f"[bf16/{route}] {out[route]:.1f} q/s (best of {args.repeats}, "
            f"K={K}, B={B}, L={L})")
        del model
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.bf16:
        run_bf16(args)
    else:
        from xlxmert_tpu_torch.ops import attention, int8_matmul

        res = run_int8(args, [attention.KERNEL, attention.HBATCH_KERNEL,
                              int8_matmul.KERNEL])
        for name, r in res["variants"].items():
            per = {k: n / r["forwards"] for k, n in r["launches"].items()}
            print(f"  {name:<10} launches per forward: "
                  + ", ".join(f"{k} {n:g}" for k, n in per.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

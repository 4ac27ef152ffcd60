#!/usr/bin/env python3
"""How far the int8 sampler's decode step moves when one of its bf16
values moves by one step, and how often the card and the CPU round its
ops differently.

    python3 scripts/sampler_int8_sensitivity.py [--seed 0] [--sentences 8]
        [--fractions 1e-6,1e-5,1e-4,1e-3] [--device cpu|cuda]
        [--out runs/sampler_int8_sensitivity.json]

On the CPU (plain versions), at full width (LxmertConfig(), 10,000
random centroids randn x 0.1, random weights from --seed, as chip_smoke
phase (j) builds them): the step-0 (all cells masked) cluster logits of
--sentences random sentences, then the same with a share --fractions of
every attention output moved up by one bf16 step; prints the cosine of
the two and the share of cells whose argmax is one of the unmoved
logits' tied maxima (chip_smoke.tie_aware_agreement). With --device
cuda, also the share of bf16 outputs where the card and the CPU differ
for tanh-gelu and LayerNorm on (4096, 768) inputs, and for the
packed-head attention kernel against its plain version at the sampler's
four shapes (B=64).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sentences", type=int, default=8)
    p.add_argument("--fractions", default="1e-6,1e-5,1e-4,1e-3")
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    p.add_argument("--out", default=os.path.join(
        "runs", "sampler_int8_sensitivity.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving import sampling_int8 as si
    from xlxmert_tpu_torch.tasks import sampling

    cfg = LxmertConfig()
    B = args.sentences
    cent = (np.random.RandomState(args.seed).randn(
        cfg.num_clusters, cfg.visual_feat_dim).astype(np.float32) * 0.1)
    table = torch.from_numpy(cent)
    sp = si.prepare_sampler_params(sampling.random_params(cfg, args.seed),
                                   cfg, cent, "cpu")
    rng = np.random.RandomState(args.seed)
    ids = torch.from_numpy(rng.randint(5, 4005, (B, 20))).long()
    ids[:, 12:] = 0
    mask = (ids > 0).float()
    si.calibrate_sampler(sp, table, ids, mask, cfg)
    engine.apply_calibration(sp)
    pos = sampling.grid_positions(8, B, "cpu", torch.bfloat16)
    feats = sp.mask_feat[None, None].expand(B, 64, -1).contiguous()
    orig = engine._attention_core
    out = {"device": args.device, "perturbed": {}, "card_vs_cpu": {}}
    with torch.inference_mode():
        base = si._predict_forward(sp, ids, feats, pos, mask,
                                   cfg.num_attention_heads)
        for frac in (float(f) for f in args.fractions.split(",")):
            gen = torch.Generator().manual_seed(args.seed + 1)

            def moved(q, k, v, bias, n_heads, frac=frac, gen=gen):
                o = orig(q, k, v, bias, n_heads)
                up = torch.nextafter(o, torch.full_like(o, float("inf")))
                return torch.where(torch.rand(o.shape, generator=gen)
                                   < frac, up, o)

            engine._attention_core = moved
            try:
                got = si._predict_forward(sp, ids, feats, pos, mask,
                                          cfg.num_attention_heads)
            finally:
                engine._attention_core = orig
            row = {"cosine": chip_smoke.cosine(base, got),
                   "argmax_agree": chip_smoke.tie_aware_agreement(base, got),
                   "per_sentence": [chip_smoke.tie_aware_agreement(
                       base[b], got[b]) for b in range(B)]}
            out["perturbed"][frac] = row
            print(f"one bf16 step on {frac:g} of the attention outputs: "
                  f"cosine {row['cosine']:.6f}, argmax agreement "
                  f"{row['argmax_agree']:.3f} (per sentence "
                  + ", ".join(f"{a:.2f}" for a in row["per_sentence"])
                  + ")", flush=True)
    if args.device == "cuda":
        from xlxmert_tpu_torch.ops import attention

        def differ(a, b):
            return float((a.cpu() != b.cpu()).float().mean())

        g = torch.Generator().manual_seed(args.seed)
        x = (torch.randn(4096, 768, generator=g) * 2).to(torch.bfloat16)
        ln = engine.LayerNorm({"scale": np.ones(768, np.float32),
                               "bias": np.zeros(768, np.float32)})
        cmp = out["card_vs_cpu"]
        cmp["layer_norm"] = differ(engine.layer_norm(x.cuda(), ln.cuda()),
                                   engine.layer_norm(x, ln.cpu()))
        cmp["gelu_tanh"] = differ(F.gelu(x.cuda(), approximate="tanh"),
                                  F.gelu(x, approximate="tanh"))
        for lq, lk, with_bias in ((20, 20, True), (64, 64, False),
                                  (20, 64, False), (64, 20, True)):
            q, k, v = (torch.randn(64, n, 768, generator=g).to(
                torch.bfloat16) for n in (lq, lk, lk))
            bias = None
            if with_bias:
                keep = torch.rand(64, lk, generator=g) > 0.3
                keep[:, 0] = True
                bias = ((1.0 - keep.float()) * -1e9)[:, None, None, :].to(
                    torch.bfloat16)
            kernel = attention.mha_blhd(
                q.cuda(), k.cuda(), v.cuda(),
                None if bias is None else bias.cuda(), 12, True)
            plain = attention.mha_blhd_reference(q, k, v, bias, 12, True)
            cmp[f"mha_blhd {lq}x{lk}"] = differ(kernel, plain)
        print("share of bf16 outputs where the card and the CPU differ: "
              + ", ".join(f"{k} {v:.2e}" for k, v in cmp.items()),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"cosine": {k: v["cosine"]
                                 for k, v in out["perturbed"].items()},
                      "argmax_agree": {k: v["argmax_agree"] for k, v in
                                       out["perturbed"].items()},
                      "card_vs_cpu": out["card_vs_cpu"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

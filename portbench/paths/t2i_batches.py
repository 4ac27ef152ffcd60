"""Text-to-image batches: cli/sample_images' int8 NAR sampler and the
SPADE render, one batch of captions at a time, for the window's seconds.

Set-up: the X-LXMERT weights, the centroid table and the generator from
the seed on the card; the caption pool (token ids drawn directly,
padded to the longest length); the sampler built and calibrated by
`cli/sample_images.build_sampler` (its calibration batch drawn evenly
across the pool, as the CLI does), the generator built at
`build_renderer`'s sizes with the seed's weights; one batch warmed up.
The window: each batch's ids to the card, the sampler's `run(ids,
mask)`, `models/gan.render` of its code, the images copied as float32 into a
pinned host buffer the client reuses (a fresh pageable copy a batch
page-faults 50 MB on the host each time, which spread the runs); a
batch's latency runs from its ids handed over to its images in host
memory. After the window: the sampled batches' decode
steps through the plain reference, teacher-forced on the program's own
step inputs (the widest gap by which a committed cluster's reference
logit lies below the reference's best), every step's input checked
against the clusters served before it (cells that do not follow), and
the images against the plain render of the served clusters (the root
mean square of the pixels' differences).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List

import numpy as np

from portbench.lib import host as host_lib
from portbench.lib import traffic as traffic_lib
from portbench.lib import weights
from portbench.lib.trace import Slice

# seed streams of one run: generator, the check's sample
GENERATOR, SAMPLE = 4, 5


class PoolTokenizer:
    """The CLI's tokenizer interface over the pre-tokenized pool: a
    "sentence" is a pool row's index."""

    def __init__(self, ids: np.ndarray):
        self.ids = ids

    def encode_batch(self, sentences, max_len: int) -> np.ndarray:
        out = np.zeros((len(sentences), max_len), np.int64)
        for i, s in enumerate(sentences):
            if s:
                row = self.ids[int(s)]
                out[i, :min(max_len, row.shape[0])] = row[:max_len]
        return out


def make_inputs(ctx) -> Dict:
    torch, dev, s = ctx.torch, ctx.device, ctx.cell.sizes
    seed = ctx.args.seed
    spec = weights.lxmert_spec(s) + weights.object_head_spec(s)
    leaves, flat = weights.make(spec, seed, s["initializer_range"], dev,
                                torch)
    gleaves, _ = weights.make(weights.generator_spec(s),
                              weights.sub_seed(seed, GENERATOR),
                              s["initializer_range"], dev, torch)
    weights.converge_spectral_norms(gleaves, torch)
    tr = traffic_lib.generate(ctx.cell.traffic, seed, s["vocab_size"])
    return {"leaves": leaves, "flat": flat, "gleaves": gleaves,
            "traffic": tr}


def calibration_rows(n_pool: int, batch: int) -> np.ndarray:
    """The pool rows `cli/sample_images.calibration_ids` picks: evenly
    across the stream."""
    return np.linspace(0, n_pool - 1, num=min(n_pool, batch), dtype=int)


def build_program(ctx, inp: Dict, on_step):
    torch, dev, s, wl = ctx.torch, ctx.device, ctx.cell.sizes, \
        ctx.cell.workload
    from xlxmert_tpu_torch.cli import sample_images as si
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.models.gan import Generator

    if dev.type == "cuda":
        from xlxmert_tpu_torch.ops import attention, int8_matmul
        from xlxmert_tpu_torch.ops._build import build_all

        build_all([int8_matmul.KERNEL, attention.KERNEL], verbose=False)
    fields = LxmertConfig.__dataclass_fields__
    cfg = LxmertConfig(**{k: v for k, v in s.items() if k in fields})
    tree = weights.host_tree(inp["leaves"], inp["flat"], torch)
    tr = inp["traffic"]
    ns = argparse.Namespace(
        int8=True, sample_mode=wl["sample_mode"],
        sample_steps=wl["sample_steps"],
        position_strategy=wl["position_strategy"],
        batch_size=int(ctx.cell.traffic["batch"]),
        max_text_length=s["max_text_length"], grid_size=s["grid_size"],
        save_intermediate=False, fast_render=False,
        g_base_dim=s["g_base_dim"], target_size=s["target_size"],
        codebook_dim=s["codebook_dim"])
    inputs = {"cfg": cfg,
              "params": {"bert": tree["bert"],
                         "obj_predict_head": tree["obj_predict_head"],
                         "mask_feat": tree["mask_feat"]},
              "centroids": tree["centroids"],
              "sentences": [str(i) for i in range(tr.ids.shape[0])],
              "tokenizer": PoolTokenizer(tr.ids)}
    run, _ = si.build_sampler(ns, inputs, dev, on_step)
    gen = Generator(emb_dim=s["visual_feat_dim"], base_dim=ns.g_base_dim,
                    target_size=ns.target_size, init_H=ns.grid_size,
                    init_W=ns.grid_size, codebook_dim=ns.codebook_dim,
                    dtype=torch.bfloat16, mod_cap=None)
    gen.load_state_dict(inp["gleaves"])
    return run, gen.to(dev).eval()


class Keep:
    """The sampler's step hook: keeps the step inputs and cluster logits
    of the batch being kept (references only: no device work)."""

    def __init__(self):
        self.current = None
        self.steps: Dict[int, List] = {}

    def __call__(self, i, inputs, logits):
        if self.current is not None:
            self.steps.setdefault(self.current, []).append(
                (inputs["feats"], inputs["vis_mask"], logits))


def run(ctx) -> Dict:
    torch, dev, rec = ctx.torch, ctx.device, ctx.record
    wl, seconds = ctx.cell.workload, float(ctx.args.seconds)
    from xlxmert_tpu_torch.models import gan

    inp = make_inputs(ctx)
    tr = inp["traffic"]
    host = traffic_lib.host_batches(tr, torch, pin=dev.type == "cuda")
    keep = Keep()
    t_inputs = time.perf_counter()
    sampler, gen = build_program(ctx, inp, keep)
    t_program = time.perf_counter()
    rng = np.random.default_rng(weights.sub_seed(ctx.args.seed, SAMPLE))
    within = int(wl["sample_within"])
    sampled = sorted(int(p) for p in rng.choice(
        np.arange(1, within + 1), size=wl["sample_batches"], replace=False))
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    traced = bool(ctx.args.trace)
    sl = Slice(torch, traced, wl["trace_slice_s"])

    # the client's buffer the images land in: host memory, reused from
    # batch to batch (pinned on the card's host)
    S = ctx.cell.sizes["target_size"]
    fetch = torch.empty((int(ctx.cell.traffic["batch"]), S, S, 3),
                        dtype=torch.float32, pin_memory=dev.type == "cuda")

    def batch(i):
        ids = host[i][0].to(dev, non_blocking=True)
        t0 = time.perf_counter()
        with sl.span("sample"):
            code, cluster_ids, _ = sampler(ids, (ids > 0).float())
        t1 = time.perf_counter()
        with sl.span("render"):
            images = gan.render(gen, code).float()
        with sl.span("fetch"):
            fetch.copy_(images, non_blocking=True)
            sync()
        return code, cluster_ids, t1 - t0

    batch(0)
    sync()
    rec.setup_s = time.perf_counter() - ctx.t_start
    print(f"set-up: python, torch and the card "
          f"{ctx.t_torch - ctx.t_start:.2f} s, the inputs "
          f"{t_inputs - ctx.t_torch:.2f} s, the program "
          f"{t_program - t_inputs:.2f} s, warm-up "
          f"{time.perf_counter() - t_program:.2f} s", file=sys.stderr)

    n = len(host)
    before = host_lib.probe_ms()
    kept: Dict[int, Dict] = {}
    latency: List[float] = []
    k = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while time.perf_counter() < deadline:
        now = time.perf_counter() - t_start
        if sl.due():    # a traced run's window ends with its slice
            sl.end()
            break
        if now >= seconds * wl["trace_at"]:
            sl.begin()
        keep.current = k if k in sampled else None
        ts = time.perf_counter()
        code, cluster_ids, sample_s = batch(k % n)
        latency.append(time.perf_counter() - ts)
        if sl.active:
            rec.slice_work.append(int(fetch.shape[0]))
        else:   # the host's spans are taken before the traced slice
            rec.span("sample", sample_s)
            rec.paced.append((time.perf_counter(), int(fetch.shape[0])))
        if keep.current is not None:
            kept[k] = {"code": code, "ids": cluster_ids,
                       "images": fetch.clone(),
                       "steps": keep.steps.pop(k, [])}
        k += 1
    sl.end()
    t_end = time.perf_counter()
    host_lib.report(before, rec.spans)
    keep.current = None
    B = int(ctx.cell.traffic["batch"])
    rec.window = {"t0": t_start, "t1": t_end, "samples": k * B,
                  "latency_s": latency}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del batch, sampler, gen, host
    inp["flat"] = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sl.reduce()
    rec.trace = sl.summary
    complete = all(p in kept for p in sampled)
    checks = judge(ctx, inp, {p: kept[p] for p in sampled if p in kept})
    correct = complete and all(v["value"] <= v["limit"]
                               for v in checks.values())
    return {"correct": correct, "attempted": k * B, "failed": 0,
            "memory_peak_bytes": peak, "checks": checks}


def nar_mask_counts(n_steps: int, n_cells: int) -> List[int]:
    return [((n_steps - i) * n_cells) // n_steps for i in range(n_steps)]


def reference_model(ctx, inp: Dict, bits: int):
    """The plain reference at `bits`, calibrated as the sampler is: on
    the CLI's calibration captions, over code grids all masked, half and
    a tenth masked (serving/sampling_int8's draws, numpy seed 0)."""
    from portbench.reference.lxmert import QuantLxmert, box_position

    torch, dev, s = ctx.torch, ctx.device, ctx.cell.sizes
    lv, tr = inp["leaves"], inp["traffic"]
    B = int(ctx.cell.traffic["batch"])
    G = s["grid_size"]
    n_cells = G * G
    ref = QuantLxmert(lv, s["num_attention_heads"], bits)
    pos = box_position(G).to(dev)
    ids = torch.from_numpy(tr.ids[calibration_rows(tr.ids.shape[0], B)]
                           [:, :s["max_text_length"]]).to(dev)
    mask = (ids > 0).float()
    table = lv["centroids"].to(torch.bfloat16)
    mask_feat = lv["mask_feat"].to(torch.bfloat16)
    rng = np.random.RandomState(0)
    cells = rng.randint(0, table.shape[0], (ids.shape[0], n_cells))
    codes = table[torch.from_numpy(cells).to(dev)]
    batches = []
    for frac in (1.0, 0.5, 0.1):
        m = torch.from_numpy(rng.rand(ids.shape[0], n_cells) < frac).to(dev)
        batches.append((torch.where(m[..., None], mask_feat, codes).float(),))

    def forward(feats):
        lang, lang_bias = ref.lang_encode(ids, mask)
        ref.cluster_logits(lang, lang_bias, feats, pos)

    ref.calibrate(forward, batches)
    return ref, pos, table, mask_feat


def judge(ctx, inp: Dict, kept: Dict[int, Dict]) -> Dict:
    """The comparison of `correct` over the kept batches."""
    from portbench.reference.lxmert import tf32_off
    from portbench.reference.spade import Render

    torch, dev, s, wl = ctx.torch, ctx.device, ctx.cell.sizes, \
        ctx.cell.workload
    tr = inp["traffic"]
    n_steps = wl["sample_steps"]
    n_cells = s["grid_size"] ** 2
    counts = nar_mask_counts(n_steps, n_cells)
    step_gap, mismatch, sq, n_px = 0.0, 0, 0.0, 0
    with tf32_off(), torch.inference_mode():
        ref, pos, table, mask_feat = reference_model(ctx, inp, 8)
        render = Render(inp["gleaves"], s)
        for p, out in kept.items():
            b = tr.batches[p % len(tr.batches)]
            ids = torch.from_numpy(tr.ids[b.rows, :b.length]).to(dev)
            lang, lang_bias = ref.lang_encode(ids, (ids > 0).float())
            served = None
            steps = out["steps"]
            mismatch += abs(len(steps) - n_steps) * ids.shape[0] * n_cells
            for i, (feats, vis_mask, logits) in enumerate(steps):
                vm = vis_mask.bool()
                prior = (mask_feat.expand(feats.shape) if served is None
                         else table[served])
                expect = torch.where(vm[..., None], mask_feat, prior)
                mismatch += int((feats != expect).any(-1).sum())
                mismatch += int((vm.sum(-1) != counts[min(i, n_steps - 1)])
                                .sum())
                got = logits.float().argmax(-1)
                r = ref.cluster_logits(lang, lang_bias, feats.float(), pos)
                gap = r.amax(-1) - r.gather(-1, got[..., None])[..., 0]
                if bool(vm.any()):
                    step_gap = max(step_gap, float(gap[vm].max()))
                served = got if served is None else torch.where(vm, got,
                                                                served)
            if served is None:
                continue
            mismatch += int((out["ids"] != served).sum())
            mismatch += int((out["code"] != table[served]).any(-1).sum())
            img = render(inp["leaves"]["centroids"][served])
            diff = out["images"].to(dev).float() - img
            sq += float((diff * diff).sum())
            n_px += diff.numel()
    limits = wl["limits"]
    return {name: {"value": v, "limit": limits[name]} for name, v in (
        ("step_gap", step_gap), ("transition_mismatch", mismatch),
        ("render_rms", (sq / max(n_px, 1)) ** 0.5))}


def control(ctx, bits: int = 4) -> Dict:
    """The control: the plain reference with its products at `bits`
    (int4, below the sampler's int8) and its render's convolutions in
    fp8 e4m3 (below the render's bf16), run as the program's NAR sampler
    on the batches a run would sample, judged by `judge`."""
    from portbench.reference.lxmert import tf32_off
    from portbench.reference.spade import Render

    torch, dev, s, wl = ctx.torch, ctx.device, ctx.cell.sizes, \
        ctx.cell.workload
    inp = make_inputs(ctx)
    tr = inp["traffic"]
    n_steps, n_cells = wl["sample_steps"], s["grid_size"] ** 2
    counts = nar_mask_counts(n_steps, n_cells)
    rng = np.random.default_rng(weights.sub_seed(ctx.args.seed, SAMPLE))
    within = int(wl["sample_within"])
    sampled = sorted(int(p) for p in rng.choice(
        np.arange(1, within + 1), size=wl["sample_batches"], replace=False))
    kept = {}
    with tf32_off(), torch.inference_mode():
        low, pos, table, mask_feat = reference_model(ctx, inp, bits)
        render = Render(inp["gleaves"], s, fp8=True)
        for p in sampled:
            b = tr.batches[p % len(tr.batches)]
            ids = torch.from_numpy(tr.ids[b.rows, :b.length]).to(dev)
            lang, lang_bias = low.lang_encode(ids, (ids > 0).float())
            B = ids.shape[0]
            prob = torch.zeros(B, n_cells, device=dev)
            code = torch.zeros(B, n_cells, table.shape[1], device=dev,
                               dtype=torch.bfloat16)
            cid = torch.zeros(B, n_cells, dtype=torch.long, device=dev)
            steps = []
            for i in range(n_steps):
                order = torch.argsort(prob, dim=-1, stable=True)
                vm = torch.argsort(order, dim=-1, stable=True) < counts[i]
                feats = torch.where(vm[..., None], mask_feat, code)
                logits = low.cluster_logits(lang, lang_bias, feats.float(),
                                            pos)
                steps.append((feats, vm, logits))
                prob = torch.exp(logits.amax(-1)
                                 - torch.logsumexp(logits, -1))
                pred = logits.argmax(-1)
                code = torch.where(vm[..., None], table[pred], code)
                cid = torch.where(vm, pred, cid)
            kept[p] = {"code": code, "ids": cid, "steps": steps,
                       "images": render(code).cpu()}
        del low
    return {k: v["value"] for k, v in judge(ctx, inp, kept).items()}

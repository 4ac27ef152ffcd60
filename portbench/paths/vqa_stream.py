"""The VQA stream: cli/serve's serving forward over a cycled question
pool, a fixed number of batches dispatched ahead of the oldest one's
answer fetch, for the window's seconds.

Set-up: the weights and the feature catalog from the seed on the card;
the pool tokenized (token ids drawn directly) and routed by bucket;
the engine prepared and calibrated as `cli/serve.serve` does it (256
pool rows sampled across the stream, batches of 8 at the longest
length), turned into the fused tree where the cell says so; one batch
of each length warmed up. The window: `serving_forward` (or
`fused_serving_forward`) on each batch of the cycle, `ahead` batches in
flight, an answer counted when its argmax reaches the host. After the
window: the sampled batches (the longest length among them) through the
plain reference, the widest gap by which a served answer's reference
logit lies below the reference's best.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from typing import Dict, List

import numpy as np

from portbench.lib import host as host_lib
from portbench.lib import traffic as traffic_lib
from portbench.lib import weights
from portbench.lib.trace import Slice

# seed streams of one run: weights, catalog, calibration rows, the check
CATALOG, CALIB, SAMPLE = 1, 2, 3


def make_inputs(ctx) -> Dict:
    """The weights, the catalog and the traffic: the benchmark's data,
    handed alike to the program and to the reference."""
    torch, dev, s = ctx.torch, ctx.device, ctx.cell.sizes
    seed = ctx.args.seed
    spec = weights.lxmert_spec(s) + weights.answer_head_spec(s)
    leaves, flat = weights.make(spec, seed, s["initializer_range"], dev,
                                torch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(weights.sub_seed(seed, CATALOG))
    table = torch.randn(s["catalog_images"], s["visual_tokens"],
                        s["visual_feat_dim"], generator=gen, device=dev,
                        dtype=torch.bfloat16)
    tr = traffic_lib.generate(ctx.cell.traffic, seed, s["vocab_size"],
                              s["catalog_images"])
    rows = np.random.default_rng(weights.sub_seed(seed, CALIB)).choice(
        tr.ids.shape[0], size=ctx.cell.workload["calib_rows"], replace=False)
    return {"leaves": leaves, "flat": flat, "table": table, "traffic": tr,
            "calib_rows": rows}


def calib_batches(inp: Dict, torch, dev, size: int = 8):
    """The calibration queries as `serve` batches them: `size` rows at
    the longest length (ids, catalog rows, mask), on `dev`."""
    tr, rows = inp["traffic"], inp["calib_rows"]
    out = []
    for a in range(0, len(rows), size):
        r = rows[a:a + size]
        ids = torch.from_numpy(tr.ids[r]).to(dev)
        out.append((ids, torch.from_numpy(tr.picks[r]).to(dev),
                    (ids > 0).float()))
    return out


def build_program(ctx, inp: Dict):
    """The engine as `cli/serve.serve` builds it, and the forward it runs
    on every batch."""
    torch, dev, s = ctx.torch, ctx.device, ctx.cell.sizes
    from xlxmert_tpu_torch.cli import serve as serve_cli
    from xlxmert_tpu_torch.core.config import LxmertConfig
    from xlxmert_tpu_torch.serving import lxmert_int8 as engine
    from xlxmert_tpu_torch.serving.feature_cache import FeatureCache
    from xlxmert_tpu_torch.utils.boxes import box_position

    fused = ctx.cell.workload["engine"] == "fused"
    if dev.type == "cuda":
        from xlxmert_tpu_torch.ops import attention, fused_block, int8_matmul
        from xlxmert_tpu_torch.ops._build import build_all

        build_all([int8_matmul.KERNEL, attention.KERNEL]
                  + ([fused_block.KERNEL] if fused else []), verbose=False)
    fields = LxmertConfig.__dataclass_fields__
    cfg = LxmertConfig(**{k: v for k, v in s.items() if k in fields})
    tree = weights.host_tree(inp["leaves"], inp["flat"], torch)
    cache = FeatureCache(inp["table"],
                         {str(i): i for i in range(s["catalog_images"])})
    qp = engine.prepare_params(tree["bert"], cfg, dev)
    hqp = engine.prepare_answer_head(tree["answer_head"], dev)
    V = s["visual_tokens"]
    pos = torch.from_numpy(box_position(s["grid_size"])).to(
        dev, torch.bfloat16)
    batches = [(ids, FeatureCache.lookup(cache.table, picks).float(),
                pos[None].expand(ids.shape[0], V, 4), mask)
               for ids, picks, mask in calib_batches(inp, torch, dev)]
    engine.calibrate(qp, hqp, batches, cfg)
    engine.apply_calibration(qp, hqp)
    engine.assert_fully_calibrated(qp, hqp)
    del batches
    if fused:
        from xlxmert_tpu_torch.serving.lxmert_fused import prepare_fused

        fp = prepare_fused(qp, cfg)
        return serve_cli.fused_serving_forward(fp, hqp, cache, cfg, dev)
    return serve_cli.serving_forward(qp, hqp, cache, cfg, dev)


def window(ctx, run, host: List, lengths: List[int], seconds: float,
           sl: Slice) -> Dict:
    """Dispatch the cycle for `seconds`, `ahead` batches in flight; every
    dispatched batch's answers fetched. A traced run's window ends with
    its slice: the profiler slows the host's launches after it too.
    Returns the answers by dispatch position and the host clocks."""
    torch, rec, wl = ctx.torch, ctx.record, ctx.cell.workload
    ahead = int(ctx.cell.traffic["ahead"])
    trace_at = seconds * wl["trace_at"]
    pending: deque = deque()
    answers: Dict[int, np.ndarray] = {}
    n = len(host)
    k = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if sl.due():
            sl.end()
            break
        if now - t0 >= trace_at:
            sl.begin()
        i = k % n
        ts = time.perf_counter()
        with sl.span("serve"):
            out = run(*host[i])
        if sl.active:
            rec.slice_work.append(lengths[i])
        else:   # the host's spans are taken before the traced slice
            rec.span("enqueue", time.perf_counter() - ts)
        pending.append((k, out))
        k += 1
        if len(pending) > ahead:
            kk, d = pending.popleft()
            with sl.span("fetch"):
                answers[kk] = d.cpu().numpy()
            if not sl.active:
                rec.paced.append((time.perf_counter(), lengths[kk % n]))
    sl.end()
    while pending:
        kk, d = pending.popleft()
        answers[kk] = d.cpu().numpy()
    t1 = time.perf_counter()
    return {"answers": answers, "t0": t0, "t1": t1, "dispatched": k}


def sample_positions(seed: int, done: List[int], lengths: List[int],
                     n_cycle: int, k: int) -> List[int]:
    """`k` completed dispatch positions drawn from the seed, one of them
    of the longest length."""
    rng = np.random.default_rng(weights.sub_seed(seed, SAMPLE))
    longest = max(lengths)
    top = [p for p in done if lengths[p % n_cycle] == longest]
    if not top:
        return []
    first = int(rng.choice(top))
    rest = [p for p in done if p != first]
    more = rng.choice(rest, size=min(k - 1, len(rest)), replace=False)
    return [first] + [int(p) for p in more]


def calib_feats(inp: Dict, torch, dev) -> List:
    """The calibration queries with their catalog rows gathered: (ids,
    features (bf16), mask)."""
    return [(ids, inp["table"].index_select(0, picks), mask)
            for ids, picks, mask in calib_batches(inp, torch, dev)]


def reference_model(ctx, inp: Dict, bits: int):
    """The plain reference at `bits`, calibrated on the same queries."""
    from portbench.reference.lxmert import QuantLxmert, box_position

    s = ctx.cell.sizes
    ref = QuantLxmert(inp["leaves"], s["num_attention_heads"], bits)
    pos = box_position(s["grid_size"]).to(ctx.device)
    ref.calibrate(lambda ids, feats, mask: ref.vqa_logits(
        ids, feats.float(), pos, mask), inp["calib"])
    return ref, pos


def answer_gap(ctx, inp: Dict, positions: List[int], served: Dict,
               feats: Dict) -> float:
    """The widest gap, over every answer of the sampled batches, by which
    the served answer's reference logit lies below the reference's
    best."""
    from portbench.reference.lxmert import tf32_off

    torch, dev = ctx.torch, ctx.device
    tr = inp["traffic"]
    n = len(tr.batches)
    worst = 0.0
    with tf32_off(), torch.inference_mode():
        ref, pos = reference_model(ctx, inp, 8)
        for p in positions:
            b = tr.batches[p % n]
            ids = torch.from_numpy(tr.ids[b.rows, :b.length]).to(dev)
            logits = ref.vqa_logits(ids, feats[p].float(), pos,
                                    (ids > 0).float())
            got = torch.from_numpy(np.asarray(served[p], np.int64)).to(dev)
            gap = logits.amax(-1) - logits.gather(1, got[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
    return worst


def run(ctx) -> Dict:
    torch, dev, rec = ctx.torch, ctx.device, ctx.record
    wl, seconds = ctx.cell.workload, float(ctx.args.seconds)
    inp = make_inputs(ctx)
    tr = inp["traffic"]
    host = traffic_lib.host_batches(tr, torch, pin=dev.type == "cuda")
    lengths = [b.length for b in tr.batches]
    t_inputs = time.perf_counter()
    fwd = build_program(ctx, inp)
    t_program = time.perf_counter()
    for length in sorted(set(lengths)):
        fwd(*host[lengths.index(length)]).cpu()
    sl = Slice(torch, bool(ctx.args.trace), wl["trace_slice_s"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec.setup_s = time.perf_counter() - ctx.t_start
    print(f"set-up: python, torch and the card "
          f"{ctx.t_torch - ctx.t_start:.2f} s, the inputs "
          f"{t_inputs - ctx.t_torch:.2f} s, the program "
          f"{t_program - t_inputs:.2f} s, warm-up "
          f"{time.perf_counter() - t_program:.2f} s", file=sys.stderr)

    before = host_lib.probe_ms()
    w = window(ctx, fwd, host, lengths, seconds, sl)
    host_lib.report(before, rec.spans)
    B = int(ctx.cell.traffic["batch"])
    answered = len(w["answers"]) * B
    rec.window = {"t0": w["t0"], "t1": w["t1"], "answers": answered,
                  "batches": len(w["answers"])}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    positions = sample_positions(ctx.args.seed, sorted(w["answers"]),
                                 lengths, len(lengths), wl["sample_batches"])
    feats = {p: inp["table"].index_select(
        0, host[p % len(lengths)][1].to(dev)) for p in positions}
    inp["calib"] = calib_feats(inp, torch, dev)
    del fwd, host
    inp["table"] = None
    inp["flat"] = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sl.reduce()
    rec.trace = sl.summary
    served = {p: w["answers"][p] for p in positions}
    checks = {}
    complete = bool(positions)
    if complete:
        checks["answer_gap"] = {
            "value": answer_gap(ctx, inp, positions, served, feats),
            "limit": wl["limits"]["answer_gap"]}
    correct = complete and all(v["value"] <= v["limit"]
                               for v in checks.values())
    return {"correct": correct, "attempted": w["dispatched"] * B,
            "failed": (w["dispatched"] - len(w["answers"])) * B,
            "memory_peak_bytes": peak, "checks": checks}


def control(ctx, bits: int = 4) -> Dict:
    """The control: the reference at `bits` (int4: the precision below
    the served int8) in the program's place, on batches a run would
    sample (drawn from the cycle's first ones, the longest length among
    them), judged by the same comparison."""
    torch, dev = ctx.torch, ctx.device
    from portbench.reference.lxmert import tf32_off

    inp = make_inputs(ctx)
    inp["calib"] = calib_feats(inp, torch, dev)
    tr = inp["traffic"]
    lengths = [b.length for b in tr.batches]
    k = ctx.cell.workload["sample_batches"]
    positions = sample_positions(ctx.args.seed, list(range(4 * k)),
                                 lengths, len(lengths), k)
    feats, served = {}, {}
    with tf32_off(), torch.inference_mode():
        low, pos = reference_model(ctx, inp, bits)
        for p in positions:
            b = tr.batches[p]
            ids = torch.from_numpy(tr.ids[b.rows, :b.length]).to(dev)
            feats[p] = inp["table"].index_select(
                0, torch.from_numpy(tr.picks[b.rows]).to(dev))
            served[p] = low.vqa_logits(ids, feats[p].float(), pos,
                                       (ids > 0).float()).argmax(-1).cpu()
    del low
    return {"answer_gap": answer_gap(ctx, inp, positions, served, feats)}

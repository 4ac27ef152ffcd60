"""Pre-training steps: cli/pretrain's step function (`pretrain_step`) over
the recipe's task round-robin, steps back to back, for the window's
seconds.

Set-up: the X-LXMERT weights (backbone, the LM, matching and
visual-cluster heads, `mask_feat`) and the centroid table from the seed
on the card; a `tasks/pretrain.PretrainEngine` at the configuration's
recipe, its state holding those weights; a pool of host batches as the
recipe's loader yields them (captions from the traffic generator, an
8x8 grid of cluster ids a caption, the matching task's captions, half
of them another pair's, and the vis_mask task's substitute caption and
grid); one warmed step of each task. The window: rounds of the three
tasks, each step `pretrain_step` on the next pool batch (the program
draws the masks and the dropout); a step's loss is read back after the
next step is launched, and its examples count then; the window ends on
a whole round. After the window: one judged step of each task through
the same engine and function, on a batch whose masks and labels are
drawn from the seed and injected, at the recipe's dropout, against the
plain fp32 reference (portbench/reference/xlxmert_pretrain.py) computed
in blocks from the program's parameters and AdamW state just before the
step and with the dropout masks the program drew in it: the loss, the
gradients the optimizer received, the set of parameters without one,
and the parameters after the update.
"""
from __future__ import annotations

import contextlib
import json
import math
import sys
import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np

from portbench.lib import host as host_lib
from portbench.lib import trace as trace_lib
from portbench.lib import traffic as traffic_lib
from portbench.lib import weights
from portbench.lib.trace import Slice

# seed streams of one run: the grids, the pairs, the judged batch
CLUSTERS, PAIRS, JUDGED = 6, 7, 8
CLS, SEP, MASK = 101, 102, 103
STAGES = "xlt.train."


def heads_spec(s: Dict) -> weights.Spec:
    """The LM head (its decoder is the tied word embeddings) and the
    matching head, as the pre-training model's parameter tree."""
    H, p = s["hidden_size"], "cls/predictions"
    return [(f"{p}/transform/dense/kernel", (H, H), "w"),
            (f"{p}/transform/dense/bias", (H,), "b"),
            (f"{p}/transform/LayerNorm/scale", (H,), "g"),
            (f"{p}/transform/LayerNorm/bias", (H,), "b"),
            (f"{p}/bias", (s["vocab_size"],), "b"),
            ("cls/seq_relationship/kernel", (H, 2), "w"),
            ("cls/seq_relationship/bias", (2,), "b")]


def host_pool(ctx, tr: traffic_lib.Traffic) -> List[Dict[str, np.ndarray]]:
    """The traffic's batches as the recipe's loader (data/datasets.
    PretrainDataset, clustering, --vis_mask_COCOVG_only) yields them."""
    s, t = ctx.cell.sizes, ctx.cell.traffic
    seed = ctx.args.seed
    n, V = tr.ids.shape[0], s["visual_tokens"]
    grids = np.random.default_rng(weights.sub_seed(seed, CLUSTERS)).integers(
        0, s["num_clusters"], size=(n, V), dtype=np.int64)
    rng = np.random.default_rng(weights.sub_seed(seed, PAIRS))
    out = []
    for b in tr.batches:
        rows = b.rows
        other = (rows + rng.integers(1, n, size=rows.shape)) % n
        swap = rng.random(rows.shape) < float(t["mismatched_share"])
        sub = rng.integers(0, n, size=rows.shape)
        out.append({"word_id": tr.ids[rows],
                    "other_word_id": tr.ids[np.where(swap, other, rows)],
                    "matched_label": (~swap).astype(np.int64),
                    "cluster_id": grids[rows],
                    "coco_word_id": tr.ids[sub],
                    "coco_cluster_id": grids[sub]})
    return out


def make_inputs(ctx) -> Dict:
    torch, dev, s = ctx.torch, ctx.device, ctx.cell.sizes
    seed = ctx.args.seed
    spec = (weights.lxmert_spec(s) + weights.object_head_spec(s)
            + heads_spec(s))
    leaves, flat = weights.make(spec, seed, s["initializer_range"], dev,
                                torch)
    tr = traffic_lib.generate(ctx.cell.traffic, seed, s["vocab_size"])
    return {"leaves": leaves, "flat": flat, "pool": host_pool(ctx, tr)}


def recipe(ctx) -> Dict:
    return ctx.cell.config["recipe"]


def build_program(ctx, inp: Dict):
    """The engine and its state as cli/pretrain builds them, holding the
    seed's weights; the centroid table on the card."""
    torch, dev, s = ctx.torch, ctx.device, ctx.cell.sizes
    from xlxmert_tpu_torch.core.config import LxmertConfig, TrainConfig
    from xlxmert_tpu_torch.tasks.pretrain import PretrainEngine

    if dev.type == "cuda":
        from xlxmert_tpu_torch.ops import attention
        from xlxmert_tpu_torch.ops._build import build_all

        build_all([attention.TRAIN_KERNEL], verbose=False)
    r = recipe(ctx)
    mfields = LxmertConfig.__dataclass_fields__
    tfields = TrainConfig.__dataclass_fields__
    mcfg = LxmertConfig(**{k: v for k, v in s.items() if k in mfields})
    cfg = TrainConfig(**{k: v for k, v in r.items() if k in tfields},
                      batch_size=int(ctx.cell.traffic["batch"]),
                      max_text_length=s["max_text_length"],
                      grid_size=s["grid_size"],
                      num_clusters=s["num_clusters"],
                      feat_dim=s["visual_feat_dim"], seed=ctx.args.seed)
    eng = PretrainEngine(cfg, mcfg, total_steps=int(r["total_steps"]),
                         train_attention=r["train_attention"], device=dev)
    tree = weights.host_tree(inp["leaves"], inp["flat"], torch)
    tree.pop("centroids")
    state = eng.create_state(ctx.args.seed, params=tree)
    centroids = inp["leaves"]["centroids"].clone()
    inp["leaves"] = inp["flat"] = None
    return eng, state, centroids


@contextlib.contextmanager
def recorded_dropout(model, out: List):
    """Each dropout mask `keep` that the model's forward draws inside
    (models/lxmert.TrainOptions.keep: the hidden dropouts and the
    attention's probabilities), appended to `out` in the order drawn."""
    from xlxmert_tpu_torch.models.lxmert import Dropout

    (opts,) = {id(m.train_opts): m.train_opts for m in model.modules()
               if isinstance(m, Dropout)}.values()
    draw = opts.keep

    def keep(shape, keep_prob, device, heads=None):
        k = draw(shape, keep_prob, device, heads)
        out.append(k)
        return k

    opts.keep = keep
    try:
        yield
    finally:
        del opts.keep


def drops_of(keeps: List, sizes: Dict, dtype) -> List:
    """The reference's dropouts from the masks the program drew: a
    (B, H, Lq, Lk) mask is the attention's, at the configuration's
    attention rate, its scale the kernel operand's value
    keep.to(dtype) / keep_prob in `dtype` (models/lxmert.Attention); any
    other a hidden dropout's at the hidden rate, which divides by
    keep_prob in `dtype` (models/lxmert.Dropout)."""
    import torch

    from portbench.reference.xlxmert_pretrain import Drop

    out = []
    for k in keeps:
        if k.dim() == 4:
            kp = torch.full((), 1.0 - sizes["attention_probs_dropout_prob"],
                            dtype=dtype)
            scale = float(torch.ones((), dtype=dtype) / kp)
        else:
            kp = torch.full((), 1.0 - sizes["hidden_dropout_prob"],
                            dtype=dtype)
            scale = 1.0 / float(kp)
        out.append(Drop(k, scale))
    return out


def keep_share_z(keeps: List, sizes: Dict) -> float:
    """The largest |kept - n keep_prob| / sqrt(n keep_prob (1 -
    keep_prob)) over the masks drawn, n a mask's elements, keep_prob at
    the configuration's rate for its kind: a draw at the wrong rate
    reads far above a few units."""
    z = 0.0
    for k in keeps:
        kp = 1.0 - sizes["attention_probs_dropout_prob" if k.dim() == 4
                         else "hidden_dropout_prob"]
        n = k.numel()
        z = max(z, abs(float(k.sum()) - n * kp)
                / math.sqrt(n * kp * (1.0 - kp)))
    return z


def run(ctx) -> Dict:
    torch, dev, rec = ctx.torch, ctx.device, ctx.record
    wl, seconds = ctx.cell.workload, float(ctx.args.seconds)
    # a program without the step function fails here, before any work
    from xlxmert_tpu_torch.cli.pretrain import pretrain_step
    from xlxmert_tpu_torch.utils import profiling

    inp = make_inputs(ctx)
    pool = inp["pool"]
    t_inputs = time.perf_counter()
    eng, state, centroids = build_program(ctx, inp)
    t_program = time.perf_counter()
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    B, n = int(ctx.cell.traffic["batch"]), len(pool)
    n_tasks = len(eng.cfg.mask_modalities)
    traced = bool(ctx.args.trace)
    sl = Slice(torch, traced, wl["trace_slice_s"])

    step = 0
    for _ in range(n_tasks):    # set-up: one step of each task
        pretrain_step(eng, state, pool[step % n], centroids, step)
        step += 1
    sync()
    rec.setup_s = time.perf_counter() - ctx.t_start
    print(f"set-up: python, torch and the card "
          f"{ctx.t_torch - ctx.t_start:.2f} s, the inputs "
          f"{t_inputs - ctx.t_torch:.2f} s, the program "
          f"{t_program - t_inputs:.2f} s, warm-up "
          f"{time.perf_counter() - t_program:.2f} s", file=sys.stderr)

    before = host_lib.probe_ms()
    done = failed = 0
    begin_ns = 0
    # the step launched last, its loss still on the card: (task, loss,
    # launched inside the slice). A step's loss is read back after the
    # next step is launched, as a loop that logs its losses does
    pending = None

    def settle():
        nonlocal pending, done, failed
        if pending is None:
            return
        task, loss, in_slice = pending
        tw = time.perf_counter()
        value = float(loss)
        te = time.perf_counter()
        rec.span("wait", te - tw)
        done += 1
        failed += 0 if math.isfinite(value) else B
        if not in_slice:
            rec.paced.append((te, task))
        pending = None

    t_start = time.perf_counter()
    rec.paced.append((t_start, None))
    while True:     # a round of the tasks a turn: the window ends on one
        now = time.perf_counter() - t_start
        if sl.due() or now >= seconds:
            break
        if now >= seconds * wl["trace_at"] and not sl.active \
                and not sl.done and traced:
            settle()    # the steps before the slice end before it
            sync()
            sl.begin()
            profiling.drain()
            profiling.enable()
            begin_ns = time.time_ns()
        for _ in range(n_tasks):
            ts = time.perf_counter()
            with sl.span("step"):
                task, metrics = pretrain_step(eng, state, pool[step % n],
                                              centroids, step)
            if not sl.active:
                rec.span("step", time.perf_counter() - ts)
            step += 1
            settle()
            pending = (task, metrics["total_loss"], sl.active)
            if sl.active:
                rec.slice_work.append(task)
    settle()
    sl.end()
    profiling.disable()
    t_end = time.perf_counter()
    host_lib.report(before, rec.spans)
    for name in ("step", "wait"):
        if rec.spans.get(name):
            q = np.percentile(np.asarray(rec.spans[name]) * 1e3,
                              [10, 50, 90])
            print(f"{name} before the slice: {q[0]:.1f} / {q[1]:.1f} / "
                  f"{q[2]:.1f} ms (10th, 50th, 90th percentile)",
                  file=sys.stderr)
    rec.window = {"t0": t_start, "t1": t_end, "samples": done * B}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if sl.prof is not None and sl.done:
        # the program's stages beside the harness's spans, on the same
        # clock marks: each launch charged to the innermost one open
        spans = [sp for sp in profiling.drain() if sp[0] >= begin_ns]
        rec.program_trace = trace_lib.summarize(sl.prof, sl.spans + spans,
                                                sl.marks)
        report_stages(rec.program_trace, profiling.drain_counts())
    sl.reduce()
    rec.trace = sl.summary
    checks = judge(ctx, eng, state, centroids, step,
                   program_step(ctx, eng, state, centroids, pretrain_step))
    correct = failed == 0 and all(v["value"] <= v["limit"]
                                  for v in checks.values())
    return {"correct": correct, "attempted": done * B, "failed": failed,
            "memory_peak_bytes": peak, "checks": checks}


def report_stages(tr, counts: Dict[str, int]) -> None:
    """Device time and launches by stage in the slice, each launch outside
    the `xlt.train.*` stages by its span, call and kernel, and the
    program's counters over the slice, on standard error."""
    if tr is None:
        return
    by: Dict[str, List[float]] = {}
    for k in tr.kernels:
        name = (k.span if k.span.startswith(STAGES) else
                f"outside ({k.span or 'none'}/{k.call}/{k.name[:40]})")
        d = by.setdefault(name, [0.0, 0])
        d[0] += k.dur
        d[1] += 1
    print("stages: " + "; ".join(
        f"{name} {1e3 * d[0]:.2f} ms device, {d[1]} launches"
        for name, d in sorted(by.items())), file=sys.stderr)
    print(f"counters: {counts}", file=sys.stderr)


# -- the comparison that decides `correct` ----------------------------------
class Snapshot(NamedTuple):
    """The state a judged step starts from: parameters (copies), AdamW's
    moments and counts, the schedule's position."""
    params: Dict
    m: Dict
    v: Dict
    counts: Dict[str, int]
    sched_step: int


class Produced(NamedTuple):
    """What the judged side gave: its loss, the gradients its update
    took (None where it took none), the parameters after it, and the
    dropout masks its forward drew."""
    loss: float
    grads: Dict
    after: Dict
    untouched_moved: int    # parameters without a gradient that moved
    keeps: List


def snapshot(state) -> Snapshot:
    opt = state.opt
    return Snapshot({k: p.detach().clone() for k, p in opt.params.items()},
                    dict(opt.m), dict(opt.v), dict(opt.count),
                    opt.sched_step)


def program_step(ctx, eng, state, centroids, pretrain_step) -> Callable:
    """The judged side is the program: `pretrain_step` at the recipe's
    dropout, each mask it draws recorded; the gradients are those its
    AdamW receives."""

    def produce(task: str, batch: Dict, step: int, snap: Snapshot
                ) -> Produced:
        seen: Dict = {}
        keeps: List = []
        update = state.opt.step

        def spy(grads, used, **kw):
            seen["grads"] = {k: g if k in used else None
                             for k, g in grads.items()}
            return update(grads, used=used, **kw)

        state.opt.step = spy
        try:
            with recorded_dropout(state.model, keeps):
                got, metrics = pretrain_step(eng, state, batch, centroids,
                                             step)
        finally:
            del state.opt.step
        if got != task:
            raise RuntimeError(f"judged step {step}: {got}, not {task}")
        opt = state.opt
        moved = sum(1 for k, g in seen["grads"].items() if g is None and (
            not bool((opt.params[k] == snap.params[k]).all())
            or opt.m[k] is not snap.m[k] or opt.count[k] != snap.counts[k]))
        return Produced(float(metrics["total_loss"]), seen["grads"],
                        {k: p.detach() for k, p in opt.params.items()},
                        moved, keeps)

    return produce


def judged_batch(ctx) -> Dict[str, np.ndarray]:
    """A pool-like batch with the masks and labels drawn from the seed:
    the word mask at the recipe's rate (80 % [MASK], 10 % a random word,
    10 % kept; [CLS], [SEP] and padding never), and a mask-predict grid
    mask (a count uniform in 1..V, then that many cells)."""
    s, r = ctx.cell.sizes, recipe(ctx)
    B = int(ctx.cell.traffic["batch"])
    tr = traffic_lib.generate(ctx.cell.traffic, weights.sub_seed(
        ctx.args.seed, JUDGED), s["vocab_size"])
    batch = host_pool(ctx, tr)[0]
    rng = np.random.default_rng(weights.sub_seed(ctx.args.seed, JUDGED))
    ids = batch["word_id"]
    words = (ids > 0) & (ids != CLS) & (ids != SEP)
    chosen = words & (rng.random(ids.shape) < float(r["word_mask_rate"]))
    chosen[0, 1] = True     # at least one label
    how = rng.random(ids.shape)
    masked = np.where(chosen & (how < 0.8), MASK, ids)
    masked = np.where(chosen & (how >= 0.9), rng.integers(
        0, s["vocab_size"], size=ids.shape), masked)
    V = s["visual_tokens"]
    count = rng.integers(1, V + 1, size=(B, 1))
    order = np.argsort(rng.random((B, V)), axis=1)
    vis = np.zeros((B, V), np.float32)
    np.put_along_axis(vis, order, (np.arange(V)[None] < count).astype(
        np.float32), axis=1)
    batch.update(masked_word_id=masked,
                 word_label=np.where(chosen, ids, -1), vis_mask=vis)
    return batch


def reference_inputs(ctx, batch: Dict, task: str):
    """What the task reads from the batch, as the recipe routes it
    (the vis_mask task reads the substitute caption and grid)."""
    from portbench.reference.xlxmert_pretrain import Inputs

    torch, dev = ctx.torch, ctx.device
    t = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
         batch.items()}
    if task == "word_mask":
        return Inputs(t["masked_word_id"], t["cluster_id"], None,
                      t["word_label"])
    if task == "matched":
        return Inputs(t["other_word_id"], t["cluster_id"], None,
                      t["matched_label"])
    sub = recipe(ctx).get("vis_mask_COCOVG_only", False)
    ids = t["coco_word_id"] if sub else t["word_id"]
    grid = t["coco_cluster_id"] if sub else t["cluster_id"]
    vm = t["vis_mask"] > 0
    return Inputs(ids, grid, vm, torch.where(vm, grid, -100))


def hyper(ctx):
    from portbench.reference.xlxmert_pretrain import Hyper

    r = recipe(ctx)
    return Hyper(r["lr"], int(r["total_steps"]), r["warmup_ratio"],
                 r["weight_decay"], r["clip_grad_norm"], r["adam_eps"])


def relative_errors(got: Dict, want: Dict, names) -> Dict[str, float]:
    """||got - want|| / max(||want||, its even share) a tensor: the share
    is the whole set's norm times sqrt(the tensor's elements over the
    set's). A tensor whose exact value is 0 or nearly so (the
    attention key biases' gradients: softmax ignores a shift) is judged
    against that share, not against its own rounding noise."""
    names = list(names)
    sq = {k: float((want[k].double() ** 2).sum()) for k in names}
    whole = math.sqrt(sum(sq.values()))
    total = sum(want[k].numel() for k in names)
    out = {}
    for k in names:
        share = whole * math.sqrt(want[k].numel() / total)
        d = float(((got[k].double() - want[k].double()) ** 2).sum())
        out[k] = math.sqrt(d) / max(math.sqrt(sq[k]), share, 1e-300)
    return out


def update_errors(after: Dict, before: Dict, exact: Dict, names
                  ) -> Dict[str, float]:
    """The updates' errors beyond the fp32 parameters' own rounding, a
    tensor: |(after - before) - u| less half an ulp of `after` an element
    (the last add's rounding, which no fp32 program escapes: with the
    updates a few ulps of a LayerNorm scale near 1 it flips whole ulps
    between two correct programs), as `relative_errors` judges it
    against the exact update u (`exact` - `before`, float64)."""
    import torch

    names = list(names)
    err, want = {}, {}
    for k in names:
        a = after[k]
        ulp = torch.nextafter(a.abs(), torch.full_like(a, math.inf)) \
            - a.abs()
        u = exact[k] - before[k].double()
        d = (a.double() - before[k].double() - u).abs()
        err[k] = (d - 0.5 * ulp.double()).clamp_min(0.0)
        want[k] = u
    return relative_errors({k: want[k] + err[k] for k in names}, want,
                           names)


def global_error(got: Dict, want: Dict, names) -> float:
    """||got - want|| / ||want|| over the whole set."""
    d = w = 0.0
    for k in names:
        d += float(((got[k].double() - want[k].double()) ** 2).sum())
        w += float((want[k].double() ** 2).sum())
    return math.sqrt(d / max(w, 1e-300))


def judge(ctx, eng, state, centroids, step: int, produce: Callable
          ) -> Dict:
    """One judged step of each task from global step `step` on, the
    judged side given by `produce`, against the fp32 reference with the
    dropout masks the judged side drew. Each reading is printed; those
    the workload limits are returned with their limits: the loss gap
    and the gradients' error a task (`loss_gap.<task>`,
    `grad_err.<task>`), and over the tasks the updates' error, the
    no-gradient sets' mismatch and the masks' kept counts against
    their rates."""
    from portbench.reference import xlxmert_pretrain as ref

    torch, s, wl = ctx.torch, ctx.cell.sizes, ctx.cell.workload
    block = int(wl["reference_block"])
    pos = ref.box_position(s["grid_size"]).to(ctx.device)
    h = hyper(ctx)
    batch = judged_batch(ctx)
    readings = {"update_err": 0.0, "no_grad_mismatch": 0,
                "keep_share_z": 0.0}
    for i in range(len(eng.cfg.mask_modalities)):
        task = eng.task_for_step(step + i)
        snap = snapshot(state)
        got = produce(task, batch, step + i, snap)
        x = reference_inputs(ctx, batch, task)
        with ref.tf32_off():
            loss, grads = ref.loss_and_grads(
                snap.params, task, x, centroids, pos,
                s["num_attention_heads"], block,
                drops=drops_of(got.keeps, s, eng.compute_dtype))
            # the update the judged side's own gradients give, exact:
            # the gradients are judged apart, and through Adam's moments
            # an error in them would be judged again, amplified where the
            # tasks' alternating gradients leave m small
            exact = ref.adamw(snap.params, got.grads, snap.m, snap.v,
                              snap.counts, snap.sched_step, h,
                              dtype=torch.float64)
        want = {k for k, g in grads.items() if g is not None}
        have = {k for k, g in got.grads.items() if g is not None}
        both = sorted(want & have)
        ge = relative_errors(got.grads, grads, both)
        du = update_errors(got.after, snap.params, exact, both)
        readings[f"loss_gap.{task}"] = abs(got.loss - loss) / abs(loss)
        readings[f"grad_err.{task}"] = max(ge.values())
        readings["update_err"] = max(readings["update_err"],
                                     max(du.values()))
        readings["no_grad_mismatch"] += (len(want ^ have)
                                         + got.untouched_moved)
        readings["keep_share_z"] = max(readings["keep_share_z"],
                                       keep_share_z(got.keeps, s))
        gk, uk = max(ge, key=ge.get), max(du, key=du.get)
        print(f"judged {task}: loss {got.loss:.6f} / reference {loss:.6f}; "
              f"gradients {global_error(got.grads, grads, both):.4g} of "
              f"the whole, worst {ge[gk]:.4g} ({gk}); updates worst "
              f"{du[uk]:.4g} ({uk}); {len(have)} with a gradient, "
              f"{len(want)} in the reference; {len(got.keeps)} dropout "
              f"masks", file=sys.stderr)
        del snap, got, grads, exact
    print("readings: " + json.dumps(readings), file=sys.stderr)
    limits = wl["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in readings.items()
            if k in limits}


def control(ctx) -> Dict:
    """The control: the program's set-up and `control_rounds` rounds, then
    the judged steps with the plain reference a precision below the
    recipe's in the program's place (fp8 e4m3 products below its bf16,
    AdamW in bf16 below its fp32), at the dropout masks the program's
    forward draws for the step, judged by `judge`."""
    from portbench.reference import xlxmert_pretrain as ref
    from xlxmert_tpu_torch.cli.pretrain import pretrain_step

    torch, s, wl = ctx.torch, ctx.cell.sizes, ctx.cell.workload
    inp = make_inputs(ctx)
    pool = inp["pool"]
    eng, state, centroids = build_program(ctx, inp)
    n_tasks = len(eng.cfg.mask_modalities)
    step = 0
    for _ in range(n_tasks * (1 + int(wl["control_rounds"]))):
        pretrain_step(eng, state, pool[step % len(pool)], centroids, step)
        step += 1
    pos = ref.box_position(s["grid_size"]).to(ctx.device)
    h = hyper(ctx)

    def produce(task, batch, i, snap):
        keeps: List = []
        with torch.no_grad(), recorded_dropout(state.model, keeps):
            eng.forward_losses(state.model, eng.place(batch), task,
                               centroids, state.generator)
        with ref.tf32_off():
            loss, grads = ref.loss_and_grads(
                snap.params, task, reference_inputs(ctx, batch, task),
                centroids, pos, s["num_attention_heads"],
                int(wl["reference_block"]), products="fp8",
                drops=drops_of(keeps, s, eng.compute_dtype))
            after = ref.adamw(snap.params, grads, snap.m, snap.v,
                              snap.counts, snap.sched_step, h,
                              dtype=torch.bfloat16)
        return Produced(loss, grads, after, 0, keeps)

    return {k: v["value"] for k, v in judge(ctx, eng, state, centroids,
                                            step, produce).items()}

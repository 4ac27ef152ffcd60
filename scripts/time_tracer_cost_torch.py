"""The stage tracer's host cost (utils/profiling.span) in the port's
serving forward and int8 NAR sampler, within one process: a benchmark
cell's program built as its path (`portbench/paths/`) builds it, then
the cycle's batches dispatched in passes, each batch once with the
tracer on and once off (on for the odd batches of even passes and the
even batches of odd ones), so the host's drift between runs, which
moves a run's host clock by 10-15 %, does not enter the comparison.

    python3 scripts/time_tracer_cost_torch.py --workload vqa-int8-mix \\
        --seed 1 [--batches 400] [--passes 2] [--control] [--rehearse] \\
        [--out runs/tracer_cost.jsonl]

A VQA call is `serving_forward` (or the fused one) on one batch, the
path's batches ahead in flight; a t2i call is the sampler's call (the
render and the copy to the host follow it, untimed). Prints one line:
the mean host ms a call with the tracer on and off, on / off - 1, the
spans recorded a call, and one empty span's cost (ns, the tracer off
and on, a loop of a million). `--control` keeps the tracer off on both
sides: the comparison's own noise.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def span_ns(profiling, n: int = 1_000_000) -> float:
    """Host ns of one empty span, the loop's own time taken off."""
    t = time.perf_counter()
    for _ in range(n):
        pass
    empty = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n):
        with profiling.span("xlt.cost"):
            pass
    return (time.perf_counter() - t - empty) / n * 1e9


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--batches", type=int, default=400,
                   help="the cycle's first batches a pass")
    p.add_argument("--passes", type=int, default=2)
    p.add_argument("--control", action="store_true",
                   help="the tracer off on both sides")
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    import torch

    from portbench.lib import harness
    from portbench.lib import traffic as traffic_lib
    from xlxmert_tpu_torch.utils import profiling

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    c = harness.cell(bench, args.workload, os.path.join(ROOT, "portbench"),
                     args.rehearse)
    dev = torch.device("cpu" if args.rehearse else "cuda")
    ctx = SimpleNamespace(
        args=SimpleNamespace(seed=args.seed, trace=0), torch=torch,
        device=dev, cell=c, record=harness.Record(c.sizes, c.workload,
                                                  c.traffic),
        t_start=time.perf_counter())
    inp = c.path.make_inputs(ctx)
    host = traffic_lib.host_batches(inp["traffic"], torch,
                                    pin=dev.type == "cuda")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if c.workload["path"].startswith("t2i"):
        from xlxmert_tpu_torch.models.gan import render

        sampler, gen = c.path.build_program(ctx, inp, None)

        def call(i):
            ids = host[i][0].to(dev, non_blocking=True)
            t = time.perf_counter()
            code, _, _ = sampler(ids, (ids > 0).float())
            dt = time.perf_counter() - t
            render(gen, code).float().cpu()
            return dt
    else:
        fwd = c.path.build_program(ctx, inp)
        ahead = int(c.traffic["ahead"])
        pending: deque = deque()

        def call(i):
            t = time.perf_counter()
            pending.append(fwd(*host[i]))
            dt = time.perf_counter() - t
            if len(pending) > ahead:
                pending.popleft().cpu()
            return dt

    n = min(args.batches, len(host))
    lengths = [int(h[0].shape[1]) for h in host[:n]]
    for length in sorted(set(lengths)):     # every shape warmed up
        call(lengths.index(length))
    sync()
    times = {True: [], False: []}
    spans = 0
    for rnd in range(args.passes):
        for k in range(n):
            on = (k + rnd) % 2 == 1
            if on and not args.control:
                profiling.enable()
            times[on].append(call(k))
            profiling.disable()
        spans += len(profiling.drain())
    sync()
    on_ms = sum(times[True]) / len(times[True]) * 1e3
    off_ms = sum(times[False]) / len(times[False]) * 1e3
    line = {"workload": args.workload, "seed": args.seed, "calls": n,
            "passes": args.passes, "control": args.control,
            "on_ms": on_ms, "off_ms": off_ms,
            "on_over_off": on_ms / off_ms - 1,
            "spans_a_call": spans / len(times[True]),
            "span_ns_off": span_ns(profiling)}
    profiling.enable()
    line["span_ns_on"] = span_ns(profiling)
    profiling.disable()
    profiling.drain()
    if dev.type == "cuda":
        line["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(line))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

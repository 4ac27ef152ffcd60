"""Where the host code of the port's serving engine and int8 NAR sampler
leaves the card idle: one cell of the port's benchmark (`portbench/`),
run as `portbench/run.py --trace 1` runs it, with the program's stage
spans (utils/profiling.span) recorded from the window's start and the
traced slice charged to them.

    python3 scripts/trace_stages_torch.py --workload vqa-int8-mix \\
        --seed 1 --seconds 51 [--spans 0] [--rehearse] \\
        [--out runs/stages.jsonl]

The benchmark prints its own result line first (the cell's per-layer
metrics, as a traced run reads them); then this script prints one line:
  host_ms     each stage's host milliseconds a batch, from the batches
              completed before the slice, at the untraced pace;
  device_ms   each stage's device milliseconds a batch in the slice, by
              the stage whose span was open when the operation was
              launched (a second `portbench/lib/trace.summarize` over
              the harness's spans and the program's, on the same clock
              marks: the innermost span open at the launch names it);
  launches    device operations a batch in the slice, likewise;
  idle_share  each stage's share (%) of the slice's idle device time, by
              the stage that launched the operation ending each gap;
  idle_gaps   the benchmark's breakdown with each gap named by the stage
              (outside every stage: the harness's span) that launched
              the operation ending it;
  counters    the program's counters (utils/profiling.count) over the
              set-up (the warm-up batch included) and over the window;
and the cell's summary: VQA `engine_host_ms`, `engine_idle_share`,
`engine_launches` (the three `xlt.engine.*` stages) beside the harness's
`enqueue_ms`; t2i `step_host_ms`, `step_device_ms`, `step_launches`
(one decode step: its five `xlt.sampler.*` stages) beside the harness's
`sample_ms` and `tiling`, the share of `sample_ms` that the language
stage and the steps' host time make up. Where the sampler's call is a
CUDA graph (on the card; its stages then fire only at the capture, in
the set-up), the t2i summary is the replay's: `replay_host_ms`,
`replay_device_ms`, `replay_launches` (the `xlt.sampler.replay` stage:
copy-in, replay, clones), `tiling` its share of `sample_ms`, and
`replays_a_batch`. The tracer is on from the slice's creation (before
the warm-up batch), so that a capture is counted; the set-up's spans
are dropped at the window's start. `--spans 0` runs the same traced
window with the tracer never enabled, for the tracer's cost (the
harness's `enqueue_ms.vqa` or `sample_ms.t2i` of the two). The benchmark's
files are not changed: its slice and record are subclassed in this
process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STEP = tuple(f"xlt.sampler.{s}" for s in
             ("remask", "visual", "cross", "head", "commit"))
# each path's first stage: one a batch
FIRST = {"vqa": "xlt.serve.inputs", "t2i": "xlt.sampler.language"}
# the graphed sampler's one stage a batch
REPLAY = "xlt.sampler.replay"

Span = Tuple[int, int, str]


def host_ms(spans: Sequence[Span], before_ns: int) -> Dict[str, float]:
    """Host milliseconds by stage, summed over the spans that closed
    before `before_ns`."""
    out: Dict[str, float] = {}
    for s, e, name in spans:
        if e <= before_ns:
            out[name] = out.get(name, 0.0) + (e - s) * 1e-6
    return out


def count(spans: Sequence[Span], name: str, before_ns: Optional[int] = None,
          from_ns: Optional[int] = None) -> int:
    return sum(1 for s, e, n in spans if n == name
               and (before_ns is None or e <= before_ns)
               and (from_ns is None or s >= from_ns))


def by_stage(summary) -> Tuple[Dict[str, float], Dict[str, int],
                               Dict[str, float]]:
    """(device ms, launches, idle ms) by the span each operation was
    launched in ("" outside every span); idle by the operation ending
    each gap."""
    dev: Dict[str, float] = {}
    n: Dict[str, int] = {}
    for k in summary.kernels:
        dev[k.span] = dev.get(k.span, 0.0) + k.dur * 1e3
        n[k.span] = n.get(k.span, 0) + 1
    idle: Dict[str, float] = {}
    for key, s in summary.idle_gaps(len(summary.kernels) + 1):
        span = key.split("/", 1)[0]
        span = "" if span == "host" else span
        idle[span] = idle.get(span, 0.0) + s * 1e3
    return dev, n, idle


def report(kind: str, spans: Sequence[Span], begin_ns: int, program,
           harness_spans: Dict[str, List[float]],
           counters: Optional[Dict[str, Dict[str, int]]] = None) -> Dict:
    """The script's line from the program's spans, the slice's start on
    the host clock, the second summary (None without a card), the
    harness's host clocks (seconds by span) and the program's counters
    ({"setup": ..., "window": ...})."""
    graphed = kind == "t2i" and count(spans, REPLAY) > 0
    first = REPLAY if graphed else FIRST[kind]
    n_before = max(count(spans, first, before_ns=begin_ns), 1)
    host = host_ms(spans, begin_ns)
    out: Dict = {"kind": kind, "batches_before": n_before,
                 "host_ms": {k: v / n_before for k, v in host.items()}}
    if counters is not None:
        out["counters"] = counters
    steps_before = max(count(spans, STEP[0], before_ns=begin_ns), 1)
    if kind == "vqa":
        out["engine_host_ms"] = sum(v for k, v in host.items()
                                    if k.startswith("xlt.engine.")) / n_before
        if harness_spans.get("enqueue"):
            e = harness_spans["enqueue"]
            out["enqueue_ms"] = sum(e) / len(e) * 1e3
    elif graphed:
        out["replay_host_ms"] = host.get(REPLAY, 0.0) / n_before
        if counters is not None:
            out["replays_a_batch"] = counters["window"].get(
                "xlt.sampler.graph_replays", 0) / count(spans, REPLAY)
        if harness_spans.get("sample"):
            e = harness_spans["sample"]
            out["sample_ms"] = sum(e) / len(e) * 1e3
            out["tiling"] = out["replay_host_ms"] / out["sample_ms"]
    else:
        out["step_host_ms"] = sum(host.get(k, 0.0)
                                  for k in STEP) / steps_before
        if harness_spans.get("sample"):
            e = harness_spans["sample"]
            out["sample_ms"] = sum(e) / len(e) * 1e3
            out["tiling"] = (host.get(first, 0.0) / n_before
                             + out["step_host_ms"] * steps_before / n_before
                             ) / out["sample_ms"]
    if program is None:
        return out
    n_slice = max(count(spans, first, from_ns=begin_ns), 1)
    steps_slice = max(count(spans, STEP[0], from_ns=begin_ns), 1)
    dev, n, idle = by_stage(program)
    idle_total = sum(idle.values()) or 1.0
    out.update(
        batches_in_slice=n_slice,
        device_ms={k or "outside": v / n_slice for k, v in dev.items()},
        launches={k or "outside": v / n_slice for k, v in n.items()},
        idle_share={k or "outside": 100 * v / idle_total
                    for k, v in idle.items()},
        idle_gaps=program.idle_gaps(10))
    if kind == "vqa":
        engine = [k for k in dev if k.startswith("xlt.engine.")]
        out["engine_idle_share"] = sum(100 * idle.get(k, 0.0) / idle_total
                                       for k in engine)
        out["engine_launches"] = sum(n[k] for k in engine) / n_slice
    elif graphed:
        out["replay_device_ms"] = dev.get(REPLAY, 0.0) / n_slice
        out["replay_launches"] = n.get(REPLAY, 0) / n_slice
    else:
        out["step_device_ms"] = sum(dev.get(k, 0.0)
                                    for k in STEP) / steps_slice
        out["step_launches"] = sum(n.get(k, 0) for k in STEP) / steps_slice
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1,
                   help="0: never enable the tracer (its cost)")
    p.add_argument("--rehearse", action="store_true",
                   help="the CPU at the files' rehearsal sizes")
    p.add_argument("--out", default=None, help="also write the line here")
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    from portbench.lib import harness
    from portbench.lib import trace as trace_lib
    from xlxmert_tpu_torch.utils import profiling

    state: Dict = {}

    class StageSlice(trace_lib.Slice):
        """The harness's slice; the tracer on from the window's first
        batch (the loop's first `due()`), off at the slice's end, and a
        second summary over the program's spans before the profiler is
        dropped."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.window_ns = self.begin_ns = None
            self.program = None
            self.program_spans: List[Span] = []
            self.counters = {"setup": {}, "window": {}}
            state["slice"] = self
            profiling.drain_counts()
            if args.spans:      # from the warm-up batch on: its capture
                profiling.enable()

        def due(self) -> bool:
            if self.window_ns is None:
                self.window_ns = time.time_ns()
                profiling.drain()   # the warm-up's spans
                self.counters["setup"] = profiling.drain_counts()
            return super().due()

        def begin(self) -> None:
            was = self.active
            super().begin()
            if self.active and not was:
                self.begin_ns = time.time_ns()

        def end(self) -> None:
            super().end()
            profiling.disable()

        def reduce(self) -> None:
            if self.prof is not None and self.done:
                self.program_spans = profiling.drain()
                self.counters["window"] = profiling.drain_counts()
                inside = [s for s in self.program_spans
                          if s[0] >= self.begin_ns]
                self.program = trace_lib.summarize(
                    self.prof, list(self.spans) + inside, self.marks)
            super().reduce()

    class StageRecord(harness.Record):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            state["record"] = self

    trace_lib.Slice = StageSlice
    harness.Record = StageRecord
    rc = harness.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"]
                      + (["--rehearse"] if args.rehearse else []))
    if rc:
        return rc
    sl = state["slice"]
    with open(os.path.join(ROOT, "portbench", "workloads",
                           f"{args.workload}.json")) as f:
        kind = "t2i" if json.load(f)["path"].startswith("t2i") else "vqa"
    line = report(kind, sl.program_spans, sl.begin_ns or time.time_ns(),
                  sl.program, state["record"].spans, sl.counters)
    line.update(workload=args.workload, seed=args.seed, spans=args.spans,
                spans_recorded=len(sl.program_spans))
    if not args.rehearse:
        import torch

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

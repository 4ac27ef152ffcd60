"""The run: find the cell's files by name, check the card, hand the path
its configuration, traffic and workload, read the metrics the cell
reports and print the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--rehearse]

`BENCHMARK.json` names each cell's configuration and traffic mix; the
files are `portbench/configs/<config>.json`,
`portbench/traffic/<traffic>.json`, `portbench/workloads/<cell>.json`
(its path, engine, sample sizes and the limits of `correct`),
`portbench/paths/<path>.py` (the loop that drives the program) and
`portbench/metrics/<metric>.py` (one reader a metric). `--rehearse`
runs the cell on the CPU at the files' `rehearsal` sizes and reports no
device number: it exists for the tests. Without it a run that finds no
card, or fewer cards than the cell asks for, exits with 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

# the JAX side of the repository: none of it may be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "xlxmert_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="portbench: one run of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU, the files' rehearsal sizes, no device metric")
    return p.parse_args(argv)


def bench_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(d: Dict, rehearse: bool) -> Dict:
    """A file's values, with its `rehearsal` values over them when
    rehearsing."""
    out = {k: v for k, v in d.items() if k != "rehearsal"}
    if rehearse:
        out.update(d.get("rehearsal", {}))
    return out


def cell(bench: Dict, name: str, root: str, rehearse: bool
         ) -> SimpleNamespace:
    """Everything a cell names, found by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    work = merged(load_json(os.path.join(root, "workloads",
                                         f"{name}.json")), rehearse)
    config = load_json(os.path.join(os.path.dirname(root), conf["file"]))
    return SimpleNamespace(
        name=name, entry=entry, workload=work,
        sizes=merged(config["sizes"], rehearse),
        config=config,
        traffic=merged(load_json(os.path.join(
            root, "traffic", f"{entry['traffic']}.json")), rehearse),
        path=load_module(os.path.join(root, "paths", f"{work['path']}.py"),
                         f"portbench_path_{work['path']}"))


def metrics_of(bench: Dict, name: str, trace: int) -> List[Dict]:
    """The metrics a cell reports in this kind of run: end-to-end ones
    untraced, per-layer ones traced; those with a `workloads` list only
    in the cells it names."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def read_metrics(metrics: List[Dict], record, root: str) -> Dict:
    out = {}
    for m in metrics:
        reader = load_module(os.path.join(root, "metrics", f"{m['name']}.py"),
                             "portbench_metric_" + m["name"].replace(".",
                                                                      "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class Record:
    """What a run leaves for the metric readers: set-up seconds, the
    window's host clocks, the host spans, the traced slice and the work
    dispatched inside it, and each batch completed before the slice
    (its host clock and its work)."""

    def __init__(self, sizes: Dict, workload: Dict, traffic: Dict):
        self.sizes, self.workload, self.traffic = sizes, workload, traffic
        self.setup_s: Optional[float] = None
        self.window: Dict = {}
        self.spans: Dict[str, List[float]] = {}
        self.trace = None           # lib.trace.Summary of the slice
        self.slice_work: List = []  # what was dispatched inside the slice
        self.paced: List = []       # (seconds, work) completed before it

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    root = bench_root()
    repo = os.path.dirname(root)
    bench = load_json(os.path.join(repo, "BENCHMARK.json"))
    c = cell(bench, args.workload, root, args.rehearse)
    chips = int(c.entry["chips"])

    import torch

    if args.rehearse:
        device = torch.device("cpu")
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.init()
    if repo not in sys.path:
        sys.path.insert(0, repo)
    record = Record(c.sizes, c.workload, c.traffic)
    ctx = SimpleNamespace(args=args, torch=torch, device=device, cell=c,
                          record=record, t_start=t_start,
                          t_torch=time.perf_counter())
    result = c.path.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    metrics = read_metrics(metrics_of(bench, c.name, args.trace), record,
                           root)
    checks = result["checks"]
    correct = result["correct"]
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics}
    if args.rehearse:
        line["device"] = {"platform": "cpu", "kind": "rehearsal", "count": 0,
                          "memory_peak_bytes": 0}
    else:
        line["device"] = {"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": chips,
                          "memory_peak_bytes": result["memory_peak_bytes"]}
    if args.trace and record.trace is not None:
        tr = record.trace
        print(f"trace: {len(tr.kernels)} device operations, "
              f"{sum(1 for k in tr.kernels if k.span)} launched under a "
              f"harness span; the profiler's clock {tr.offset_ns} ns ahead "
              f"of the host's", file=sys.stderr)
        line["device"]["busy_s"] = record.trace.busy_s
        line["device"]["window_s"] = record.trace.window_s
        line["breakdown"] = {"device_ops": record.trace.top_ops(10),
                             "idle_gaps": record.trace.idle_gaps(10)}
    line["checks"] = checks
    for name, v in checks.items():
        print(f"check {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


def control_main(argv=None) -> int:
    """The control of a cell's `correct`: the plain reference at the
    precision below the configuration's, put in the program's place and
    judged by the run's own comparison. Prints one JSON line: each
    compared number, its limit and whether it fails."""
    p = argparse.ArgumentParser(description="portbench: a control reading")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    root = bench_root()
    repo = os.path.dirname(root)
    bench = load_json(os.path.join(repo, "BENCHMARK.json"))
    c = cell(bench, args.workload, root, args.rehearse)

    import torch

    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    if repo not in sys.path:
        sys.path.insert(0, repo)
    ctx = SimpleNamespace(args=SimpleNamespace(seed=args.seed, trace=0),
                          torch=torch, device=device, cell=c,
                          record=Record(c.sizes, c.workload, c.traffic),
                          t_start=time.perf_counter())
    t0 = time.perf_counter()
    values = c.path.control(ctx)
    limits = c.workload["limits"]
    out = {name: {"value": v, "limit": limits[name],
                  "fails": v > limits[name]} for name, v in values.items()}
    print(json.dumps({"workload": c.name, "seed": args.seed,
                      "seconds": time.perf_counter() - t0, "control": out}))
    return 0

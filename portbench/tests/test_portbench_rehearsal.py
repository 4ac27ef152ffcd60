"""Each cell end to end on the CPU under --rehearse (the files'
rehearsal sizes, the kernels' plain versions, no device metric); a run
without it on a machine with no card, or in a directory that holds only
the benchmark, exits non-zero and prints no result."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["vqa-int8-mix", "t2i-nar4-int8", "vqa-fused-mix"]


def run(args, cwd=ROOT, timeout=240):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def last_line(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_runs_end_to_end_on_the_cpu(cell, trace):
    line = last_line(run(["--workload", cell, "--seed", "2147483903",
                          "--seconds", "3", "--trace", str(trace),
                          "--rehearse"]))
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    sources = {m["name"]: m["source"]
               for m in bench["end_to_end"] + bench["per_layer"]}
    assert line["metrics"]
    # no device number from a CPU run
    assert all(sources[m] != "device_trace" for m in line["metrics"])
    if not trace:
        assert "setup_s" in line["metrics"]


def test_a_run_that_finds_no_card_fails_without_a_result():
    proc = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                "--trace", "0"])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_directory_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                "--trace", "0", "--rehearse"], cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

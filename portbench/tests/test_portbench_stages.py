"""scripts/trace_stages_torch.py over each path's rehearsal: the
program's stage spans recorded from the window's start, each stage's
host time before the slice, the cell's summary, no device number from
the CPU; with --spans 0 the tracer records nothing and the benchmark's
own line is the same kind of line."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGES = {
    "vqa-int8-mix": ["xlt.serve.inputs", "xlt.engine.language",
                     "xlt.engine.visual", "xlt.engine.cross",
                     "xlt.serve.head"],
    "t2i-nar4-int8": ["xlt.sampler.language", "xlt.sampler.remask",
                      "xlt.sampler.visual", "xlt.sampler.cross",
                      "xlt.sampler.head", "xlt.sampler.commit",
                      "xlt.render"],
}
HOST = {"vqa-int8-mix": ["engine_host_ms", "enqueue_ms"],
        "t2i-nar4-int8": ["step_host_ms", "sample_ms", "tiling"]}
DEVICE = ["device_ms", "launches", "idle_share", "idle_gaps",
          "engine_idle_share", "engine_launches", "step_device_ms",
          "step_launches"]


def stages(cell, spans):
    proc = subprocess.run(
        [sys.executable, "scripts/trace_stages_torch.py", "--workload",
         cell, "--seed", "2147483903", "--seconds", "3", "--spans",
         str(spans), "--rehearse"], cwd=ROOT, capture_output=True,
        text=True, timeout=240, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    bench, line = proc.stdout.strip().splitlines()[-2:]
    return json.loads(bench), json.loads(line)


@pytest.mark.parametrize("cell", sorted(STAGES))
def test_a_rehearsal_reports_each_stage_on_the_host_alone(cell):
    bench, line = stages(cell, 1)
    assert bench["correct"] is True
    assert sorted(line["host_ms"]) == sorted(STAGES[cell])
    assert all(line[k] > 0 for k in HOST[cell])
    assert not set(DEVICE) & set(line)
    if cell.startswith("t2i"):
        # the language stage and the steps make up the sampler's call
        assert 0.9 < line["tiling"] <= 1.0


def test_the_tracer_never_enabled_records_nothing():
    bench, line = stages("vqa-int8-mix", 0)
    assert bench["correct"] is True
    assert line["spans_recorded"] == 0 and line["host_ms"] == {}
    assert line["enqueue_ms"] > 0

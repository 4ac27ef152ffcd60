"""A cell, a configuration, a traffic mix and a per-layer metric are
added by new files and BENCHMARK.json entries alone: in a copy of the
benchmark, with no file that is there edited, the harness finds them."""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

METRIC = '''"""batches_per_s.vqa: batches answered a second (host clock)."""


def read(rec):
    w = rec.window
    return w["batches"] / (w["t1"] - w["t0"]) if w.get("batches") else None
'''


def test_new_files_add_a_cell_a_config_a_mix_and_a_metric(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "xlxmert_tpu_torch"),
               tmp_path / "xlxmert_tpu_torch")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pb = tmp_path / "portbench"
    before = {p: open(p, "rb").read() for p in pb.rglob("*") if p.is_file()}

    conf = json.load(open(pb / "configs" / "lxmert-base-vqa.json"))
    conf["name"] = "lxmert-base-vqa-copy"
    (pb / "configs" / "lxmert-base-vqa-copy.json").write_text(
        json.dumps(conf))
    mix = json.load(open(pb / "traffic" / "vqa-mix.json"))
    mix["length_mix"] = {"8": 0.5, "20": 0.5}
    (pb / "traffic" / "vqa-two.json").write_text(json.dumps(mix))
    shutil.copy(pb / "workloads" / "vqa-int8-mix.json",
                pb / "workloads" / "vqa-int8-two.json")
    (pb / "metrics" / "batches_per_s.vqa.py").write_text(METRIC)
    bench["configs"].append(dict(bench["configs"][0],
                                 name="lxmert-base-vqa-copy",
                                 file="portbench/configs/"
                                 "lxmert-base-vqa-copy.json"))
    bench["workloads"].append({"name": "vqa-int8-two",
                               "config": "lxmert-base-vqa-copy",
                               "traffic": "vqa-two", "chips": 1,
                               "why": "two lengths"})
    bench["per_layer"].append({"name": "batches_per_s.vqa",
                               "unit": "batches/s", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "answers_per_s",
                               "workloads": ["vqa-int8-two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert open(p, "rb").read() == data

    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "vqa-int8-two",
         "--seed", "77", "--seconds", "3", "--trace", "1", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["batches_per_s.vqa"]["value"] > 0
    assert "enqueue_ms.vqa" not in line["metrics"]

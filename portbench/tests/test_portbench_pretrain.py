"""The pre-training cell `pretrain-b256`: rehearsed end to end on the CPU
(untraced and traced), its five per-layer readers on made-up records
(nothing where the launch count or the program's stages are missing),
the training arithmetic against a hand count, and the control of its
`correct` failing at the rehearsal sizes (on the card: a short run is
correct and the control is not, under the `gpu` marker).

    python -m pytest -q portbench/tests/test_portbench_pretrain.py
"""
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
from pytest import approx

from portbench.lib import arith, arith_train, harness
from portbench.lib.trace import Kernel, Summary

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "pretrain-b256"
METRICS = ("step_launches.pretrain", "idle_share.pretrain", "mfu.pretrain",
           "mha_blhd_train_roofline.pretrain", "optimizer_share.pretrain")


def run(script, args, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, f"portbench/{script}"] + args,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def full_sizes():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "xlxmert-base-pretrain.json")) as f:
        return harness.merged(json.load(f)["sizes"], False)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_end_to_end_on_the_cpu(trace):
    line = run("run.py", ["--workload", CELL, "--seed", "2147483903",
                          "--seconds", "3", "--trace", str(trace),
                          "--rehearse"])
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["attempted"] % (3 * 16) == 0    # whole rounds of 16
    assert set(line["checks"]) == {"grad_err.word_mask", "update_err",
                                   "no_grad_mismatch", "keep_share_z"}
    got = set(line["metrics"])
    if trace:   # no device number from a CPU run
        assert got == set()
    else:
        assert got == {"samples_per_s", "setup_s"}


def test_the_benchmark_names_the_cell_and_its_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert harness.metrics_of(bench, CELL, 0) == [
        m for m in bench["end_to_end"]
        if m["name"] in ("samples_per_s", "setup_s")]
    assert [m["name"] for m in harness.metrics_of(bench, CELL, 1)] == \
        list(METRICS)


def record(slice_work, kernels=(), busy=0.0, program=None):
    s = full_sizes()
    rec = SimpleNamespace(
        sizes=s, traffic={"batch": 256}, workload={}, spans={},
        slice_work=list(slice_work), paced=[], window={},
        trace=Summary(list(kernels), 1.0, busy) if kernels else None)
    if program is not None:
        rec.program_trace = program
    return rec


def attention_kernels(n, dur):
    return [Kernel("void attention_mma::attend_mma_kernel<4, true>",
                   0.001 * i, dur, "portbench.step", "cudaLaunchKernel")
            for i in range(n)]


def test_step_launches_are_the_slices_operations_a_step():
    read = reader("step_launches.pretrain")
    assert read(record([])) is None     # an untraced run
    rec = record(["vis_mask", "word_mask", "matched"],
                 attention_kernels(102, 0.0005))
    assert read(rec) == approx(34.0)


def test_idle_share_reads_the_busy_time_a_step_against_the_pace():
    tasks = ["vis_mask", "word_mask", "matched"]
    rec = record(tasks, attention_kernels(1, 0.01), busy=0.45)
    assert reader("idle_share.pretrain")(rec) is None      # no pace
    rec.paced = [(0.0, None), (0.25, "vis_mask"), (0.5, "word_mask"),
                 (0.75, "matched")]
    # 0.15 s busy a step of 0.25
    assert reader("idle_share.pretrain")(rec) == approx(40.0)


def test_mfu_counts_each_steps_task():
    tasks = ["vis_mask", "word_mask", "matched"]
    rec = record(tasks, attention_kernels(1, 0.01))
    rec.paced = [(0.0, None), (0.3, "vis_mask"), (0.6, "word_mask"),
                 (0.9, "matched")]
    s = rec.sizes
    ops = sum(arith_train.step_ops(s, t, 256, 20) for t in tasks)
    assert reader("mfu.pretrain")(rec) == approx(
        100 * ops / 989e12 / 0.9)
    rec.trace = None    # an untraced run
    assert reader("mfu.pretrain")(rec) is None


def test_the_attention_roofline_counts_34_launches_a_step():
    s = full_sizes()
    work = arith_train.attention_launches(s, 256, 20, True)
    bound = sum(ln.bound_s for ln in work)
    rec = record(["vis_mask", "word_mask"], attention_kernels(68, 0.0005))
    assert reader("mha_blhd_train_roofline.pretrain")(rec) == approx(
        100 * 2 * bound / (68 * 0.0005))
    rec = record(["vis_mask", "word_mask"], attention_kernels(67, 0.0005))
    assert reader("mha_blhd_train_roofline.pretrain")(rec) is None
    assert reader("mha_blhd_train_roofline.pretrain")(record([])) is None


def test_the_optimizer_share_reads_the_programs_stages():
    def k(span, dur):
        return Kernel("elementwise", 0.0, dur, span, "cudaLaunchKernel")

    program = Summary([k("xlt.train.forward", 0.06),
                       k("xlt.train.backward", 0.1),
                       k("xlt.train.clip", 0.01),
                       k("xlt.train.optimizer", 0.03)], 1.0, 0.2)
    read = reader("optimizer_share.pretrain")
    assert read(record(["vis_mask"], program=program)) == approx(20.0)
    # a program without the stages, and a run without the summary
    bare = Summary([k("portbench.step", 0.1)], 1.0, 0.1)
    assert read(record(["vis_mask"], program=bare)) is None
    assert read(record(["vis_mask"])) is None


SMALL = dict(vocab_size=10, hidden_size=4, num_attention_heads=2,
             intermediate_size=8, l_layers=1, x_layers=1, r_layers=1,
             visual_feat_dim=6, visual_pos_dim=4, visual_tokens=2,
             num_clusters=5)


@pytest.mark.parametrize("task,ops", [("vis_mask", 9936),
                                      ("word_mask", 10800),
                                      ("matched", 9904)])
def test_step_operations_match_a_hand_count(task, ops):
    """B = 1, L = 3, V = 2, hidden 4, 2 heads of 2, FFN 8, features 6:
    2MKN a product forward, as much again for each gradient it feeds.
    vis_mask: visn_fc 96 x 3, box_fc 64 x 2, the language layer
    (4 x 96 + 144 + 2 x 192) x 3, the visual layer (4 x 64 + 64 + 2 x
    128) x 3, the cross layer's language side 416 + 912 forward only, its
    visual side 416 x 3 + 576 x 3, the pooler 32, the head 64 x 3 + 96 x
    3 + 120 x 2; word_mask: visn_fc 96 x 2, the cross layer's sides the
    other way round, the head 96 x 3 + 240 x 3; matched: the pooler and
    the 2-way head 16 at x 3."""
    assert arith_train.step_ops(SMALL, task, 1, 3) == ops


def test_attention_launch_bytes_and_operations():
    ln = arith_train.attention_launch(2, 12, 20, 64, 64, True, True)
    # q, out (2, 20, 768), k, v (2, 64, 768) bf16; bias (2, 64) bf16;
    # mask (2, 12, 20, 64) bf16
    assert ln.nbytes == 2 * 168 * 768 * 2 + 2 * 64 * 2 + 2 * 12 * 20 * 64 * 2
    assert ln.ops == 4 * 2 * 12 * 20 * 64 * 64
    assert ln.kind == "bfloat16" and ln.kernel == "mha_blhd_train"
    assert ln.bound_s == max(ln.nbytes / arith.HBM_BYTES_PER_S,
                             ln.ops / 989e12)
    work = arith_train.attention_launches(full_sizes(), 256, 20, True)
    assert len(work) == 34
    assert sum(1 for w in work if w.nbytes == arith_train.attention_launch(
        256, 12, 20, 20, 64, True, True).nbytes) == 9 + 5


@pytest.mark.parametrize("seed", [2147483711, 2147483721, 2147483731])
def test_the_control_comes_out_not_correct(seed, capsys):
    assert harness.control_main(["--workload", CELL, "--seed", str(seed),
                                 "--rehearse"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert any(v["fails"] for v in line["control"].values()), line


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(card):
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483801", "--seconds", "5", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_the_control_on_the_card_is_not_correct(card):
    proc = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", CELL,
         "--seed", "2147483803"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert any(v["fails"] for v in line["control"].values())

"""On the card (the `gpu` marker; skipped without one): a short run of
each cell is correct, and the control at the cell's own sizes is not.

    python -m pytest -q -m gpu portbench/tests/test_portbench_chip.py
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ["vqa-int8-mix", "t2i-nar4-int8", "vqa-fused-mix"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def last_line(script, args):
    proc = subprocess.run([sys.executable, f"portbench/{script}"] + args,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    line = last_line("run.py", ["--workload", cell, "--seed", "2147483801",
                                "--seconds", "5", "--trace", "0"])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS[:2])
def test_the_control_on_the_card_is_not_correct(card, cell):
    line = last_line("control.py", ["--workload", cell, "--seed",
                                    "2147483803"])
    assert any(v["fails"] for v in line["control"].values())

"""chip_smoke.py's phase (m), FID, on the CPU at a small size with the
card's work done on CPU tensors: both extractors run through eval_fid's
path below its file reading, the host resize and the Fréchet distance
are timed, the card-vs-CPU gates hold, and no port kernel launches."""
import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from test_torch_fid import share_the_cores_and_blas  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("share_the_cores_and_blas")

# 3 + 3 images in batches of 2 (a partial last batch of each set)
SMALL = dict(batch=2, images=3, size=48, coco=(30, 40), check=1,
             fid_check=4)


def test_fid_phase_runs_on_the_cpu():
    from xlxmert_tpu_torch.ops import attention

    log = []
    kernels = [attention.KERNEL, attention.TRAIN_KERNEL]
    out = chip_smoke.run_fid_path(torch, argparse.Namespace(seed=0),
                                  kernels, log.append, device="cpu",
                                  sizes=SMALL)
    assert out["launches"] == {"mha_blhd": 0, "mha_blhd_train": 0}
    for kind in ("inception", "resnet"):
        run = out["extractors"][kind]
        assert run["fid"] > 0 and run["images_per_s"] > 0
    assert out["resize_ms"] > 0 and out["frechet_s"] > 0
    for mode in ("tf32", "tf32_off"):
        assert out["pool3_card_vs_cpu"][mode]["cosine"] > 0.9999999
    assert out["fid_card_vs_cpu"]["rel_diff"]["tf32_off"] == 0.0
    assert any("pool3 card vs CPU" in m for m in log)
    json.dumps(out)       # chip_smoke writes it to --out


def test_fid_images_are_in_range_and_the_fake_set_differs():
    real = chip_smoke.fid_images(4, 16, seed=0)
    fake = chip_smoke.fid_images(4, 16, seed=1, shift=0.1)
    assert real.shape == (4, 16, 16, 3) and real.dtype == np.float32
    assert 0.0 <= real.min() and real.max() <= 1.0
    assert fake.mean() > real.mean() + 0.05

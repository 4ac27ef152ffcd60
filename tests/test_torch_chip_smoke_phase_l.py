"""chip_smoke.py's phase (l), the offline feature factory, on the CPU at
a small size with the card's work done on CPU tensors: every part runs
(k-means, the grid extractor in both types, the bbox path and its
split, each card-vs-CPU check), no port kernel launches,
and its widths are bench.py measure_factory's."""
import argparse
import ast
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from test_torch_chip_smoke import share_the_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("share_the_cores")

SMALL = dict(rows=3072, clusters=40, dim=32, chunk=1024, check_rows=600,
             check_clusters=16, grid_batch=2, canvas=(480, 640),
             image=(470, 630), grid=4, timed=1, check_canvas=(64, 96),
             bbox_batch=2, proposals=60, classes=11, num_features=8,
             config=dict(stage_blocks=(1, 1, 1, 1), num_groups=2,
                         width_per_group=4, stem_channels=8,
                         stage_out_channels=(16, 32, 64, 128), fpn_dim=16,
                         mlp_dim=24))


def test_factory_phase_runs_on_the_cpu():
    from xlxmert_tpu_torch.ops import attention

    log = []
    kernels = [attention.KERNEL, attention.FUSED_MHA_KERNEL]
    out = chip_smoke.run_factory_path(
        torch, argparse.Namespace(seed=0), kernels, log.append,
        device="cpu", sizes=SMALL)
    assert out["launches"] == {"mha_blhd": 0, "fused_mha": 0}
    km = out["kmeans"]
    assert km["rows_per_s"] > 0 and km["card_vs_cpu"]["failures"] == []
    assert km["bound"]["bound_by"] in ("bytes", "operations")
    assert set(out["grid"]["runs"]) == {"bf16", "fp32"}
    assert out["grid"]["card_vs_cpu"]["cosine"] >= chip_smoke.GRID_COSINE
    assert out["grid"]["bf16_vs_fp32"]["cosine"] >= chip_smoke.BF16_COSINE
    lv = out["grid"]["levels_card_vs_cpu"]
    assert lv["levels"] == [2, 3, 4, 5]
    assert lv["pooled"]["cosine"] >= chip_smoke.GRID_COSINE
    assert lv["fc6"]["cosine"] >= chip_smoke.GRID_COSINE
    bbox = out["bbox"]
    assert set(bbox["parts_s"]) == {"backbone_rpn_head", "proposals_nms",
                                    "box_head", "select_top_features"}
    units = bbox["card_vs_cpu"]
    assert units["proposals"]["mismatches"] == []
    for name in ("cls", "fc6", "fc7"):
        assert units[name]["cosine"] >= chip_smoke.GRID_COSINE, name
    assert units["select"] == {"keep_boxes_equal": True,
                               "obj_id_equal": True}
    assert any("k-means Lloyd step" in m for m in log)
    assert any("bbox card vs CPU" in m for m in log)
    json.dumps(out)       # chip_smoke writes it to --out


def test_proposal_comparison_allows_only_near_tie_swaps():
    inf = float("inf")
    host = {"ids": torch.tensor([[5, 7, 9, 2]]),
            "scores": torch.tensor([[3.0, 2.0, 2.0, -inf]])}
    swapped = {"ids": torch.tensor([[5, 9, 7, 4]]),
               "scores": torch.tensor([[3.0, 2.0, 2.0, -inf]])}
    got = chip_smoke._proposal_ids_agree(swapped, host)
    assert got["near_tie_swaps"] == 2 and got["mismatches"] == []
    assert got["valid"] == 3 and got["valid_equal"]
    apart = {"ids": torch.tensor([[7, 5, 9, 2]]),
             "scores": torch.tensor([[3.0, 2.0, 2.0, -inf]])}
    assert chip_smoke._proposal_ids_agree(apart, host)["mismatches"] == [
        (0, 0), (0, 1)]


def test_factory_widths_are_measure_factorys():
    """FACTORY_SIZES against bench.py measure_factory's constants (N, K,
    D, chunk; B, H, W of the grid canvas)."""
    src = open(os.path.join(ROOT, "bench.py")).read()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef)
              and n.name == "measure_factory")
    consts = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Tuple) and isinstance(node.value,
                                                           ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            values = [v.value for v in node.value.elts]
            consts.update(zip(names, values))
    sz = chip_smoke.FACTORY_SIZES
    assert (sz["rows"], sz["clusters"], sz["dim"], sz["chunk"]) == (
        consts["N"], consts["Kc"], consts["D"], consts["chunk"])
    assert (sz["grid_batch"], *sz["canvas"]) == (consts["B"], consts["H"],
                                                 consts["W"])
    assert sz["image"] == (800, 1333)

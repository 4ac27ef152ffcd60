"""The launch plans of the two whole-chain kernels (ops/_plan.py), which
mirror their CUDA index arithmetic: at every path shape (the rows of
chip_smoke's fused_ffn and fused_block cases) and at ragged ones, the
CTAs of a launch cover every row, and on each row block every
intermediate column (per column half), every FFN output column, every
normalised output column and every tail column, exactly once."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from xlxmert_tpu_torch.core.config import LxmertConfig  # noqa: E402
from xlxmert_tpu_torch.ops import _plan  # noqa: E402

CFG = LxmertConfig()
PATH_ROWS = sorted({M for M, _ in chip_smoke.ffn_cases(CFG, chip_smoke.BATCH)}
                   | {M for M, _, _ in chip_smoke.fused_block_cases(
                       CFG, chip_smoke.BATCH)})
EDGE_ROWS = [1, 63, 64, 65, 127, 129, 200, 8000]


def _partition(ranges, n):
    """True when the ranges cover [0, n) exactly once."""
    cover = [0] * n
    for r in ranges:
        for i in r:
            cover[i] += 1
    return cover == [1] * n


@pytest.mark.parametrize("M", PATH_ROWS + EDGE_ROWS)
@pytest.mark.parametrize("I,Nq", [(3072, 2304), (128, 128), (192, 0),
                                  (0, 2304)])
def test_the_plan_covers_every_row_and_column_once(M, I, Nq):
    split = _plan.launch_plan(M, I)
    assert split in (1, 2)
    if I:
        assert -(-I // _plan.CHUNK) % split == 0
    blocks = {}
    for cta in range(_plan.ctas(M, split)):
        w = _plan.cta_work(cta, M, I, Nq, split)
        assert len(w["rows"]) <= _plan.ROWS
        blocks.setdefault((w["rows"].start, w["rows"].stop), []).append(w)
    starts = sorted(blocks)
    assert starts[0][0] == 0 and starts[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(starts, starts[1:]))
    for work in blocks.values():
        assert len(work) == 2 * split
        for half in (0, 1):
            mine = [w for w in work
                    if w["sums"].start == 384 * half]
            assert len(mine) == split
            assert _partition([w["inter"] for w in mine], I)
        assert _partition({(w["sums"].start, w["sums"].stop): w["sums"]
                           for w in work}.values(), _plan.HIDDEN)
        assert _partition([w["out"] for w in work], _plan.HIDDEN)
        assert _partition([w["tail"] for w in work], Nq)


def test_the_split_takes_a_second_wave_of_pairs_only_where_it_pays():
    """Path shapes: the visual rows (256 row blocks) and the text rows up
    to L=16 run pairs only; L=20's 80 row blocks (160 pair CTAs, a second
    wave of 28) split the intermediate."""
    assert [(M, _plan.launch_plan(M, 3072)) for M in (2048, 3072, 4096,
                                                      5120, 16384)] == [
        (2048, 1), (3072, 1), (4096, 1), (5120, 2), (16384, 1)]
    assert _plan.launch_plan(5120, 3 * 128) == 1  # 3 chunks: no split

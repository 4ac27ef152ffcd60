"""Launch plans of the two whole-chain kernels, `csrc/fused_ffn.cu` and
`csrc/fused_block.cu`.

A CTA owns a block of ROWS rows and a part of its columns: a
thread-block cluster of 2 x `split` CTAs shares each row block. Two
halves of the output's columns each take the FFN's sums of their 384
columns; `split` slices of the intermediate (CHUNK-wide chunks) each
compute theirs (both halves of a slice compute its activation); the 2 x
`split` CTAs take equal parts of the out-projection's, the LayerNorms'
and the tail's columns, and meet through distributed shared memory. The
split multiplies the CTAs where the row blocks do not fill the card (the
text rows). `cta_work` is the kernels' own index arithmetic, written out
so that a test can show that a plan covers every row and every column
exactly once.
"""
from __future__ import annotations

ROWS = 64      # rows a CTA: one wgmma row tile per warpgroup
CHUNK = 128    # intermediate columns a chunk
TILE = 64      # output and tail columns a tile
HIDDEN = 768
SMS = 132      # SMs of an H100 SXM


def launch_plan(M: int, I: int = 0) -> int:
    """The split for M rows and an intermediate of I (0: none). 1 (a
    pair a row block) unless the pairs need a second wave that a split
    of the intermediate into 2 (dividing its chunks) fills better: the
    split's partial sums and its smaller CTAs cost more than they gain
    within one wave (H100 timings, PERF.md)."""
    pairs = 2 * -(-M // ROWS)
    if pairs <= SMS or (I and -(-I // CHUNK) % 2):
        return 1
    return 2 if -(-2 * pairs // SMS) / 2 < -(-pairs // SMS) else 1


def ctas(M: int, split: int) -> int:
    return -(-M // ROWS) * 2 * split


def _part(n: int, j: int, c: int) -> range:
    return range(n * j // c, n * (j + 1) // c)


def cta_work(cta: int, M: int, I: int, Nq: int, split: int) -> dict:
    """What CTA `cta` of a launch computes, as the kernels index it: its
    rows, its intermediate columns, the FFN output columns it sums, the
    output columns it normalises and writes and the tail columns (Nq
    wide) it computes."""
    parts = 2 * split
    r = cta % parts
    half, s = r // split, r % split
    m0 = (cta // parts) * ROWS
    per = -(-I // CHUNK) // split
    tiles = _part(Nq // TILE, r, parts)
    own = _part(HIDDEN // TILE, r, parts)
    return {"rows": range(m0, min(m0 + ROWS, M)),
            "inter": range(min(per * s * CHUNK, I),
                           min(per * (s + 1) * CHUNK, I)),
            "sums": range(384 * half, 384 * (half + 1)),
            "out": range(own.start * TILE, own.stop * TILE),
            "tail": range(tiles.start * TILE, tiles.stop * TILE)}

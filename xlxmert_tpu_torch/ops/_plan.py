"""Launch plans of the two whole-chain kernels, `csrc/fused_ffn.cu` and
`csrc/fused_block.cu`, and of the batched-head attention,
`csrc/mha_hbatch.cu`.

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

`hbatch_plan` gives `csrc/mha_hbatch.cu` its grid (B, G): CTA (b, g)
walks heads [g H/G, (g+1) H/G) of batch row b through a ring of slots
in shared memory, `lanes` heads at a time, one warp a 16-row q tile of
a lane's head. `hbatch_cta_work` is that kernel's index arithmetic, and
`hbatch_resident` the CTAs an SM holds at once by the kernel's limits
(shared memory, threads, the registers its launch bounds leave a
thread, its named barriers).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

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


# csrc/mha_hbatch.cu
HBATCH_SLOTS = 8           # ring slots a CTA, at most
HBATCH_ROW_BYTES = 144     # a shared-memory row: 64 bf16 + 16 B padding
SM_SMEM = 233_472          # shared memory an SM holds (228 KB)
CTA_SMEM = 232_448         # dynamic shared memory a CTA may have (227 KB)
CTA_RESERVED = 1_024       # shared memory the system keeps a CTA
SM_THREADS = 2_048
HBATCH_SM_CTAS = 4         # the kernel's 16 named barriers: 4 CTAs an SM


def hbatch_max_warps(Lk: int) -> int:
    """Warps a CTA, at most, by the kernel's launch bounds (two CTAs an
    SM): 12 up to 32 keys, 8 beyond (where the per-tile body needs more
    than the 80 registers a thread that 12 warps leave)."""
    return 12 if Lk <= 32 else 8


def hbatch_regs(Lk: int) -> int:
    """Registers a thread, at most, under those bounds: 65,536 over two
    CTAs' threads, in steps of 8."""
    return 65_536 // (2 * 32 * hbatch_max_warps(Lk)) // 8 * 8


class HbatchPlan(NamedTuple):
    grid: tuple      # (B, G)
    heads: int       # heads a CTA walks: H / G
    lanes: int       # heads computed at once, one warp a q tile each
    slots: int       # ring slots, one head's q, k and v each
    warps: int       # lanes x q tiles of 16 rows
    smem: int        # dynamic shared memory bytes a CTA

    def launch_args(self) -> tuple:
        """The plan as `mha_hbatch_launch` takes it: G, heads, lanes,
        slots, warps, bytes."""
        return (self.grid[1], self.heads, self.lanes, self.slots,
                self.warps, self.smem)


@functools.lru_cache(maxsize=None)
def hbatch_plan(B: int, H: int, Lq: int, Lk: int) -> HbatchPlan:
    """One CTA a batch row (G = 1) where the rows fill the card, else the
    fewest head groups G (a divisor of H) whose B x G CTAs do, or one
    head a CTA. Then the lanes (at most hbatch_max_warps warps) and the
    ring's slots (more than the lanes, so that a head is in flight while
    the lanes compute, unless every head has a slot) that run the CTAs in
    the fewest waves, with the most warps at work an SM, then with the
    most slots: the per-head body is latency-bound (a warp's softmax),
    so once the ring hides the loads the warps in flight set the pace.
    Cached: the wrapper asks at every launch."""
    G = next((d for d in range(1, H + 1) if H % d == 0 and B * d >= SMS),
             H)
    heads, qt = H // G, -(-Lq // 16)
    best = None
    for lanes in range(1, min(heads, hbatch_max_warps(Lk) // qt) + 1):
        for slots in range(min(heads, lanes + 1),
                           min(heads, HBATCH_SLOTS) + 1):
            plan = HbatchPlan((B, G), heads, lanes, slots, lanes * qt,
                              hbatch_smem(Lq, Lk, slots, heads))
            on_sm = hbatch_resident(plan, Lk)
            if plan.smem > CTA_SMEM or on_sm < 1:
                continue
            waves = -(-B * G // (SMS * on_sm))
            busy = min(on_sm, -(-B * G // SMS)) * plan.warps
            key = (waves, -busy, -slots)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def hbatch_smem(Lq: int, Lk: int, slots: int, heads: int) -> int:
    """Bytes of `slots` ring slots (q, k and v of a head, each padded to
    16 rows), an 8-byte barrier a head and the Lk fp32 bias values."""
    return (slots * 16 * (-(-Lq // 16) + 2 * -(-Lk // 16))
            * HBATCH_ROW_BYTES + 8 * heads + 4 * Lk)


def hbatch_cta_work(plan: HbatchPlan, bx: int, by: int) -> dict:
    """What CTA (bx, by) of a launch computes, as the kernel indexes it:
    its batch row, and each lane's heads in order with the slot each
    lands in (head j of the CTA: slot j % slots)."""
    h0 = by * plan.heads
    return {"row": bx, "lanes": [
        [(h0 + j, j % plan.slots) for j in range(p, plan.heads, plan.lanes)]
        for p in range(plan.lanes)]}


def hbatch_resident(plan: HbatchPlan, Lk: int) -> int:
    """CTAs of the plan an SM holds at once."""
    threads = 32 * plan.warps
    return min(SM_SMEM // (plan.smem + CTA_RESERVED),
               SM_THREADS // threads,
               65_536 // (threads * hbatch_regs(Lk)), HBATCH_SM_CTAS)

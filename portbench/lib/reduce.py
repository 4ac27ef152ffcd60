"""What several metric readers share: the port's kernel names as the
device trace shows them, and a kernel's share of its roofline over the
traced slice's dispatched work.

A reader returns None where it finds nothing to read: no traced slice
(an untraced or CPU run), or a slice whose launches of the kernel do not
match the work dispatched inside it (then the bytes and operations
would be counted for other launches than those timed).
"""
from __future__ import annotations

from typing import Callable, List, Optional

from portbench.lib import arith

# the __global__ functions of xlxmert_tpu_torch/csrc/, by kernel
KERNEL_NAMES = {
    "int8_dense": ("int8_dense_kernel",),
    "mha_blhd": ("attend_mma_kernel", "mha_blhd_kernel"),
    "fused_block": ("fused_block_kernel",),
    "fused_ffn": ("fused_ffn_kernel",),
    "mha_hbatch": ("mha_hbatch_kernel",),
    "mha_int8": ("mha_int8_kernel",),
}
PORT_KERNELS = tuple(p for names in KERNEL_NAMES.values() for p in names)


def slice_launches(rec, launches_of: Callable[[object], List[arith.Launch]]
                   ) -> List[arith.Launch]:
    """Every port-kernel launch of the work dispatched inside the slice:
    `launches_of(item)` for each item the path recorded there."""
    out: List[arith.Launch] = []
    for item in rec.slice_work:
        out.extend(launches_of(item))
    return out


def roofline_pct(rec, kernel: str,
                 launches_of: Callable[[object], List[arith.Launch]]
                 ) -> Optional[float]:
    """100 x the least time of `kernel`'s launches in the slice over the
    device time its kernels took there."""
    tr = rec.trace
    if tr is None or not rec.slice_work:
        return None
    work = [ln for ln in slice_launches(rec, launches_of)
            if ln.kernel == kernel]
    names = KERNEL_NAMES[kernel]
    if not work or tr.count(names) != len(work):
        return None
    t = tr.device_s(names)
    return 100.0 * sum(ln.bound_s for ln in work) / t if t > 0 else None


def paced_s(rec) -> Optional[float]:
    """Seconds between the completions of the batches before the traced
    slice: the window's untraced pace, a batch."""
    p = rec.paced
    if len(p) < 2:
        return None
    return (p[-1][0] - p[0][0]) / (len(p) - 1)


def idle_pct(rec) -> Optional[float]:
    """100 x the share of a batch's time at the window's untraced pace in
    which the card is idle: 1 - the slice's busy time a batch over the
    pace. The slice's own pace is the profiler's: it slows each launch."""
    tr, per = rec.trace, paced_s(rec)
    if tr is None or not rec.slice_work or per is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / len(rec.slice_work) / per)

"""mha_blhd_roofline.vqa (device trace): the least time of the
packed-head attention launches of the batches dispatched in the slice
(q, k, v, out and the key bias at 3.35 TB/s or q.k and p.v at 989 bf16
TFLOP/s, the larger, each launch) over the device time of
csrc/mha_blhd.cu's kernel there."""

from portbench.lib import arith
from portbench.lib.reduce import roofline_pct


def read(rec):
    B = int(rec.traffic["batch"])
    engine = rec.workload["engine"]
    return roofline_pct(rec, "mha_blhd", lambda L: arith.vqa_forward_launches(
        rec.sizes, B, L, engine))

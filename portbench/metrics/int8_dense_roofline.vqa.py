"""int8_dense_roofline.vqa (device trace): the least time of the int8
dense launches of the batches dispatched in the slice (bytes at 3.35
TB/s or operations at 1,979 TOP/s, the larger, each launch) over the
device time of csrc/int8_dense.cu's kernel there."""

from portbench.lib import arith
from portbench.lib.reduce import roofline_pct


def read(rec):
    B = int(rec.traffic["batch"])
    engine = rec.workload["engine"]
    return roofline_pct(rec, "int8_dense", lambda L: arith.vqa_forward_launches(
        rec.sizes, B, L, engine))

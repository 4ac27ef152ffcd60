"""int8_dense_roofline.t2i (device trace): the least time of the int8
sampler's int8 dense launches in the slice's batches (the language
stack once, then each decode step's; bytes at 3.35 TB/s or operations
at 1,979 TOP/s, the larger, each launch) over the device time of
csrc/int8_dense.cu's kernel there."""

from portbench.lib import arith
from portbench.lib.reduce import roofline_pct


def read(rec):
    s, w = rec.sizes, rec.workload
    return roofline_pct(rec, "int8_dense", lambda B: arith.sampler_launches(
        s, B, s["max_text_length"], w["sample_steps"]))

"""mfu.t2i (host clock): the analytic operations of the samples
completed before the traced slice (the int8 sampler's products at 1,979
TOP/s; its attention cores, box_fc and the render's convolutions and
resizes at 989 bf16 TFLOP/s) over the time they took, from the first
batch's images on the host to the last one's."""

from portbench.lib import arith


def read(rec):
    p = rec.paced
    if rec.trace is None or len(p) < 2:     # a run on the card, traced
        return None
    s, w = rec.sizes, rec.workload
    one = arith.peak_seconds(arith.sample_ops(s, s["max_text_length"],
                                              w["sample_steps"]))
    return 100.0 * one * sum(n for _, n in p[1:]) / (p[-1][0] - p[0][0])

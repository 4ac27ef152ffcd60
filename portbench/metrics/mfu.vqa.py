"""mfu.vqa (host clock): the model's analytic operations for the answers
completed before the traced slice (bench.py's count: int8 products at
1,979 TOP/s, attention cores, box_fc and the pooler at 989 bf16
TFLOP/s) over the time they took, from the first batch's answers on the
host to the last one's."""

from portbench.lib import arith


def read(rec):
    p = rec.paced
    if rec.trace is None or len(p) < 2:     # a run on the card, traced
        return None
    B = int(rec.traffic["batch"])
    need = sum(B * arith.peak_seconds(arith.vqa_forward_ops(rec.sizes, L))
               for _, L in p[1:])
    return 100.0 * need / (p[-1][0] - p[0][0])

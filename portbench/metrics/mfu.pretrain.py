"""mfu.pretrain (host clock): the model operations of the training steps
completed before the traced slice (forward plus backward, without the
attention's recompute; portbench/lib/arith_train.step_ops, each step by
its task), at 989 bf16 TFLOP/s, over the time they took from the
window's start."""

from portbench.lib import arith, arith_train


def read(rec):
    p = rec.paced
    if rec.trace is None or len(p) < 2:     # a run on the card, traced
        return None
    s = rec.sizes
    B, L = int(rec.traffic["batch"]), s["max_text_length"]
    ops = sum(arith_train.step_ops(s, task, B, L) for _, task in p[1:])
    return (100.0 * ops / arith.PEAK_OPS_PER_S["bfloat16"]
            / (p[-1][0] - p[0][0]))

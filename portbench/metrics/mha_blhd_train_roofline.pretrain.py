"""mha_blhd_train_roofline.pretrain (device trace): the least time of the
training attention's forward launches of the steps in the slice (34 a
step; q, k, v, out, the key bias and the dropout mask at 3.35 TB/s or
4 B H Lq Lk D operations at 989 bf16 TFLOP/s, the larger, each launch;
portbench/lib/arith_train) over the device time of
csrc/mha_blhd_train.cu's bf16 kernel (attention_mma.cuh's
attend_mma_kernel) there; nothing where the launch count differs."""

from portbench.lib import arith_train


def read(rec):
    tr = rec.trace
    if tr is None or not rec.slice_work:
        return None
    s = rec.sizes
    B, L = int(rec.traffic["batch"]), s["max_text_length"]
    dropout = s.get("attention_probs_dropout_prob", 0.0) > 0
    work = [ln for _ in rec.slice_work
            for ln in arith_train.attention_launches(s, B, L, dropout)]
    names = arith_train.TRACE_NAMES
    if tr.count(names) != len(work):
        return None
    t = tr.device_s(names)
    return 100.0 * sum(ln.bound_s for ln in work) / t if t > 0 else None

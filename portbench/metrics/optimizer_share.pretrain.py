"""optimizer_share.pretrain (device trace): the share of the slice's
device time launched under the program's `xlt.train.clip` and
`xlt.train.optimizer` stages (the global norm and clip, AdamW's
update; core/optim), read from the path's second summary
of the slice over the harness's and the program's spans. Nothing where
the slice holds no `xlt.train.*` stage (a program without them)."""

STAGES = ("xlt.train.clip", "xlt.train.optimizer")


def read(rec):
    tr = getattr(rec, "program_trace", None)
    if tr is None:
        return None
    if not any(k.span.startswith("xlt.train.") for k in tr.kernels):
        return None
    total = tr.device_s()
    if total <= 0:
        return None
    return 100.0 * sum(k.dur for k in tr.kernels
                       if k.span in STAGES) / total

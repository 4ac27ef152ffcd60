"""step_launches.pretrain (device trace): the card's operations a
training step in the traced slice (every operation there over the
slice's steps, whole rounds of the three tasks): the work the host
issues a step, one launch at a time, which sets the pace where the host
issues a step more slowly than the card runs it."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.slice_work:
        return None
    return len(tr.kernels) / len(rec.slice_work)

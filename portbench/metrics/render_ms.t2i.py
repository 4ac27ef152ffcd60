"""render_ms.t2i (device trace): the device time of the operations that
models/gan.render launched in the slice, a batch."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.slice_work:
        return None
    return 1e3 * tr.span_device_s("portbench.render") / len(rec.slice_work)

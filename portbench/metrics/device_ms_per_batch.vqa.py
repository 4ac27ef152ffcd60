"""device_ms_per_batch.vqa (device trace): the device time of every
operation launched while the slice was traced, over the batches
dispatched in it (the engine: serving/lxmert_int8 or lxmert_fused, the
feature_cache gather, the answer head and the answers' copy)."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.slice_work:
        return None
    return 1e3 * tr.device_s() / len(rec.slice_work)

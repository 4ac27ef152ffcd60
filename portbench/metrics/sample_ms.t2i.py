"""sample_ms.t2i (host clock): the mean host time of one call of the int8
sampler (serving/sampling_int8 through cli/sample_images.build_sampler's
run), which dispatches its decode steps, over every batch of the
window."""


def read(rec):
    spans = rec.spans.get("sample")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

"""enqueue_ms.vqa (host clock): the mean host time of one call of the
serving forward (cli/serve), which dispatches a batch without waiting
for the card, over every batch of the window outside the traced slice."""


def read(rec):
    spans = rec.spans.get("enqueue")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

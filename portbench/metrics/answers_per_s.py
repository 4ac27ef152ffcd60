"""answers_per_s (host clock): every answer whose argmax reached the
host, over the window from its first dispatch to its last fetch."""


def read(rec):
    w = rec.window
    if not w.get("answers"):
        return None
    return w["answers"] / (w["t1"] - w["t0"])

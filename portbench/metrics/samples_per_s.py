"""samples_per_s (host clock): every image that reached host memory as
float32, over the window from its first batch's start to its last
batch's end."""


def read(rec):
    w = rec.window
    if not w.get("samples"):
        return None
    return w["samples"] / (w["t1"] - w["t0"])

"""t2i_batch_p95_ms (host clock): the 95th percentile over every batch of
the window, from its captions handed to the sampler to its images on
the host (linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    lat = rec.window.get("latency_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))

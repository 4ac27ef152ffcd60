"""graph_share.t2i (device trace): the share of the device time of the
operations launched inside the harness's sample span (the int8 NAR
sampler's call) whose launching call was a CUDA graph's launch
(`cudaGraphLaunch`): 100 when the call replays one graph, 0 when it
launches each operation itself."""

SPAN = "portbench.sample"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    inside = [k for k in tr.kernels if k.span == SPAN]
    total = sum(k.dur for k in inside)
    if total <= 0:
        return None
    graphed = sum(k.dur for k in inside
                  if k.call.startswith("cudaGraphLaunch"))
    return 100.0 * graphed / total

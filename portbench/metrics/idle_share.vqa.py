"""idle_share.vqa (device trace): the share of a batch's time at the
window's untraced pace (the host clock between the batches completed
before the slice) in which no operation ran on the card (the slice's
busy time a batch). The profiler slows each launch in the slice, so the
slice's own busy_s over window_s reads a host-paced cell idler."""

from portbench.lib.reduce import idle_pct


def read(rec):
    return idle_pct(rec)

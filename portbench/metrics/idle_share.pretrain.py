"""idle_share.pretrain (device trace): the share of a step's time at the
window's untraced pace (the host clock from the window's start to the
last step completed before the slice, over those steps) in which no
operation ran on the card (the slice's busy time a step; the slice holds
whole rounds of the three tasks)."""

from portbench.lib.reduce import idle_pct


def read(rec):
    return idle_pct(rec)

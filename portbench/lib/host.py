"""The host's speed around the window, printed on standard error.

The measured rates of the host-paced cells follow the speed of the
card's host, which is shared with other machines' work: a fixed piece
of Python timed just before and just after the window tells a run that
read far off because its host was slow from one that changed.
"""
from __future__ import annotations

import sys
import time

PROBE_STEPS = 1_000_000


def probe_ms() -> float:
    """Milliseconds the host takes for a fixed loop of Python."""
    t = time.perf_counter()
    x = 0
    for i in range(PROBE_STEPS):
        x += i & 7
    return 1e3 * (time.perf_counter() - t)


def report(before_ms: float, spans) -> None:
    """Print the probe before and after the window, and the mean of each
    host span list in `spans` ({name: [seconds]})."""
    parts = [f"host: a fixed Python loop {before_ms:.1f} ms before the "
             f"window, {probe_ms():.1f} ms after"]
    for name, v in sorted(spans.items()):
        if v:
            parts.append(f"{name} {1e3 * sum(v) / len(v):.2f} ms "
                         f"({len(v)})")
    print("; ".join(parts), file=sys.stderr)

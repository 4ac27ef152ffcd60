"""Tracing (port of xlxmert_tpu/utils/profiling.py's `trace`) and the
program's stage spans.

- `span(name)`: a named stage of the program's hot paths
  ("xlt.engine.language", "xlt.sampler.head", ...). The spans of a path
  are flat: none opens inside another, so each device launch falls in
  at most one. Off by default, a span costs one test of a module flag
  and hands back a shared null context: no allocation, no clock read.
  After `enable()` every span that closes appends (start_ns, end_ns,
  name), read on `time.time_ns()`, to a buffer that `drain()` hands
  over and empties; `disable()` stops recording. A device trace whose
  clock is tied to `time.time_ns()` (as portbench/lib/trace.py ties
  torch.profiler's through marker calls) then charges each launch to
  the stage that issued it.
- `count(name)`: a counter of how often a mechanism of the program
  engages ("xlt.sampler.graphs_captured", ...), beside the spans and
  under the same rule: off, one flag test; after `enable()` it adds to
  a total that `counts()` reads and `drain_counts()` hands over and
  empties.
- `trace(logdir)`: a torch.profiler context over the CPU and, where
  there is one, the card; inside it every span also opens a
  `record_function`, so the stages are ranges of the trace. On exit it
  writes a Chrome trace (`<host>_<pid>.<ms>.pt.trace.json`, TensorBoard's
  profiler plugin and Perfetto read it) into `logdir`; without a logdir
  nothing is written and the caller reads the yielded profiler.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

Span = Tuple[int, int, str]

_active = False     # any span work: recording, or ranges inside trace()
_recording = False
_ranges = 0         # trace() contexts open
_spans: List[Span] = []
_counts: Dict[str, int] = {}
_NULL = contextlib.nullcontext()


def _update() -> None:
    global _active
    _active = _recording or _ranges > 0


class _Stage:
    __slots__ = ("name", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _ranges:
            import torch

            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns() if _recording else None
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            _spans.append((self.start, time.time_ns(), self.name))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """Context manager for one stage of the program; see the module
    docstring."""
    if not _active:
        return _NULL
    return _Stage(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while recording; see the module
    docstring."""
    if _recording:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """The counters' totals so far (a copy)."""
    return dict(_counts)


def drain_counts() -> Dict[str, int]:
    """The counters' totals so far; empties them."""
    global _counts
    out, _counts = _counts, {}
    return out


def recording() -> bool:
    """Whether spans and counters are being recorded."""
    return _recording


def enable() -> None:
    """Record every span from here on."""
    global _recording
    _recording = True
    _update()


def disable() -> None:
    """Stop recording; what was recorded stays until `drain()`."""
    global _recording
    _recording = False
    _update()


def drain() -> List[Span]:
    """The spans recorded so far, in the order they closed, as
    (start_ns, end_ns, name); empties the buffer."""
    global _spans
    out, _spans = _spans, []
    return out


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    global _ranges
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = (torch.profiler.tensorboard_trace_handler(logdir)
               if logdir else None)
    with profile(activities=activities, on_trace_ready=handler) as prof:
        _ranges += 1
        _update()
        try:
            yield prof
        finally:
            _ranges -= 1
            _update()

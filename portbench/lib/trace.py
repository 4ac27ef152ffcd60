"""A bounded slice of the window under torch.profiler's CUDA activity
alone, reduced to what the per-layer metrics read: device intervals by
kernel name, the busy time and its window, device time by the harness's
spans, the longest device operations and the idle gaps named by what
the host was doing.

The profiler records the device's operations and the runtime calls
that launched them, and no host op: recording every aten op slowed the
host-paced slices by a third or more, which the idle share and `mfu`
then read. The harness marks its own spans on the host clock
(`Slice.span`). The kineto events are read raw
(`kineto_results.events()`): a kernel is tied to its launch call through
the correlation id, and the launch to the innermost span open on the
host at that moment. The profiler's timestamps are tied to the host
clock by marker calls (`cudaStreamQuery`) at the slice's start and end.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

SPAN_PREFIX = "portbench."
NAME_CHARS = 160    # a kernel's name in the breakdown, cut to this
MARK_CALL = "cudaStreamQuery"


class Kernel(NamedTuple):
    name: str
    start: float     # seconds, the trace's clock
    dur: float
    span: str        # the harness span its launch ran in ("" if none)
    call: str        # the runtime call that launched it


class Summary(NamedTuple):
    kernels: List[Kernel]
    window_s: float  # first device event's start to the last one's end
    busy_s: float    # the union of the device intervals
    offset_ns: int = 0   # the profiler's clock less the host's

    def device_s(self, patterns: Sequence[str] = ()) -> float:
        """Device seconds of the kernels whose name holds one of
        `patterns` (all kernels when empty)."""
        return sum(k.dur for k in self.kernels
                   if not patterns or any(p in k.name for p in patterns))

    def count(self, patterns: Sequence[str]) -> int:
        return sum(1 for k in self.kernels
                   if any(p in k.name for p in patterns))

    def span_device_s(self, span: str) -> float:
        return sum(k.dur for k in self.kernels if k.span == span)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for k in self.kernels:
            name = k.name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + k.dur
        return [[name, s] for name, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device time between consecutive intervals, summed by what
        the host was doing when it launched the operation that ended the
        gap (its span and the launching call)."""
        by: Dict[str, float] = {}
        end = None
        for k in sorted(self.kernels, key=lambda k: k.start):
            if end is not None and k.start > end:
                key = f"{k.span or 'host'}/{k.call}"
                by[key] = by.get(key, 0.0) + (k.start - end)
            end = k.start + k.dur if end is None else max(end,
                                                          k.start + k.dur)
        return [[name, s] for name, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def clock_offset(marks: Sequence[Tuple[int, int]],
                 calls: Sequence[int]) -> int:
    """Nanoseconds to subtract from a profiler timestamp to read the host
    clock: the median, over the marks, of the nearest marker call's
    start less the middle of the mark (0 without marks)."""
    calls = sorted(calls)
    d = []
    for a, b in marks:
        mid = (a + b) // 2
        i = bisect.bisect_left(calls, mid)
        near = [calls[j] for j in (i - 1, i) if 0 <= j < len(calls)]
        if near:
            d.append(min(near, key=lambda c: abs(c - mid)) - mid)
    d.sort()
    return d[len(d) // 2] if d else 0


def summarize(prof, spans: Sequence[Tuple[int, int, str]] = (),
              marks: Sequence[Tuple[int, int]] = ()) -> Optional[Summary]:
    """Reduce a stopped torch.profiler.profile, with the harness's spans
    (start, end, name; host clock, ns) and clock marks (before, after).
    None when the slice holds no device activity (a CPU run)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches: Dict[int, Tuple[int, str]] = {}   # correlation id -> call
    markers: List[int] = []
    device = []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
            continue
        name = e.name()
        if name == MARK_CALL:
            markers.append(_ns(e, "start"))
        corr = e.correlation_id()
        if corr and name.startswith(("cuda", "cu")):
            launches[corr] = (_ns(e, "start"), name)
    if not device:
        return None
    offset = clock_offset(marks, markers)
    spans = sorted(spans)
    starts = [sp[0] for sp in spans]

    def span_at(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 8, -1), -1):
            if spans[j][1] >= t:
                return spans[j][2]
        return ""

    kernels = []
    for e in device:
        # work launched before the slice began is not the slice's
        launch = launches.get(e.correlation_id())
        if launch is None:
            continue
        kernels.append(Kernel(e.name(), _ns(e, "start") * 1e-9,
                              _ns(e, "duration") * 1e-9,
                              span_at(launch[0] - offset), launch[1]))
    if not kernels:
        return None
    kernels.sort(key=lambda k: k.start)
    busy, cur_s, cur_e = 0.0, None, None
    for k in kernels:
        if cur_e is None or k.start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = k.start, k.start + k.dur
        else:
            cur_e = max(cur_e, k.start + k.dur)
    busy += cur_e - cur_s
    window = max(k.start + k.dur for k in kernels) - kernels[0].start
    return Summary(kernels, window, busy, offset)


class Slice:
    """Profile the window from `begin` for `seconds` (`due`, asked by the
    path's loop at batch boundaries) to `end`; `span(name)` marks the
    harness's calls into a layer while the slice runs. The profiler's
    first start takes seconds inside the window, before the slice: a
    start in set-up would slow every launch after it."""

    def __init__(self, torch, enabled: bool, seconds: float = 0.0):
        self.torch, self.enabled, self.seconds = torch, enabled, seconds
        self.cuda = torch.cuda.is_available()
        self.prof = None
        self.summary: Optional[Summary] = None
        self.active = False
        self.done = False
        self.t_begin = 0.0
        self.spans: List[Tuple[int, int, str]] = []
        self.marks: List[Tuple[int, int]] = []

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        # the CPU activity only where there is no card (a rehearsal)
        return profile(activities=[ProfilerActivity.CUDA if self.cuda
                                   else ProfilerActivity.CPU])

    def _mark(self) -> None:
        if self.cuda:
            a = time.time_ns()
            self.torch.cuda.current_stream().query()
            self.marks.append((a, time.time_ns()))

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((a, time.time_ns(), SPAN_PREFIX + name))

    def begin(self) -> None:
        if self.enabled and not self.active and not self.done:
            self.prof = self._profile()
            self.prof.start()
            self._mark()
            self.active = True
            self.t_begin = time.perf_counter()

    def due(self) -> bool:
        """The slice has run its seconds."""
        return self.active and \
            time.perf_counter() - self.t_begin >= self.seconds

    def end(self) -> None:
        if self.active:
            self._mark()
            if self.cuda:   # every operation launched in the slice runs
                self.torch.cuda.synchronize()
            self.prof.stop()
            self.active, self.done = False, True

    def reduce(self) -> None:
        """Read the stopped slice (after the window: it takes seconds)."""
        if self.prof is not None and self.done:
            self.summary = summarize(self.prof, self.spans, self.marks)
            self.prof = None

"""The trace reduction on a made-up slice: kernels tied to the harness's
span and the call that launched them, launches outside the slice left
out, the profiler's clock tied to the host's by the marker calls, the
busy union, the idle gaps by what the host was doing, and the roofline
reader's count check."""
from types import SimpleNamespace

from torch.autograd import DeviceType
from pytest import approx

from portbench.lib import arith, reduce, trace


class Event:
    def __init__(self, name, start, dur, device=False, corr=0):
        self._n, self._s, self._d, self._c = name, start, dur, corr
        self._t = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def correlation_id(self):
        return self._c


def fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


# the profiler's clock runs 5,000 ns ahead of the host's
AHEAD = 5000


def slice_events():
    return [
        Event("cudaStreamQuery", 11 + AHEAD, 2),
        Event("cudaLaunchKernel", 120 + AHEAD, 10, corr=1),
        Event("cuLaunchKernelEx", 300 + AHEAD, 10, corr=2),
        Event("cudaStreamQuery", 1501 + AHEAD, 2),
        Event("elementwise_add_kernel", 2000, 100, device=True, corr=1),
        Event("int8_dense_kernel<2>", 2300, 200, device=True, corr=2),
        Event("int8_dense_kernel<2>", 2600, 50, device=True, corr=99),
    ]


SPANS = [(100, 250, "portbench.serve"), (280, 400, "portbench.fetch")]
MARKS = [(8, 14), (1498, 1504)]


def summary():
    return trace.summarize(fake_prof(slice_events()), SPANS, MARKS)


def test_summary_keeps_the_slices_kernels_with_their_launchers():
    s = summary()
    assert [k.name for k in s.kernels] == ["elementwise_add_kernel",
                                           "int8_dense_kernel<2>"]
    assert [k.span for k in s.kernels] == ["portbench.serve",
                                           "portbench.fetch"]
    assert [k.call for k in s.kernels] == ["cudaLaunchKernel",
                                           "cuLaunchKernelEx"]
    assert s.window_s == approx(500e-9) and s.busy_s == approx(300e-9)
    [[gap, idle]] = s.idle_gaps()
    assert gap == "portbench.fetch/cuLaunchKernelEx"
    assert idle == approx(200e-9)
    assert s.device_s(["int8_dense"]) == approx(200e-9)
    assert s.count(["int8_dense"]) == 1
    assert s.span_device_s("portbench.serve") == approx(100e-9)


def test_the_clock_offset_is_read_from_the_marker_calls():
    assert trace.clock_offset(MARKS, [11 + AHEAD, 1501 + AHEAD]) == AHEAD
    assert trace.clock_offset([], [AHEAD]) == 0
    # without the offset the launches fall outside the spans
    s = trace.summarize(fake_prof(slice_events()), SPANS, [])
    assert [k.span for k in s.kernels] == ["", ""]


def test_a_slice_without_device_work_reads_nothing():
    assert trace.summarize(fake_prof(slice_events()[:4]), SPANS,
                           MARKS) is None


def test_the_roofline_reads_nothing_when_launches_do_not_match_the_work():
    s = summary()
    ln = arith.dense_launch(64, 768, 768)
    # batches completed 1,000 ns apart before the slice
    rec = SimpleNamespace(trace=s, slice_work=[1],
                          paced=[(0.0, 1), (1000e-9, 1), (2000e-9, 1)])
    assert reduce.roofline_pct(rec, "int8_dense", lambda _: [ln]) == \
        approx(100.0 * ln.bound_s / 200e-9)
    assert reduce.roofline_pct(rec, "int8_dense",
                               lambda _: [ln, ln]) is None
    # the idle share at the untraced pace: 300 ns busy of 1,000
    assert reduce.idle_pct(rec) == approx(100.0 * (1 - 300 / 1000))
    assert reduce.idle_pct(SimpleNamespace(trace=s, slice_work=[1],
                                           paced=[(0.0, 1)])) is None

"""scripts/trace_stages_torch.py's reduction on a made-up slice: the
second summary over the harness's spans and the program's charges a
launch inside a stage to the stage and one outside every stage to the
harness's span, and the script's line reads each stage's host time
before the slice and its device time, launches and idle share in it;
for a graphed sampler, the replay stage and the counters."""
import importlib.util
import os
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.lib import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script():
    spec = importlib.util.spec_from_file_location(
        "trace_stages_torch",
        os.path.join(ROOT, "scripts", "trace_stages_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


AHEAD = 5000    # the profiler's clock ahead of the host's
# a batch of the VQA stream: the harness's serve span around two stages,
# then its fetch span; a launch between the stages, one after the fetch
HARNESS = [(100, 500, "portbench.serve"), (600, 700, "portbench.fetch")]
PROGRAM = [(110, 200, "xlt.serve.inputs"), (210, 400, "xlt.engine.language")]
LAUNCHES = [(150, "xlt.serve.inputs"), (300, "xlt.engine.language"),
            (320, "xlt.engine.language"), (450, "portbench.serve"),
            (650, "portbench.fetch"), (800, "")]


def summarize(spans):
    events = [Event("cudaStreamQuery", 11 + AHEAD, 2),
              Event("cudaStreamQuery", 1001 + AHEAD, 2)]
    for i, (t, _) in enumerate(LAUNCHES, 1):
        events.append(Event("cudaLaunchKernel", t + AHEAD, 5, corr=i))
        # each operation runs 1,000 ns after its launch for 20 ns
        events.append(Event(f"k{i}", 1000 * i, 20, device=True, corr=i))
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return trace.summarize(prof, spans, [(8, 14), (998, 1004)])


def test_the_second_summary_charges_launches_to_the_stage_open():
    assert [k.span for k in summarize(HARNESS).kernels] == [
        "portbench.serve"] * 4 + ["portbench.fetch", ""]
    program = summarize(HARNESS + PROGRAM)
    assert [k.span for k in program.kernels] == [s for _, s in LAUNCHES]
    # each gap named by the stage that launched the operation ending it
    gaps = dict(program.idle_gaps(10))
    assert gaps["xlt.engine.language/cudaLaunchKernel"] == pytest.approx(
        2 * 980e-9)
    assert gaps["portbench.serve/cudaLaunchKernel"] == pytest.approx(980e-9)


def test_the_line_reads_each_stage_before_and_in_the_slice():
    mod = script()
    begin = 10_000_000      # the slice's start, ns
    before = [(0, 1_000_000, "xlt.serve.inputs"),
              (1_000_000, 4_000_000, "xlt.engine.language"),
              (4_000_000, 5_000_000, "xlt.engine.cross")] * 2
    spans = before + [(begin + s, begin + e, n) for s, e, n in PROGRAM]
    line = mod.report("vqa", spans, begin, summarize(HARNESS + PROGRAM),
                      {"enqueue": [0.005, 0.007]})
    # before the slice: 2 batches, language 3 ms and cross 1 ms each
    assert line["batches_before"] == 2
    assert line["engine_host_ms"] == pytest.approx(4.0)
    assert line["enqueue_ms"] == pytest.approx(6.0)
    # in the slice: 1 batch; of 5 gaps of 980 ns, 2 end at language's
    assert line["engine_launches"] == 2
    assert line["engine_idle_share"] == pytest.approx(40.0)
    assert line["launches"]["outside"] == 1
    assert line["device_ms"]["xlt.serve.inputs"] == pytest.approx(20e-6)


def test_the_t2i_line_reads_a_decode_step_and_the_tiling():
    mod = script()
    step = ["xlt.sampler.remask", "xlt.sampler.visual",
            "xlt.sampler.cross", "xlt.sampler.head", "xlt.sampler.commit"]
    spans, t = [(0, 2_000_000, "xlt.sampler.language")], 2_000_000
    for _ in range(4):
        for name in step:
            spans.append((t, t + 1_000_000, name))
            t += 1_000_000
    line = mod.report("t2i", spans, t, None, {"sample": [0.0224]})
    assert line["step_host_ms"] == pytest.approx(5.0)
    assert line["sample_ms"] == pytest.approx(22.4)
    assert line["tiling"] == pytest.approx(22.0 / 22.4)
    assert "step_device_ms" not in line     # no device summary


def test_the_t2i_line_of_a_graphed_sampler_reads_the_replay():
    mod = script()
    replay = "xlt.sampler.replay"
    begin = 10_000_000
    before = [(0, 500_000, replay), (500_000, 2_000_000, "xlt.render"),
              (2_000_000, 2_500_000, replay),
              (2_500_000, 4_000_000, "xlt.render")]
    # in the slice: the launches at 150, 300 and 320 inside the replay
    spans = before + [(begin + 110, begin + 400, replay)]
    harness = [(100, 500, "portbench.sample"), (600, 700, "portbench.render")]
    counters = {"setup": {"xlt.sampler.graphs_captured": 1,
                          "xlt.sampler.graph_replays": 1},
                "window": {"xlt.sampler.graph_replays": 3}}
    line = mod.report("t2i", spans, begin,
                      summarize(harness + [(110, 400, replay)]),
                      {"sample": [0.0006, 0.0004]}, counters)
    assert line["batches_before"] == 2
    assert line["replay_host_ms"] == pytest.approx(0.5)
    assert line["sample_ms"] == pytest.approx(0.5)
    assert line["tiling"] == pytest.approx(1.0)
    assert line["replays_a_batch"] == 1.0
    assert line["counters"] == counters
    assert line["replay_launches"] == 3
    assert line["replay_device_ms"] == pytest.approx(60e-6)
    assert line["launches"]["portbench.sample"] == 1
    assert not {"step_host_ms", "step_device_ms", "step_launches"} & set(line)

"""Tracing and step timing (port of xlxmert_tpu/utils/profiling.py).

- `trace(logdir)`: a torch.profiler context over the CPU and, where
  there is one, the card; on exit it writes a Chrome trace
  (`<host>_<pid>.<ms>.pt.trace.json`, TensorBoard's profiler plugin and
  Perfetto read it) into `logdir`.
- `annotate(name)`: a named range in the trace (record_function).
- `StepTimer`: per-step wall time with warm-up skip and a percentile
  summary; `force` waits for the device of a tensor it is given.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)) as prof:
        yield prof


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self.times: List[float] = []
        self._n = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self._t0
        self._n += 1
        if self._n > self.skip_first:
            self.times.append(dt)

    @staticmethod
    def force(x) -> None:
        """Wait for the device of the first tensor in `x` (a tensor, or a
        dict, list or tuple holding one)."""
        import torch

        stack = [x]
        while stack:
            leaf = stack.pop(0)
            if isinstance(leaf, dict):
                stack[:0] = list(leaf.values())
            elif isinstance(leaf, (list, tuple)):
                stack[:0] = list(leaf)
            elif isinstance(leaf, torch.Tensor):
                if leaf.is_cuda:
                    torch.cuda.synchronize(leaf.device)
                return

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
            "n": len(arr),
        }

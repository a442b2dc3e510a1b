"""Tracing and step timing, the port's counterpart of the JAX package's
`utils/profiling.py` in PyTorch's idiom.

    with trace("traces/step"):        # torch.profiler, host and CUDA timelines
        with annotate("train_step"):  # a named span on the timeline
            step()

    timer = StepTimer()
    with timer:                        # wall time and steps/sec
        step()
    print(timer.summary())

The trace is a Chrome trace (`trace.json`) in `log_dir`, for
chrome://tracing or Perfetto.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

__all__ = ["trace", "StepTimer", "annotate"]


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler over the block, CPU and (where a card is present) CUDA
    activities; the Chrome trace is written to `log_dir`/trace.json. Yields
    the profiler, whose `key_averages()` can be read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / "trace.json"))


def annotate(name: str):
    """A named span that shows on the profiler's timelines."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-time statistics of the last `window` steps (host clock;
    a step that ends on the card must synchronize inside the block)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)
        return False

    @property
    def last(self):
        return self.times[-1] if self.times else float("nan")

    @property
    def mean(self):
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def steps_per_sec(self):
        m = self.mean
        return 1.0 / m if m and m == m and m > 0 else float("nan")

    def summary(self):
        return {"step_time_s": round(self.mean, 4),
                "steps_per_sec": round(self.steps_per_sec, 3)}

"""Timers for code that runs on a CUDA card, shared by `chip_smoke.py` and
the timing tools in this folder, so that their numbers are measured the
same way: the mean time of a call by CUDA events, and the device time and
device launches of a call from torch.profiler. Imports torch only."""
from __future__ import annotations

import torch


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(prof):
    """The device kernels of a finished torch.profiler run, by name. A user
    annotation (such as the optimizer's step range) is a span on the
    device's timeline, not work of its own, so it is left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def device_per_call(fn, iters=20):
    """Device time and device launches per call of fn(), from torch.profiler
    over `iters` warm calls: the kernels' own time, without the gaps between
    launches that the CUDA-event time (cuda_ms) includes. Returns (ms,
    launches per call, {kernel name: launches per call})."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = kernel_events(prof)
    ms = sum(e.self_device_time_total for e in rows) / 1e3 / iters
    names = {e.key: e.count / iters for e in rows}
    return ms, sum(names.values()), names


def named_device_ms(fn, names, iters=20, windows=3):
    """Device time per call of fn() of the kernels whose names contain one of
    `names` (substrings), from torch.profiler over `iters` warm calls; the
    first of up to `windows` profiler windows that saw such a kernel is kept
    (a window has been seen to record no device event). Returns (ms,
    launches of those kernels per call), or (None, 0) where no window saw
    one: not measured."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(windows):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in kernel_events(prof) if any(n in e.key for n in names)]
        if rows:
            return (sum(e.self_device_time_total for e in rows) / 1e3 / iters,
                    sum(e.count for e in rows) / iters)
    return None, 0

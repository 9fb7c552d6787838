"""The traced run's instrument: a profiled slice of a few frames inside
the window.

The slice runs under ``torch.profiler`` (host and device activity) and
the kernel recorder (program.KernelRecorder), between two device
synchronisations inside one ``record_function`` range, so the slice's
kernels are those that start inside the range, on every stream, and its
host syncs the blocking CUDA runtime calls made inside it on any thread
(the two of the slice's own bounds left out). Only a slice is profiled:
the profiler's exit and the reading of its events hold the interpreter
lock for seconds, and the profiler (CUPTI) slows every launch once it
has started, so the slice comes late in the window and its events are
read after the window has closed.
"""

from __future__ import annotations

import time

import torch

from . import roofline, stats
from .program import KERNEL_NAMES, KernelRecorder

RANGE = "slambench.slice"
# the CUDA runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
NAME_CHARS = 96


class ProfiledSlice:
    """``with`` around the slice's frames; ``frames`` counts them."""

    def __init__(self):
        self.recorder = KernelRecorder()
        self.frames = 0
        self.summary = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = torch.profiler.record_function(RANGE)
        self._range.__enter__()
        torch.cuda.synchronize()
        self._launches0 = self.recorder.launches()
        self.recorder.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.recorder.__exit__(*exc)
        launches = {k: v - self._launches0[k] for k, v in self.recorder.launches().items()}
        self._range.__exit__(*exc)
        t = time.perf_counter()
        self._prof.__exit__(*exc)
        self.exit_s = time.perf_counter() - t
        self._launches = launches
        return False

    def summarize(self) -> dict:
        """The slice's summary (``summarize``); reading the profiler's events
        takes tens of seconds, so call it once the window has closed."""
        if self.summary is None:
            self.summary = summarize(self._prof.events(), self._launches, self.recorder.calls,
                                     self.frames)
            self.summary["profiler_exit_s"] = self.exit_s
            self._prof = None
        return self.summary


def summarize(events, launches, calls, frames) -> dict:
    """The slice's kernels, its wall time, the device's busy time, each
    kernel kind's events and device time, the top kernels and the longest
    idle gaps named by the innermost host operation running on the
    tracking thread when each gap began."""
    cuda = torch.autograd.DeviceType.CUDA
    rng = [e for e in events if e.name == RANGE and e.device_type != cuda]
    if not rng:
        raise RuntimeError("the profiled slice's range is missing from the trace")
    t0, t1 = rng[0].time_range.start, rng[0].time_range.end
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
               if e.device_type == cuda and e.name != RANGE and t0 <= e.time_range.start <= t1]
    syncs = sum(1 for e in events if e.device_type != cuda and e.name in SYNC_CALLS
                and t0 <= e.time_range.start <= t1) - 2
    host = [e for e in events if e.device_type != cuda and e.name != RANGE
            and e.thread == rng[0].thread and t0 <= e.time_range.start <= t1]
    by_kind = {}
    for kind, names in KERNEL_NAMES.items():
        sel = [(a, b) for n, a, b in kernels if any(k in n for k in names)]
        by_kind[kind] = dict(events=len(sel), device_s=sum(b - a for a, b in sel) / 1e6)
    totals = {}
    for n, a, b in kernels:
        totals[n] = totals.get(n, 0.0) + (b - a) / 1e6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    short = (lambda n: n[:NAME_CHARS])
    idle = sorted(stats.gaps([(a, b) for _, a, b in kernels], t0, t1),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in idle:
        around = [e for e in host if e.time_range.start <= a <= e.time_range.end]
        inner = min(around, key=lambda e: e.time_range.end - e.time_range.start, default=None)
        named.append([short(inner.name) if inner else "(no host op)", (b - a) / 1e6])
    return dict(frames=frames, wall_s=(t1 - t0) / 1e6,
                busy_s=stats.busy([(a, b) for _, a, b in kernels]) / 1e6,
                kernels=len(kernels), syncs=syncs, by_kind=by_kind, launches=launches,
                calls=calls, device_ops=[[short(n), t] for n, t in top], idle_gaps=named)


def roofline_pct(summary, kinds) -> float | None:
    """100 x the least time over the device time of the slice's launches
    of `kinds`; None where they launched nothing, or where the trace's
    kernel events disagree with the launches the wrappers counted."""
    least = device = 0.0
    for kind in kinds:
        ev = summary["by_kind"][kind]
        if ev["events"] != summary["launches"][kind]:
            return None
        device += ev["device_s"]
        least += sum(roofline.LEAST_S[kind](args, kw) for args, kw in summary["calls"][kind]
                     if roofline.launched(kind, args, kw))
    return 100.0 * least / device if device > 0 else None

"""Host-side counters and the program's span recorder.

Counters are bumped where the work happens and read as a snapshot; the
JAX package keeps the same counters (tests/test_torch_constants.py holds
``bump``, ``timed_fetch`` and ``snapshot`` equal). By convention:
  track_dispatches   fused tracking steps issued
  fs_rebuilds        device snapshots of the local map rebuilt
  fast_failures      fused steps that failed at retire and were replayed
  weak_frames        frames kept by the pipelined retire's hysteresis band
  staged_frames      tracked frames that took the staged path
  ready_waits        waits on a ``streams.Ready``'s copies (the card only)
  tri_points_added, recent_points_culled, fuse_points_merged
                     map points the keyframe event adds, culls and merges
  host_fetches       blocking device->host fetches (``timed_fetch``; the
                     sharded BA's)
  host_fetch_s       seconds spent blocked in those fetches

Spans time the program's layers. ``with span(name, cause):`` records, on
exit, one ``Span``: its id, its parent's id (the innermost span open on
the same thread), the name, the thread's name, start and end in
``time.perf_counter_ns()`` (the clock the benchmark stamps hand-over and
pose-known with) and ``cause``, the request the work belongs to (a frame
id on the tracker's spans, a keyframe id on an event's; a span given none
takes its parent's). While a torch profiler is running the span is also a
``torch.profiler.record_function`` range under its own name, so it stands
in the device trace on the trace's clock. Names are ``<layer>.<stage>``
(``frame``, ``track.*``, ``event``, ``map.*``, ``loop.*``);
PERF.md section 3 lists them with the metrics that read them.

The recorder is off unless ``trace_enabled``: then ``span`` returns one
shared object whose enter and exit do nothing (no clock, no allocation,
no torch call). ``spans()`` returns the completed spans, ``clear_spans()``
drops them; nothing is written to disk.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch

_counts: dict = defaultdict(float)
enabled = True
trace_enabled = False


class Span(NamedTuple):
    id: int
    parent: int | None
    name: str
    thread: str
    start_ns: int
    end_ns: int
    cause: int | None


_spans: list = []  # completed spans as plain tuples (Span's fields)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the thread's open spans, innermost last


class _Off:
    """The span while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "cause", "id", "parent", "range", "start")

    def __init__(self, name: str, cause):
        self.name = name
        self.cause = cause

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.cause is None and parent is not None:
            self.cause = parent.cause
        self.id = next(_ids)
        stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.stack.pop()
        _spans.append((self.id, self.parent, self.name, threading.current_thread().name,
                       self.start, end, self.cause))
        return False


def span(name: str, cause=None):
    """``with span(name, cause):`` times the block as a span (a no-op while
    the recorder is off)."""
    if not trace_enabled:
        return _OFF
    return _On(name, cause)


def spans() -> list:
    """The completed spans (``Span``), in the order they ended."""
    return [Span(*s) for s in list(_spans)]


def clear_spans():
    _spans.clear()


def bump(key: str, n: float = 1.0):
    if enabled:
        _counts[key] += n


def get(key: str) -> float:
    return _counts.get(key, 0.0)


def snapshot() -> dict:
    return dict(_counts)


def reset():
    _counts.clear()


class timed_fetch:
    """Context manager: count a blocking device->host fetch and the time
    spent in it."""

    def __init__(self, key: str = "host_fetch"):
        self.key = key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        bump(self.key + "es")
        bump(self.key + "_s", dt)
        return False

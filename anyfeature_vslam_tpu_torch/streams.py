"""Streams, hand-offs and readiness probes of the asynchronous schedules
(asynchronous mapping, the threaded mapping worker, the pipelined tracker).

On the card the System gives the tracker one CUDA stream and the mapping
side (the deferred BA solves, and the worker thread in threaded mode)
another, so that a solve queued by mapping never sits in front of a
tracked frame on one queue. PyTorch's current stream belongs to each
thread, so the System enters the right stream on each thread (``use``).

A tensor that one stream produces and another reads crosses with a
``Handoff``: the reader's stream waits on an event recorded after the
production, and ``record_stream`` keeps the caching allocator from reusing
the tensor's memory while the reader may still run. Results bound for the
host go through ``Ready``: copied ``non_blocking`` into pinned host
buffers, then an event, which is the readiness probe (``is_set`` queries
it, ``wait`` synchronizes it). For CPU tensors every hand-off is a no-op
and every probe is ready at once, so runs on the CPU are deterministic.
"""

from __future__ import annotations

import contextlib

import torch

from . import perfcount


def use(stream):
    """Context making `stream` the current CUDA stream of this thread (no-op
    for None)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def new_stream(device):
    """A CUDA stream on `device`, or None for a CPU device."""
    device = torch.device(device)
    return torch.cuda.Stream(device) if device.type == "cuda" else None


class Handoff:
    """Tensors produced on the current stream, for readers on any stream
    (None entries are skipped; a tuple, such as a prepared candidate set,
    counts as its tensors)."""

    def __init__(self, tensors):
        flat = (x for t in tensors if t is not None
                for x in (t if isinstance(t, tuple) else (t,)))
        self.tensors = [t for t in flat if t.is_cuda]
        self.event = None
        self._readers = set()
        if self.tensors:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            self.event = torch.cuda.Event()
            self.event.record(stream)
            self._readers.add(stream.cuda_stream)

    def take(self):
        """Order the current stream after the production (once per stream)
        and keep the memory alive for it."""
        if self.event is None:
            return
        cur = torch.cuda.current_stream(self.tensors[0].device)
        if cur.cuda_stream in self._readers:
            return
        cur.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(cur)
        self._readers.add(cur.cuda_stream)


class Ready:
    """Readiness probe of device results bound for the host. CUDA tensors
    are copied non_blocking into pinned host buffers on the current stream
    and an event is recorded after the copies; CPU tensors are ready at
    once."""

    def __init__(self, tensors):
        tensors = list(tensors)
        self.event = None
        if tensors and tensors[0].is_cuda:
            self._src = tensors  # alive until the copies have run
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self._host = [t.detach() for t in tensors]

    def is_set(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            perfcount.bump("ready_waits")
            self.event.synchronize()
            self._src = None

    def host(self) -> list:
        """The results as numpy arrays (waits for them)."""
        self.wait()
        return [h.numpy() for h in self._host]

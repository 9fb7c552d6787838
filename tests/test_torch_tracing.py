"""The port's span recorder (perfcount.span) on the CPU.

Off, it records nothing and hands out one shared no-op object. On, spans
nest per thread, each child inside its parent's range, and a span without
a cause takes its parent's. A threaded-mapping System on the test scene
records the tracked frame's and the keyframe event's spans under their
names, each with its cause: the tracker's a frame id, the worker's the id
of the keyframe that the tracker's ``track.keyframe`` minted. Under a
torch profiler the tracking thread's spans are ranges of the trace.
"""

import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from anyfeature_vslam_tpu_torch import perfcount
from anyfeature_vslam_tpu_torch.system import System
from span_trace import Tracing
from torch_slice_scene import SliceScene

W, H, N_FEATURES, N_FRAMES = 320, 240, 600, 20
SMALL = dict(width=160, height=120, n_features=200, frames=6)
MAP_STAGES = {"map.stats+cullpts", "map.dispatch", "map.wait", "map.triangulate", "map.fuse",
              "map.local_ba", "map.cullkfs"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the port's runs at this size are launch-bound,
    and more threads only oversubscribe the cores other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_system():
    sc = SliceScene(SMALL["width"], SMALL["height"], n_frames=SMALL["frames"])
    system = System(SimpleNamespace(**sc.camera), n_features=SMALL["n_features"],
                    enable_loop_closing=False, async_mapping=False, device="cpu")
    return system, [sc.render(i)[0] for i in range(SMALL["frames"])]


def test_off_records_nothing():
    assert not perfcount.trace_enabled
    perfcount.clear_spans()
    system, frames = _small_system()
    for i, img in enumerate(frames):
        system.track_monocular(img, i / 30.0)
    assert system.frame_times and perfcount.spans() == []
    a, b = perfcount.span("frame", 1), perfcount.span("track.extract")
    assert a is b
    with a:
        pass
    assert perfcount.spans() == []


def test_spans_nest_per_thread():
    def worker():
        with perfcount.span("event", 7):
            with perfcount.span("map.fuse"):
                pass

    with Tracing() as rec:
        with perfcount.span("frame", 3):
            with perfcount.span("track.extract"):
                th = threading.Thread(target=worker, name="mapping")
                th.start()
                th.join()
            with perfcount.span("track.retire", 2):
                with perfcount.span("track.retire_wait"):
                    pass
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"frame", "track.extract", "track.retire", "track.retire_wait", "event",
                       "map.fuse"}
    assert by["frame"].parent is None and by["event"].parent is None
    for child, parent in (("track.extract", "frame"), ("track.retire", "frame"),
                          ("track.retire_wait", "track.retire"), ("map.fuse", "event")):
        c, p = by[child], by[parent]
        assert c.parent == p.id and c.thread == p.thread
        assert p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns
    assert by["event"].thread == "mapping" and by["frame"].thread != "mapping"
    assert [by[n].cause for n in ("frame", "track.extract", "track.retire",
                                  "track.retire_wait")] == [3, 3, 2, 2]
    assert by["map.fuse"].cause == 7
    assert len({s.id for s in rec.spans}) == len(rec.spans)


def test_spans_from_many_threads_are_all_kept():
    """More threads than cores, switching every microsecond: no span is
    lost, ids stay unique and every parent is the same thread's."""
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(t):
        for _ in range(n_spans):
            with perfcount.span("event", t):
                with perfcount.span("map.fuse"):
                    pass

    try:
        with Tracing() as rec:
            threads = [threading.Thread(target=work, args=(t,), name=f"w{t}")
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60.0)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(rec.spans) == 2 * n_threads * n_spans
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    for s in rec.spans:
        if s.name == "map.fuse":
            p = by_id[s.parent]
            assert p.name == "event" and p.thread == s.thread and s.cause == p.cause
            assert s.thread == f"w{s.cause}"
        else:
            assert s.parent is None


@pytest.fixture(scope="module")
def threaded_run():
    """A threaded-mapping System over the test scene with the recorder on,
    paced as on the card (the worker idle before each frame, so that
    keyframes mint often); returns its spans, its System and every
    keyframe minted as (keyframe id, its thread's name, perf_counter_ns
    when it was minted)."""
    sc = SliceScene(W, H, n_frames=40, seed=9)
    frames = [sc.render(i)[0] for i in range(N_FRAMES)]
    system = System(SimpleNamespace(**sc.camera), n_features=N_FEATURES, threaded_mapping=True,
                    device="cpu")
    minted = []
    add_keyframe = system.map.add_keyframe

    def recording(*args, **kw):
        kf = add_keyframe(*args, **kw)
        minted.append((int(kf), threading.current_thread().name, time.perf_counter_ns()))
        return kf

    system.map.add_keyframe = recording
    done = {}

    def run():
        with Tracing() as rec:
            for i, img in enumerate(frames):
                system._worker.flush(timeout=120.0)
                system.track_monocular(img, i / 30.0)
            system.shutdown(timeout=60.0)
        done["spans"] = rec.spans

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(300.0)
    assert not th.is_alive(), "the threaded run did not finish within 300 s"
    assert "spans" in done
    return done["spans"], system, minted


def test_threaded_system_records_its_spans(threaded_run):
    spans, system, minted = threaded_run
    names = {s.name for s in spans}
    want = {"frame", "frame.barrier", "frame.turn_wait", "track.extract", "track.staged",
            "track.snapshot", "track.motion", "track.local_map", "track.pose_lm",
            "track.motion_sync", "track.retire", "track.retire_wait", "track.keyframe",
            "event"} | MAP_STAGES
    assert want <= names, sorted(want - names)
    assert all(s.cause is not None for s in spans), [s for s in spans if s.cause is None]
    frames = [s for s in spans if s.name == "frame"]
    assert sorted(s.cause for s in frames) == list(range(N_FRAMES))
    assert len({s.thread for s in frames}) == 1
    tracker = frames[0].thread
    # the tracker's spans lie inside its frames, with the frame's id or,
    # at a retire, the retired frame's (an earlier one)
    by_id = {s.id: s for s in spans}

    def root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s

    last_end = max(s.end_ns for s in frames)
    for s in spans:
        if s.thread == tracker and s.name != "frame":
            top = root(s)
            if top.name != "frame":  # the shutdown retires the frames in flight
                assert top.name == "track.retire" and top.start_ns > last_end, s
                continue
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
            assert s.cause <= top.cause, s
    retired = sorted(s.cause for s in spans if s.name == "track.retire")
    assert retired and len(set(retired)) == len(retired)
    # every keyframe is minted on the tracker inside a track.keyframe span
    # (the initial map's two: in the initializing frame's track.staged);
    # every event is a keyframe minted before it (a culled keyframe's id
    # is minted again later), and its stages carry that keyframe's id
    minting = [s for s in spans if s.name in ("track.keyframe", "track.staged")]
    minted_in = {}
    for kf, thread, t in minted:
        inside = [s for s in minting if s.thread == thread and s.start_ns <= t <= s.end_ns]
        assert thread == tracker and inside, (kf, t)
        minted_in.setdefault(kf, []).append(min(inside, key=lambda s: s.end_ns - s.start_ns))
    assert minted_in
    events = [s for s in spans if s.name == "event"]
    assert events and {s.thread for s in events} == {"mapping"}
    for ev in events:
        assert any(w.start_ns < ev.start_ns for w in minted_in.get(ev.cause, [])), ev
    for s in spans:
        if s.name.startswith("map.") or s.name.startswith("loop."):
            top = root(s)
            assert top.name == "event" and s.cause == top.cause, s
    # the counters that count stay
    assert system.local_mapper.ba_log and system.mapping_times and system.frame_times


def test_profiler_holds_the_tracking_threads_spans():
    system, frames = _small_system()
    with Tracing() as rec:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i, img in enumerate(frames[:3]):
                system.track_monocular(img, i / 30.0)
    traced = {e.name for e in prof.events()}
    recorded = {s.name for s in rec.spans}
    assert {"frame", "frame.turn_wait", "track.staged", "track.extract"} <= recorded
    assert recorded <= traced, sorted(recorded - traced)

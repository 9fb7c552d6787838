"""The system under test, as the benchmark drives and reads it.

Everything the benchmark touches of ``anyfeature_vslam_tpu_torch`` is
here: the ``System`` it builds (threaded mapping, the worker thread and
the pipelined tracker), the frames it hands over, when each frame's pose
becomes known to the caller (a new entry in the tracker's trajectory),
the counters and timings the System keeps, the kernels' Python entry
points (to record each launch's arguments while a slice is profiled, and
a sample of K2's searches in the window) and the outputs the reference
judges once the window has closed.
"""

from __future__ import annotations

import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from anyfeature_vslam_tpu_torch.frontend import cuda_fast
from anyfeature_vslam_tpu_torch.ops import cuda_match
from anyfeature_vslam_tpu_torch.system import System

# the kernels' names in a device trace, by the entry point that launches them
KERNEL_NAMES = {"k1": ("fast_nms_kernel",), "pack": ("pack_bits_kernel",),
                "k2": ("best_two_bits_kernel", "best_two_f32_kernel")}


class Program:
    """One System on `device`, built from a configuration file."""

    def __init__(self, config: dict, device):
        cam = config["camera"]
        feat = config["feature"]
        self.searches = None
        self.fps = float(cam["fps"])
        self.system = System(
            SimpleNamespace(**{k: cam[k] for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1",
                                                    "p2", "k3", "width", "height")}),
            feature=feat["family"], n_features=int(feat["n_features"]), fps=self.fps,
            feature_settings=feat["settings"], threaded_mapping=True, device=device)
        self.known: dict[int, float] = {}  # frame -> when its pose became known
        self._seen = 0

    def track(self, img: np.ndarray, i: int):
        """Hand over frame i (a host uint8 array); returns when the call does."""
        self.system.track_monocular(img, i / self.fps)
        self._note(time.perf_counter())

    def _note(self, now: float):
        traj = self.system.tracker.trajectory
        if len(traj) < self._seen:  # a re-initialization dropped entries
            self._seen = len(traj)
        for ts, *_ in traj[self._seen:]:
            self.known.setdefault(int(round(ts * self.fps)), now)
        self._seen = len(traj)

    def initialized(self) -> bool:
        return self.system.get_tracking_state().name == "OK"

    def finish(self, timeout: float):
        """Retire the frames in flight and drain and stop the mapping
        worker (System.shutdown)."""
        self.system.shutdown(timeout)
        self._note(time.perf_counter())

    def counters(self) -> dict:
        """What the System has counted so far."""
        s = self.system
        return dict(frame_times=len(s.frame_times),
                    events=len(s.mapping_times), loop_times=len(s.loop_times),
                    lost=s.tracker.stats["lost_frames"], resets=s.tracker.stats["resets"])

    def timings(self, before: dict, until: dict | None = None) -> dict:
        """Seconds per tracked call and per keyframe event (local mapping
        plus the loop stage) between the counters `before` and `until`
        (now, by default)."""
        s = self.system
        until = until or self.counters()
        mapping = s.mapping_times[before["events"]:until["events"]]
        loops = s.loop_times[before["loop_times"]:until["loop_times"]]
        events = ([a + b for a, b in zip(mapping, loops)] if len(loops) == len(mapping)
                  else list(mapping))
        return dict(frame_times=s.frame_times[before["frame_times"]:until["frame_times"]],
                    event_times=events)

    def outputs(self, window_first: int) -> dict:
        """The run's answers, copied to the host: each frame's final pose
        (its trajectory entry resolved through its keyframe), the map's
        points (by id, with their validity), every keyframe's pose,
        features and matches, and the last retired frame's features and
        matches."""
        s = self.system
        m = s.map
        poses = {}
        for ts, t_cr, uid, _lost in s.tracker.trajectory:
            t_cw = m.resolve_anchor(t_cr, uid)
            if t_cw is not None:
                poses[int(round(ts * self.fps))] = np.asarray(t_cw, np.float64)
        kfs = []
        for kf in m.keyframe_ids():
            v = m.kf_feat_valid[kf]
            kfs.append(dict(frame=int(m.kf_frame_id[kf]), pose=m.kf_pose[kf].astype(np.float64),
                            uv=m.kf_uv[kf][v].copy(),
                            octave=m.kf_octave[kf][v].copy(), size=m.kf_size[kf][v].copy(),
                            desc=m.kf_desc_bits[kf][v].copy(), matches=m.kf_matches[kf][v].copy()))
        last = None
        f = s.tracker.last
        if f is not None and f.feats is not None and f.frame_id >= window_first:
            v = np.asarray(f.feats["valid"], bool)
            matches = f.matches if f.matches is not None else np.full(v.shape, -1, np.int32)
            last = dict(frame=int(f.frame_id), uv=np.asarray(f.feats["uv_und"])[v],
                        octave=np.asarray(f.feats["octave"])[v],
                        size=np.asarray(f.feats["size"])[v],
                        desc=np.asarray(f.feats["desc_bits"])[v], matches=np.asarray(matches)[v])
        return dict(poses=poses, points=m.pt_pos.astype(np.float64), point_valid=m.pt_valid.copy(),
                    keyframes=kfs, last=last,
                    searches=self.searches.host() if self.searches is not None else [])

    def close(self):
        self.system = None


class KernelRecorder:
    """While active, records the arguments of every call to the kernels'
    Python entry points (K1 ``fast_nms_levels``, K2 ``best_two``,
    ``pack_bits``), on every thread, and counts the launches their
    wrappers make. The entry points are module attributes that every
    caller looks up at call time."""

    _SITES = ((cuda_fast, "fast_nms_levels", "k1"), (cuda_match, "best_two", "k2"),
              (cuda_match, "pack_bits", "pack"))

    def __init__(self):
        self.calls = {"k1": [], "k2": [], "pack": []}
        self._saved = []

    def launches(self) -> dict:
        """The wrappers' own launch counters."""
        return {"k1": cuda_fast.fast_nms.launches, "k2": cuda_match.best_two.launches,
                "pack": cuda_match.pack_bits.launches}

    def __enter__(self):
        for mod, name, key in self._SITES:
            orig = getattr(mod, name)
            calls = self.calls[key]

            def wrapped(*args, _orig=orig, _calls=calls, **kw):
                _calls.append((args, kw))
                return _orig(*args, **kw)

            # the originals count their launches on the module attribute
            wrapped.launches = getattr(orig, "launches", 0)
            self._saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            if hasattr(orig, "launches"):
                orig.launches = getattr(mod, name).launches
            setattr(mod, name, orig)
        self._saved.clear()
        return False


_K2_ARGS = ("q_feat", "c_feat", "q_uv", "c_uv", "q_rad", "q_slo", "q_shi", "c_size", "c_valid",
            "c_dim")


class SearchSample:
    """While active, keeps a sample of K2's searches (``best_two``, the
    entry point every guided search looks up at call time), drawn from the
    seed: a reservoir of ``size`` calls made on the thread that entered
    (the tracker's) and one of as many made on the others (the mapping
    worker's). A kept call holds its arguments and answers as they are (no
    copy: no caller writes to them); ``host`` copies them out once the
    window has closed. Enter it after any fault planted in K2, so that it
    keeps the answers the caller got."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = size
        self.kept = {True: [], False: []}
        self.seen = {True: 0, False: 0}
        self._lock = threading.Lock()
        self._orig = None

    def __enter__(self):
        orig = self._orig = cuda_match.best_two
        tracker = threading.get_ident()

        def sampled(*args, **kw):
            out = orig(*args, **kw)
            own = threading.get_ident() == tracker
            with self._lock:
                self.seen[own] += 1
                kept = self.kept[own]
                if len(kept) < self.size:
                    kept.append((args, kw, out))
                else:
                    j = self.rng.randrange(self.seen[own])
                    if j < self.size:
                        kept[j] = (args, kw, out)
            return out

        # the original counts its launches on the module attribute
        sampled.launches = getattr(orig, "launches", 0)
        cuda_match.best_two = sampled
        return self

    def __exit__(self, *exc):
        if hasattr(self._orig, "launches"):
            self._orig.launches = cuda_match.best_two.launches
        cuda_match.best_two = self._orig
        return False

    def host(self) -> list:
        """The kept calls, each {argument: CPU tensor, ..., "answer": (best,
        index, second)}: the tracker's first."""
        out = []
        for own in (True, False):
            for args, kw, ans in self.kept[own]:
                call = dict(zip(_K2_ARGS, args), **kw)
                call = {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                            else v.cpu() if isinstance(v, torch.Tensor) else v)
                        for k, v in call.items()}
                call["answer"] = tuple(t.cpu() for t in ans)
                call["tracker"] = own
                out.append(call)
        return out


def free(device):
    """Hand the device memory the program held back."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

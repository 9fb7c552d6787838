#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Drives the port (anyfeature_vslam_tpu_torch, never the JAX package) through
its main path, the orb32 tracked frame at 640x480 with 1000 features and a
4096-row local-map block:

  1. builds the hand-written CUDA kernels from csrc/ with nvcc, one nvcc
     per source, started together;
  2. K1 (FAST + NMS) on all 8 pyramid levels of a rendered frame, in one
     launch, against its plain PyTorch twin: bit-exact;
  3. pack_bits at every binary width and K2 (masked best/second) on random
     binary 4096x1000 and 1000x1000 searches against their twins: exact;
     the float path to atol 1e-2;
  4. the slice on a small input (320x240) on the card against the same
     code on the CPU (plain twins);
  5. the slice: fused_extract_track over 25 tracked frames of the rendered
     benchmark sequence against a ground-truth map; every frame must track
     with >= 50 inliers, the first 10 within 2 cm / 0.5 deg of ground
     truth (see BOUNDED_FRAMES), and the launch counters must show one K1
     launch per frame, one K2 launch per search and one pack per
     candidate set; then
     5b. the kernels' device time (torch.profiler) over the first 8 of
         those frames, every launch the wrappers counted found among the
         profiler's kernel events (else profiled again, and failing after
         5);
     5c. K2 and pack_bits at the recorded inputs of one frame's searches:
         exact, with device, eager (events around calls, host issue
         included) and CUDA-graph replay times beside the plain twin and
         the bound;
  6. where a frame's time goes: the frame and its stages run alone, host
     syncs attributed to source lines, a torch.profiler summary;
  7. flagship.tracking_step once on make_example(480, 640);
  8. the System (system.py, synchronous, 640x480, orb32, 1000 features)
     with the JAX System's defaults (the shipped orb32 vocabulary, loop
     detection at every keyframe event) over the first 48 frames of the
     benchmark sequence: two-view initialization, tracked frames, keyframe
     events (triangulation, fusion, local BA, culling, the loop stage). It
     must not reset, track >= 45 frames, reach a Sim3-aligned keyframe and
     frame ATE < 5 cm, close no loop (the path does not revisit), launch
     K1 on every frame and K2 from the init, tracking and fusion searches;
     K2 is held exact against its twin at the recorded inputs of the init
     search and of one fusion search; host syncs are counted over a fresh
     System's first 16 frames;
  9. relocalization: phase 8's System loses the camera to 3 uniform gray
     frames (LOST) and must relocalize within 3 frames on views at the
     poses of frames 20-22, its camera centre within 5 cm of the truth
     after phase 8's alignment; one K2 search per BoW candidate;
 10. the live loop closure of tests/test_loop_live.py at 640x480 with 1000
     features: session A maps circle A and saves a checkpoint, session B
     loads it, boots a fresh component and re-enters A; the test's gates:
     0 resets, <= 5 lost frames, >= 1 closure and loop edge, keyframe ATE
     < 8 cm, over both sessions' keyframes and over session A's (as the
     test scores it); the closure's stages, the global BA's caps and path;
 10b. the constructed loop map of tests/test_loop_closing_unit.py through
     the LoopCloser on the card and on the CPU: the same closure, keyframe
     poses within 2e-3 where the global BA starts.
K2 is then held exact against its twin at the recorded inputs of the
relocalization and loop searches.

The launch counters are set to 0 before phases 5, 8, 9 and 10 and read
after each. Every phase logs its wall time. Prints the card (nvidia-smi
name, power limit) first, then per-phase lines, one JSON line of kernel
results (K1 and pack_bits: launches in phase 8 and by phase, per tracked
frame of phase 5: device time, eager and graph times, plain twin, bound;
K2 once per search, by the search's label: launches over phases 8-10 and
its times at one recorded input), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result line, when any phase fails or no CUDA device
is present.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, N_FEATURES = 640, 480, 1000
N_TRACKED = 25
N_PROFILED = 8  # phase 5b profiles the first frames of phase 5 (its profile is slow to parse)
N_WARMUP_FRAMES = 5
MIN_INLIERS = 50
MAX_ROT_DEG = 0.5
MAX_TRANS_M = 0.02
# Frames held to the pose bounds. With the map frozen at keyframes 0-12,
# the constant-velocity prediction amplifies the rotation/translation
# ambiguity of the near-planar scene once the view leaves the mapped area:
# from frame 24 the pose drifts by centimetres, in the JAX package as in
# the port (PERF.md, "the slice's pose bounds"). Later frames must still
# track with >= MIN_INLIERS.
BOUNDED_FRAMES = 10


T_START = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def assert_no_jax():
    """The port must import neither jax nor the JAX package."""
    if "jax" in sys.modules or any(m.startswith("anyfeature_vslam_tpu.") for m in sys.modules):
        raise RuntimeError("the port must not import jax or the JAX package")


def time_ms(torch, fn, reps=20, warmup=3):
    """Eager time of fn() in ms: CUDA events around `reps` calls, so the
    host's issue time of each call is inside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=20):
    """Time of one replay of a CUDA graph that captured fn() once: CUDA
    events around `reps` replays, so no host issue time. The wrappers
    launch on torch.cuda.current_stream(), the capture stream here."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Kernel names as the profiler reports them (mangled templates: matched by
# substring), and the H100 SXM peaks the bounds are taken against: HBM3
# bytes/s and float32 operations/s outside the tensor cores, one operation
# per compare, min/max, xor or popcount.
PROFILED_KERNELS = ("fast_nms_kernel", "pack_bits_kernel", "best_two_bits_kernel")
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms_by_kernel(torch, prof):
    """{kernel substring: (launches, total device ms)} from a profile."""
    out = {k: (0, 0.0) for k in PROFILED_KERNELS}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in PROFILED_KERNELS:
            if k in e.name:
                n, t = out[k]
                out[k] = (n + 1, t + e.device_time / 1e3)
    return out


PROFILE_ATTEMPTS = 5
PROFILE_PAD = 32  # kernels of another name at each end of a profile


def profile_kernels(torch, fn):
    """{kernel substring: (events, total device ms)} of fn()'s kernels from
    torch.profiler events. Each kernel's events must equal the launches its
    wrapper counted while fn() ran: a profile that missed a launch is taken
    again, and after PROFILE_ATTEMPTS such profiles this raises rather than
    report a device time that was not measured."""
    from torch.profiler import ProfilerActivity, profile

    from anyfeature_vslam_tpu_torch.frontend import cuda_fast
    from anyfeature_vslam_tpu_torch.ops import cuda_match

    wrappers = dict(zip(PROFILED_KERNELS,
                        (cuda_fast.fast_nms, cuda_match.pack_bits, cuda_match.best_two)))
    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        pad = torch.ones(1, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            # kernels of another name before and after fn()'s: a profile's
            # first few kernel events (up to 5 seen) and its last one are
            # the ones lost
            for _ in range(PROFILE_PAD):
                pad.add_(1)
            torch.cuda.synchronize()
            n0 = {k: w.launches for k, w in wrappers.items()}
            fn()
            torch.cuda.synchronize()
            for _ in range(PROFILE_PAD):
                pad.add_(1)
            torch.cuda.synchronize()
        dk = device_ms_by_kernel(torch, prof)
        del prof
        missed = {k: (dk[k][0], w.launches - n0[k]) for k, w in wrappers.items()
                  if dk[k][0] != w.launches - n0[k]}
        if not missed:
            return dk
        log(f"[device] profile {attempt + 1}: kernel events != counted launches "
            f"{missed}; profiling again")
    raise AssertionError(f"torch.profiler missed kernel launches in {PROFILE_ATTEMPTS} "
                         f"profiles: {missed}")


def k1_work(torch, levels, threshold):
    """Bytes, operations and live pixels of K1 on these levels: each pixel
    read and written once; 35 operations per pixel (16 ring differences, 8
    cardinal tests, the 3x3 NMS), and 162 more (the 128 min/max of the arc
    tree, its two 15-step reductions, the threshold tests) at a live pixel,
    where an adjacent pair of cardinal points is both brighter or both
    darker than the threshold: only there can the score be non-zero."""
    import torch.nn.functional as F

    from anyfeature_vslam_tpu_torch.frontend.fast import CIRCLE_OFFSETS

    nbytes = nops = n_live = 0
    for lev in levels:
        h, w = lev.shape
        pad = F.pad(lev[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
        card = [pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - lev
                for dy, dx in (CIRCLE_OFFSETS[k] for k in (0, 4, 8, 12))]
        live = torch.zeros_like(lev, dtype=torch.bool)
        for k in range(4):
            a, b = card[k], card[(k + 1) % 4]
            live |= ((a > threshold) & (b > threshold)) | ((a < -threshold) & (b < -threshold))
        n = int(live[3:h - 3, 3:w - 3].sum())
        nbytes += 8 * h * w
        nops += 35 * h * w + 162 * n
        n_live += n
    return nbytes, nops, n_live


def k2_work(args, packed_candidates):
    """Bytes and operations of one binary K2 search: inputs read once
    (query bit planes, candidate bit planes or packed words, 20 B of gate
    data per query and 13 per candidate), 12 B written per query; 8 gate
    operations per pair, and an xor and a popcount per word of each pair
    that passes."""
    from anyfeature_vslam_tpu_torch.ops.cuda_match import gate_mask

    q, c, *side = args
    nq, d = q.shape
    nc = c.shape[0]
    nwords = (d + 31) // 32
    passes = int(gate_mask(*side).sum())
    c_bytes = nc * nwords * 4 if packed_candidates else nc * d
    nbytes = nq * d + 32 * nq + c_bytes + 13 * nc
    return nbytes, 8 * nq * nc + 2 * nwords * passes, passes


def measure_k2(torch, a, kw, label):
    """K2 at one search's recorded inputs (the arguments of
    matching.guided_best_two): exact against the plain version, then
    eager, CUDA-graph, plain, profiled device time and the bound."""
    from anyfeature_vslam_tpu_torch.ops import cuda_match, matching

    guided = matching.guided_best_two
    b, i, s = guided(*a, **kw)
    rb, ri, rs = cuda_match.reference_best_two(*a)
    torch.cuda.synchronize()
    if not (torch.equal(b, rb) and torch.equal(i.long(), ri) and torch.equal(s, rs)):
        raise AssertionError(f"K2 at the {label} search: differs from the plain version")
    err = max(float((b - rb).abs().max()), float((s - rs).abs().max()))
    e_ms = time_ms(torch, lambda: guided(*a, **kw))
    g_ms = graph_ms(torch, lambda: guided(*a, **kw))
    p_ms = time_ms(torch, lambda: cuda_match.reference_best_two(*a))
    nbytes, nops, passes = k2_work(a, kw.get("c_words") is not None)
    b_ms, b_by = bound(nbytes, nops)
    # device time per call: every launch of 20 calls, profiled
    reps = 20

    def calls():
        for _ in range(reps):
            guided(*a, **kw)

    dk = profile_kernels(torch, calls)
    n_match = dk["best_two_bits_kernel"][0] / reps
    n_pack = dk["pack_bits_kernel"][0] / reps
    if n_match < 1:
        raise AssertionError(f"K2 at the {label} search: no search kernel was launched")
    d_ms = dk["best_two_bits_kernel"][1] / reps
    d_pack_ms = dk["pack_bits_kernel"][1] / reps
    nq, nc = a[0].shape[0], a[1].shape[0]
    log(f"[K2 real] {label} {nq}x{nc}: exact ({int((i >= 0).sum())} matched, {passes} pairs "
        f"pass the gates, {100 * passes / (nq * nc):.3f}%); {n_match:g} search + {n_pack:g} "
        f"pack launches; device search {d_ms:.5f} ms + pack {d_pack_ms:.5f} ms; eager "
        f"{e_ms:.4f} ms, graph {g_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(label=label, nq=nq, nc=nc, passes=passes, max_abs_err=err, eager_ms=e_ms,
                graph_ms=g_ms, plain_ms=p_ms, device_ms=d_ms, pack_device_ms=d_pack_ms,
                bound_ms=b_ms, bound_by=b_by)


class sync_counter:
    """Count host syncs by source line in the port's package while active
    (torch.cuda.set_sync_debug_mode("warn")): sites[site] += 1."""

    def __init__(self, torch, sites):
        self.torch, self.sites = torch, sites
        self.pkg = os.path.join(ROOT, "anyfeature_vslam_tpu_torch")

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        import traceback

        if "synchronizing CUDA operation" not in str(message):
            return
        # the innermost caller in the port's package names the sync site
        site = "?"
        for fr in traceback.extract_stack()[:-1]:
            if fr.filename.startswith(self.pkg):
                site = f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno} {fr.line}"
        self.sites[site] = self.sites.get(site, 0) + 1

    def __enter__(self):
        import warnings

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._on_warning
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)
        return False


def track_frames(torch, sc, cam, ext, state, frames, device):
    """Run fused_extract_track over `frames` (pre-rendered uint8 images of
    frames FIRST_TRACKED..), chaining the carry and the pose prediction as
    the sequential tracker does. Returns per frame (pose, n_inliers,
    track_ok, ms, feats, match_pt, used_motion)."""
    from anyfeature_vslam_tpu_torch.slam import fast_track
    from torch_slice_scene import FIRST_TRACKED, TRACK_PARAMS

    lo, hi = (torch.from_numpy(b).to(device) for b in sc.bounds)
    last = torch.from_numpy(sc.poses[FIRST_TRACKED - 1]).to(device)
    prev = torch.from_numpy(sc.poses[FIRST_TRACKED - 2]).to(device)
    state = dict(state)
    out_rows = []
    for img8 in frames:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = fast_track.predict_pose(last, prev)
        feats, out = fast_track.fused_extract_track(
            torch.from_numpy(img8).to(device), cam, ext, **state,
            pred_pose=pred, last_pose=last, use_motion=True,
            bounds_lo=lo, bounds_hi=hi, fx=sc.fx, fy=sc.fy, cx=sc.cx, cy=sc.cy,
            **TRACK_PARAMS,
        )
        pose, pt, n_in, _, ok, used_mm, pos = out
        state.update(last_uv=feats["uv_und"], last_bits=feats["desc_bits"],
                     last_size=feats["size"], last_angle=feats["angle"],
                     last_match_pt=pt, last_match_pos=pos)
        prev, last = last, pose
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out_rows.append((pose, int(n_in), bool(ok), ms, feats, pt, bool(used_mm)))
    return out_rows


N_SYSTEM_FRAMES = 48
N_SYNC_FRAMES = 16
RECORDED_EVENT = 10  # the keyframe event whose fusion searches are recorded
MIN_SYSTEM_TRACKED = 45
MAX_ATE_M = 0.05
# K2's searches in the System, by the innermost labelled caller: the init
# search, the tracked frame's searches, fusion, relocalization's candidate
# searches and its projection rounds (add-match and local map), and loop
# closing's global match, Sim3-guided projections and SearchAndFuse
SEARCHES = ("init", "tracking", "fusion", "reloc", "reloc_projection", "loop_global",
            "loop_projection", "loop_fuse")
RECORD_FIRST = 4  # calls kept per relocalization / loop search label


class SystemProbe:
    """While active, on one System: K2 launches counted by search (the
    label of the innermost labelled caller, SEARCHES), the inputs of the
    init searches, of the fusion searches of keyframe event RECORDED_EVENT
    and of the first RECORD_FIRST relocalization and loop searches kept in
    `record` by label, keyframe events timed (ms, K2 and pack launches,
    host syncs when `sync_sites` is counting)."""

    def __init__(self, torch, system, device, record=None, sync_sites=None):
        from anyfeature_vslam_tpu_torch.frontend import cuda_fast
        from anyfeature_vslam_tpu_torch.ops import cuda_match

        self.torch, self.system, self.device = torch, system, torch.device(device)
        self.record, self.sync_sites = record, sync_sites
        self.counters = (cuda_fast.fast_nms, cuda_match.best_two, cuda_match.pack_bits)
        self.label = "tracking"
        self.k2_by_label = {}
        self.events = []
        self._patched = []

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _syncs(self):
        return sum(self.sync_sites.values()) if self.sync_sites is not None else None

    def _patch(self, owner, name, wrap):
        self._patched.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrap(getattr(owner, name)))

    def _labelled(self, tag):
        def wrap(fn):
            def inner(*a, **kw):
                prev = self.label
                # SearchAndFuse's projections stay SearchAndFuse's
                self.label = prev if (prev, tag) == ("loop_fuse", "loop_projection") else tag
                try:
                    return fn(*a, **kw)
                finally:
                    self.label = prev
            return inner
        return wrap

    def _recorder(self, fn):
        def inner(*a, **kw):
            rec, lab = self.record, self.label
            if rec is not None and (
                    lab == "init" or (lab == "fusion" and len(self.events) == RECORDED_EVENT)
                    or (lab not in ("init", "fusion", "tracking")
                        and len(rec.get(lab, ())) < RECORD_FIRST)):
                rec.setdefault(lab, []).append((a, kw))
            n0 = self.counters[1].launches
            out = fn(*a, **kw)
            self.k2_by_label[lab] = self.k2_by_label.get(lab, 0) + self.counters[1].launches - n0
            return out
        return inner

    def _event_wrap(self, fn):
        def inner(kf):
            n0 = [c.launches for c in self.counters]
            s0 = self._syncs()
            t0 = time.perf_counter()
            fn(kf)
            self._sync()
            self.events.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                    k2=self.counters[1].launches - n0[1],
                                    pack=self.counters[2].launches - n0[2],
                                    syncs=None if s0 is None else self._syncs() - s0))
        return inner

    def __enter__(self):
        from anyfeature_vslam_tpu_torch.ops import matching
        from anyfeature_vslam_tpu_torch.slam import frame_ops
        from anyfeature_vslam_tpu_torch.slam.loop_closing import LoopCloser
        from anyfeature_vslam_tpu_torch.slam.tracking import Tracker

        for owner, name, tag in (
                (frame_ops, "match_for_initialization", "init"),
                (frame_ops, "fuse_points_into_targets", "fusion"),
                (frame_ops, "fuse_target_points_into_kf", "fusion"),
                (frame_ops, "match_descriptors_to_many", "reloc"),
                (Tracker, "_relocalization", "reloc_projection"),
                (LoopCloser, "_compute_sim3", "loop_global"),
                (LoopCloser, "_project_loop_points", "loop_projection"),
                (LoopCloser, "_search_and_fuse", "loop_fuse")):
            self._patch(owner, name, self._labelled(tag))
        self._patch(matching, "guided_best_two", self._recorder)
        self._patch(self.system.tracker, "on_new_keyframe", self._event_wrap)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._patched):
            setattr(owner, name, fn)
        self._patched = []
        return False

    def frame(self, img8, ts):
        """Track one frame; its row: ms, state, launches, events, map size."""
        c = self.counters
        n0 = [x.launches for x in c]
        ev0 = len(self.events)
        s0 = self._syncs()
        t0 = time.perf_counter()
        state = self.system.track_monocular(img8, ts)
        self._sync()
        m = self.system.map
        return dict(ms=(time.perf_counter() - t0) * 1e3, state=state.name,
                    k1=c[0].launches - n0[0], k2=c[1].launches - n0[1],
                    pack=c[2].launches - n0[2], events=len(self.events) - ev0,
                    kfs=m.n_keyframes(), pts=m.n_points(), inliers=self.system.tracker.n_inliers,
                    syncs=None if s0 is None else self._syncs() - s0)


def system_run(torch, width, height, n_frames, device, record=None, sync_sites=None):
    """The port's System with its defaults (shipped vocabulary, loop
    closing on) over the first n_frames of the bench sequence (rendered in
    memory), orb32, 1000 features, synchronous. Returns (system, per-frame
    rows, per-event rows, scene, K2 launches by search)."""
    from anyfeature_vslam_tpu_torch.system import System
    from torch_slice_scene import SliceScene

    sc = SliceScene(width, height)
    frames = [sc.render(i)[0] for i in range(n_frames)]
    system = System(SimpleNamespace(**sc.camera), feature="orb32", n_features=N_FEATURES,
                    device=device)
    with SystemProbe(torch, system, device, record, sync_sites) as probe:
        rows = [probe.frame(img8, i / 30.0) for i, img8 in enumerate(frames)]
    return system, rows, probe.events, sc, probe.k2_by_label


def ate(system, sc):
    """(keyframe ATE, frame ATE, n keyframes, n frames, the keyframes'
    aligning Sim3 (s, R, t)): Sim3-aligned RMSE of the camera centres
    against the rendered ground truth (the port's io/evaluation copy of the
    JAX package's scorer)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch.io import evaluation

    def centre(t):
        return -t[:3, :3].T @ t[:3, 3]

    m = system.map
    kfs = m.keyframe_ids()
    est = [centre(m.kf_pose[k].astype(np.float64)) for k in kfs]
    gt = [centre(sc.poses[int(m.kf_frame_id[k])]) for k in kfs]
    kf_ate, align = evaluation.ate_rmse(np.asarray(est), np.asarray(gt))
    est, gt = [], []
    for ts, t_cr, uid, lost in system.tracker.trajectory:
        t_cw = m.resolve_anchor(t_cr, uid)
        if lost or t_cw is None:
            continue
        est.append(centre(t_cw.astype(np.float64)))
        gt.append(centre(sc.poses[int(round(ts * 30.0))]))
    fr_ate = evaluation.ate_rmse(np.asarray(est), np.asarray(gt))[0]
    return kf_ate, fr_ate, len(kfs), len(est), align


def loop_stage_line(system, label):
    """The loop stage per keyframe event: its ms, the BoW transform's and
    detection's medians, the database's size."""
    lc = system.loop_closer
    st = {k: statistics.median(v) * 1e3 for k, v in lc.stage_times.items() if v}
    log(f"[{label}] loop stage: {len(system.loop_times)} events, median "
        f"{statistics.median(system.loop_times) * 1e3:.2f} ms (BoW transform "
        f"{st.get('bow', float('nan')):.2f}, detection {st.get('detect', float('nan')):.2f} ms; "
        f"{len(lc.stage_times.get('sim3', []))} Sim3 candidates tried); database "
        f"{int(system.database.present.sum())} keyframes; closures {lc.n_loops_closed}")


def system_phase(torch, device):
    """Phase 8: the System with its defaults over the first N_SYSTEM_FRAMES
    frames at 640x480, with its checks. Returns (launches K1, K2, pack;
    K2 launches by search; K2 measured at the init and fusion inputs; the
    system, its scene and the Sim3 aligning its keyframes to the truth)."""
    from anyfeature_vslam_tpu_torch import perfcount

    counters = _counters()
    recorded = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    perfcount.reset()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    system, srows, sevents, ssc, k2_by = system_run(torch, W, H, N_SYSTEM_FRAMES, device,
                                                    record=recorded)
    sys_wall = time.perf_counter() - t0
    sys_k1, sys_k2, sys_pack = (c.launches for c in counters)
    for i, r in enumerate(srows):
        log(f"[system] frame {i}: {r['state']} kfs {r['kfs']} pts {r['pts']} inliers "
            f"{r['inliers']} {r['ms']:.1f} ms, events {r['events']}, launches K1 {r['k1']} "
            f"K2 {r['k2']} pack {r['pack']}")
    stats = system.tracker.stats
    ok_frames = [i for i, r in enumerate(srows) if r["state"] == "OK"]
    init_frame = ok_frames[0] if ok_frames else -1
    kf_ate, fr_ate, n_kf_ate, n_fr_ate, align = ate(system, ssc)
    steady = srows[init_frame + 2:] if init_frame >= 0 else []
    kf_frames = [r["ms"] for r in steady if r["events"]]
    plain_frames = [r["ms"] for r in steady if not r["events"]]
    ev_k2 = sum(e["k2"] for e in sevents)
    n_init_k2, n_fuse_k2, n_track_k2 = (k2_by.get(k, 0) for k in ("init", "fusion", "tracking"))
    n_loop_k2 = sum(k2_by.get(k, 0) for k in ("loop_global", "loop_projection", "loop_fuse"))
    log(f"[system] {N_SYSTEM_FRAMES} frames {W}x{H} orb32 {N_FEATURES} features in "
        f"{sys_wall:.1f} s; init at frame {init_frame} with {srows[init_frame]['kfs']} "
        f"keyframes and {srows[init_frame]['pts']} points; at the end "
        f"{system.map.n_keyframes()} keyframes, {system.map.n_points()} points")
    log(f"[system] tracked {stats['tracked_frames']}, lost {stats['lost_frames']}, resets "
        f"{stats['resets']}; ATE (Sim3-aligned) keyframes {kf_ate:.5f} m over {n_kf_ate}, "
        f"frames {fr_ate:.5f} m over {n_fr_ate}")
    if not sevents:
        raise AssertionError("the System phase ran no keyframe event")
    log(f"[system] median ms per frame after init+1: without a keyframe event "
        f"{statistics.median(plain_frames) if plain_frames else float('nan'):.1f} "
        f"({len(plain_frames)} frames), with one "
        f"{statistics.median(kf_frames) if kf_frames else float('nan'):.1f} "
        f"({len(kf_frames)} frames); {len(sevents)} keyframe events, median "
        f"{statistics.median(e['ms'] for e in sevents):.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for name, ts in system.local_mapper.stage_times.items():
        log(f"[system] event stage {name}: median {1e3 * statistics.median(ts):.1f} ms, "
            f"max {1e3 * max(ts):.1f} ms over {len(ts)} events")
    loop_stage_line(system, "system")
    ba_lines(system.local_mapper.ba_log, "system", "local BA")
    log(f"[system] map counters: {json.dumps(perfcount.snapshot())}")
    log(f"[system] launches: K1 {sys_k1} ({sys_k1 / len(srows):.2f} per frame, min "
        f"{min(r['k1'] for r in srows)}), K2 {sys_k2} (init search {n_init_k2}, tracking "
        f"{n_track_k2}, {n_track_k2 / max(len(ok_frames) - 1, 1):.2f} per tracked frame; "
        f"fusion {n_fuse_k2}, {n_fuse_k2 / max(len(sevents), 1):.1f} per event; loop "
        f"{n_loop_k2}), pack {sys_pack} ({sum(e['pack'] for e in sevents)} in events); "
        f"by search {json.dumps(k2_by)}")
    sys_fail = []
    if stats["resets"] != 0:
        sys_fail.append(f"{stats['resets']} resets")
    if stats["tracked_frames"] < MIN_SYSTEM_TRACKED:
        sys_fail.append(f"{stats['tracked_frames']} tracked frames")
    if not (kf_ate < MAX_ATE_M and fr_ate < MAX_ATE_M):
        sys_fail.append(f"ATE {kf_ate:.4f} / {fr_ate:.4f} m")
    if system.loop_closer is None or system.database is None or system.vocabulary is None:
        sys_fail.append("the System runs without the shipped vocabulary or loop closing")
    elif system.loop_closer.n_loops_closed != 0:
        sys_fail.append(f"{system.loop_closer.n_loops_closed} loop closures on a path that "
                        f"does not revisit")
    elif len(system.loop_times) != len(sevents):
        sys_fail.append("a keyframe event without its loop stage")
    if min(r["k1"] for r in srows) < 1:
        sys_fail.append("a frame without a K1 launch")
    if sys_pack < 1:
        sys_fail.append("no pack_bits launch")
    if not (n_init_k2 > 0 and n_fuse_k2 > 0 and n_track_k2 > 0
            and sum(k2_by.values()) == sys_k2 and ev_k2 == n_fuse_k2 + n_loop_k2):
        sys_fail.append("K2 not launched by each of the init, tracking and fusion searches")
    if sys_fail:
        raise AssertionError(f"the System phase failed: {sys_fail}")
    k2_sys = {}
    for label in ("init", "fusion"):
        if label not in recorded:
            raise AssertionError(f"no {label} search was recorded")
        # the successful init search (the last), the fusion search of event
        # RECORDED_EVENT with the most active queries
        calls = recorded[label]
        a, kw = calls[-1] if label == "init" else max(
            calls, key=lambda c: int((c[0][4] >= 0).sum()))
        k2_sys[label] = measure_k2(
            torch, a, kw, f"System {label} search ({int((a[4] >= 0).sum())} active queries)")
    # host syncs: a fresh System over the first frames, syncs counted
    sync_sites = {}
    with sync_counter(torch, sync_sites):
        _, crows, cevents, _, _ = system_run(torch, W, H, N_SYNC_FRAMES, device,
                                             sync_sites=sync_sites)
    tracked_syncs = [r["syncs"] for r in crows if r["state"] == "OK" and not r["events"]]
    log(f"[system syncs] first {N_SYNC_FRAMES} frames: {sum(sync_sites.values())} host syncs; "
        f"per keyframe event {[e['syncs'] for e in cevents]}; per frame without an event "
        f"{tracked_syncs}")
    for site, n in sorted(sync_sites.items(), key=lambda kv: -kv[1])[:15]:
        log(f"[system syncs]   {n:5d}x  {site}")
    return ((sys_k1, sys_k2, sys_pack), k2_by, k2_sys, (system, ssc, align))


def _counters():
    from anyfeature_vslam_tpu_torch.frontend import cuda_fast
    from anyfeature_vslam_tpu_torch.ops import cuda_match

    return (cuda_fast.fast_nms, cuda_match.best_two, cuda_match.pack_bits)


def ba_lines(log_rows, tag, what):
    """One line per padded-cap combination of a BA log: solves, path, ms."""
    by_caps = {}
    for b in log_rows:
        key = (b["k_cap"], b["p_cap"], b["o_cap"], "dense" if b["dense"] else "CG")
        by_caps.setdefault(key, []).append(b)
    for (k, p, o, path), rows in sorted(by_caps.items()):
        ms = [b["ms"] for b in rows]
        log(f"[{tag}] {what} caps k {k} p {p} o {o} ({path}): {len(ms)} solves over "
            f"{rows[0]['n_kf']} keyframes, {rows[0]['n_pt']} points, {rows[0]['n_obs']} "
            f"observations; median {statistics.median(ms):.1f} ms, max {max(ms):.1f} ms")


N_BLACKOUT = 3
RELOC_VIEWS = (20, 21, 22)  # re-rendered views at the poses of mapped frames
MAX_RELOC_M = 0.05


def reloc_phase(torch, device, system, sc, align):
    """Phase 9: phase 8's System loses the camera to N_BLACKOUT uniform
    frames and must relocalize, within 3 frames, on views at the poses of
    earlier mapped frames: at least one relocalization, the relocalized
    camera centre within MAX_RELOC_M of the truth after phase 8's Sim3
    alignment. Counts set to 0 just before, read just after. Returns
    (launches K1, K2, pack; K2 by search; recorded search inputs)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch import perfcount
    from anyfeature_vslam_tpu_torch.ops import pnp

    counters = _counters()
    tracker = system.tracker
    recorded = {}
    cands, pnp_ms = [], []
    db = system.database
    find = db.detect_relocalization_candidates
    ransac = pnp.pnp_ransac_many

    def find_rec(*a, **kw):
        out = find(*a, **kw)
        cands.append(list(out))
        return out

    def ransac_timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ransac(*a, **kw)
        torch.cuda.synchronize()
        pnp_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    db.detect_relocalization_candidates = find_rec
    pnp.pnp_ransac_many = ransac_timed
    perfcount.reset()
    perfcount.trace_enabled = True
    perfcount.clear_events()
    reloc0 = tracker.stats["relocalizations"]
    sync_sites = {}
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    rows = []
    try:
        with SystemProbe(torch, system, device, recorded, sync_sites) as probe, \
                sync_counter(torch, sync_sites):
            ts = N_SYSTEM_FRAMES / 30.0
            dark = np.full((sc.height, sc.width), 25, np.uint8)
            for _ in range(N_BLACKOUT):
                rows.append(("blackout", probe.frame(dark, ts)))
                ts += 1 / 30.0
            state_after_blackout = tracker.state.name
            for f in RELOC_VIEWS:
                rows.append((f"view of frame {f}", probe.frame(sc.render(f)[0], ts)))
                ts += 1 / 30.0
                if rows[-1][1]["state"] == "OK":
                    break
    finally:
        del db.detect_relocalization_candidates
        pnp.pnp_ransac_many = ransac
        perfcount.trace_enabled = False
    launches = tuple(c.launches for c in counters)
    k2_by = probe.k2_by_label
    reloc_events = [e for e in perfcount.events() if e[1] == "reloc"]
    perfcount.clear_events()
    for what, r in rows:
        log(f"[reloc] {what}: {r['state']} {r['ms']:.1f} ms, inliers {r['inliers']}, launches "
            f"K1 {r['k1']} K2 {r['k2']} pack {r['pack']}, host syncs {r['syncs']}")
    s_, r_, t_ = align
    pose = tracker.last.pose.astype(np.float64)
    fid = RELOC_VIEWS[len(rows) - N_BLACKOUT - 1]
    est = s_ * r_ @ (-pose[:3, :3].T @ pose[:3, 3]) + t_
    gt = -sc.poses[fid][:3, :3].T @ sc.poses[fid][:3, 3]
    err = float(np.linalg.norm(est - gt))
    n_reloc = tracker.stats["relocalizations"] - reloc0
    log(f"[reloc] after {N_BLACKOUT} blackout frames: {state_after_blackout}; relocalized "
        f"{n_reloc} time(s) at the view of frame {fid}, {len(rows) - N_BLACKOUT} frame(s) "
        f"after the blackout; camera centre {100 * err:.3f} cm from the truth")
    log(f"[reloc] relocalization attempts: {len(reloc_events)}, ms "
        f"{[round(1e3 * e[2]['dur'], 2) for e in reloc_events]}; candidates per attempt "
        f"{[len(c) for c in cands]} ({cands}); batched RANSAC-EPnP ms "
        f"{[round(x, 2) for x in pnp_ms]}; K2 launches by search {json.dumps(k2_by)}; host "
        f"syncs {sum(sync_sites.values())}")
    for site, n in sorted(sync_sites.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[reloc syncs]   {n:5d}x  {site}")
    fail = []
    if state_after_blackout != "LOST":
        fail.append(f"state {state_after_blackout} after the blackout")
    if rows[-1][1]["state"] != "OK" or n_reloc < 1:
        fail.append("no relocalization within 3 frames")
    if err >= MAX_RELOC_M:
        fail.append(f"relocalized {err:.4f} m from the truth")
    n_cand_searches = sum(min(len(c), 8) for c in cands)
    if k2_by.get("reloc", 0) != n_cand_searches or n_cand_searches < 1:
        fail.append(f"{k2_by.get('reloc', 0)} candidate searches for {n_cand_searches} candidates")
    if fail:
        raise AssertionError(f"the relocalization phase failed: {fail}")
    return launches, k2_by, recorded


# The JAX System with async_mapping=False closes this loop on the CPU at
# 640x480 with 1000 features (PERF.md, cells), so phase 10 runs there and
# not at the test's 320x240 with 600.
LOOP_W, LOOP_H, LOOP_FEATURES = 640, 480, 1000
MAX_LOOP_LOST = 5
MAX_LOOP_ATE_M = 0.08


def _render_loop_chunk(width, height, idx):
    from torch_slice_scene import LoopScene

    sc = LoopScene(width, height)
    return [(i, sc.render(i)) for i in idx]


def render_loop_frames(width, height, idx):
    """{i: uint8 frame i of the loop scene}, rendered on the host's cores
    (one spawned process per core, at most 8; none touches the card)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n_proc = min(8, os.cpu_count() or 1)
    with ProcessPoolExecutor(n_proc, mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = pool.map(_render_loop_chunk, [width] * n_proc, [height] * n_proc,
                         [idx[k::n_proc] for k in range(n_proc)])
        return dict(p for part in parts for p in part)


def loop_phase(torch, device):
    """Phase 10: the two-session merge of tests/test_loop_live.py, rendered
    in memory (torch_slice_scene.LoopScene at LOOP_W x LOOP_H). Session A
    maps circle A and saves a checkpoint; session B loads it, boots a fresh
    component in circle B and re-enters A, where only a Sim3 loop closure
    can merge the two. Gates, the test's own: 0 resets, <= 5 lost frames,
    >= 1 closure and loop edge, the keyframe ATE < 8 cm over both
    sessions' keyframes (>= 8 of each; only a right closure keeps it low)
    and over session A's (the test's evaluate() pairs keyframes with
    ground truth by timestamp, and session B's carry +100 s). Counts set to
    0 just before, read just after. Returns (launches K1, K2, pack; K2 by
    search; recorded search inputs)."""
    import tempfile

    import numpy as np

    from anyfeature_vslam_tpu_torch.io import evaluation
    from anyfeature_vslam_tpu_torch.system import System
    from torch_slice_scene import LoopScene

    t0 = time.perf_counter()
    sc = LoopScene(LOOP_W, LOOP_H)
    frames = render_loop_frames(LOOP_W, LOOP_H, list(sc.session_a) + list(sc.session_b))
    log(f"[loop] rendered {len(frames)} frames {LOOP_W}x{LOOP_H} in "
        f"{time.perf_counter() - t0:.1f} s")
    counters = _counters()
    recorded = {}
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    cam = SimpleNamespace(**sc.camera)
    sys_a = System(cam, feature="orb32", n_features=LOOP_FEATURES, device=device)
    with SystemProbe(torch, sys_a, device) as probe_a:
        rows_a = [probe_a.frame(frames[i], i / 30.0) for i in sc.session_a]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "session_a.npz")
        sys_a.save_checkpoint(ckpt)
        sys_b = System(cam, feature="orb32", n_features=LOOP_FEATURES, device=device)
        sys_b.load_checkpoint(ckpt)
    n_loaded = sys_b.map.n_keyframes()
    closing = []
    with SystemProbe(torch, sys_b, device, recorded) as probe_b:
        rows_b = []
        for i in sc.session_b:
            n0 = sys_b.loop_closer.n_loops_closed
            rows_b.append(probe_b.frame(frames[i], i / 30.0 + 100.0))
            if sys_b.loop_closer.n_loops_closed > n0:
                closing.append((i, rows_b[-1]["ms"]))
    wall = time.perf_counter() - t0
    launches = tuple(c.launches for c in counters)
    k2_by = dict(probe_a.k2_by_label)
    for k, v in probe_b.k2_by_label.items():
        k2_by[k] = k2_by.get(k, 0) + v
    st_a, st_b = sys_a.tracker.stats, sys_b.tracker.stats
    lc = sys_b.loop_closer
    # keyframe ATE over both sessions: session B's timestamps carry +100 s
    m = sys_b.map
    kfs = m.keyframe_ids()
    fids = [int(round((ts - 100.0 if ts >= 100.0 else ts) * 30.0)) for ts in m.kf_ts[kfs]]
    est = np.stack([-m.kf_pose[k][:3, :3].T @ m.kf_pose[k][:3, 3] for k in kfs]).astype(np.float64)
    gt = np.stack([-sc.poses[f][:3, :3].T @ sc.poses[f][:3, 3] for f in fids])
    kf_ate = evaluation.ate_rmse(est, gt)[0]
    in_b = m.kf_ts[kfs] >= 100.0
    n_b = int(in_b.sum())
    ate_a = evaluation.ate_rmse(est[~in_b], gt[~in_b])[0]
    ate_b = evaluation.ate_rmse(est[in_b], gt[in_b])[0] if n_b >= 3 else float("nan")
    ms_a = [r["ms"] for r in rows_a[5:]]
    ms_b = [r["ms"] for r in rows_b]
    log(f"[loop] session A: {len(rows_a)} frames, {st_a}, {sys_a.map.n_keyframes()} keyframes, "
        f"median {statistics.median(ms_a):.1f} ms per frame; checkpoint loaded into session B: "
        f"{n_loaded} keyframes")
    log(f"[loop] session B: {len(rows_b)} frames, {st_b}, median {statistics.median(ms_b):.1f} "
        f"ms per frame; closures {lc.n_loops_closed} at frames {closing}; loop edges "
        f"{m.loop_edges}; {len(kfs)} keyframes ({n_b} of session B); keyframe ATE as the test "
        f"scores it (session A's keyframes) {ate_a:.5f} m; over both sessions {kf_ate:.5f} m; "
        f"session B's alone {ate_b:.5f} m; {wall:.1f} s")
    loop_stage_line(sys_b, "loop")
    for name in ("sim3", "correct", "fuse", "essential_graph", "global_ba"):
        v = lc.stage_times.get(name, [])
        if v:
            log(f"[loop] closure stage {name}: {len(v)} runs, last {v[-1] * 1e3:.1f} ms, "
                f"median {statistics.median(v) * 1e3:.2f} ms")
    ba_lines(lc.gba_log, "loop", "global BA")
    ba_lines(sys_b.local_mapper.ba_log, "loop", "local BA (session B)")
    log(f"[loop] K2 launches by search over both sessions: {json.dumps(k2_by)}; K1 "
        f"{launches[0]}, K2 {launches[1]}, pack {launches[2]}")
    fail = []
    if st_a["resets"] or st_b["resets"]:
        fail.append("a reset")
    if st_b["lost_frames"] > MAX_LOOP_LOST:
        fail.append(f"{st_b['lost_frames']} lost frames")
    if lc.n_loops_closed < 1 or len(m.loop_edges) < 1:
        fail.append("no loop closure")
    if not (kf_ate < MAX_LOOP_ATE_M and ate_a < MAX_LOOP_ATE_M and n_b >= 8
            and len(kfs) - n_b >= 8):
        fail.append(f"keyframe ATE {kf_ate:.4f} m over both sessions ({n_b} keyframes of B), "
                    f"{ate_a:.4f} m over session A's {len(kfs) - n_b}")
    if lc.n_loops_closed and not all(k2_by.get(k, 0) > 0 for k in
                                     ("loop_global", "loop_projection", "loop_fuse")):
        fail.append("a loop search without a K2 launch")
    if fail:
        raise AssertionError(f"the loop-closure phase failed: {fail}")
    return launches, k2_by, recorded


def constructed_loop_phase(torch, device):
    """Phase 10b: the constructed loop map of tests/test_loop_closing_unit.py
    (tests/loop_map.py) through the port's LoopCloser on the card and on
    the CPU in this process: the same closing keyframe and candidate,
    keyframe poses within 2e-3 where the global BA starts (within 2e-2
    after it: the BA ends in a flat valley on this map, where a 1e-6 input
    change moves it by 5e-3), the end drift below 0.6 of its value before."""
    import functools

    import numpy as np

    from anyfeature_vslam_tpu_torch.place_recognition import vocab
    from anyfeature_vslam_tpu_torch.place_recognition.database import KeyFrameDatabase
    from anyfeature_vslam_tpu_torch.slam.loop_closing import LoopCloser
    from anyfeature_vslam_tpu_torch.slam.map_state import SlamMap
    from loop_map import CAMERA, build_loop_map, end_drift, train_map_vocabulary

    out = {}
    for dev in ("cpu", device):
        dev = torch.device(dev)
        m, gt_pose = build_loop_map(functools.partial(SlamMap, device=dev))
        n_kf = m.n_keyframes()
        voc = train_map_vocabulary(m, vocab.train_vocabulary)
        lc = LoopCloser(m, SimpleNamespace(**CAMERA), KeyFrameDatabase(voc, m.max_kf, dev),
                        match_th=75.0, device=dev)
        before = end_drift(m, gt_pose, n_kf)
        t0 = time.perf_counter()
        closed_at = next((kf for kf in range(n_kf) if lc.process_keyframe(kf)), None)
        ms = (time.perf_counter() - t0) * 1e3
        out[dev.type] = dict(closed_at=closed_at, edges=list(m.loop_edges), poses=m.kf_pose.copy(),
                             ba_in=[b["kf_pose_in"] for b in lc.gba_log], before=before,
                             after=end_drift(m, gt_pose, n_kf), ms=ms,
                             stages={k: round(1e3 * sum(v), 2) for k, v in lc.stage_times.items()},
                             gba=lc.gba_log)
    c, g = out["cpu"], out[torch.device(device).type]
    d_in = float(np.abs(c["ba_in"][0] - g["ba_in"][0]).max()) if c["ba_in"] and g["ba_in"] else None
    d_out = float(np.abs(c["poses"] - g["poses"]).max())
    for k, r in out.items():
        log(f"[loop map] {k}: closed at keyframe {r['closed_at']} edges {r['edges']}, end drift "
            f"{r['before']:.4f} -> {r['after']:.4f}, {r['ms']:.1f} ms; stage ms {r['stages']}; "
            f"global BA {[(b['k_cap'], b['p_cap'], b['o_cap'], 'dense' if b['dense'] else 'CG') for b in r['gba']]}")
    log(f"[loop map] card vs CPU: keyframe poses max abs diff {d_in} where the global BA starts, "
        f"{d_out:.2e} after it")
    if not (g["closed_at"] is not None and g["closed_at"] == c["closed_at"]
            and g["edges"] == c["edges"] and d_in is not None and d_in < 2e-3 and d_out < 2e-2
            and g["after"] < 0.6 * g["before"]):
        raise AssertionError("the constructed-map loop closure on the card disagrees with the "
                             "CPU port")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's smoke "
              "test runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np

    import anyfeature_vslam_tpu_torch  # noqa: F401  (TF32 off)
    from anyfeature_vslam_tpu_torch import convert, cuda_build, flagship
    from anyfeature_vslam_tpu_torch.frontend import cuda_fast
    from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, OrbExtractor
    from anyfeature_vslam_tpu_torch.ops import camera as cam_ops
    from anyfeature_vslam_tpu_torch.ops import cuda_match
    from torch_slice_scene import FIRST_TRACKED, SliceScene, pose_error

    assert_no_jax()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 1 begins")
    # ---- 1. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor

    names = ("fast_nms", "best_two")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.build, names))
    log(f"[build] {', '.join(names)} in parallel: {time.perf_counter() - t0:.1f} s")
    for name in names:
        cuda_build.load(name)
        log(f"[build] {name} -> {cuda_build.library_path(name).name}")
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")

    # ---- scene (rendered on the host before anything is timed)
    t0 = time.perf_counter()
    sc = SliceScene(W, H)
    frames = [sc.render(i)[0] for i in range(FIRST_TRACKED, FIRST_TRACKED + N_TRACKED)]
    log(f"[scene] rendered {len(frames)} frames {W}x{H} in {time.perf_counter() - t0:.1f} s")
    cfg = ExtractorConfig(n_features=N_FEATURES)
    ext = OrbExtractor(cfg, H, W).to(device)
    cam = convert.camera_from_numpy(SimpleNamespace(**sc.camera), device)

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 2 begins")
    # ---- 2. K1 on every pyramid level
    from anyfeature_vslam_tpu_torch.frontend import pyramid

    img = torch.from_numpy(frames[0]).to(device).float()
    levels = [l.contiguous() for l in pyramid.build_pyramid(img, ext.resize_mats())]
    k1_err = 0.0
    before = cuda_fast.fast_nms.launches
    got_levels = cuda_fast.fast_nms_levels(levels, cfg.detect_th)
    if cuda_fast.fast_nms.launches != before + 1:
        raise AssertionError("K1: the 8 levels took more than one launch")
    for lvl, (lev, got) in enumerate(zip(levels, got_levels)):
        want = cuda_fast.fast_nms_plain(lev, cfg.detect_th)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        k1_err = max(k1_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 level {lvl} {tuple(lev.shape)}: not bit-exact "
                                 f"(max abs err {err}, {int((got != want).sum())} px)")
        log(f"[K1] level {lvl} {tuple(lev.shape)}: bit-exact, {int((got > 0).sum())} corners")

    def k1_frame():
        return cuda_fast.fast_nms_levels(levels, cfg.detect_th)

    k1_ms = time_ms(torch, k1_frame)
    k1_graph_ms = graph_ms(torch, k1_frame)
    k1_plain_ms = time_ms(torch, lambda: [cuda_fast.fast_nms_plain(l, cfg.detect_th) for l in levels])
    k1_bytes, k1_ops, k1_live = k1_work(torch, levels, cfg.detect_th)
    k1_bound_ms, k1_bound_by = bound(k1_bytes, k1_ops)
    n_px = sum(l.numel() for l in levels)
    log(f"[K1] 8 levels per frame, one launch: eager {k1_ms:.4f} ms, graph {k1_graph_ms:.4f} ms, "
        f"plain {k1_plain_ms:.4f} ms, bound {k1_bound_ms:.5f} ms ({k1_bound_by}: {k1_bytes} B, "
        f"{k1_ops} operations; {k1_live} of {n_px} pixels live at the cardinal test)")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 3 begins")
    # ---- 3. K2 at the main path's shapes
    rng = np.random.default_rng(0)

    def k2_case(nq, nc, binary):
        if binary:
            q = rng.integers(0, 2, (nq, 256)).astype(np.uint8)
            c = rng.integers(0, 2, (nc, 256)).astype(np.uint8)
        else:
            q = rng.normal(size=(nq, 128)).astype(np.float32)
            c = rng.normal(size=(nc, 128)).astype(np.float32)
        side = (
            rng.uniform(0, W, (nq, 2)).astype(np.float32),
            rng.uniform(0, W, (nc, 2)).astype(np.float32),
            np.where(rng.random(nq) < 0.9, rng.uniform(20, 200, nq), -1.0).astype(np.float32),
            rng.uniform(0.5, 1.2, nq).astype(np.float32),
            rng.uniform(2.0, 4.0, nq).astype(np.float32),
            rng.uniform(1, 3.6, nc).astype(np.float32),
            rng.random(nc) < 0.9,
        )
        q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid = (torch.from_numpy(a).to(device) for a in side)
        return (torch.from_numpy(q).to(device), torch.from_numpy(c).to(device),
                q_uv, c_uv, q_rad, q_slo, q_shi, c_size, c_valid)

    for d in (256, 384, 488, 512):
        bits = torch.from_numpy(rng.integers(0, 2, (1000, d)).astype(np.uint8)).to(device)
        words = cuda_match.pack_bits(bits)
        torch.cuda.synchronize()
        if not torch.equal(words, cuda_match.pack_bits_plain(bits)):
            raise AssertionError(f"pack_bits D={d}: differs from the plain version")
    log("[K2] pack_bits 1000 x {256, 384, 488, 512}: equal to the plain version")
    k2_err = 0.0
    for nq, nc in ((4096, 1000), (1000, 1000)):
        args = k2_case(nq, nc, True)
        b, i, s = cuda_match.best_two(*args)
        rb, ri, rs = cuda_match.reference_best_two(*args)
        torch.cuda.synchronize()
        if not (torch.equal(b, rb) and torch.equal(i.long(), ri) and torch.equal(s, rs)):
            raise AssertionError(f"K2 binary {nq}x{nc}: differs from the plain version "
                                 f"({int((i.long() != ri).sum())} idx)")
        k2_err = max(k2_err, float((b - rb).abs().max()), float((s - rs).abs().max()))
        k_ms = time_ms(torch, lambda: cuda_match.best_two(*args))
        g_ms = graph_ms(torch, lambda: cuda_match.best_two(*args))
        p_ms = time_ms(torch, lambda: cuda_match.reference_best_two(*args))
        b_ms, b_by = bound(*k2_work(args, False)[:2])
        log(f"[K2] binary {nq}x{nc} random: exact ({int((i >= 0).sum())} matched, "
            f"{int(cuda_match.gate_mask(*args[2:]).sum())} pairs pass the gates); eager {k_ms:.4f} ms, "
            f"graph {g_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    args = k2_case(1000, 1000, False)
    b, i, s = cuda_match.best_two(*args)
    rb, ri, rs = cuda_match.reference_best_two(*args)
    torch.cuda.synchronize()
    f_err = max(float((b - rb).abs().max()), float((s - rs).abs().max()))
    near_tie = (rs - rb) < 1e-2
    if f_err > 1e-2 or bool(((i.long() != ri) & ~near_tie).any()):
        raise AssertionError(f"K2 float 1000x1000: max abs err {f_err}")
    log(f"[K2] float 1000x1000 D=128: max abs err {f_err:.3g} (atol 1e-2)")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 4 begins")
    # ---- 4. the slice on a small input: card vs the CPU port
    small = SliceScene(320, 240)
    cfg_s = ExtractorConfig(n_features=500)
    ext_cpu = OrbExtractor(cfg_s, 240, 320)
    cam_cpu = convert.camera_from_numpy(SimpleNamespace(**small.camera), "cpu")

    def extract_cpu(img8):
        f = ext_cpu(torch.from_numpy(img8).float())
        f["uv_und"] = cam_ops.undistort_points(cam_cpu, f["xy"])
        return {k: v.numpy() for k, v in f.items()}

    carry, ref, block = small.build_state(extract_cpu)
    small_frames = [small.render(FIRST_TRACKED + k)[0] for k in range(2)]
    rows = {}
    for dev in (torch.device("cpu"), device):  # ext_cpu.to() moves it: CPU first
        rows[dev.type] = track_frames(
            torch, small, convert.camera_from_numpy(SimpleNamespace(**small.camera), dev),
            ext_cpu.to(dev), convert.track_state_from_numpy(carry, ref, block, dev),
            small_frames, dev)
    for k, (rc, rg) in enumerate(zip(rows["cpu"], rows["cuda"])):
        same_pt = float((rc[5] == rg[5].cpu()).float().mean())
        dpose = float((rc[0] - rg[0].cpu()).abs().max())
        log(f"[small] frame {FIRST_TRACKED + k} 320x240: n_in cpu {rc[1]} card {rg[1]}, "
            f"match ids equal {same_pt:.4f}, max pose diff {dpose:.2e}")
        if same_pt < 0.99 or dpose > 1e-3 or not (rc[2] and rg[2]):
            raise AssertionError("the slice on the card disagrees with the CPU port")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 5 begins")
    # ---- 5. the slice at full size: the main path
    def extract_dev(img8):
        f = ext(torch.from_numpy(img8).to(device).float())
        f["uv_und"] = cam_ops.undistort_points(cam, f["xy"])
        return {k: v.cpu().numpy() for k, v in f.items()}

    carry, ref, block = sc.build_state(extract_dev)
    n_pts = int(block["blk_valid"].sum())
    log(f"[slice] ground-truth map: {n_pts} points in a {block['blk_ids'].shape[0]}-row block")
    state = convert.track_state_from_numpy(carry, ref, block, device)
    torch.cuda.synchronize()
    cuda_fast.fast_nms.launches = 0
    cuda_match.best_two.launches = 0
    cuda_match.pack_bits.launches = 0
    rows = track_frames(torch, sc, cam, ext, state, frames, device)
    k1_launches = cuda_fast.fast_nms.launches
    k2_launches = cuda_match.best_two.launches
    pack_launches = cuda_match.pack_bits.launches
    failures = []
    for k, (pose, n_in, ok, ms, feats, _, _) in enumerate(rows):
        fid = FIRST_TRACKED + k
        p = pose.cpu().numpy()
        rot, trans = pose_error(p, sc.poses[fid])
        log(f"[slice] frame {fid}: track_ok {ok} n_inliers {n_in} "
            f"valid kps {int(feats['valid'].sum())} err {rot:.4f} deg {trans * 100:.3f} cm "
            f"{ms:.2f} ms")
        in_bounds = rot <= MAX_ROT_DEG and trans <= MAX_TRANS_M
        if not (ok and n_in >= MIN_INLIERS and np.isfinite(p).all()
                and (in_bounds or k >= BOUNDED_FRAMES)):
            failures.append(fid)
    frame_ms = [r[3] for r in rows[N_WARMUP_FRAMES:]]
    log(f"[slice] median {statistics.median(frame_ms):.2f} ms per tracked frame "
        f"({len(frame_ms)} frames after {N_WARMUP_FRAMES} warm-up; min {min(frame_ms):.2f}, "
        f"max {max(frame_ms):.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    # a frame searches 3 times (motion, its 2x retry, local map) and packs
    # its keypoints once; the reference-keyframe fallback adds a search and
    # the pack of the keyframe's descriptors
    n_fallback = sum(not r[6] for r in rows)
    want_k2 = 3 * len(rows) + n_fallback
    want_pack = len(rows) + n_fallback
    log(f"[slice] launches: K1 {k1_launches} (1 x {len(rows)} frames), K2 {k2_launches} "
        f"({want_k2} searches, {n_fallback} fallbacks), pack {pack_launches} ({want_pack})")
    if failures:
        raise AssertionError(f"frames {failures} did not track within the bounds")
    if k1_launches != len(rows) or k2_launches != want_k2 or pack_launches != want_pack:
        raise AssertionError("the main path did not go through the kernels as designed")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 5b begins")
    # ---- 5b. the kernels' device time over the first frames, profiled
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    profiled = frames[:N_PROFILED]
    dev_frames = profile_kernels(
        torch, lambda: track_frames(torch, sc, cam, ext, state, profiled, device))
    log(f"[device] torch.profiler kernel events over the first {len(profiled)} frames of "
        f"phase 5 ({time.perf_counter() - t0:.1f} s, parsing included):")
    for k, (n, t) in dev_frames.items():
        log(f"[device]   {k}: {n} launches ({n / len(profiled):.2f} per frame), device "
            f"{t / len(profiled):.5f} ms per frame, {t / max(n, 1):.5f} ms per launch")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 5c begins")
    # ---- 5c. K2 at the inputs of the searches of one tracked frame
    from anyfeature_vslam_tpu_torch.ops import matching
    from anyfeature_vslam_tpu_torch.slam import fast_track
    from torch_slice_scene import TRACK_PARAMS

    lo, hi = (torch.from_numpy(b).to(device) for b in sc.bounds)
    last = torch.from_numpy(sc.poses[FIRST_TRACKED - 1]).to(device)
    pred = fast_track.predict_pose(last, torch.from_numpy(sc.poses[FIRST_TRACKED - 2]).to(device))
    img_dev = torch.from_numpy(frames[0]).to(device)
    guided = matching.guided_best_two
    searches = []

    def record(*a, **kw):
        searches.append((a, kw))
        return guided(*a, **kw)

    matching.guided_best_two = record
    try:
        # the motion-model frame, then the same frame forced onto the
        # reference-keyframe search
        for use_motion in (True, False):
            fast_track.fused_extract_track(
                img_dev, cam, ext, **state, pred_pose=pred, last_pose=last,
                use_motion=use_motion, bounds_lo=lo, bounds_hi=hi, fx=sc.fx, fy=sc.fy,
                cx=sc.cx, cy=sc.cy, **TRACK_PARAMS)
            if use_motion:
                n_motion = len(searches)
    finally:
        matching.guided_best_two = guided
    labels = ["motion r", "motion 2r"] + ["ref-KF"] * (n_motion - 3) + ["local map"]
    real = list(zip(labels, searches[:n_motion])) + [("ref-KF", searches[n_motion])]
    frame_searches = n_motion  # the searches the frame ran
    k2_real = []
    for label, (a, kw) in real:
        row = measure_k2(torch, a, kw, f"frame {FIRST_TRACKED} {label}")
        k2_err = max(k2_err, row["max_abs_err"])
        k2_real.append(row)

    # pack_bits at the frame's keypoints, the candidates of its searches
    f_bits = searches[0][0][1]
    f_words = cuda_match.pack_bits(f_bits)
    torch.cuda.synchronize()
    if not torch.equal(f_words, cuda_match.pack_bits_plain(f_bits)):
        raise AssertionError(f"pack_bits at frame {FIRST_TRACKED}: differs from the plain version")
    pack_ms = time_ms(torch, lambda: cuda_match.pack_bits(f_bits))
    pack_graph_ms = graph_ms(torch, lambda: cuda_match.pack_bits(f_bits))
    pack_plain_ms = time_ms(torch, lambda: cuda_match.pack_bits_plain(f_bits))
    n, d = f_bits.shape
    pack_bound_ms, pack_bound_by = bound(n * d + f_words.numel() * 4, n * d)
    log(f"[pack] frame {FIRST_TRACKED} {n}x{d}: equal; eager {pack_ms:.4f} ms, graph "
        f"{pack_graph_ms:.4f} ms, plain {pack_plain_ms:.4f} ms, "
        f"bound {pack_bound_ms:.5f} ms ({pack_bound_by})")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 6 begins")
    # ---- 6. where a tracked frame's time goes, and its host syncs
    from anyfeature_vslam_tpu_torch.ops import pose_opt
    from anyfeature_vslam_tpu_torch.slam import frame_ops

    # host time of the frame and of its stages, each run alone (median of 7)
    def host_ms(fn, reps=7):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    f0 = ext(img_dev.float())
    f0_uv = cam_ops.undistort_points(cam, f0["xy"])
    f0_words = cuda_match.pack_bits(f0["desc_bits"])
    blk = [state[k] for k in convert.BLOCK_KEYS[1:]]
    stages = {
        "whole tracked frame (fused_extract_track)": lambda: fast_track.fused_extract_track(
            img_dev, cam, ext, **state, pred_pose=pred, last_pose=last, use_motion=True,
            bounds_lo=lo, bounds_hi=hi, fx=sc.fx, fy=sc.fy, cx=sc.cx, cy=sc.cy, **TRACK_PARAMS),
        "extraction (pyramid, K1 once, top-k, angle, BRIEF)": lambda: ext(img_dev.float()),
        "one pose LM (4 x 10 steps, 1000 observations)": lambda: pose_opt.pose_optimize(
            last, state["last_match_pos"], state["last_uv"], f0["inv_sigma2"],
            state["last_match_pt"] >= 0, sc.fx, sc.fy, sc.cx, sc.cy),
        "local-map search (projection, K2 4096 x 1000, acceptance)": lambda: (
            frame_ops.project_and_match(
                *blk, last, sc.fx, sc.fy, sc.cx, sc.cy, lo, hi, f0_uv, f0["desc_bits"],
                f0["size"], f0["valid"], TRACK_PARAMS["local_radius"],
                TRACK_PARAMS["match_th"], TRACK_PARAMS["local_ratio"], f0_words)),
    }
    for name, fn in stages.items():
        log(f"[stages] {host_ms(fn):8.2f} ms  {name}")

    torch.cuda.synchronize()
    sync_sites = {}
    with sync_counter(torch, sync_sites):
        fast_track.fused_extract_track(
            img_dev, cam, ext, **state, pred_pose=pred, last_pose=last, use_motion=True,
            bounds_lo=lo, bounds_hi=hi, fx=sc.fx, fy=sc.fy, cx=sc.cx, cy=sc.cy, **TRACK_PARAMS)
    log(f"[syncs] host syncs inside one fused_extract_track: {sum(sync_sites.values())}")
    for site, n in sorted(sync_sites.items(), key=lambda kv: -kv[1]):
        log(f"[syncs]   {n:4d}x  {site}")

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        track_frames(torch, sc, cam, ext, state, frames[:n_prof], device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    log(f"[profile] {n_prof} frames: wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.2f}%), "
        f"{len(kernels) / n_prof:.0f} device kernels per frame")
    by_kernel = {}
    for e in kernels:
        n, t = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, t + e.device_time)
    for name, (n, t) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"[profile]   device {t / 1e3 / n_prof:8.3f} ms/frame  {n // n_prof:5d}x  {name[:90]}")
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in ops[:12]:
        log(f"[profile]   host {a.self_cpu_time_total / 1e3 / n_prof:8.3f} ms/frame  "
            f"{a.count // n_prof:5d}x  {a.key[:60]}")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 7 begins")
    # ---- 7. flagship step
    fn, ex_args = flagship.entry(device)
    pose, n_in, feats = fn(*ex_args)
    torch.cuda.synchronize()
    if pose.shape != (4, 4) or not bool(torch.isfinite(pose).all()) or feats["xy"].shape != (1000, 2):
        raise AssertionError("flagship.tracking_step output malformed")
    log(f"[flagship] tracking_step on make_example(480, 640): n_inliers {int(n_in)}, "
        f"valid kps {int(feats['valid'].sum())}")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 8 begins")
    # ---- 8. the System: two-view init, tracked frames, keyframe events
    t_phase = time.perf_counter()
    (sys_k1, sys_k2, sys_pack), k2_by, k2_sys, (system, ssc, align) = system_phase(torch, device)
    k2_err = max([k2_err] + [r["max_abs_err"] for r in k2_sys.values()])
    assert_no_jax()  # the System's modules are imported by now
    log(f"[phase 8] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 9 begins")
    # ---- 9. relocalization of phase 8's System
    t_phase = time.perf_counter()
    reloc_launches, reloc_by, reloc_rec = reloc_phase(torch, device, system, ssc, align)
    del system
    log(f"[phase 9] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 10 begins")
    # ---- 10. the live loop closure: two sessions merged by a Sim3 closure
    t_phase = time.perf_counter()
    loop_launches, loop_by, loop_rec = loop_phase(torch, device)
    log(f"[phase 10] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 10b begins")
    # ---- 10b. the constructed loop map: the card against the CPU port
    t_phase = time.perf_counter()
    constructed_loop_phase(torch, device)
    log(f"[phase 10b] {time.perf_counter() - t_phase:.1f} s")

    # K2 at the recorded inputs of the relocalization and loop searches:
    # each label's call with the most active queries
    t_phase = time.perf_counter()
    k2_new = {}
    for label, rec in (("reloc", reloc_rec), ("reloc_projection", reloc_rec),
                       ("loop_global", loop_rec), ("loop_projection", loop_rec),
                       ("loop_fuse", loop_rec)):
        if label not in rec:
            raise AssertionError(f"no {label} search was recorded")
        a, kw = max(rec[label], key=lambda c: int((c[0][4] >= 0).sum()))
        k2_new[label] = measure_k2(
            torch, a, kw, f"{label} search ({int((a[4] >= 0).sum())} active queries)")
    k2_err = max([k2_err] + [r["max_abs_err"] for r in k2_new.values()])
    log(f"[K2 real] relocalization and loop searches measured in "
        f"{time.perf_counter() - t_phase:.1f} s")
    by_search = {k: k2_by.get(k, 0) + reloc_by.get(k, 0) + loop_by.get(k, 0) for k in SEARCHES}

    # per tracked frame: K1 over the 8 levels; pack_bits at frame 13's
    # keypoints; K2 once per search: the tracked frame's searches (frame
    # 13's, summed: events and bounds; phase 5b's frames: device time), the
    # System's init and fusion searches (phase 8) and the relocalization
    # (phase 9) and loop (phase 10) searches, each at one recorded input
    n_frames = len(rows)
    frame_k2 = {key: sum(r[key] for r in k2_real[:frame_searches])
                for key in ("eager_ms", "graph_ms", "plain_ms", "bound_ms", "max_abs_err")}
    k2_bound_by = max(k2_real[:frame_searches], key=lambda r: r["bound_ms"])["bound_by"]
    k2_src = dict(route="cuda", source="anyfeature_vslam_tpu_torch/csrc/best_two.cu",
                  replaces="anyfeature_vslam_tpu/ops/pallas_match.py:179", library_ms=None)
    phases = ("system", "reloc", "loop")
    k2_entries = [dict(
        name="best_two[tracking]", search="tracking", **k2_src, launches=by_search["tracking"],
        launches_by_phase=dict(zip(phases, (k2_by.get("tracking", 0),
                                            reloc_by.get("tracking", 0),
                                            loop_by.get("tracking", 0)))),
        launches_tracked_frame=k2_launches, launches_per_frame=k2_launches / n_frames,
        max_abs_err=frame_k2["max_abs_err"], ms=frame_k2["eager_ms"],
        eager_ms=frame_k2["eager_ms"], graph_ms=frame_k2["graph_ms"],
        device_ms=dev_frames["best_two_bits_kernel"][1] / N_PROFILED,
        plain_ms=frame_k2["plain_ms"], bound_ms=frame_k2["bound_ms"], bound_by=k2_bound_by,
        at=f"frame {FIRST_TRACKED}'s {frame_searches} searches, summed")]
    for label, r in list(k2_sys.items()) + list(k2_new.items()):
        k2_entries.append(dict(
            name=f"best_two[{label}]", search=label, **k2_src, launches=by_search[label],
            launches_by_phase=dict(zip(phases, (k2_by.get(label, 0), reloc_by.get(label, 0),
                                                loop_by.get(label, 0)))),
            max_abs_err=r["max_abs_err"], ms=r["eager_ms"], eager_ms=r["eager_ms"],
            graph_ms=r["graph_ms"], device_ms=r["device_ms"], pack_device_ms=r["pack_device_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            at=r["label"], nq=r["nq"], nc=r["nc"], passes=r["passes"]))
    launches_by_phase = dict(zip(phases, ((sys_k1, sys_k2, sys_pack), reloc_launches,
                                          loop_launches)))
    log(json.dumps({"kernels": [
        {"name": "fast_nms", "route": "cuda",
         "source": "anyfeature_vslam_tpu_torch/csrc/fast_nms.cu",
         "replaces": "anyfeature_vslam_tpu/frontend/pallas_fast.py:105",
         "launches": sys_k1, "launches_per_frame_system": sys_k1 / N_SYSTEM_FRAMES,
         "launches_by_phase": {k: v[0] for k, v in launches_by_phase.items()},
         "launches_tracked_frame": k1_launches, "launches_per_frame": k1_launches / n_frames,
         "max_abs_err": k1_err, "ms": k1_ms, "eager_ms": k1_ms, "graph_ms": k1_graph_ms,
         "device_ms": dev_frames["fast_nms_kernel"][1] / N_PROFILED, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None},
        {"name": "pack_bits", "route": "cuda",
         "source": "anyfeature_vslam_tpu_torch/csrc/best_two.cu",
         "replaces": "anyfeature_vslam_tpu/ops/pallas_match.py:179",
         "launches": sys_pack, "launches_by_phase": {k: v[2] for k, v in launches_by_phase.items()},
         "launches_tracked_frame": pack_launches,
         "launches_per_frame": pack_launches / n_frames,
         "max_abs_err": 0.0, "ms": pack_ms, "eager_ms": pack_ms, "graph_ms": pack_graph_ms,
         "device_ms": dev_frames["pack_bits_kernel"][1] / N_PROFILED, "plain_ms": pack_plain_ms,
         "bound_ms": pack_bound_ms, "bound_by": pack_bound_by, "library_ms": None},
    ] + k2_entries}))
    log(f"[total] {time.perf_counter() - T_START:.1f} s")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

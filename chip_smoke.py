#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Drives the port (anyfeature_vslam_tpu_torch, never the JAX package) through
its main path, the orb32 tracked frame at 640x480 with 1000 features and a
4096-row local-map block:

  1. builds the hand-written CUDA kernels from csrc/ with nvcc;
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
     5b. the kernels' device time (torch.profiler) over the same frames,
         every launch the wrappers counted found among the profiler's
         kernel events (else profiled again, and failing after 5);
     5c. K2 and pack_bits at the recorded inputs of one frame's searches:
         exact, with device, eager (events around calls, host issue
         included) and CUDA-graph replay times beside the plain twin and
         the bound;
  6. where a frame's time goes: the frame and its stages run alone, host
     syncs attributed to source lines, a torch.profiler summary;
  7. flagship.tracking_step once on make_example(480, 640);
  8. the System (system.py, synchronous, 640x480, orb32, 1000 features)
     over the first 48 frames of the benchmark sequence: two-view
     initialization, tracked frames, keyframe events (triangulation,
     fusion, local BA, culling). It must not reset, track >= 45 frames,
     reach a Sim3-aligned keyframe and frame ATE < 5 cm, launch K1 on every
     frame and K2 from the init, tracking and fusion searches; K2 is held
     exact against its twin at the recorded inputs of the init search and
     of one fusion search; host syncs are counted over a fresh System's
     first 16 frames.

The launch counters are set to 0 before phases 5 and 8 and read after
each. Prints the card (nvidia-smi name, power limit) first, then
per-phase lines, one JSON line of kernel results ("launches": phase 8;
per tracked frame of phase 5: launches, device time, eager and graph
times, plain twin, bound; K2 at phase 8's init and fusion inputs), and as
the last line
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
        n0 = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            fn()
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


def system_run(torch, width, height, n_frames, device, record=None, sync_sites=None):
    """The port's System over the first n_frames of the bench sequence
    (rendered in memory), orb32, 1000 features, synchronous. Returns
    (system, per-frame rows, per-event rows, scene, K2 launches by search):
    per frame ms, K1 / K2 / pack launches and keyframe events; per event
    ms, K2 / pack launches; the K2 launches of the "init", "tracking" and
    "fusion" searches. With `record` (a dict), the inputs of every init
    search and of the fusion searches of event RECORDED_EVENT are kept
    there by label. With `sync_sites`, the host syncs
    counted into it are attributed to frames and events."""
    from anyfeature_vslam_tpu_torch.frontend import cuda_fast
    from anyfeature_vslam_tpu_torch.ops import cuda_match, matching
    from anyfeature_vslam_tpu_torch.slam import frame_ops
    from anyfeature_vslam_tpu_torch.system import System
    from torch_slice_scene import SliceScene

    sc = SliceScene(width, height)
    frames = [sc.render(i)[0] for i in range(n_frames)]
    system = System(SimpleNamespace(**sc.camera), feature="orb32", n_features=N_FEATURES,
                    device=device)
    counters = (cuda_fast.fast_nms, cuda_match.best_two, cuda_match.pack_bits)
    label = ["tracking"]
    events = []
    patched = []

    def patch(mod, name, wrapper):
        patched.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrapper(getattr(mod, name)))

    def labelled(tag):
        def wrap(fn):
            def inner(*a, **kw):
                prev, label[0] = label[0], tag
                try:
                    return fn(*a, **kw)
                finally:
                    label[0] = prev
            return inner
        return wrap

    k2_by_label = {}

    def recorder(fn):
        def inner(*a, **kw):
            # every init search, and the fusion searches of one event
            if record is not None and (label[0] == "init" or (
                    label[0] == "fusion" and len(events) == RECORDED_EVENT)):
                record.setdefault(label[0], []).append((a, kw))
            n0 = counters[1].launches
            out = fn(*a, **kw)
            k2_by_label[label[0]] = k2_by_label.get(label[0], 0) + counters[1].launches - n0
            return out
        return inner

    def event_wrap(fn):
        def inner(kf):
            n0 = [c.launches for c in counters]
            sites0 = sum(sync_sites.values()) if sync_sites is not None else 0
            t0 = time.perf_counter()
            fn(kf)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            events.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                               k2=counters[1].launches - n0[1], pack=counters[2].launches - n0[2],
                               syncs=(sum(sync_sites.values()) - sites0)
                               if sync_sites is not None else None))
        return inner

    patch(frame_ops, "match_for_initialization", labelled("init"))
    patch(frame_ops, "fuse_points_into_targets", labelled("fusion"))
    patch(frame_ops, "fuse_target_points_into_kf", labelled("fusion"))
    patch(matching, "guided_best_two", recorder)
    system.tracker.on_new_keyframe = event_wrap(system.tracker.on_new_keyframe)
    rows = []
    try:
        for i, img8 in enumerate(frames):
            n0 = [c.launches for c in counters]
            ev0 = len(events)
            sites0 = sum(sync_sites.values()) if sync_sites is not None else 0
            t0 = time.perf_counter()
            state = system.track_monocular(img8, i / 30.0)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            rows.append(dict(
                ms=(time.perf_counter() - t0) * 1e3, state=state.name,
                k1=counters[0].launches - n0[0], k2=counters[1].launches - n0[1],
                pack=counters[2].launches - n0[2], events=len(events) - ev0,
                kfs=system.map.n_keyframes(), pts=system.map.n_points(),
                inliers=system.tracker.n_inliers,
                syncs=(sum(sync_sites.values()) - sites0) if sync_sites is not None else None))
    finally:
        for mod, name, fn in reversed(patched):
            setattr(mod, name, fn)
    return system, rows, events, sc, k2_by_label


def ate(system, sc):
    """(keyframe ATE, frame ATE, n keyframes, n frames): Sim3-aligned RMSE of
    the camera centres against the rendered ground truth (the port's
    io/evaluation copy of the JAX package's scorer)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch.io import evaluation

    def centre(t):
        return -t[:3, :3].T @ t[:3, 3]

    m = system.map
    kfs = m.keyframe_ids()
    est = [centre(m.kf_pose[k].astype(np.float64)) for k in kfs]
    gt = [centre(sc.poses[int(m.kf_frame_id[k])]) for k in kfs]
    kf_ate = evaluation.ate_rmse(np.asarray(est), np.asarray(gt))[0]
    est, gt = [], []
    for ts, t_cr, uid, lost in system.tracker.trajectory:
        t_cw = m.resolve_anchor(t_cr, uid)
        if lost or t_cw is None:
            continue
        est.append(centre(t_cw.astype(np.float64)))
        gt.append(centre(sc.poses[int(round(ts * 30.0))]))
    fr_ate = evaluation.ate_rmse(np.asarray(est), np.asarray(gt))[0]
    return kf_ate, fr_ate, len(kfs), len(est)


def system_phase(torch, device):
    """Phase 8: the System over the first N_SYSTEM_FRAMES frames at
    640x480, with its checks. Returns (launches K1, K2, pack; K2 launches
    by search; K2 measured at the init and fusion inputs)."""
    from anyfeature_vslam_tpu_torch import perfcount
    from anyfeature_vslam_tpu_torch.frontend import cuda_fast
    from anyfeature_vslam_tpu_torch.ops import cuda_match

    counters = (cuda_fast.fast_nms, cuda_match.best_two, cuda_match.pack_bits)
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
    kf_ate, fr_ate, n_kf_ate, n_fr_ate = ate(system, ssc)
    steady = srows[init_frame + 2:] if init_frame >= 0 else []
    kf_frames = [r["ms"] for r in steady if r["events"]]
    plain_frames = [r["ms"] for r in steady if not r["events"]]
    ev_k2 = sum(e["k2"] for e in sevents)
    n_init_k2, n_fuse_k2, n_track_k2 = (k2_by.get(k, 0) for k in ("init", "fusion", "tracking"))
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
    by_caps = {}
    for b in system.local_mapper.ba_log:
        key = (b["k_cap"], b["p_cap"], b["o_cap"], "dense" if b["dense"] else "CG")
        by_caps.setdefault(key, []).append(b["ms"])
    for (k, p, o, path), ms in sorted(by_caps.items()):
        log(f"[system] local BA caps k {k} p {p} o {o} ({path}): {len(ms)} solves, median "
            f"{statistics.median(ms):.1f} ms, max {max(ms):.1f} ms")
    log(f"[system] map counters: {json.dumps(perfcount.snapshot())}")
    log(f"[system] launches: K1 {sys_k1} ({sys_k1 / len(srows):.2f} per frame, min "
        f"{min(r['k1'] for r in srows)}), K2 {sys_k2} (init search {n_init_k2}, tracking "
        f"{n_track_k2}, {n_track_k2 / max(len(ok_frames) - 1, 1):.2f} per tracked frame; "
        f"fusion {n_fuse_k2}, {n_fuse_k2 / max(len(sevents), 1):.1f} per event), pack "
        f"{sys_pack} ({sum(e['pack'] for e in sevents)} in events)")
    sys_fail = []
    if stats["resets"] != 0:
        sys_fail.append(f"{stats['resets']} resets")
    if stats["tracked_frames"] < MIN_SYSTEM_TRACKED:
        sys_fail.append(f"{stats['tracked_frames']} tracked frames")
    if not (kf_ate < MAX_ATE_M and fr_ate < MAX_ATE_M):
        sys_fail.append(f"ATE {kf_ate:.4f} / {fr_ate:.4f} m")
    if min(r["k1"] for r in srows) < 1:
        sys_fail.append("a frame without a K1 launch")
    if sys_pack < 1:
        sys_fail.append("no pack_bits launch")
    if not (n_init_k2 > 0 and n_fuse_k2 > 0 and n_track_k2 > 0
            and n_init_k2 + n_fuse_k2 + n_track_k2 == sys_k2 and ev_k2 == n_fuse_k2):
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
    return ((sys_k1, sys_k2, sys_pack),
            dict(init=n_init_k2, tracking=n_track_k2, fusion=n_fuse_k2), k2_sys)


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

    # ---- 1. build
    for name in ("fast_nms", "best_two"):
        t0 = time.perf_counter()
        cuda_build.load(name)
        log(f"[build] {name}: {time.perf_counter() - t0:.1f} s -> {cuda_build.library_path(name).name}")
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

    # ---- 5b. the kernels' device time over the same frames, profiled
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    dev_frames = profile_kernels(
        torch, lambda: track_frames(torch, sc, cam, ext, state, frames, device))
    log(f"[device] torch.profiler kernel events over the {len(frames)} frames of phase 5 "
        f"({time.perf_counter() - t0:.1f} s, parsing included):")
    for k, (n, t) in dev_frames.items():
        log(f"[device]   {k}: {n} launches ({n / len(frames):.2f} per frame), device "
            f"{t / len(frames):.5f} ms per frame, {t / max(n, 1):.5f} ms per launch")

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

    # ---- 7. flagship step
    fn, ex_args = flagship.entry(device)
    pose, n_in, feats = fn(*ex_args)
    torch.cuda.synchronize()
    if pose.shape != (4, 4) or not bool(torch.isfinite(pose).all()) or feats["xy"].shape != (1000, 2):
        raise AssertionError("flagship.tracking_step output malformed")
    log(f"[flagship] tracking_step on make_example(480, 640): n_inliers {int(n_in)}, "
        f"valid kps {int(feats['valid'].sum())}")

    # ---- 8. the System: two-view init, tracked frames, keyframe events
    (sys_k1, sys_k2, sys_pack), k2_by, k2_sys = system_phase(torch, device)
    k2_err = max([k2_err] + [r["max_abs_err"] for r in k2_sys.values()])
    assert_no_jax()  # the System's modules are imported by now

    # per tracked frame: K1 over the 8 levels; K2 over the searches frame
    # 13 ran (events and bounds) and over phase 5's frames (device time);
    # pack_bits at frame 13's keypoints and over phase 5's frames
    n_frames = len(rows)
    frame_k2 = {key: sum(r[key] for r in k2_real[:frame_searches])
                for key in ("eager_ms", "graph_ms", "plain_ms", "bound_ms")}
    k2_bound_by = max(k2_real[:frame_searches], key=lambda r: r["bound_ms"])["bound_by"]
    log(json.dumps({"kernels": [
        {"name": "fast_nms", "route": "cuda",
         "source": "anyfeature_vslam_tpu_torch/csrc/fast_nms.cu",
         "replaces": "anyfeature_vslam_tpu/frontend/pallas_fast.py:105",
         "launches": sys_k1, "launches_per_frame_system": sys_k1 / N_SYSTEM_FRAMES,
         "launches_tracked_frame": k1_launches, "launches_per_frame": k1_launches / n_frames,
         "max_abs_err": k1_err, "ms": k1_ms, "eager_ms": k1_ms, "graph_ms": k1_graph_ms,
         "device_ms": dev_frames["fast_nms_kernel"][1] / n_frames, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None},
        {"name": "best_two", "route": "cuda",
         "source": "anyfeature_vslam_tpu_torch/csrc/best_two.cu",
         "replaces": "anyfeature_vslam_tpu/ops/pallas_match.py:179",
         "launches": sys_k2, "launches_system_by_search": k2_by,
         "launches_tracked_frame": k2_launches, "launches_per_frame": k2_launches / n_frames,
         "max_abs_err": k2_err, "ms": frame_k2["eager_ms"], "eager_ms": frame_k2["eager_ms"],
         "graph_ms": frame_k2["graph_ms"],
         "device_ms": dev_frames["best_two_bits_kernel"][1] / n_frames,
         "plain_ms": frame_k2["plain_ms"], "bound_ms": frame_k2["bound_ms"],
         "bound_by": k2_bound_by, "library_ms": None,
         "init_search": k2_sys["init"], "fusion_search": k2_sys["fusion"]},
        {"name": "pack_bits", "route": "cuda",
         "source": "anyfeature_vslam_tpu_torch/csrc/best_two.cu",
         "replaces": "anyfeature_vslam_tpu/ops/pallas_match.py:179",
         "launches": sys_pack, "launches_tracked_frame": pack_launches,
         "launches_per_frame": pack_launches / n_frames,
         "max_abs_err": 0.0, "ms": pack_ms, "eager_ms": pack_ms, "graph_ms": pack_graph_ms,
         "device_ms": dev_frames["pack_bits_kernel"][1] / n_frames, "plain_ms": pack_plain_ms,
         "bound_ms": pack_bound_ms, "bound_by": pack_bound_by, "library_ms": None},
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

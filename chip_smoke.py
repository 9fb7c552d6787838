#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Drives the port (anyfeature_vslam_tpu_torch, never the JAX package) through
its main path, the orb32 tracked frame at 640x480 with 1000 features and a
4096-row local-map block:

  1. builds the hand-written CUDA kernels from csrc/ with nvcc, one nvcc
     per source, and the host library (csrc/slam_native.cpp, the host C++
     compiler), all started together;
  2. K1 (FAST + NMS) on all 8 pyramid levels of a rendered frame, in one
     launch, against its plain PyTorch twin: bit-exact;
  3. pack_bits at every binary width and K2 (masked best/second) on random
     binary 4096x1000 and 1000x1000 searches against their twins: exact;
     the float search on unit rows (D = 48, 64, 128; 1000x1000,
     2000x2000, 4096x1000, 700x5000), with random windows and with none,
     on a prepared candidate set: within atol 1e-5 of the twin, the index
     equal wherever best and second lie further apart, one launch each;
     device (profiled), eager, graph, twin and bound times and the pass
     share;
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
  8. the System (system.py, async_mapping=False, 640x480, orb32, 1000 features)
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
 9b. localization mode on that System: the views of the relocalized frame
     and the 7 before it, retraced backwards (the staged tracker, no
     mapping): every frame OK, the keyframe and point counts unchanged, K1
     once per frame; only_tracking cleared at the frame after
     deactivation;
 10. the live loop closure of tests/test_loop_live.py at 640x480 with 1000
     features: session A maps circle A and saves a checkpoint, session B
     loads it, boots a fresh component and re-enters A; the test's gates:
     0 resets, <= 5 lost frames, >= 1 closure and loop edge, keyframe ATE
     < 8 cm, over both sessions' keyframes and over session A's (as the
     test scores it); the closure's stages, the global BA's caps and path;
 10b. the constructed loop map of tests/test_loop_closing_unit.py through
     the LoopCloser on the card and on the CPU: the same closure, keyframe
     poses within 2e-3 where the global BA starts.
 11. the System with the JAX System's defaults (asynchronous mapping: each
     local BA issued on the mapping stream, folded at the next event) over
     phase 8's 48 frames, run through the CLI from phase 20's PNG files
     (one run serves both phases): phase 8's gates (0 resets, >= 45
     tracked, keyframe ATE < 5 cm), every local BA deferred; frames timed
     without a device sync; where each fold landed, the events' waits on a
     solve, host syncs per frame over its first 16 frames (left out of the
     times);
 12. threaded_mapping=True (the mapping worker thread, the tracker
     pipelined two frames deep: the bench's schedule) over the bench's 150
     frames (rendered on 8 host processes while the kernels build): 0
     resets, <= 5 lost frames,
     keyframe ATE < 5 cm, shutdown() drains and stops the worker in time;
     host syncs per pipelined dispatch over frames 0-11, the device busy
     share over frames 12-15 (profiled), then frames/s, median and p90
     frame ms, the timed events' stages, replayed fast-path failures and
     the worker's largest queue over frames 16-149.
K2 is then held exact against its twin at the recorded inputs of the
relocalization and loop searches.
 13. the other families, each at 640x480 with 1000 features: the FAST
     families brisk48 (BRISK, 384 bits, scale 1.5), anyfeat_bin (FREAK,
     512 bits) and anyfeat_nonbin (learned 48-d float), the nonlinear
     families akaze61 (M-LDB, 488 bits) and kaze64 (M-SURF, 64-d float),
     which detect on the FED scale space, surf64 (det(H) per pyramid
     level, 64-d SURF sums) and sift128 (3D DoG extrema over Gaussian
     octaves, 128-d SIFT histograms); only the FAST families launch K1:
     K1 bit-exact on a FAST family's 8 levels of one frame; one
     extraction on the card against the CPU (>= 99% of keypoints equal,
     sift128's within 0.01 px; binary rows >= 99% equal, float rows
     >= 99% within 1e-4; median angle error < 1e-4 rad) and, to hold
     detection and description alone, against the CPU at the card's
     pyramid or scale space (the same; anyfeat_nonbin's and surf64's
     float rows all within 1e-4), and its time (for the families without
     K1 also the scale space's or pyramid's difference and a profile of
     its device events; for akaze61 / kaze64 the contrast factor on both
     devices); every family runs, and a failure of any fails the phase;
     the System with the JAX defaults (asynchronous mapping, the
     family's shipped vocabulary, loop detection at every event) over
     phase 8's 48 frames: 0 resets, >= 45 tracked, keyframe ATE < 2 cm,
     K1 once per frame (once more for a rebuilt initialization) for a
     FAST family and never for the others, K2 from the init,
     tracking and fusion searches (pack_bits for the binary families
     only), ms per frame with and without an event; K2 against
     its twin at the recorded init search, the tracked frame's
     reference-keyframe search (no window) and one of its windowed
     (motion-model or local-map) searches, and a fusion search, each
     with its launches (binary: exact; float: within 1e-5, equal indices
     where best and second lie further apart).
 14. r2d2_128 (precomputed 128-d float features) at 640x480 with 1000
     features: tests/r2d2_scene.py's landmark scene, its r2d2 .bin files
     written to a temporary folder and a flat gray uint8 array passed
     with each image path; phase 13's System run, gates and K2 rows at
     D = 128 (0 K1 and 0 pack_bits launches; the vocabulary is trained
     online, so only the events after it run the loop stage).
 15. RGB-D at 640x480 with 1000 orb32 features on tests/test_rgbd_stereo.py's
     scene and poses (fx 520, a 0.1 m baseline; rendered with exact depth
     on 8 host processes), the System with the JAX defaults and
     sensor="rgbd" over 40 frames: the instant map at frame 0 (its median
     point depth within 0.1 m of the rendered median), 0 resets, 0 lost,
     >= 39 tracked, the keyframes' metric displacement within 12% of the
     truth, every keyframe with > 100 matches, K1 once per frame, K2 by
     search (the staged tracker's motion-model, reference-keyframe and
     local-map searches labelled apart); ms per frame with and without an
     event, host syncs per frame over frames 1-8; then localization mode:
     its last 8 frames retraced backwards, then 50 frames out beyond the
     map and back (every frame OK, counts unchanged, mb_vo set out of the
     map's view and cleared on the way back, K1 once per frame, K2 by
     search, relocalization included) and deactivation; K2 exact against its twin at the
     recorded inputs of one motion-model and one local-map search;
 16. stereo on the same scene: the row matcher with its sub-pixel SAD
     refinement at one pair (>= 150 matches, median depth error < 8%, the
     same matches as on the CPU from the same features, disparities within
     1e-3 px), then the stereo System with the JAX defaults over 12 pairs:
     >= 1 keyframe, >= 70% tracked, 0 lost, K1 twice per frame (left and
     right).
 17. DBoW2 text vocabularies: the shipped orb32 tree (k 14, L 4, 38,416
     words) written as DBoW2 text into a temporary folder and loaded; the
     words of frame 13's descriptors on the card equal the CPU's and the
     native tree's; a tree of ORBvoc.txt's shape (k 10, L 6, 1,111,111
     nodes, 32-byte rows) built in memory from a seed, its words for 1000
     descriptors on the card equal the CPU's (descent ms, device memory
     held); phase 8's System (synchronous, 48 frames) on the .txt
     vocabulary under phase 8's gates (0 resets, >= 45 tracked, keyframe
     ATE < 5 cm), BoW ms per event, K1 / K2 launches;
 18. the viewer on that System: save_outputs writes a map SVG that parses
     with one circle per valid point and one square per keyframe;
     render_frame writes a PNG, decoded here with zlib: its pixels equal
     the returned array, its slam_state the tracker's state, and >= 99%
     of the tracked / untracked keypoint positions show a green / blue box;
 19. BA layouts on the last local BA of phase 17's map at its real caps:
     sharded_bundle_adjust_two_stage over a one-rank NCCL group against
     the unsharded CG two-stage solve; two gloo ranks in two processes on
     the card against each other and the one-rank solve;
     global_ba_point_sharded at one rank against the unsharded CG solve,
     at two ranks against one; compensated against plain on the card, and
     card against CPU (poses within 5e-4, >= 99% of the points within
     5e-3, final costs within 1e-3 relative; compensated card vs CPU 1e-4
     / 1e-3); the sharded solves against bundle_adjust_two_stage /
     bundle_adjust (dense) by their final cost; each with its ms; then a System with use_mesh=True over phase 8's first 24 frames:
     0 resets, >= 22 tracked, keyframe ATE < 5 cm, every local BA sharded,
     ms per event. The NCCL group is destroyed at the end;
 20. the CLI from files, run in phase 11's place: the bench sequence's
     first 48 frames (640x480) as the port's tools/make_synth_sequence
     lays them out, the rendered frames written as PNGs whose rows take
     libpng's adaptive filter choice (filtered_png), with the tool's text
     files; the tool itself renders the first 4, which must equal, byte for
     byte, io/png.write_png's files of those frames; load_gray of frame 13
     equals the rendered frame; run_mono (orb32, the JAX System's
     defaults) on the card over the folder, its frames read ahead by
     native.FrameLoader, scored by tools/evaluate_ate: 0 resets, >= 45
     tracked, keyframe ATE < 5 cm, PIL never imported; ms per frame, the
     reader thread's decode ms per frame and the tracking thread's wait in
     get(i) (median, p90, max), the plain unfilter's decode of every 6th
     file (equal), an all-Paeth copy of frame 13, K1 / K2 / pack launches
     (phase 11's); then the host library: 8 RGB 640x480 frames with
     adaptive filters read by the FrameLoader equal the plain unfilter's
     decode byte for byte (ms per frame, compiled and plain unfilter); on
     the run's final map the library's observation counts, covisibility
     weights and matrix and point statistics equal their numpy twins
     (floats bit for bit), ms per call each;
 21. tools/create_vocabulary (orb32, every 6th of those frames, 8 frames,
     branching 32, depth 2) on the card and on the CPU: at least 99.9% of
     the descriptor rows equal; equal rows must give equal trees; frame
     13's words under the card's tree equal on the card and the CPU; K1
     launches;
 22. tools/train_patch_descriptor (synthetic corpus of 16 images, seed 0,
     batch 512, 200 steps) on the card and its first 3 steps on the CPU:
     the step-0 losses within 1e-5 relative, the loss at step 199 below
     step 0's, the saved weights in an anyfeat_nonbin extractor give unit
     descriptors (1e-5); ms per step, the suggested matchingTh;
 23. tools/bench_ba (--mesh 2, the problems cut 16-fold: one rank on one
     card), tools/profile_detect and tools/profile_tracking over 8 frames,
     each once, printing their lines.

The launch counters are set to 0 before phases 5, 8, 9, 9b, 10, 11, 12,
each family's System run in 13, phase 14's, phase 15's run and its
retrace, phase 16's System run, phase 17's System run, phase 19's
mesh System and each device's run in 21, and read
after each. Every phase logs
its wall time. Prints the card (nvidia-smi
name, power limit) first, then per-phase lines, one JSON line of kernel
results (K1 and pack_bits: launches in phase 8, by phase and by family,
per tracked frame of phase 5: device time, eager and graph times, plain
twin, bound; K2 once per search, by the search's label: launches over
phases 8-12 and its times at one recorded input, and once per family's
init, tracking (reference-keyframe and windowed) and fusion search,
phases 13 and 14), and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, with no result line, when any phase fails or no CUDA device
is present.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, N_FEATURES = 640, 480, 1000
N_TRACKED = 25
N_PROFILED = 4  # phase 5b profiles the first frames of phase 5 (its profile is slow to parse)
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
CARD = ["card not read"]  # nvidia-smi's name and power limit, set by main()


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
PROFILED_KERNELS = ("fast_nms_kernel", "pack_bits_kernel", "best_two_bits_kernel",
                    "best_two_f32_kernel")
K2_KERNELS = ("best_two_bits_kernel", "best_two_f32_kernel")
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_events(torch, prof):
    """A profile's device events (kernels, copies): its CUDA events less the
    device-side annotations that the ranges of the port's span recorder
    (perfcount.span, on from phase 8) leave in the card's trace."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def device_ms_by_kernel(torch, prof):
    """{kernel substring: (launches, total device ms)} from a profile."""
    out = {k: (0, 0.0) for k in PROFILED_KERNELS}
    for e in device_events(torch, prof):
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

    # each wrapper's launches against its kernels' events (K2: binary and float)
    wrappers = {("fast_nms_kernel",): cuda_fast.fast_nms,
                ("pack_bits_kernel",): cuda_match.pack_bits,
                K2_KERNELS: cuda_match.best_two}
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
        events = {k: sum(dk[name][0] for name in k) for k in wrappers}
        missed = {k: (events[k], w.launches - n0[k]) for k, w in wrappers.items()
                  if events[k] != w.launches - n0[k]}
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
    """Bytes and operations of one K2 search: inputs read once (binary:
    query bit planes, candidate bit planes or packed words; float: 4 B
    per element of both, and 4 B per candidate norm where the set comes
    prepared; 20 B of gate data per query and 13 per candidate), 12 B
    written per query; 8 gate operations per pair, and per pair that
    passes an xor and a popcount per word (binary) or a multiply and an
    add per element and 4 more for the distance (float), plus 2 D for each
    float query's norm and each raw candidate row's."""
    from anyfeature_vslam_tpu_torch.ops.cuda_match import gate_mask

    q, c, *side = args
    nq, d = q.shape
    nc = c.shape[0]
    passes = int(gate_mask(*side).sum())
    if q.dtype.is_floating_point:
        nbytes = 4 * d * (nq + nc) + 32 * nq + 13 * nc + (4 * nc if packed_candidates else 0)
        norms = 2 * d * (nq + (0 if packed_candidates else nc))
        return nbytes, 8 * nq * nc + (2 * d + 4) * passes + norms, passes
    nwords = (d + 31) // 32
    c_bytes = nc * nwords * 4 if packed_candidates else nc * d
    nbytes = nq * d + 32 * nq + c_bytes + 13 * nc
    return nbytes, 8 * nq * nc + 2 * nwords * passes, passes


# the float search against its twin: squared L2 of unit vectors summed in
# another order, so best and second within FLOAT_ATOL and the index equal
# wherever best and second lie further apart than that
FLOAT_ATOL = 1e-5


def k2_agrees(torch, got, want, binary):
    """(agrees, max abs err) of a K2 result against its plain twin: binary
    exactly equal, float within FLOAT_ATOL as above."""
    (b, i, s), (rb, ri, rs) = got, want
    err = max(float((b - rb).abs().max()), float((s - rs).abs().max())) if b.numel() else 0.0
    if binary:
        return err == 0.0 and torch.equal(i.long(), ri), err
    clear = (rs - rb) > FLOAT_ATOL
    return err <= FLOAT_ATOL and torch.equal(i.long()[clear], ri[clear]), err


def measure_k2(torch, a, kw, label):
    """K2 at one search's recorded inputs (the arguments of
    matching.guided_best_two): exact against the plain version, then
    eager, CUDA-graph, plain, profiled device time and the bound."""
    from anyfeature_vslam_tpu_torch.ops import cuda_match, matching

    guided = matching.guided_best_two
    binary = a[0].dtype == torch.uint8
    b, i, s = guided(*a, **kw)
    rb, ri, rs = cuda_match.reference_best_two(*a)
    torch.cuda.synchronize()
    agrees, err = k2_agrees(torch, (b, i, s), (rb, ri, rs), binary)
    if not agrees:
        raise AssertionError(f"K2 at the {label} search: differs from the plain version "
                             f"(max abs err {err})")
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
    kernel = "best_two_bits_kernel" if binary else "best_two_f32_kernel"
    n_match = dk[kernel][0] / reps
    n_pack = dk["pack_bits_kernel"][0] / reps
    if n_match != 1:
        raise AssertionError(f"K2 at the {label} search: {n_match:g} launches of {kernel} "
                             "per search")
    d_ms = dk[kernel][1] / reps
    d_pack_ms = dk["pack_bits_kernel"][1] / reps
    nq, nc = a[0].shape[0], a[1].shape[0]
    agreement = "exact" if binary else f"max abs err {err:.3g} (atol {FLOAT_ATOL:g})"
    log(f"[K2 real] {label} {nq}x{nc} D={a[0].shape[1]} {a[0].dtype}: {agreement} "
        f"({int((i >= 0).sum())} matched, {passes} pairs "
        f"pass the gates, {100 * passes / (nq * nc):.3f}%); {n_match:g} search + {n_pack:g} "
        f"pack launches; device search {d_ms:.5f} ms ({kernel}) + pack {d_pack_ms:.5f} ms; "
        f"eager {e_ms:.4f} ms, graph {g_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by})")
    return dict(label=label, nq=nq, nc=nc, passes=passes, max_abs_err=err, eager_ms=e_ms,
                graph_ms=g_ms, plain_ms=p_ms, device_ms=d_ms, pack_device_ms=d_pack_ms,
                bound_ms=b_ms, bound_by=b_by)


class sync_counter:
    """Count host syncs by source line in the port's package while active
    (torch.cuda.set_sync_debug_mode("warn"), on every thread): sites[site]
    += 1; with within=(function name, dict), the syncs with that function
    on the stack are also counted in the dict. Explicit waits on events
    (streams.Ready) are not flagged by the debug mode; perfcount's
    "ready_waits" counts them."""

    def __init__(self, torch, sites, within=None):
        self.torch, self.sites, self.within = torch, sites, within
        self.pkg = os.path.join(ROOT, "anyfeature_vslam_tpu_torch")

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        import traceback

        if "synchronizing CUDA operation" not in str(message):
            return
        # the innermost caller in the port's package names the sync site
        site = "?"
        stack = traceback.extract_stack()[:-1]
        for fr in stack:
            if fr.filename.startswith(self.pkg):
                site = f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno} {fr.line}"
        self.sites[site] = self.sites.get(site, 0) + 1
        if self.within is not None and any(fr.name == self.within[0] for fr in stack):
            self.within[1][site] = self.within[1].get(site, 0) + 1

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
# phase 14's scene mints a keyframe every ~10 frames (5 events in 48 frames)
RECORDED_EVENT_R2D2 = 2
MIN_SYSTEM_TRACKED = 45
MAX_ATE_M = 0.05
# K2's searches in the System, by the innermost labelled caller: the init
# search, the tracked frame's searches, fusion, relocalization's candidate
# searches and its projection rounds (add-match and local map), and loop
# closing's global match, Sim3-guided projections and SearchAndFuse
SEARCHES = ("init", "tracking", "fusion", "reloc", "reloc_projection", "loop_global",
            "loop_projection", "loop_fuse")
# the staged tracker's searches, labelled apart in the phases that ask for
# them (RGB-D, stereo, localization mode: frames that leave the fused step);
# elsewhere they count as "tracking"
STAGED_SEARCHES = ("motion_model", "reference_kf", "local_map")
RECORD_FIRST = 4  # calls kept per tracking / relocalization / loop search label


class SystemProbe:
    """While active, on one System: K2 launches counted by search (the
    label of the innermost labelled caller on the launching thread,
    SEARCHES; the kernel's launches on that thread, one per guided search
    that has queries and candidates), the inputs of the init
    searches, of the fusion searches of keyframe event `record_event`
    (RECORDED_EVENT unless given) and
    of the first RECORD_FIRST tracking, relocalization and loop searches kept in
    `record` by label, the tracked frame's reference-keyframe searches (no
    window) counted apart in `k2_reference` (they are also "tracking"
    launches), keyframe events timed (ms, K2 and pack launches, host
    syncs when `sync_sites` is counting), and where each pending BA fold
    landed (`folds`: at the next event, at the tracker's interrupt, in the
    loop stage, on the watcher thread, at the final drain). With
    sync=False neither frames nor events wait for the device, so the
    deferred solves overlap what follows them. With staged=True the staged
    tracker's searches are labelled by stage (STAGED_SEARCHES; inside a
    relocalization they stay "reloc_projection")."""

    def __init__(self, torch, system, device, record=None, sync_sites=None, sync=True,
                 record_event=RECORDED_EVENT, staged=False):
        from anyfeature_vslam_tpu_torch.frontend import cuda_fast
        from anyfeature_vslam_tpu_torch.ops import cuda_match

        self.torch, self.system, self.device = torch, system, torch.device(device)
        self.record, self.sync_sites, self.sync = record, sync_sites, sync
        self.record_event = record_event
        self.staged = staged
        self.counters = (cuda_fast.fast_nms, cuda_match.best_two, cuda_match.pack_bits)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.k2_by_label = {}
        self.k2_reference = 0
        self.events = []
        self.folds = {}
        self._patched = []

    @property
    def label(self):
        return getattr(self._tls, "label", "tracking")

    @label.setter
    def label(self, value):
        self._tls.label = value

    def _sync(self):
        if self.sync and self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _syncs(self):
        return sum(self.sync_sites.values()) if self.sync_sites is not None else None

    def _patch(self, owner, name, wrap):
        # an object's own attribute is put back; one it takes from its
        # class is removed again
        own = isinstance(owner, type) or owner.__class__.__name__ == "module" \
            or name in vars(owner)
        self._patched.append((owner, name, getattr(owner, name) if own else None))
        setattr(owner, name, wrap(getattr(owner, name)))

    def _labelled(self, tag):
        def wrap(fn):
            def inner(*a, **kw):
                prev = self.label
                # SearchAndFuse's projections stay SearchAndFuse's, and a
                # relocalization's local-map search its own
                keep = (prev, tag) == ("loop_fuse", "loop_projection") or (
                    prev == "reloc_projection" and tag in STAGED_SEARCHES)
                self.label = prev if keep else tag
                try:
                    return fn(*a, **kw)
                finally:
                    self.label = prev
            return inner
        return wrap

    def _fold_site(self, site):
        def wrap(fn):
            def inner(*a, **kw):
                prev = getattr(self._tls, "site", None)
                self._tls.site = site
                try:
                    return fn(*a, **kw)
                finally:
                    self._tls.site = prev
            return inner
        return wrap

    def _fold_counter(self, fn):
        lm = self.system.local_mapper

        def inner():
            if lm._pending_fold is not None:
                site = getattr(self._tls, "site", None) or (
                    "watcher" if threading.current_thread().name == "ba-fold" else "drain")
                with self._lock:
                    self.folds[site] = self.folds.get(site, 0) + 1
            return fn()
        return inner

    def _recorder(self, fn):
        from anyfeature_vslam_tpu_torch.ops import cuda_match

        def inner(*a, **kw):
            rec, lab = self.record, self.label
            if rec is not None and (
                    lab == "init" or (lab == "fusion" and len(self.events) == self.record_event)
                    or (lab != "init" and lab != "fusion"
                        and len(rec.get(lab, ())) < RECORD_FIRST)):
                rec.setdefault(lab, []).append((a, kw))
            # the kernel's launches on this thread: a search with no query
            # or no candidate launches nothing
            n0 = cuda_match.thread_launches()
            out = fn(*a, **kw)
            with self._lock:
                self.k2_by_label[lab] = (self.k2_by_label.get(lab, 0)
                                         + cuda_match.thread_launches() - n0)
            return out
        return inner

    def _reference(self, fn):
        from anyfeature_vslam_tpu_torch.ops import cuda_match

        # match_descriptors_global under the "tracking" label is the tracked
        # frame's reference-keyframe search (relocalization and loop closing
        # call it under their own labels)
        def inner(*a, **kw):
            n0 = cuda_match.thread_launches()
            out = fn(*a, **kw)
            if self.label == "tracking":
                with self._lock:
                    self.k2_reference += cuda_match.thread_launches() - n0
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
        from anyfeature_vslam_tpu_torch.slam.local_mapping import LocalMapper
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
        if self.staged:
            for name, tag in zip(("_track_motion_model", "_track_reference_kf",
                                  "_track_local_map"), STAGED_SEARCHES):
                self._patch(Tracker, name, self._labelled(tag))
        self._patch(matching, "guided_best_two", self._recorder)
        self._patch(frame_ops, "match_descriptors_global", self._reference)
        self._patch(LocalMapper, "process_keyframe", self._fold_site("next event"))
        self._patch(LoopCloser, "process_keyframe", self._fold_site("loop stage"))
        sysm = self.system
        self._patch(sysm.local_mapper, "fold_pending", self._fold_counter)
        im = sysm.tracker.interrupt_mapping
        if getattr(im, "__func__", None) is type(sysm.local_mapper).fold_pending:
            # asynchronous mapping: the interrupt lands the fold
            self._patch(sysm.tracker, "interrupt_mapping", lambda fn: self._fold_site(
                "interrupt")(lambda: sysm.local_mapper.fold_pending()))
        if sysm._worker is not None:
            self._patch(sysm._worker, "_event", self._event_wrap)
        else:
            self._patch(sysm.tracker, "on_new_keyframe", self._event_wrap)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._patched):
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)
        self._patched = []
        return False

    def frame(self, img8, ts, image_path=None, depth=None, right=None):
        """Track one frame; its row: ms, state, launches, events, map size.
        image_path: where a precomputed family's features are found;
        depth: an RGB-D frame's depth map; right: a stereo frame's right
        image."""
        c = self.counters
        n0 = [x.launches for x in c]
        ev0 = len(self.events)
        s0 = self._syncs()
        t0 = time.perf_counter()
        if depth is not None:
            state = self.system.track_rgbd(img8, depth, ts)
        elif right is not None:
            state = self.system.track_stereo(img8, right, ts)
        else:
            state = self.system.track_monocular(img8, ts, image_path=image_path)
        self._sync()
        m = self.system.map
        return dict(ms=(time.perf_counter() - t0) * 1e3, state=state.name,
                    k1=c[0].launches - n0[0], k2=c[1].launches - n0[1],
                    pack=c[2].launches - n0[2], events=len(self.events) - ev0,
                    kfs=m.n_keyframes(), pts=m.n_points(), inliers=self.system.tracker.n_inliers,
                    syncs=None if s0 is None else self._syncs() - s0)


def system_run(torch, width, height, n_frames, device, record=None, sync_sites=None,
               frames=None, sync=True, sync_frames=None, feature="orb32", sc=None,
               image_paths=None, record_event=RECORDED_EVENT, **system_kw):
    """The port's System (shipped vocabulary, loop closing on, `system_kw`
    for the schedule) over the first n_frames of the bench sequence
    (rendered in memory unless `frames` are given; or of the scene `sc`,
    whose frame i is read from image_paths[i]), `feature`, 1000
    features.
    With `sync_frames`, host syncs are counted into `sync_sites` over that
    many first frames only (those rows have "sync_counted"). Returns
    (system, per-frame rows, per-event rows, scene, K2 launches by search,
    the probe)."""
    from anyfeature_vslam_tpu_torch.system import System
    from torch_slice_scene import SliceScene

    sc = sc or SliceScene(width, height)
    if frames is None:
        frames = [sc.render(i)[0] for i in range(n_frames)]
    system = System(SimpleNamespace(**sc.camera), feature=feature, n_features=N_FEATURES,
                    device=device, **system_kw)
    rows = []
    with SystemProbe(torch, system, device, record, sync_sites, sync=sync,
                     record_event=record_event) as probe:
        for i, img8 in enumerate(frames[:n_frames]):
            counted = sync_frames is not None and i < sync_frames
            path = image_paths[i] if image_paths is not None else None
            with sync_counter(torch, sync_sites) if counted else contextlib.nullcontext():
                rows.append(dict(probe.frame(img8, i / 30.0, path), sync_counted=counted))
    return system, rows, probe.events, sc, probe.k2_by_label, probe


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


def record_spans():
    """Turn the port's span recorder on (perfcount.span), its earlier spans
    dropped: a phase that reads stage times calls it first."""
    from anyfeature_vslam_tpu_torch import perfcount

    perfcount.clear_spans()
    perfcount.trace_enabled = True


def span_seconds(prefix):
    """{stage: [seconds, ...]} of the recorded spans named prefix + stage,
    in the order they ended (``record_spans``)."""
    from anyfeature_vslam_tpu_torch import perfcount

    out = {}
    for s in perfcount.spans():
        if s.name.startswith(prefix):
            out.setdefault(s.name[len(prefix):], []).append((s.end_ns - s.start_ns) / 1e9)
    return out


def loop_stage_line(system, label):
    """The loop stage per keyframe event: its ms, the BoW transform's and
    detection's medians (the loop.* spans since ``record_spans``), the
    database's size."""
    lc = system.loop_closer
    stages = span_seconds("loop.")
    st = {k: statistics.median(v) * 1e3 for k, v in stages.items() if v}
    log(f"[{label}] loop stage: {len(system.loop_times)} events, median "
        f"{statistics.median(system.loop_times) * 1e3:.2f} ms (BoW transform "
        f"{st.get('bow', float('nan')):.2f}, detection {st.get('detect', float('nan')):.2f} ms; "
        f"{len(stages.get('sim3', []))} Sim3 candidates tried); database "
        f"{int(system.database.present.sum())} keyframes; closures {lc.n_loops_closed}")


# the CUDA API calls that launch a kernel (``cuda*`` and the lower-level
# ``cu*``), in a profile's host events
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def tracked_calls(spans, since_ns=0):
    """The tracked calls among `spans` (perfcount.spans()) that began at or
    after since_ns, in order: one {span name: summed ms} per ``frame`` span,
    the frame's own ms under "frame" and each span nested in it summed
    under its name."""
    by_id = {s.id: s for s in spans}

    def root(s):
        while s.parent is not None and s.parent in by_id:
            s = by_id[s.parent]
        return s

    frames = sorted((s for s in spans if s.name == "frame" and s.start_ns >= since_ns),
                    key=lambda s: s.start_ns)
    per = {s.id: {"frame": (s.end_ns - s.start_ns) / 1e6} for s in frames}
    for s in spans:
        top = root(s)
        if s is not top and top.id in per:
            call = per[top.id]
            call[s.name] = call.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return [per[s.id] for s in frames]


def span_launches(torch, prof):
    """({span name: kernel launch calls inside its ranges}, tracked calls)
    from a profile taken with host and device activity while the recorder
    was on: the launch calls on the tracking thread (the thread of the
    ``frame`` ranges) whose start lies in a range of that name, a call
    counted once per name (nested names count it each)."""
    import bisect

    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in prof.events() if e.device_type != cuda]
    frames = [e for e in host if e.name == "frame"]
    if not frames:
        return {}, 0
    thread = frames[0].thread
    mine = [e for e in host if e.thread == thread]
    starts = sorted(e.time_range.start for e in mine if e.name in LAUNCH_CALLS)
    names = {"frame"} | {e.name for e in mine if e.name.startswith(("frame.", "track."))}
    out = {}
    for e in mine:
        if e.name in names:
            a, b = e.time_range.start, e.time_range.end
            n = bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
            out[e.name] = out.get(e.name, 0) + n
    return out, len(frames)


def span_split(label, spans, since_ns=0, launches=None, detail=False):
    """Log where a tracked call's time goes, from the recorder's spans: the
    median ms per call of the extraction (``track.extract``), the pose LMs
    (summed ``track.pose_lm``), the host syncs (``track.motion_sync`` +
    ``track.retire_wait``) and the frame; the 90th percentile of the wait
    for the turn (``frame.turn_wait``); the keyframe events' median
    (``event``). With detail, a line per span name: the calls it ran in,
    its median ms there and, given `launches` (``span_launches``), its
    kernel launch calls per profiled call."""
    calls = tracked_calls(spans, since_ns)
    if not calls:
        log(f"[{label}] spans: no tracked call recorded")
        return
    med = (lambda name: statistics.median(c.get(name, 0.0) for c in calls))
    sync = statistics.median(c.get("track.motion_sync", 0.0) + c.get("track.retire_wait", 0.0)
                             for c in calls)
    waits = sorted(c.get("frame.turn_wait", 0.0) for c in calls)
    events = [(s.end_ns - s.start_ns) / 1e6 for s in spans
              if s.name == "event" and s.start_ns >= since_ns]
    log(f"[{label}] spans over {len(calls)} tracked calls (median ms per call): frame "
        f"{med('frame'):.2f}, extraction {med('track.extract'):.2f}, pose LMs "
        f"{med('track.pose_lm'):.2f}, host syncs {sync:.2f}; turn wait p90 "
        f"{waits[int(0.9 * (len(waits) - 1))]:.2f} ms; {len(events)} keyframe events, median "
        f"{statistics.median(events) if events else float('nan'):.2f} ms")
    if detail:
        counts, n_prof = launches if launches is not None else ({}, 0)
        for name in sorted({n for c in calls for n in c}):
            there = [c[name] for c in calls if name in c]
            per = (f"; {counts.get(name, 0) / n_prof:.0f} launch calls per call over "
                   f"{n_prof} profiled calls" if n_prof else "")
            log(f"[{label}] span {name}: in {len(there)} of {len(calls)} calls, median "
                f"{statistics.median(there):.2f} ms there, {sum(there) / len(calls):.2f} ms "
                f"per call{per}")


def system_phase(torch, device, frames):
    """Phase 8: the System with its defaults over the first N_SYSTEM_FRAMES
    of the bench's `frames` at 640x480, with its checks. Returns (launches K1, K2, pack;
    K2 launches by search; K2 measured at the init and fusion inputs; the
    system, its scene and the Sim3 aligning its keyframes to the truth)."""
    from anyfeature_vslam_tpu_torch import perfcount

    counters = _counters()
    recorded = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    perfcount.reset()
    record_spans()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    system, srows, sevents, ssc, k2_by, _ = system_run(torch, W, H, N_SYSTEM_FRAMES, device,
                                                       record=recorded, frames=frames,
                                                       async_mapping=False)
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
        f"{stats['resets']}, reinitializations {stats['reinitializations']}; ATE "
        f"(Sim3-aligned) keyframes {kf_ate:.5f} m over {n_kf_ate}, frames {fr_ate:.5f} m "
        f"over {n_fr_ate}")
    if not sevents:
        raise AssertionError("the System phase ran no keyframe event")
    log(f"[system] median ms per frame after init+1: without a keyframe event "
        f"{statistics.median(plain_frames) if plain_frames else float('nan'):.1f} "
        f"({len(plain_frames)} frames), with one "
        f"{statistics.median(kf_frames) if kf_frames else float('nan'):.1f} "
        f"({len(kf_frames)} frames); {len(sevents)} keyframe events, median "
        f"{statistics.median(e['ms'] for e in sevents):.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for name, ts in span_seconds("map.").items():
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
        _, crows, cevents, _, _, _ = system_run(torch, W, H, N_SYNC_FRAMES, device,
                                                sync_sites=sync_sites, frames=frames,
                                                async_mapping=False)
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


def reloc_phase(torch, device, system, sc, align, frames):
    """Phase 9: phase 8's System loses the camera to N_BLACKOUT uniform
    frames and must relocalize, within 3 frames, on views at the poses of
    earlier mapped frames (the bench's `frames`, rendered there): at least one relocalization, the relocalized
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
    record_spans()
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
                rows.append((f"view of frame {f}", probe.frame(frames[f], ts)))
                ts += 1 / 30.0
                if rows[-1][1]["state"] == "OK":
                    break
    finally:
        del db.detect_relocalization_candidates
        pnp.pnp_ransac_many = ransac
    launches = tuple(c.launches for c in counters)
    k2_by = probe.k2_by_label
    reloc_s = span_seconds("track.").get("reloc", [])
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
    log(f"[reloc] relocalization attempts: {len(reloc_s)}, ms "
        f"{[round(1e3 * d, 2) for d in reloc_s]}; candidates per attempt "
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
    return launches, k2_by, recorded, fid


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


N_RENDER_PROCS = min(8, os.cpu_count() or 1)


@contextlib.contextmanager
def render_pool(pool=None):
    """`pool`, or a new pool of spawned processes, one per host core (at
    most 8; none touches the card), shut down on exit."""
    if pool is not None:
        yield pool
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(N_RENDER_PROCS,
                             mp_context=multiprocessing.get_context("spawn")) as new:
        yield new


def render_loop_frames(width, height, idx, pool=None):
    """{i: uint8 frame i of the loop scene}, rendered on the host's cores
    (render_pool)."""
    n_proc = N_RENDER_PROCS
    with render_pool(pool) as workers:
        parts = workers.map(_render_loop_chunk, [width] * n_proc, [height] * n_proc,
                            [idx[k::n_proc] for k in range(n_proc)])
        return dict(p for part in parts for p in part)


def loop_phase(torch, device, sc, frames):
    """Phase 10: the two-session merge of tests/test_loop_live.py, rendered
    in memory (`sc`, torch_slice_scene.LoopScene at LOOP_W x LOOP_H, and its
    `frames`: render_loop_frames). Session A
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

    counters = _counters()
    recorded = {}
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    cam = SimpleNamespace(**sc.camera)
    sys_a = System(cam, feature="orb32", n_features=LOOP_FEATURES, async_mapping=False,
                   device=device)
    with SystemProbe(torch, sys_a, device) as probe_a:
        rows_a = [probe_a.frame(frames[i], i / 30.0) for i in sc.session_a]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "session_a.npz")
        sys_a.save_checkpoint(ckpt)
        sys_b = System(cam, feature="orb32", n_features=LOOP_FEATURES, async_mapping=False,
                       device=device)
        sys_b.load_checkpoint(ckpt)
    n_loaded = sys_b.map.n_keyframes()
    record_spans()  # the loop stage's spans: session B's alone
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
    loop_stages = span_seconds("loop.")
    for name in ("sim3", "correct", "fuse", "essential_graph", "global_ba"):
        v = loop_stages.get(name, [])
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
        record_spans()
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
                             stages={k: round(1e3 * sum(v), 2)
                                     for k, v in span_seconds("loop.").items()},
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


N_ASYNC_FRAMES = 48
N_THREADED_FRAMES = 150
N_THREADED_SYNC_FRAMES = 12
MAX_THREADED_LOST = 5
# phase 12's frames under torch.profiler, after its sync-counted frames and
# before its timed ones: the profiler's exit takes tens of seconds to
# collect the window's kernels, holding the GIL, and stalls the worker
PROFILED_WINDOW = (12, 16)
# phase 12's next frames, profiled with host events too while the span
# recorder is on, for the kernel launch calls inside each tracker span
SPAN_WINDOW = (16, 19)
SHUTDOWN_TIMEOUT_S = 60.0


def _render_slice_chunk(width, height, idx):
    from torch_slice_scene import SliceScene

    sc = SliceScene(width, height)
    return [(i, sc.render(i)[0]) for i in idx]


def render_slice_frames(width, height, n, pool=None):
    """The first n uint8 frames of the bench sequence, rendered on the
    host's cores (render_pool)."""
    n_proc = N_RENDER_PROCS
    idx = list(range(n))
    with render_pool(pool) as workers:
        parts = workers.map(_render_slice_chunk, [width] * n_proc, [height] * n_proc,
                            [idx[k::n_proc] for k in range(n_proc)])
        got = dict(p for part in parts for p in part)
    return [got[i] for i in idx]


def _frame_stats(rows):
    """(median ms per frame without an event, frames; with one, frames)
    after init + 1, leaving out the frames whose host syncs were counted
    (the sync debug mode slows them)."""
    ok = [i for i, r in enumerate(rows) if r["state"] == "OK"]
    steady = [r for r in rows[ok[0] + 2:] if not r.get("sync_counted")] if ok else []
    plain = [r["ms"] for r in steady if not r["events"]]
    ev = [r["ms"] for r in steady if r["events"]]
    med = (lambda v: statistics.median(v) if v else float("nan"))
    return med(plain), len(plain), med(ev), len(ev)


def _busy_share(torch, prof, wall_ms):
    """Device busy ms (the union of the CUDA kernels' intervals) and share."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in device_events(torch, prof))
    busy, end = 0.0, -1.0
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(iv), 100.0 * busy / 1e3 / wall_ms


def threaded_phase(torch, device, frames):
    """Phase 12: threaded_mapping=True (the worker thread, pipeline depth 2,
    the bench's schedule) over the bench's 150 frames. Gates: 0 resets, at
    most MAX_THREADED_LOST lost frames, keyframe ATE < MAX_ATE_M, shutdown()
    drains and stops the worker within SHUTDOWN_TIMEOUT_S; K1, K2 and pack
    launched. Host syncs are counted over the first N_THREADED_SYNC_FRAMES
    frames (those inside the pipelined dispatch apart), the next frames
    (PROFILED_WINDOW) run under torch.profiler for the device's busy share,
    the next (SPAN_WINDOW) under a profiler with host events for the launch
    calls in each span, and the worker is drained; the frames after are
    timed as a caller sees them (no device sync), frames/s runs from there
    to the end of the final drain, and the event stages and the tracked
    call's split (``span_split``) are those of the spans issued then.
    Counts set to 0 just before, read just after. Returns (launches K1, K2,
    pack; K2 by search)."""
    from torch.profiler import ProfilerActivity, profile

    from anyfeature_vslam_tpu_torch import perfcount
    from anyfeature_vslam_tpu_torch.system import System
    from torch_slice_scene import SliceScene

    sc = SliceScene(W, H)
    cam = SimpleNamespace(**sc.camera)
    sync_sites, dispatch_sites = {}, {}
    counters = _counters()
    torch.cuda.synchronize()
    perfcount.reset()
    record_spans()
    for c in counters:
        c.launches = 0
    system = System(cam, feature="orb32", n_features=N_FEATURES, threaded_mapping=True,
                    device=device)
    rows, busy = [], None
    with SystemProbe(torch, system, device, sync=False) as probe:
        for i, img in enumerate(frames):
            if i == N_THREADED_SYNC_FRAMES:
                n_disp = perfcount.get("track_dispatches")
            if i == SPAN_WINDOW[1]:
                system._worker.flush(SHUTDOWN_TIMEOUT_S)
                lm = system.local_mapper
                n0 = dict(events=len(probe.events), ba=len(lm.ba_log),
                          **{k: len(v) for k, v in span_seconds("map.").items()})
                t0, t0_ns = time.perf_counter(), time.perf_counter_ns()
            if i == SPAN_WINDOW[0]:
                span_prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                span_prof.__enter__()
            if i == PROFILED_WINDOW[0]:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                t_prof = time.perf_counter()
            counted = i < N_THREADED_SYNC_FRAMES
            with sync_counter(torch, sync_sites, within=("_fast_dispatch", dispatch_sites)) \
                    if counted else contextlib.nullcontext():
                rows.append(dict(probe.frame(img, i / 30.0), sync_counted=counted))
            if i == PROFILED_WINDOW[1] - 1:
                torch.cuda.synchronize()
                t_exit = time.perf_counter()
                wall_ms = (t_exit - t_prof) * 1e3
                prof.__exit__(None, None, None)
                busy = _busy_share(torch, prof, wall_ms) + (
                    wall_ms, time.perf_counter() - t_exit)
                del prof
            if i == SPAN_WINDOW[1] - 1:
                torch.cuda.synchronize()
                span_prof.__exit__(None, None, None)
                launches = span_launches(torch, span_prof)
                del span_prof
        max_queue = system._worker.max_pending
        t_stop = time.perf_counter()
        try:
            system.shutdown(SHUTDOWN_TIMEOUT_S)
            stopped = system._worker is None
        except TimeoutError:
            stopped = False
        shutdown_s = time.perf_counter() - t_stop
    wall = time.perf_counter() - t0
    k1, k2, pack = (c.launches for c in counters)
    stats = system.tracker.stats
    kf_ate, fr_ate, n_kf, n_fr, _ = ate(system, sc)
    log(f"[threaded syncs] first {N_THREADED_SYNC_FRAMES} frames: "
        f"{sum(sync_sites.values())} host syncs on both threads; "
        f"{sum(dispatch_sites.values())} inside {n_disp:.0f} pipelined dispatches "
        f"({sum(dispatch_sites.values()) / max(n_disp, 1):.2f} per dispatch), by site:")
    for site, n in sorted(dispatch_sites.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[threaded syncs]   {n:5d}x  {site}")
    timed = rows[SPAN_WINDOW[1]:]
    ms = sorted(r["ms"] for r in timed)
    p90 = ms[int(0.9 * (len(ms) - 1))]
    log(f"[threaded] {len(frames)} frames {W}x{H}; frames {SPAN_WINDOW[1]}-"
        f"{len(frames) - 1} in {wall:.2f} s ({len(timed) / wall:.3f} frames/s, the final "
        f"drain included; shutdown {shutdown_s:.2f} s, worker stopped {stopped}); frame ms "
        f"over them median {statistics.median(ms):.1f}, p90 {p90:.1f}, max {ms[-1]:.1f}")
    med = (lambda v: statistics.median(v) if v else float("nan"))
    plain = [r["ms"] for r in timed if not r["events"]]
    with_ev = [r["ms"] for r in timed if r["events"]]
    log(f"[threaded] median ms per timed frame: without a keyframe event {med(plain):.1f} "
        f"({len(plain)} frames), with one (the worker's turn inside it) {med(with_ev):.1f} "
        f"({len(with_ev)} frames)")
    log(f"[threaded] tracked {stats['tracked_frames']}, lost {stats['lost_frames']}, resets "
        f"{stats['resets']}, relocalizations {stats['relocalizations']}; "
        f"{system.map.n_keyframes()} keyframes, {system.map.n_points()} points; ATE "
        f"(Sim3-aligned) keyframes {kf_ate:.5f} m over {n_kf}, frames {fr_ate:.5f} m over {n_fr}")
    events = probe.events[n0["events"]:]
    log(f"[threaded] {len(probe.events)} worker events, {len(events)} while timed, median "
        f"{med([e['ms'] for e in events]):.1f} ms; worker's largest queue {max_queue}; "
        f"fast-path failures replayed "
        f"{perfcount.get('fast_failures'):.0f}, weak frames {perfcount.get('weak_frames'):.0f}, "
        f"staged frames {perfcount.get('staged_frames'):.0f}, pipelined dispatches "
        f"{perfcount.get('track_dispatches'):.0f}; folds landed by site {json.dumps(probe.folds)}")
    for name, ts in span_seconds("map.").items():
        ts = ts[n0.get(name, 0):]
        if ts:
            log(f"[threaded] timed event stage {name}: median {1e3 * statistics.median(ts):.2f} "
                f"ms, max {1e3 * max(ts):.2f} ms over {len(ts)} events")
    ba_lines(lm.ba_log[n0["ba"]:], "threaded", "timed local BA (issue ms)")
    spans = perfcount.spans()
    span_split("threaded", spans, t0_ns, launches, detail=True)
    whole = {}
    for sp in spans:
        whole[sp.name] = whole.get(sp.name, 0) + 1
    log(f"[threaded] spans over the whole run, by name: {json.dumps(whole, sort_keys=True)}")
    loop_stage_line(system, "threaded")
    log(f"[threaded] profiled frames {PROFILED_WINDOW[0]}-{PROFILED_WINDOW[1] - 1}: wall "
        f"{busy[3]:.1f} ms (profiler on), device busy {busy[0]:.2f} ms over {busy[1]} "
        f"kernels ({busy[2]:.2f}%, the union of kernel intervals on both streams); the "
        f"profiler's exit {busy[4]:.1f} s")
    log(f"[threaded] launches: K1 {k1}, K2 {k2} (by search {json.dumps(probe.k2_by_label)}), "
        f"pack {pack}")
    fail = []
    if stats["resets"] != 0:
        fail.append(f"{stats['resets']} resets")
    if stats["lost_frames"] > MAX_THREADED_LOST:
        fail.append(f"{stats['lost_frames']} lost frames")
    if not kf_ate < MAX_ATE_M:
        fail.append(f"keyframe ATE {kf_ate:.4f} m")
    if not stopped:
        fail.append("shutdown did not stop the worker")
    if k1 < 1 or k2 < 1 or pack < 1:
        fail.append("a kernel of the path was not launched")
    if fail:
        raise AssertionError(f"the threaded-mapping phase failed: {fail}")
    return (k1, k2, pack), dict(probe.k2_by_label)


FAMILIES = ("brisk48", "anyfeat_bin", "anyfeat_nonbin", "akaze61", "kaze64", "surf64",
            "sift128")
N_FAMILY_FRAMES = 48
# JAX's own per-family bound (tests/test_synth_sequence_e2e.py:75-93); the
# JAX package's keyframe ATE on the CPU over these 48 frames: PERF.md
# section 5 (tests/family_ate.py)
MAX_FAMILY_ATE_M = 0.02
MIN_FAMILY_AGREE = 0.99
MAX_FLOAT_DESC_ERR = 1e-4
MAX_MEDIAN_ANGLE_ERR = 1e-4
FAMILY_SEARCHES = ("init", "tracking", "fusion")


# sift128's keypoints are integer maxima moved by subpixel offsets, which
# magnify a last-bit difference in the scale space: equal when their
# octaves are and they lie this close (tests/test_torch_families.py)
SIFT_KP_TOL_PX = 0.01


def family_extraction(torch, device, feature, img8):
    """Phase 13, the extractor of one family on one rendered frame: for a
    FAST family K1 bit-exact on its 8 levels (one launch); for akaze61 /
    kaze64 the nonlinear scale space, for surf64 the det(H) pyramid, for
    sift128 the Gaussian octaves, with no K1 launch; then the extraction
    on the card against the same extractor on the CPU, and its time on
    the card (and for the families without K1 a profile of its device
    events). Returns K1's max abs err against its twin (None where the
    family does not run K1)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch.frontend import cuda_fast, pyramid
    from anyfeature_vslam_tpu_torch.frontend.extractor import (ExtractorConfig,
                                                               NonlinearExtractor,
                                                               SiftExtractor, make_extractor)

    cfg = ExtractorConfig.for_feature(feature, N_FEATURES)
    ext = make_extractor(cfg, H, W).to(device)
    nonlinear = isinstance(ext, NonlinearExtractor)
    sift = isinstance(ext, SiftExtractor)
    img = torch.from_numpy(img8).to(device).float()
    n_k1 = cuda_fast.fast_nms.launches
    k1_err = None
    if cfg.detector != "fast":
        levels = ext.levels(img)
    else:
        levels = [l.contiguous() for l in pyramid.build_pyramid(img, ext.resize_mats())]
        got_levels = cuda_fast.fast_nms_levels(levels, cfg.detect_th)
        if cuda_fast.fast_nms.launches != n_k1 + 1:
            raise AssertionError(f"[{feature}] K1: the 8 levels took more than one launch")
        k1_err = 0.0
        for lvl, (lev, got) in enumerate(zip(levels, got_levels)):
            want = cuda_fast.fast_nms_plain(lev, cfg.detect_th)
            torch.cuda.synchronize()
            k1_err = max(k1_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"[{feature}] K1 level {lvl} {tuple(lev.shape)}: not "
                                     "bit-exact")
        log(f"[{feature}] K1 bit-exact on levels {[tuple(l.shape) for l in levels]} (scale "
            f"{cfg.scale_factor}, threshold {cfg.detect_th}), "
            f"{sum(int((g > 0).sum()) for g in got_levels)} corners")

    # the extraction on the card; on the CPU from the CPU's own pyramid (or
    # scale space); and on the CPU from the card's levels, which holds the
    # detection and descriptor stages alone (the levels' matmuls sum in
    # another order on each device: a last-bit difference in a level can
    # flip the bf16 rounding of a descriptor operand, which moves a
    # learned48 row by ~1e-4)
    fd = {k: v.cpu().numpy() for k, v in ext.from_levels(levels).items()}
    ext_cpu = make_extractor(cfg, H, W)
    cpu_levels = ext_cpu.levels(img.cpu())
    if nonlinear:
        # L, Lx, Ly in intensity / 255 units; det(H) relative to its level's largest
        level_err = max(float((getattr(a, n).cpu() - getattr(b, n)).abs().max())
                        for a, b in zip(levels, cpu_levels) for n in ("L", "Lx", "Ly"))
        resp_err = max(float((a.response.cpu() - b.response).abs().max()
                             / b.response.abs().max()) for a, b in zip(levels, cpu_levels))
        k_card = float(nonlinear_k(torch, ext, img))
        k_cpu = float(nonlinear_k(torch, ext_cpu, img.cpu()))
        level_line = (f"scale space max abs diff {level_err:.3g} (L, Lx, Ly), det(H) "
                      f"{resp_err:.3g} of its level's largest; contrast factor card "
                      f"{k_card!r}, CPU {k_cpu!r}")
        card_levels = [ev.to("cpu") for ev in levels]
    elif sift:
        # the Gaussian slices of every octave
        level_err = max(float((a.cpu() - b).abs().max())
                        for oa, ob in zip(levels, cpu_levels) for a, b in zip(oa, ob))
        level_line = f"scale space max abs diff {level_err:.3g} gray levels"
        card_levels = [[a.cpu() for a in oa] for oa in levels]
    else:
        level_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(levels, cpu_levels))
        level_line = f"levels max abs diff {level_err:.3g} gray levels"
        card_levels = [l.cpu() for l in levels]
    fc = {k: v.numpy() for k, v in ext_cpu.from_levels(cpu_levels).items()}
    fs = {k: v.numpy() for k, v in ext_cpu.from_levels(card_levels).items()}

    def pairs(fa, fb):
        """(slot in fa, slot in fb) of the valid keypoints of both: equal
        (octave, x, y), or for sift128 equal octaves within
        SIFT_KP_TOL_PX (the nearest, each used once)."""
        if not sift:
            def keyed(f):
                keys = zip(f["octave"], f["xy"][:, 0], f["xy"][:, 1])
                return {k: i for i, k in enumerate(keys) if f["valid"][i]}

            ka, kb = keyed(fa), keyed(fb)
            return [(ka[k], kb[k]) for k in sorted(set(ka) & set(kb))]
        out, used = [], set()
        va = np.nonzero(fa["valid"])[0]
        for j in np.nonzero(fb["valid"])[0]:
            cand = va[fa["octave"][va] == fb["octave"][j]]
            if len(cand):
                d = np.abs(fa["xy"][cand] - fb["xy"][j]).max(axis=1)
                k = int(np.argmin(d))
                if d[k] <= SIFT_KP_TOL_PX and int(cand[k]) not in used:
                    used.add(int(cand[k]))
                    out.append((int(cand[k]), int(j)))
        return out

    def compare(fa, fb):
        pa = pairs(fa, fb)
        ia, ib = [a for a, _ in pa], [b for _, b in pa]
        n_a, n_b = int(fa["valid"].sum()), int(fb["valid"].sum())
        same_kp = len(pa) / max(n_a, n_b, 1)
        ra = fa["desc_bits"][ia]
        rb = fb["desc_bits"][ib]
        ang = np.abs(fa["angle"][ia] - fb["angle"][ib])
        med_ang = float(np.median(ang)) if len(ang) else float("inf")
        if ra.dtype == np.uint8:
            same_rows = (ra == rb).all(axis=1)
            err = float((~same_rows).any())
        else:
            row_err = np.abs(ra - rb).max(axis=1) if len(ra) else np.zeros(0)
            same_rows = row_err <= MAX_FLOAT_DESC_ERR
            err = float(row_err.max()) if len(ra) else 0.0
        return n_b, n_a, same_kp, ra, float(same_rows.mean()), err, med_ang

    n_c, n_d, same_kp, rd, same_rows, err, med_ang = compare(fd, fc)
    *_, same_kp_s, _, same_rows_s, err_s, med_ang_s = compare(fd, fs)
    if rd.dtype == np.uint8:
        desc_line = f"{same_rows:.4f} of rows equal ({same_rows_s:.4f} at the card's levels)"
        desc_ok = same_rows >= MIN_FAMILY_AGREE and same_rows_s >= MIN_FAMILY_AGREE
    else:
        desc_line = (f"{same_rows:.4f} of rows within {MAX_FLOAT_DESC_ERR:g} "
                     f"({same_rows_s:.4f} at the card's levels), max abs err {err:.3g} "
                     f"({err_s:.3g})")
        # M-SURF's and SIFT's orientations bin per-sample angles: a
        # last-bit change can move a sample to the next bin and, once in a
        # while, the whole window, so kaze64 and sift128 are held by the
        # share of rows
        desc_ok = same_rows >= MIN_FAMILY_AGREE and (
            same_rows_s >= MIN_FAMILY_AGREE if nonlinear or sift
            else err_s <= MAX_FLOAT_DESC_ERR)
    if cfg.detector != "fast" and cuda_fast.fast_nms.launches != n_k1:
        raise AssertionError(f"[{feature}] K1 launched by the {cfg.detector} extraction")
    e_ms = time_ms(torch, lambda: ext(img), reps=10)
    log(f"[{feature}] extraction card vs CPU: {level_line}; {n_c} / {n_d} valid keypoints, "
        f"{same_kp:.4f} equal (level, x, y) ({same_kp_s:.4f} at the card's levels); "
        f"descriptors {rd.dtype} x {rd.shape[1]}: {desc_line}; median angle err "
        f"{med_ang:.3g} rad ({med_ang_s:.3g}); {e_ms:.3f} ms on the card (eager)")
    if cfg.detector != "fast":
        extraction_profile(torch, feature, ext, img, e_ms)
    if not (min(same_kp, same_kp_s) >= MIN_FAMILY_AGREE and desc_ok
            and max(med_ang, med_ang_s) < MAX_MEDIAN_ANGLE_ERR):
        raise AssertionError(f"[{feature}] the extraction on the card disagrees with the CPU")
    return k1_err


def nonlinear_k(torch, ext, img):
    """The contrast factor of a nonlinear extractor's input image."""
    from anyfeature_vslam_tpu_torch.frontend import nonlinear

    img01 = img.reshape(ext.height, ext.width) * (1.0 / 255.0)
    return nonlinear.contrast_factor(img01, ext.consts.smooth)


def extraction_profile(torch, feature, ext, img, eager_ms):
    """Where an extraction without K1 (akaze61, kaze64, surf64, sift128)
    spends its time: its kernel launches and summed device time
    (torch.profiler) beside its eager time, split into the scale space (or
    pyramid) and the detection + description."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        ev = device_events(torch, prof)
        return out, len(ev), sum(e.device_time for e in ev) / 1e3

    levels, n_space, d_space = kernels(lambda: ext.levels(img))
    _, n_desc, d_desc = kernels(lambda: ext.from_levels(levels))
    s_ms = time_ms(torch, lambda: ext.levels(img), reps=10)
    log(f"[{feature}] extraction on the card (profiled): scale space {n_space} device "
        f"events (kernels, copies), {d_space:.3f} ms device ({s_ms:.3f} ms eager); detection "
        f"+ description {n_desc} device events, {d_desc:.3f} ms device; whole {eager_ms:.3f} ms eager, device busy "
        f"{100 * (d_space + d_desc) / eager_ms:.1f}%")


def family_phase(torch, device, feature, frames, sc=None, image_paths=None):
    """Phase 13 for one family: K1 (FAST families) and the extraction
    (``family_extraction``), then the System with the JAX System's
    defaults (asynchronous mapping, the family's shipped vocabulary, loop
    detection at every event) over frames: 0 resets, >= 45 tracked,
    keyframe ATE < MAX_FAMILY_ATE_M; K1 once per frame (once more for a
    rebuilt initialization) for a FAST family and never for the others,
    K2 from the init, tracking and fusion searches; K2 held against its twin at the recorded inputs of the init
    search, the tracked frame's reference-keyframe search (no window), one
    of its windowed searches (motion model or local map, the one with the
    most active queries) and one fusion search, each row with the
    launches of its kind. Counts set to 0 just before the System run,
    read just after. With image_paths (phase 14, r2d2_128: frames of the
    scene `sc` whose features are read from those files) there is no
    extraction, and the vocabulary is trained online, so the events
    before it have no loop stage. Returns (K1 launches, K1 max abs err,
    pack launches, K2 rows by search)."""
    import numpy as np

    from torch_slice_scene import FIRST_TRACKED

    from anyfeature_vslam_tpu_torch import perfcount
    from anyfeature_vslam_tpu_torch.ops import cuda_match

    precomputed = image_paths is not None
    k1_err = None if precomputed else family_extraction(torch, device, feature,
                                                          frames[FIRST_TRACKED])
    counters = _counters()
    recorded = {}
    torch.cuda.synchronize()
    record_spans()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    system, rows, events, sc, k2_by, probe = system_run(
        torch, W, H, len(frames), device, record=recorded, frames=frames, sync=False,
        feature=feature, sc=sc, image_paths=image_paths,
        record_event=RECORDED_EVENT if image_paths is None else RECORDED_EVENT_R2D2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, pack = (c.launches for c in counters)
    k2_ref = probe.k2_reference
    stats = system.tracker.stats
    kf_ate, fr_ate, n_kf, n_fr, _ = ate(system, sc)
    plain_ms, n_plain, ev_ms, n_ev = _frame_stats(rows)
    for i, r in enumerate(rows):
        log(f"[{feature}] frame {i}: {r['state']} kfs {r['kfs']} pts {r['pts']} inliers "
            f"{r['inliers']} {r['ms']:.1f} ms, events {r['events']}, launches K1 {r['k1']} "
            f"K2 {r['k2']} pack {r['pack']}")
    log(f"[{feature}] System {len(frames)} frames {W}x{H} in {wall:.1f} s; tracked "
        f"{stats['tracked_frames']}, lost {stats['lost_frames']}, resets {stats['resets']}, "
        f"reinitializations {stats['reinitializations']}; "
        f"{system.map.n_keyframes()} keyframes, {system.map.n_points()} points, descriptors "
        f"{np.dtype(system.map.desc_dtype).name} x {system.map.desc_dim}; ATE (Sim3-aligned) "
        f"keyframes {kf_ate:.5f} m over {n_kf}, frames {fr_ate:.5f} m over {n_fr}")
    log(f"[{feature}] median ms per frame after init+1 (no device sync): without a keyframe "
        f"event {plain_ms:.1f} ({n_plain} frames), with one {ev_ms:.1f} ({n_ev} frames); "
        f"{len(events)} events")
    loop_stage_line(system, feature)
    span_split(feature, perfcount.spans())
    log(f"[{feature}] launches: K1 {k1} ({len(rows)} frames), K2 {k2} (by search "
        f"{json.dumps(k2_by)}; {k2_ref} of the tracking ones reference-keyframe searches), "
        f"pack {pack}")
    fail = []
    if stats["resets"] != 0:
        fail.append(f"{stats['resets']} resets")
    if stats["tracked_frames"] < MIN_SYSTEM_TRACKED:
        fail.append(f"{stats['tracked_frames']} tracked frames")
    if not kf_ate < MAX_FAMILY_ATE_M:
        fail.append(f"keyframe ATE {kf_ate:.4f} m")
    if system.vocabulary is None or system.loop_closer is None:
        fail.append("the System runs without a vocabulary or loop closing")
    elif len(system.loop_times) != len(events) and not precomputed:
        fail.append("a keyframe event without its loop stage")
    if k1_err is None:  # the families without FAST detection
        if k1 != 0:
            fail.append(f"{k1} K1 launches")
    # a rebuilt initialization extracts its frame again (init extractor)
    elif k1 != len(rows) + stats["reinitializations"] or min(r["k1"] for r in rows) != 1:
        fail.append("K1 not launched once per frame (and once per reinitialization)")
    if not all(k2_by.get(k, 0) > 0 for k in FAMILY_SEARCHES) or sum(k2_by.values()) != k2:
        fail.append("K2 not launched by each of the init, tracking and fusion searches")
    if not 0 < k2_ref < k2_by.get("tracking", 0):
        fail.append(f"{k2_ref} reference-keyframe searches of {k2_by.get('tracking', 0)} "
                    "tracking searches")
    binary = np.dtype(system.map.desc_dtype) == np.uint8
    if binary != (pack > 0):
        fail.append(f"{pack} pack_bits launches with {np.dtype(system.map.desc_dtype).name} "
                    "descriptors")
    if fail:
        raise AssertionError(f"[{feature}] the family's System phase failed: {fail}")
    del system
    for label in FAMILY_SEARCHES:
        if label not in recorded:
            raise AssertionError(f"[{feature}] no {label} search was recorded")

    def active(call):
        return int((call[0][4] >= 0).sum())

    def unwindowed(call):  # every active query at radius INF
        rad = call[0][4]
        return bool((rad >= 0).any()) and bool((rad[rad >= 0] >= cuda_match.INF).all())

    track = recorded["tracking"]
    kinds = {"init": (recorded["init"][-1:], k2_by["init"]),
             "tracking_reference": ([c for c in track if unwindowed(c)], k2_ref),
             "tracking_windowed": ([c for c in track if not unwindowed(c)],
                                   k2_by["tracking"] - k2_ref),
             "fusion": (recorded["fusion"], k2_by["fusion"])}
    k2_rows = {}
    for label, (calls, launches) in kinds.items():
        if not calls:
            raise AssertionError(f"[{feature}] no {label} search was recorded")
        a, kw = max(calls, key=active)
        k2_rows[label] = measure_k2(
            torch, a, kw, f"{feature} {label} search ({active((a, kw))} active queries)")
        k2_rows[label]["launches"] = launches
    return dict(k1=k1, k1_err=k1_err, pack=pack, k2_rows=k2_rows)


N_R2D2_LANDMARKS = 7000  # keeps the 2000 init and 1000 tracking slots full at 640x480


def r2d2_phase(torch, device):
    """Phase 14: r2d2_128 (precomputed 128-d float features) at 640x480
    with 1000 features: tests/r2d2_scene.py's landmark scene over
    N_FAMILY_FRAMES frames, its .bin files written to a temporary folder,
    each frame a flat gray uint8 array passed with its image path; then
    ``family_phase``'s System run, gates and K2 rows (D = 128)."""
    import tempfile

    from r2d2_scene import R2d2Scene

    sc = R2d2Scene(W, H, n_frames=N_FAMILY_FRAMES, n_pts=N_R2D2_LANDMARKS)
    with tempfile.TemporaryDirectory() as root:
        paths = sc.write(root)
        visible = [len(sc.features(i)[1]) for i in (0, N_FAMILY_FRAMES - 1)]
        log(f"[r2d2_128] {len(paths)} frames of {N_R2D2_LANDMARKS} landmarks written; "
            f"{visible} visible at the first and last frame")
        if min(visible) < 2 * N_FEATURES:
            raise AssertionError(f"[r2d2_128] the scene does not fill the init slots: {visible}")
        return family_phase(torch, device, "r2d2_128", [sc.image()] * N_FAMILY_FRAMES,
                            sc=sc, image_paths=paths)

N_RETRACE = 8  # frames retraced backwards in localization mode


def _localization_gates(tag, system, rows, counts_before):
    """The localization retrace's gates: every frame OK and tracked in
    localization mode, the map's keyframe and point counts unchanged."""
    fail = []
    bad = [i for i, r in enumerate(rows) if r["state"] != "OK"]
    if bad:
        fail.append(f"frames {bad} not OK")
    if not system.tracker.only_tracking:
        fail.append("only_tracking not set")
    counts = (system.map.n_keyframes(), system.map.n_points())
    if counts != counts_before:
        fail.append(f"keyframes, points {counts_before} -> {counts}")
    if fail:
        raise AssertionError(f"[{tag}] localization mode failed: {fail}")


def _deactivate(tag, probe, system, img, ts, **frame_kw):
    """Deactivate localization mode; only_tracking must clear at the next
    frame."""
    system.deactivate_localization_mode()
    probe.frame(img, ts, **frame_kw)
    if system.tracker.only_tracking:
        raise AssertionError(f"[{tag}] only_tracking still set after deactivation")


def mono_localization_phase(torch, device, system, sc, fid, frames):
    """Phase 9b: localization mode on phase 8's System, relocalized at the
    view of frame `fid` in phase 9: the views of frames fid, fid - 1, ...
    retraced backwards (N_RETRACE frames, the staged path, no keyframe);
    every frame OK, the keyframe and point counts unchanged, K1 once per
    frame; then deactivated, only_tracking clears at the next frame.
    Counts set to 0 just before the retrace, read just after. Returns
    (launches K1, K2, pack; K2 by search)."""
    counters = _counters()
    views = [fid - j for j in range(N_RETRACE)]
    imgs = [frames[f] for f in views]
    counts_before = (system.map.n_keyframes(), system.map.n_points())
    system.activate_localization_mode()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    rows = []
    ts = (N_SYSTEM_FRAMES + 10) / 30.0
    with SystemProbe(torch, system, device, staged=True) as probe:
        for img in imgs:
            rows.append(probe.frame(img, ts))
            ts += 1 / 30.0
        launches = tuple(c.launches for c in counters)
        k2_by = dict(probe.k2_by_label)
        for f, r in zip(views, rows):
            log(f"[mono localization] view of frame {f}: {r['state']} inliers {r['inliers']} "
                f"{r['ms']:.1f} ms, launches K1 {r['k1']} K2 {r['k2']}, mb_vo "
                f"{system.tracker.mb_vo}")
        _localization_gates("mono localization", system, rows, counts_before)
        _deactivate("mono localization", probe, system, imgs[-1], ts)
    log(f"[mono localization] {len(rows)} frames retraced, keyframes, points "
        f"{counts_before} unchanged; median {statistics.median(r['ms'] for r in rows):.1f} ms "
        f"per frame; launches K1 {launches[0]}, K2 {launches[1]} (by search "
        f"{json.dumps(k2_by)}), pack {launches[2]}")
    if [r["k1"] for r in rows] != [1] * len(rows):
        raise AssertionError("[mono localization] K1 not launched once per frame")
    return launches, k2_by


# Phases 15 and 16: tests/test_rgbd_stereo.py's scene (its texture,
# platforms, poses and 0.1 m baseline) at 640x480, its intrinsics scaled
# from 320x240 (fx 260 -> 520, the principal point at the centre;
# tests/torch_plane_scene.py)
N_RGBD_FRAMES = 40
N_STEREO_FRAMES = 12
N_RGBD_SYNC_FRAMES = 8     # host syncs counted over frames 1-8
# test_rgbd_stereo.py's gates
MAX_SCALE_ERR = 0.12       # the keyframes' metric displacement against the truth
MIN_KF_MATCHES = 100       # matches of every keyframe
MAX_INIT_DEPTH_ERR_M = 0.1  # the instant map's median depth against the rendered one
MIN_STEREO_MATCHES = 150
MAX_STEREO_DEPTH_ERR = 0.08  # median relative depth error of the stereo matches
MIN_STEREO_TRACKED = 0.7
# the card's sub-pixel disparities against the CPU's: the 11x11 SAD sums
# are float32 sums in another order
STEREO_DISP_ATOL = 1e-3


def plane_camera():
    """The plane scene's camera at W x H and its bf (baseline x fx)."""
    from torch_plane_scene import BASELINE, plane_intrinsics

    fx, cx, cy = plane_intrinsics(W, H)
    return SimpleNamespace(fx=fx, fy=fx, cx=cx, cy=cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                           width=W, height=H), fx * BASELINE


def rgbd_poses():
    """test_rgbd_stereo.py's poses: the camera 2 m above the plane, moving
    along x."""
    from torch_plane_scene import line_traj

    return line_traj(N_RGBD_FRAMES, x1=3.2)


def leg_poses():
    """tests/test_torch_rgbd.py's leg after the localization retrace, from
    the retrace's last pose out of the map's view and back."""
    from torch_plane_scene import out_and_back

    return out_and_back(float(_centre64(rgbd_poses()[N_RGBD_FRAMES - N_RETRACE])[0]))


def _render_plane_chunk(kind, idx):
    """Frames idx of the RGB-D run or its localization leg ((image,
    depth)), or of the stereo run ((left, right, left depth)), float32 as
    the scene renders them."""
    from torch_plane_scene import line_traj, plane_scene, right_view

    sc = plane_scene(W, H)
    if kind in ("rgbd", "leg"):
        poses = rgbd_poses() if kind == "rgbd" else leg_poses()
        return [(kind, i, sc.render_with_depth(poses[i])) for i in idx]
    out = []
    for i in idx:
        pose = line_traj(N_STEREO_FRAMES)[i]
        img, depth = sc.render_with_depth(pose)
        out.append((kind, i, (img, right_view(sc, pose), depth)))
    return out


def render_plane_frames(pool=None):
    """Phase 15's RGB-D frames and localization leg, and phase 16's stereo
    pairs, rendered on the host's cores (render_pool)."""
    n_proc = N_RENDER_PROCS
    counts = {"rgbd": N_RGBD_FRAMES, "leg": len(leg_poses()), "stereo": N_STEREO_FRAMES}
    jobs = [(kind, list(range(n))[k::n_proc]) for kind, n in counts.items()
            for k in range(n_proc)]
    jobs = [j for j in jobs if j[1]]
    with render_pool(pool) as workers:
        parts = workers.map(_render_plane_chunk, *zip(*jobs))
        got = {(kind, i): v for part in parts for kind, i, v in part}
    return tuple([got[kind, i] for i in range(n)] for kind, n in counts.items())


def _centre64(t):
    import numpy as np

    t = np.asarray(t, np.float64)
    return -t[:3, :3].T @ t[:3, 3]


def rgbd_phase(torch, device, frames, leg):
    """Phase 15: the RGB-D System (sensor="rgbd", bf = 0.1 m x fx, the JAX
    System's defaults) over the N_RGBD_FRAMES frames of tests/
    test_rgbd_stereo.py's run at 640x480, then localization mode. Gates:
    the instant map at frame 0 with its median point depth within
    MAX_INIT_DEPTH_ERR_M of the rendered median; 0 resets, 0 lost, >=
    N_RGBD_FRAMES - 1 tracked; the keyframes' metric displacement within
    MAX_SCALE_ERR of the truth, no alignment; every keyframe with more
    than MIN_KF_MATCHES matches; K1 once per frame; K2 from the staged
    searches (motion model, reference keyframe, local map) and fusion.
    Then localization mode: the last N_RETRACE frames retraced backwards,
    then `leg` (``leg_poses``: beyond the map, where the tracker rides
    its depth points in mb_vo and tries relocalization at every frame,
    and back, where the motion model's map matches or a relocalization
    end mb_vo); every frame OK, counts unchanged, mb_vo set on the way out
    and cleared by the end, K1 once per frame, K2 by search (reloc
    included), deactivation. ms per frame with
    and without an event, host syncs per frame over frames 1-8 (left out
    of the times). K2 held exact against its twin at the recorded inputs
    of one motion-model and one local-map search. Counts set to 0 just
    before each run, read just after. Returns (launches K1, K2, pack; K2
    by search; the same of the retrace; K2 rows by search)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch.system import System

    counters = _counters()
    recorded, sync_sites = {}, {}
    cam, bf = plane_camera()
    system = System(cam, feature="orb32", n_features=N_FEATURES, sensor="rgbd", bf=bf,
                    device=device)
    if not (system.async_mapping and system.loop_closer is not None):
        raise AssertionError("[rgbd] the System runs without the JAX System's defaults")
    poses = rgbd_poses()
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    rows = []
    t0 = time.perf_counter()
    with SystemProbe(torch, system, device, recorded, sync_sites, staged=True) as probe:
        for i, (img, depth) in enumerate(frames):
            counted = 1 <= i <= N_RGBD_SYNC_FRAMES
            with sync_counter(torch, sync_sites) if counted else contextlib.nullcontext():
                rows.append(dict(probe.frame(img, i / 30.0, depth=depth), sync_counted=counted))
            if i == 0:
                m = system.map
                kf0 = m.keyframe_ids()
                ids = m.kf_matches[kf0[0]][m.kf_matches[kf0[0]] >= 0] if len(kf0) else []
                init_depth = float(np.median(m.pt_pos[ids][:, 2])) if len(ids) else float("nan")
                rendered = float(np.median(depth[depth > 0]))
        wall = time.perf_counter() - t0
        launches = tuple(c.launches for c in counters)
        k2_by = dict(probe.k2_by_label)
        events = list(probe.events)
        stats = dict(system.tracker.stats)
        m = system.map
        kfs = m.keyframe_ids()
        kf_frames = [int(m.kf_frame_id[k]) for k in kfs]
        kf_matched = [int((m.kf_matches[k] >= 0).sum()) for k in kfs]
        est = np.stack([_centre64(m.kf_pose[k]) for k in kfs])
        gt = np.stack([_centre64(poses[f]) for f in kf_frames])
        d_est, d_gt = float(np.linalg.norm(est[-1] - est[0])), float(
            np.linalg.norm(gt[-1] - gt[0]))
        for i, r in enumerate(rows):
            log(f"[rgbd] frame {i}: {r['state']} kfs {r['kfs']} pts {r['pts']} inliers "
                f"{r['inliers']} {r['ms']:.1f} ms, events {r['events']}, launches K1 {r['k1']} "
                f"K2 {r['k2']} pack {r['pack']}, host syncs {r['syncs']}")
        plain_ms, n_plain, ev_ms, n_ev = _frame_stats(rows)
        log(f"[rgbd] {len(rows)} frames {W}x{H} orb32 {N_FEATURES} features, bf {bf:g} "
            f"in {wall:.1f} s; init at frame 0: {len(ids)} points, median depth "
            f"{init_depth:.4f} m (rendered {rendered:.4f} m); at the end {len(kfs)} keyframes "
            f"(frames {kf_frames}, matches {kf_matched}), {m.n_points()} points; tracked "
            f"{stats['tracked_frames']}, lost {stats['lost_frames']}, resets {stats['resets']}; "
            f"keyframe displacement {d_est:.4f} m against {d_gt:.4f} m "
            f"({100 * abs(d_est - d_gt) / d_gt:.2f}%)")
        log(f"[rgbd] median ms per frame after init+1: without a keyframe event {plain_ms:.1f} "
            f"({n_plain} frames), with one {ev_ms:.1f} ({n_ev} frames); {len(events)} events; "
            f"host syncs per frame over frames 1-{N_RGBD_SYNC_FRAMES} "
            f"{[r['syncs'] for r in rows if r['sync_counted']]}")
        for site, n in sorted(sync_sites.items(), key=lambda kv: -kv[1])[:10]:
            log(f"[rgbd syncs]   {n:5d}x  {site}")
        log(f"[rgbd] launches: K1 {launches[0]}, K2 {launches[1]} (by search "
            f"{json.dumps(k2_by)}), pack {launches[2]}")
        fail = []
        if not abs(init_depth - rendered) < MAX_INIT_DEPTH_ERR_M:
            fail.append(f"instant map's median depth {init_depth:.4f} m, rendered {rendered:.4f}")
        if stats["resets"] or stats["lost_frames"] or \
                stats["tracked_frames"] < N_RGBD_FRAMES - 1:
            fail.append(f"stats {stats}")
        if len(kfs) < 2 or not abs(d_est - d_gt) / d_gt < MAX_SCALE_ERR:
            fail.append(f"{len(kfs)} keyframes, displacement {d_est:.4f} m of {d_gt:.4f} m")
        if min(kf_matched) <= MIN_KF_MATCHES:
            fail.append(f"a keyframe with {min(kf_matched)} matches")
        if [r["k1"] for r in rows] != [1] * len(rows):
            fail.append("K1 not launched once per frame")
        if not (all(k2_by.get(k, 0) > 0 for k in ("motion_model", "local_map", "fusion"))
                and sum(k2_by.values()) == launches[1]):
            fail.append("K2 not launched by the motion-model, local-map and fusion searches")
        if fail:
            raise AssertionError(f"[rgbd] the RGB-D phase failed: {fail}")

        # localization mode: the last frames retraced backwards
        counts_before = (m.n_keyframes(), m.n_points())
        reloc0 = stats["relocalizations"]
        system.activate_localization_mode()
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        n_by0 = dict(probe.k2_by_label)
        loc_rows, mb_vo = [], []
        ts = 2.0
        for what, (img, depth) in ([("retrace", f) for f in reversed(frames[-N_RETRACE:])]
                                   + [("leg", f) for f in leg]):
            loc_rows.append(dict(probe.frame(img, ts, depth=depth), what=what))
            mb_vo.append(system.tracker.mb_vo)
            ts += 1 / 30.0
        loc_launches = tuple(c.launches for c in counters)
        loc_by = {k: v - n_by0.get(k, 0) for k, v in probe.k2_by_label.items()
                  if v - n_by0.get(k, 0)}
        n_reloc = system.tracker.stats["relocalizations"] - reloc0
        for j, r in enumerate(loc_rows):
            log(f"[rgbd localization] {r['what']} {j}: {r['state']} inliers {r['inliers']} "
                f"{r['ms']:.1f} ms, launches K1 {r['k1']} K2 {r['k2']}, mb_vo {mb_vo[j]}")
        vo_ms = [r["ms"] for r, v in zip(loc_rows, mb_vo) if v]
        log(f"[rgbd localization] {N_RETRACE} frames retraced, {len(leg)} out of the map and "
            f"back; median {statistics.median(r['ms'] for r in loc_rows):.1f} ms per frame, "
            f"{statistics.median(vo_ms) if vo_ms else float('nan'):.1f} in mb_vo "
            f"({len(vo_ms)} frames); relocalizations {n_reloc}; launches K1 "
            f"{loc_launches[0]}, K2 {loc_launches[1]} (by search {json.dumps(loc_by)}), pack "
            f"{loc_launches[2]}")
        _localization_gates("rgbd", system, loc_rows, counts_before)
        fail = []
        if any(mb_vo[:N_RETRACE]) or not any(mb_vo) or mb_vo[-1]:
            fail.append(f"mb_vo {mb_vo}")
        if [r["k1"] for r in loc_rows] != [1] * len(loc_rows):
            fail.append("K1 not launched once per frame")
        if fail:
            raise AssertionError(f"[rgbd localization] failed: {fail}")
        # the leg ends at rest: its last view again
        _deactivate("rgbd", probe, system, leg[-1][0], ts, depth=leg[-1][1])
    del system
    k2_rows = {}
    for label in ("motion_model", "local_map"):
        if label not in recorded:
            raise AssertionError(f"[rgbd] no {label} search was recorded")
        a, kw = max(recorded[label], key=lambda c: int((c[0][4] >= 0).sum()))
        k2_rows[label] = measure_k2(
            torch, a, kw, f"rgbd {label} search ({int((a[4] >= 0).sum())} active queries)")
    return (launches, k2_by), (loc_launches, loc_by), k2_rows


def stereo_phase(torch, device, pairs):
    """Phase 16: stereo. The row matcher with its sub-pixel refinement
    (frame_ops.match_stereo_rows_subpix) at pair 0, on the features the
    stereo tracker extracts (the left image's uint8 copy, the right image
    as given): >= MIN_STEREO_MATCHES matches, median depth error under
    MAX_STEREO_DEPTH_ERR against the rendered depth, and the same matches
    on the CPU from the same features (indices and validity equal,
    disparities within STEREO_DISP_ATOL px); then the stereo System (the
    JAX defaults) over N_STEREO_FRAMES pairs: >= 1 keyframe, >=
    MIN_STEREO_TRACKED of the frames tracked, 0 lost, 0 resets, K1 twice
    per frame (left and right). Counts set to 0 just before the System
    run, read just after. Returns (launches K1, K2, pack; K2 by search)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch.slam import frame_ops
    from anyfeature_vslam_tpu_torch.system import System

    counters = _counters()
    cam, bf = plane_camera()
    system = System(cam, feature="orb32", n_features=N_FEATURES, sensor="stereo", bf=bf,
                    device=device)
    tracker = system.tracker
    img_l, img_r, depth = pairs[0]
    fl = tracker._extract(img_l, init=False)
    il, ir = (torch.from_numpy(x).to(device) for x in (img_l, img_r))
    fr = tracker.extractor(ir)
    keys = ("desc_bits", "xy", "size", "valid")
    args = (*(fl.dev(k) for k in keys), *(fr[k] for k in keys), tracker.cfg.match_th, 0.0,
            cam.fx)
    res = frame_ops.match_stereo_rows_subpix(il, ir, *args)
    cpu = frame_ops.match_stereo_rows_subpix(il.cpu(), ir.cpu(),
                                             *(a.cpu() if torch.is_tensor(a) else a
                                               for a in args))
    res = {k: v.cpu().numpy() for k, v in res.items()}
    cpu = {k: v.numpy() for k, v in cpu.items()}
    ms = time_ms(torch, lambda: frame_ops.match_stereo_rows_subpix(il, ir, *args), reps=10)
    ok = res["valid"] & (res["disparity"] > 0)
    xy = fl["xy"][ok]
    z_gt = depth[np.clip(np.rint(xy[:, 1]).astype(int), 0, H - 1),
                 np.clip(np.rint(xy[:, 0]).astype(int), 0, W - 1)]
    rel = float(np.median(np.abs(bf / res["disparity"][ok] - z_gt) / z_gt)) \
        if ok.any() else float("nan")
    same_valid = bool(np.array_equal(res["valid"], cpu["valid"]))
    same_idx = bool(np.array_equal(res["idx"][res["valid"]], cpu["idx"][cpu["valid"]])) \
        if same_valid else False
    disp_err = float(np.abs(res["disparity"] - cpu["disparity"]).max())
    log(f"[stereo] row matcher at pair 0: {int(ok.sum())} matches of "
        f"{int(fl['valid'].sum())} left / {int(fr['valid'].sum())} right keypoints; median "
        f"depth error {100 * rel:.3f}%; card vs CPU: validity equal {same_valid}, indices "
        f"equal {same_idx}, max disparity difference {disp_err:.3g} px; eager {ms:.3f} ms")
    fail = []
    if ok.sum() < MIN_STEREO_MATCHES or not rel < MAX_STEREO_DEPTH_ERR:
        fail.append(f"{int(ok.sum())} matches, median depth error {rel:.4f}")
    if not (same_valid and same_idx and disp_err <= STEREO_DISP_ATOL):
        fail.append("the card's stereo matches differ from the CPU's")
    if fail:
        raise AssertionError(f"[stereo] the row matcher failed: {fail}")

    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    rows = []
    t0 = time.perf_counter()
    with SystemProbe(torch, system, device, staged=True) as probe:
        for i, (left, right, _) in enumerate(pairs):
            rows.append(probe.frame(left, i / 30.0, right=right))
        launches = tuple(c.launches for c in counters)
        k2_by = dict(probe.k2_by_label)
    wall = time.perf_counter() - t0
    stats = system.tracker.stats
    for i, r in enumerate(rows):
        log(f"[stereo] frame {i}: {r['state']} kfs {r['kfs']} pts {r['pts']} inliers "
            f"{r['inliers']} {r['ms']:.1f} ms, events {r['events']}, launches K1 {r['k1']} "
            f"K2 {r['k2']} pack {r['pack']}")
    plain_ms, n_plain, ev_ms, n_ev = _frame_stats(rows)
    log(f"[stereo] {len(rows)} pairs in {wall:.1f} s; {system.map.n_keyframes()} keyframes, "
        f"{system.map.n_points()} points; tracked {stats['tracked_frames']}, lost "
        f"{stats['lost_frames']}, resets {stats['resets']}; median ms per frame after init+1: "
        f"without an event {plain_ms:.1f} ({n_plain}), with one {ev_ms:.1f} ({n_ev}); "
        f"launches K1 {launches[0]}, K2 {launches[1]} (by search {json.dumps(k2_by)}), pack "
        f"{launches[2]}")
    fail = []
    if system.map.n_keyframes() < 1 or stats["lost_frames"] or stats["resets"] or \
            stats["tracked_frames"] < MIN_STEREO_TRACKED * N_STEREO_FRAMES:
        fail.append(f"{system.map.n_keyframes()} keyframes, stats {stats}")
    if [r["k1"] for r in rows] != [2] * len(rows):
        fail.append(f"K1 launches per frame {[r['k1'] for r in rows]}, not 2")
    if fail:
        raise AssertionError(f"[stereo] the stereo System failed: {fail}")
    return launches, k2_by


# ---------------------------------------------------------------- phases 17-19
ORBVOC_K, ORBVOC_L = 10, 6  # ORBvoc.txt's shape: 1,111,111 nodes, 10^6 words
N_ORBVOC_QUERIES = 1000
N_MESH_FRAMES = 24
MIN_MESH_TRACKED = 22
# bounds of the BA comparisons on a real local-BA problem: those of
# tests/test_sharded_ba.py (poses 5e-4, points 5e-3) and
# tests/test_point_sharded_ba.py (chi2 2e-2 relative + 5e-2) between
# solves of the CG path (sharded or not; CUDA's index_add_ sums in no
# fixed order, so two runs of one solve differ in the last bits). On a
# real map a point seen at low parallax slides along its ray (0.08% of
# the points beyond 5e-3 between one and two ranks, first card run), so
# the point bound holds for >= 99% of the points, and the final costs
# agree within 1e-3 relative. Against the dense solve, only the cost is
# held: the dense and the CG solve reach the same cost (1.8e-7 relative)
# 2.5e-3 apart in the poses, along a direction the local BA leaves
# almost free (first card run)
MAX_BA_POSE_DIFF = 5e-4
MAX_BA_POINT_DIFF = 5e-3
MIN_BA_POINT_SHARE = 0.99
MAX_BA_COST_REL = 1e-3
# card against CPU, compensated (tests/test_torch_ba_compensated.py)
MAX_COMP_POSE_DIFF = 1e-4
MAX_COMP_POINT_DIFF = 1e-3
N_COMP_CPU_ITERS = 3


def orbvoc_shaped_tree(seed=0):
    """A balanced DBoW2 tree of ORBvoc.txt's shape (k = 10, L = 6, 32-byte
    rows), its node rows drawn from `seed`: the port's Dbow2Vocabulary,
    built in memory (parsing 1.1M text lines would take minutes)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch.place_recognition import dbow2_io

    k, depth = ORBVOC_K, ORBVOC_L
    n_nodes = sum(k ** l for l in range(depth + 1))
    rng = np.random.default_rng(seed)
    node_desc = np.zeros((n_nodes, 256), np.uint8)
    node_desc[1:] = dbow2_io._bytes_to_bitplanes(
        rng.integers(0, 256, (n_nodes - 1, 32), dtype=np.uint8))
    # breadth first: node i's children are k * i + 1 .. k * i + k
    n_inner = n_nodes - k ** depth
    children = np.full((n_nodes, k), -1, np.int32)
    children[:n_inner] = (k * np.arange(n_inner)[:, None] + 1 + np.arange(k)).astype(np.int32)
    leaf_word = np.full(n_nodes, -1, np.int32)
    leaf_word[n_inner:] = np.arange(k ** depth, dtype=np.int32)
    weights = rng.uniform(0.5, 8.0, k ** depth).astype(np.float32)
    return dbow2_io.Dbow2Vocabulary(branching=k, depth=depth, children=children,
                                    node_desc=node_desc, leaf_word=leaf_word,
                                    word_weight=weights, fold=k ** depth)


def dbow2_phase(torch, device, frames, ext):
    """Phase 17: the shipped orb32 tree written as DBoW2 text and loaded;
    words of frame FIRST_TRACKED's descriptors on the card against the CPU
    and the native tree; an ORBvoc.txt-shaped tree's words for 1000
    descriptors, card against CPU (descent ms, device memory held); phase
    8's System on the .txt vocabulary (phase 8's gates, BoW ms per event,
    K1 / K2 launches). Returns (the System, its scene, the .txt path's
    directory handle, launches (K1, K2, pack), K2 by search, the last
    local-BA problem)."""
    import tempfile

    import numpy as np

    from anyfeature_vslam_tpu_torch import perfcount
    from anyfeature_vslam_tpu_torch.place_recognition import dbow2_io, vocab
    from torch_slice_scene import FIRST_TRACKED

    tmp = tempfile.TemporaryDirectory()
    npz = os.path.join(ROOT, "vocabularies", "voc_orb32_38k.npz")
    txt = os.path.join(tmp.name, "orb32_DBoW2_voc.txt")
    native = vocab.Vocabulary.load(npz)
    t0 = time.perf_counter()
    dbow2_io.save_dbow2_text(native, txt)
    t1 = time.perf_counter()
    dvoc = vocab.Vocabulary.load(txt)
    t2 = time.perf_counter()
    log(f"[dbow2] {npz} -> DBoW2 text ({os.path.getsize(txt) / 2**20:.1f} MiB) in "
        f"{(t1 - t0) * 1e3:.1f} ms, loaded in {(t2 - t1) * 1e3:.1f} ms: k {dvoc.branching}, L "
        f"{dvoc.depth}, {len(dvoc.leaf_word)} nodes, {dvoc.n_words} words")
    fail = []
    if not (isinstance(dvoc, dbow2_io.Dbow2Vocabulary) and dvoc.n_words == native.n_words
            and np.array_equal(dvoc.idf, native.idf)):
        fail.append("the .txt tree is not the .npz tree")
    feats = ext(torch.from_numpy(frames[FIRST_TRACKED]).to(device).float())
    desc, valid = feats["desc_bits"], feats["valid"]
    w_card = vocab.transform_words(dvoc, desc, valid)
    w_cpu = vocab.transform_words(dvoc, desc.cpu(), valid.cpu())
    w_native = vocab.transform_words(native, desc, valid)
    ms_txt = time_ms(torch, lambda: vocab.transform_words(dvoc, desc, valid))
    ms_native = time_ms(torch, lambda: vocab.transform_words(native, desc, valid))
    same_cpu = bool(torch.equal(w_card.cpu(), w_cpu))
    same_native = bool(torch.equal(w_card, w_native))
    log(f"[dbow2] frame {FIRST_TRACKED}: {int(valid.sum())} descriptors; words on the card "
        f"equal the CPU's {same_cpu}, the native tree's {same_native}; descent "
        f"{ms_txt:.3f} ms (.txt tree), {ms_native:.3f} ms (native tree), eager")
    if not (same_cpu and same_native):
        fail.append("frame words differ")

    t0 = time.perf_counter()
    big = orbvoc_shaped_tree()
    t_build = time.perf_counter() - t0
    q = desc[valid][:N_ORBVOC_QUERIES].contiguous()
    qv = torch.ones(len(q), dtype=torch.bool, device=device)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    wb_card = dbow2_io.transform_words_dbow2(big, q, qv)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - mem0
    wb_cpu = dbow2_io.transform_words_dbow2(big, q.cpu(), qv.cpu())
    ms_big = time_ms(torch, lambda: dbow2_io.transform_words_dbow2(big, q, qv))
    same_big = bool(torch.equal(wb_card.cpu(), wb_cpu))
    log(f"[dbow2] ORBvoc-shaped tree (k {ORBVOC_K}, L {ORBVOC_L}, {len(big.leaf_word)} nodes, "
        f"{big.n_words} words; built on the host in {t_build:.1f} s): {len(q)} descriptors, "
        f"words on the card equal the CPU's {same_big}; descent {ms_big:.3f} ms eager; device "
        f"memory held by the tree {held / 2**20:.1f} MiB; {len(np.unique(wb_cpu.numpy()))} "
        f"distinct words")
    if not same_big:
        fail.append("ORBvoc-shaped words differ")
    del big, wb_card
    if fail:
        raise AssertionError(f"the DBoW2 phase failed: {fail}")

    counters = _counters()
    torch.cuda.synchronize()
    perfcount.reset()
    record_spans()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    system, rows, events, sc, k2_by, _ = system_run(
        torch, W, H, N_SYSTEM_FRAMES, device, frames=frames, async_mapping=False,
        vocabulary_path=txt)
    wall = time.perf_counter() - t0
    k1, k2, pack = (c.launches for c in counters)
    stats = system.tracker.stats
    kf_ate, fr_ate, n_kf, n_fr, _ = ate(system, sc)
    bow = span_seconds("loop.").get("bow", [])
    log(f"[dbow2 system] {N_SYSTEM_FRAMES} frames {W}x{H} on the .txt vocabulary in {wall:.1f} "
        f"s: tracked {stats['tracked_frames']}, lost {stats['lost_frames']}, resets "
        f"{stats['resets']}; {system.map.n_keyframes()} keyframes, {system.map.n_points()} "
        f"points; ATE (Sim3-aligned) keyframes {kf_ate:.5f} m over {n_kf}, frames {fr_ate:.5f} "
        f"m over {n_fr}; BoW per event: median "
        f"{statistics.median(bow) * 1e3 if bow else float('nan'):.2f} ms over {len(bow)} events")
    loop_stage_line(system, "dbow2 system")
    log(f"[dbow2 system] launches: K1 {k1}, K2 {k2} (by search {json.dumps(k2_by)}), pack "
        f"{pack}")
    if stats["resets"] != 0:
        fail.append(f"{stats['resets']} resets")
    if stats["tracked_frames"] < MIN_SYSTEM_TRACKED:
        fail.append(f"{stats['tracked_frames']} tracked frames")
    if not kf_ate < MAX_ATE_M:
        fail.append(f"keyframe ATE {kf_ate:.4f} m")
    if not isinstance(system.vocabulary, dbow2_io.Dbow2Vocabulary) or not bow \
            or len(system.loop_times) != len(events):
        fail.append("the loop stage did not run on the .txt vocabulary")
    if min(r["k1"] for r in rows) < 1 or k2 < 1 or pack < 1:
        fail.append("a kernel of the path was not launched")
    if system.local_mapper.last_ba_problem is None:
        fail.append("no local BA was recorded")
    if fail:
        raise AssertionError(f"the DBoW2 System failed: {fail}")
    return system, sc, tmp, (k1, k2, pack), k2_by, system.local_mapper.last_ba_problem


def _decode_png(path):
    """(H, W, 3) uint8 pixels and the tEXt chunks of an 8-bit RGB PNG
    whose rows use filter type 0 (what io/viewer.write_png writes)."""
    import struct
    import zlib

    import numpy as np

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    at, idat, text, hdr = 8, b"", {}, None
    while at < len(data):
        n, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        crc = struct.unpack(">I", data[at + 8 + n:at + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"bad CRC in {kind}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"tEXt":
            key, value = body.split(b"\0", 1)
            text[key.decode("latin-1")] = value.decode("latin-1")
        at += 12 + n
    w, h, bits, color = hdr[:4]
    if (bits, color) != (8, 2):
        raise AssertionError(f"not 8-bit RGB: {hdr}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError("a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3), text


def viewer_phase(system, frames):
    """Phase 18: save_outputs of phase 17's System (a parseable map SVG:
    one circle per valid point, one square per keyframe) and render_frame
    of its last frame (the PNG decoded with zlib: its pixels the returned
    array, its slam_state the tracker's state, a box of the right colour at
    >= 99% of the tracked and untracked keypoint positions, no pixel of
    another colour)."""
    import tempfile
    import xml.etree.ElementTree as ET

    import numpy as np

    fail = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        system.save_outputs(tmp, "smoke")
        t_save = time.perf_counter() - t0
        svg = os.path.join(tmp, "smoke_map.svg")
        root = ET.parse(svg).getroot()
        n_circle = sum(el.tag.endswith("circle") for el in root)
        n_rect = sum(el.tag.endswith("rect") for el in root) - 1  # the background
        n_path = sum(el.tag.endswith("path") for el in root)
        log(f"[viewer] save_outputs in {t_save * 1e3:.1f} ms; map.svg "
            f"{os.path.getsize(svg) / 1024:.1f} KiB: {n_circle} circles ({system.map.n_points()} "
            f"points), {n_rect} keyframe squares ({system.map.n_keyframes()} keyframes), "
            f"{n_path} trajectory path; files {sorted(os.listdir(tmp))}")
        if (n_circle, n_rect, n_path) != (system.map.n_points(), system.map.n_keyframes(), 1):
            fail.append("the map SVG does not hold the map")
        img = frames[-1]  # the last frame the System tracked
        png = os.path.join(tmp, "frame.png")
        t0 = time.perf_counter()
        out = system.render_frame(img, path=png)
        t_render = time.perf_counter() - t0
        pixels, text = _decode_png(png)
        f = system.tracker.last
        xy, valid = f.feats["xy"], f.feats["valid"]
        u = np.round(xy[:, 0].astype(np.float64)).astype(int)
        v = np.round(xy[:, 1].astype(np.float64)).astype(int)
        h, w = img.shape
        shown = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        tracked = shown & (f.matches >= 0)
        # one box per keypoint position, in the colour of the last keypoint
        # drawn there (keypoints of two pyramid levels can round to one
        # pixel); a box is there when a pixel of its 7x7 outline (clipped to
        # the image, as drawn) shows that colour: later boxes overdraw
        # parts of earlier ones
        last = {}
        for i in np.nonzero(shown)[0]:
            last[(int(u[i]), int(v[i]))] = bool(tracked[i])
        pos = np.array(list(last), dtype=np.int64).reshape(-1, 2)
        is_green = np.array(list(last.values()), bool)
        d = np.arange(-3, 4)
        ring = np.array([(dy, dx) for dy in d for dx in d if max(abs(dy), abs(dx)) == 3])
        ys = np.clip(pos[:, 1:2] + ring[:, 0], 0, h - 1)
        xs = np.clip(pos[:, 0:1] + ring[:, 1], 0, w - 1)
        outline = out[ys, xs]  # (boxes, 24, 3)
        green = (outline == (90, 230, 90)).all(-1).any(-1)
        blue = (outline == (110, 160, 255)).all(-1).any(-1)
        n_green, n_blue = int(green[is_green].sum()), int(blue[~is_green].sum())
        n_tracked, n_untracked = int(is_green.sum()), int((~is_green).sum())
        coloured = (out[..., 0] != out[..., 1]) | (out[..., 1] != out[..., 2])
        stray = int((coloured & ~(out == (90, 230, 90)).all(-1)
                     & ~(out == (110, 160, 255)).all(-1)).sum())
        log(f"[viewer] render_frame in {t_render * 1e3:.1f} ms ({os.path.getsize(png) / 1024:.1f} "
            f"KiB PNG): pixels equal the returned array {np.array_equal(pixels, out)}; "
            f"slam_state {text.get('slam_state')!r} (tracker {system.tracker.state.name}); "
            f"{int(shown.sum())} keypoints in the image at {len(pos)} positions: green boxes at "
            f"{n_green} of {n_tracked} tracked positions, blue at {n_blue} of {n_untracked} "
            f"untracked; {stray} pixels of another colour")
        if not np.array_equal(pixels, out) or text.get("slam_state") != system.tracker.state.name:
            fail.append("the PNG is not the overlay")
        if n_green < 0.99 * n_tracked or n_blue < 0.99 * n_untracked or n_tracked < 100 \
                or stray:
            fail.append("the boxes do not match the keypoints")
    if fail:
        raise AssertionError(f"the viewer phase failed: {fail}")


def _ba_compare(tag, got, want, n_pt, valid, pose_tol=MAX_BA_POSE_DIFF,
                point_tol=MAX_BA_POINT_DIFF, share=MIN_BA_POINT_SHARE, cost_only=False):
    """got / want: (poses, points, chi2) as numpy. The poses' largest
    difference, the share of the live points within point_tol, and the
    final costs (the sum of chi2 over the valid observations), all
    gated unless cost_only (the cost alone: a CG solve against the dense
    one). Returns a failure text or None."""
    import numpy as np

    dp = float(np.abs(got[0] - want[0]).max())
    dx = np.linalg.norm(got[1][:n_pt] - want[1][:n_pt], axis=1)
    within = float((dx <= point_tol).mean())
    c_got, c_want = (float(np.sum(np.where(valid, c, 0.0), dtype=np.float64))
                     for c in (got[2], want[2]))
    rel = abs(c_got - c_want) / max(abs(c_want), 1e-12)
    log(f"[ba layouts] {tag}: poses {dp:.3g} apart, points {float(np.median(dx)):.3g} median / "
        f"{float(dx.max()):.3g} max apart ({within:.4f} within {point_tol:g}), final cost "
        f"{c_got:.6g} against {c_want:.6g} ({rel:.3g} relative)")
    if rel > MAX_BA_COST_REL or not (cost_only or (dp <= pose_tol and within >= share)):
        return tag
    return None


def ba_layouts_phase(torch, device, problem, intrinsics, frames):
    """Phase 19: the last local BA of phase 17's map at its real caps,
    solved as bundle_adjust_two_stage (dense) and as the unsharded CG
    two-stage solve, as sharded_bundle_adjust_two_stage over a one-rank
    NCCL group and over two gloo ranks in two processes on this card, as
    global_ba_point_sharded at one rank and two, and compensated on the
    card and the CPU, each held to its CG reference (the dense solve by
    its cost); then a System with use_mesh=True over phase 8's first 24
    frames. Returns (launches K1, K2, pack; K2 by search)."""
    import tempfile

    import numpy as np

    from anyfeature_vslam_tpu_torch import perfcount
    from anyfeature_vslam_tpu_torch.ops import ba
    from anyfeature_vslam_tpu_torch.parallel import point_sharded_ba, sharded_ba

    arrays, info = problem
    n_pt = info["n_pt"]
    args = [torch.from_numpy(a).to(device) for a in arrays] + list(intrinsics)
    valid = arrays[7]
    log(f"[ba layouts] the last local BA of phase 17: {info['n_kf']} keyframes, {n_pt} points, "
        f"{info['n_obs']} observations; caps k {info['k_cap']} p {info['p_cap']} o "
        f"{info['o_cap']} ({'dense' if info['dense'] else 'CG'} unsharded)")
    host = lambda ts: [t.cpu().numpy() if torch.is_tensor(t) else t for t in ts]  # noqa: E731

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    mesh = sharded_ba.make_mesh(device)
    mesh.all_reduce(torch.zeros(1, device=device))
    torch.cuda.synchronize()
    log(f"[ba layouts] one-rank NCCL group and its first all-reduce in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (left out of the timings)")
    fail = []
    try:
        ba.bundle_adjust_two_stage(*args)  # warm
        ref, ms_ref = timed(lambda: ba.bundle_adjust_two_stage(*args))
        cg, ms_cg = timed(lambda: ba.two_stage(ba._bundle_adjust_impl, *args))
        sh, ms_sh = timed(lambda: sharded_ba.sharded_bundle_adjust_two_stage(mesh, *args))
        log(f"[ba layouts] two-stage solve ms: bundle_adjust_two_stage {ms_ref:.1f}, the "
            f"unsharded CG {ms_cg:.1f}, sharded over the one-rank NCCL group {ms_sh:.1f}")
        hs, hr, hg = host(sh), host(ref), host(cg)
        # two-stage costs over the observations both solves keep
        fail.append(_ba_compare("one-rank NCCL sharded vs the unsharded CG two-stage solve",
                                (hs[0], hs[1], hs[2]), (hg[0], hg[1], hg[2]), n_pt,
                                hs[4] & hg[4]))
        fail.append(_ba_compare("one-rank NCCL sharded vs bundle_adjust_two_stage (dense)",
                                (hs[0], hs[1], hs[2]), (hr[0], hr[1], hr[2]), n_pt,
                                hs[4] & hr[4], cost_only=True))
        same_out = float((hs[4] == hr[4]).mean())
        log(f"[ba layouts] final observation sets equal on {same_out:.5f} of the observations")

        # two gloo ranks in two processes on this card. The map's padding
        # lies at the end of the observations and points, so the problem
        # is spread first (observations alternating between the ranks'
        # halves, the points in a seeded order): both ranks then hold real
        # observations and points, and the sums really cross the ranks
        o_cap, p_cap = len(arrays[3]), len(arrays[1])
        obs_perm = np.concatenate([np.arange(0, o_cap, 2), np.arange(1, o_cap, 2)])
        pt_perm = np.random.default_rng(0).permutation(p_cap)
        pt_inv = np.argsort(pt_perm)
        with tempfile.TemporaryDirectory() as tmp:
            prob = os.path.join(tmp, "prob.npz")
            np.savez(prob, poses=arrays[0], pts=arrays[1][pt_perm], kf_free=arrays[2],
                     obs_kf=arrays[3][obs_perm], obs_pt=pt_inv[arrays[4][obs_perm]],
                     obs_uv=arrays[5][obs_perm], obs_w=arrays[6][obs_perm],
                     obs_valid=arrays[7][obs_perm], intr=np.array(intrinsics), n_iters=10,
                     solves="two_stage,point")
            outs = [os.path.join(tmp, f"out{r}.npz") for r in range(2)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, "-m",
                                       "anyfeature_vslam_tpu_torch.parallel.rank_worker", prob,
                                       str(r), "2", os.path.join(tmp, "store"),
                                       torch.device(device).type, outs[r]],
                                      cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for r in range(2)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=300)[0])
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
            wall = time.perf_counter() - t0
            for r, (p, out) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    log(out[-3000:])
                    raise AssertionError(f"gloo rank {r} failed")
            r0, r1 = (dict(np.load(o)) for o in outs)
        same = all(np.array_equal(r0[k], r1[k]) for k in r0 if not k.startswith("ms_"))
        for k in ("ts_pts", "ps_pts"):
            r0[k] = r0[k][pt_inv]
        for k in ("ts_chi2", "ts_valid", "ps_chi2"):
            back = np.empty_like(r0[k])
            back[obs_perm] = r0[k]
            r0[k] = back
        log(f"[ba layouts] two gloo ranks on the card ({wall:.1f} s with process start): the ranks "
            f"agree {same}; rank 0 ms: two-stage {float(r0['ms_two_stage']):.1f}, point-sharded "
            f"{float(r0['ms_point']):.1f}")
        if not same:
            fail.append("the gloo ranks disagree")
        fail.append(_ba_compare("two gloo ranks vs the one-rank sharded solve",
                                (r0["ts_poses"], r0["ts_pts"], r0["ts_chi2"]),
                                (hs[0], hs[1], hs[2]), n_pt, hs[4] & r0["ts_valid"]))

        one, ms_one = timed(lambda: ba.bundle_adjust(*args))
        one_cg, ms_one_cg = timed(lambda: ba._bundle_adjust_impl(*args))
        ps, ms_ps = timed(lambda: point_sharded_ba.global_ba_point_sharded(*args, mesh=mesh))
        ho, hog = host(one), host(one_cg)
        log(f"[ba layouts] single stage ms: bundle_adjust (dense) {ms_one:.1f}, the unsharded "
            f"CG {ms_one_cg:.1f}, global_ba_point_sharded at one rank {ms_ps:.1f} (host "
            f"partition included)")
        fail.append(_ba_compare("one-rank point-sharded vs the unsharded CG solve",
                                (ps[0], ps[1], ps[2]), (hog[0], hog[1], hog[2]), n_pt, valid))
        fail.append(_ba_compare("one-rank point-sharded vs bundle_adjust (dense)",
                                (ps[0], ps[1], ps[2]), (ho[0], ho[1], ho[2]), n_pt, valid,
                                cost_only=True))
        fail.append(_ba_compare("two gloo ranks point-sharded vs one rank",
                                (r0["ps_poses"], r0["ps_pts"], r0["ps_chi2"]),
                                (ps[0], ps[1], ps[2]), n_pt, valid))
        chi_share = float(np.isclose(ps[2][valid], hog[2][valid], rtol=2e-2, atol=5e-2).mean())
        log(f"[ba layouts] point-sharded chi2 within 2e-2 relative + 5e-2 of the unsharded CG "
            f"solve's: {chi_share:.5f} of the valid observations")
        if chi_share < MIN_BA_POINT_SHARE:
            fail.append("point-sharded chi2")

        comp, ms_comp = timed(lambda: ba.bundle_adjust(*args, compensated=True))
        hc = host(comp)
        fail.append(_ba_compare("compensated vs plain (the CG solve), card",
                                (hc[0], hc[1], hc[2]), (hog[0], hog[1], hog[2]), n_pt, valid))
        # card against CPU over N_COMP_CPU_ITERS LM steps (the CPU's CG
        # solve at these caps takes tens of seconds per 10 steps)
        comp3, ms_comp3 = timed(lambda: ba.bundle_adjust(*args, n_iters=N_COMP_CPU_ITERS,
                                                         compensated=True))
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
        t0 = time.perf_counter()
        comp3_cpu = ba.bundle_adjust(*cpu_args, n_iters=N_COMP_CPU_ITERS, compensated=True)
        ms_comp3_cpu = (time.perf_counter() - t0) * 1e3
        hc3, hcc3 = host(comp3), host(comp3_cpu)
        log(f"[ba layouts] compensated bundle_adjust ms: card {ms_comp:.1f} (10 LM steps), "
            f"{ms_comp3:.1f} ({N_COMP_CPU_ITERS} steps); CPU {ms_comp3_cpu:.1f} "
            f"({N_COMP_CPU_ITERS} steps)")
        fail.append(_ba_compare("compensated card vs CPU", (hc3[0], hc3[1], hc3[2]),
                                (hcc3[0], hcc3[1], hcc3[2]), n_pt, valid,
                                pose_tol=MAX_COMP_POSE_DIFF, point_tol=MAX_COMP_POINT_DIFF))

        # a System with use_mesh=True over phase 8's first frames
        counters = _counters()
        torch.cuda.synchronize()
        perfcount.reset()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        system, rows, events, sc, k2_by, _ = system_run(
            torch, W, H, N_MESH_FRAMES, device, frames=frames, async_mapping=False,
            use_mesh=True)
        wall = time.perf_counter() - t0
        k1, k2, pack = (c.launches for c in counters)
        stats = system.tracker.stats
        kf_ate, fr_ate, n_kf, n_fr, _ = ate(system, sc)
        lm = system.local_mapper
        log(f"[mesh system] {N_MESH_FRAMES} frames {W}x{H} with use_mesh=True (one-rank group "
            f"of size {system.mesh.size}) in {wall:.1f} s: tracked {stats['tracked_frames']}, "
            f"lost {stats['lost_frames']}, resets {stats['resets']}; "
            f"{system.map.n_keyframes()} keyframes; ATE (Sim3-aligned) keyframes {kf_ate:.5f} m "
            f"over {n_kf}, frames {fr_ate:.5f} m over {n_fr}; {len(events)} events, median "
            f"{statistics.median(e['ms'] for e in events) if events else float('nan'):.1f} ms")
        ba_lines(lm.ba_log, "mesh system", "local BA (sharded)")
        log(f"[mesh system] launches: K1 {k1}, K2 {k2} (by search {json.dumps(k2_by)}), pack "
            f"{pack}")
        if stats["resets"] != 0 or stats["tracked_frames"] < MIN_MESH_TRACKED \
                or not kf_ate < MAX_ATE_M:
            fail.append(f"the mesh System's gates ({stats['resets']} resets, "
                        f"{stats['tracked_frames']} tracked, keyframe ATE {kf_ate:.4f} m)")
        if not lm.ba_log or not all(b.get("mesh") == 1 and not b["dense"] for b in lm.ba_log):
            fail.append("a local BA of the mesh System was not sharded")
        if min(r["k1"] for r in rows) < 1 or k2 < 1 or pack < 1:
            fail.append("a kernel of the path was not launched")
    finally:
        mesh.close()
    fail = [f for f in fail if f]
    if fail:
        raise AssertionError(f"the BA layouts phase failed: {fail}")
    return (k1, k2, pack), k2_by


# ---------------------------------------------------------------- phases 20-23
N_TOOL_FRAMES = 4  # frames make_synth_sequence renders itself in phase 20
N_RGB_FRAMES = 8   # phase 20's RGB frames through the FrameLoader
PLAIN_DECODE_EVERY = 6  # phase 20 decodes every 6th file with the plain unfilter too
VOCAB_ARGS = ("feature:orb32", "sample_every:6", "max_frames:8")
# the card's and the CPU's orb32 rows over those frames: 99.95% equal on
# the card (PERF.md section 6); a faulty extraction gives far fewer
MIN_VOCAB_AGREE = 0.999
# learned48 training on the card, cut for the script's time limit: 200
# steps (the tool's default 2000) on a 16-image corpus (default 160)
TRAIN_ARGS = dict(sequence_path="synthetic", seed="0", batch="512", steps="200",
                  n_corpus="16")
N_TRAIN_CPU_STEPS = 3
MAX_TRAIN_LOSS_REL = 1e-5
MAX_DESC_NORM_ERR = 1e-5


def filtered_png(path, img, filters=(0, 1, 2, 3, 4)):
    """An 8-bit gray (H, W) or RGB (H, W, 3) PNG of `img` whose every row
    takes, of `filters`, the filter type with the smallest sum of absolute
    values of its bytes read as signed (libpng's adaptive heuristic; the
    first such type on ties). The filters read the original pixels only,
    so every row's five candidates are computed at once in numpy.
    filters=(4,): every row Paeth, the slowest to undo."""
    import struct
    import zlib

    import numpy as np

    from anyfeature_vslam_tpu_torch.io import png

    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    raw = img.reshape(h, w * bpp).astype(np.int64)
    zero_col = np.zeros((h, bpp), np.int64)
    prior = np.vstack([np.zeros((1, raw.shape[1]), np.int64), raw[:-1]])
    left = np.hstack([zero_col, raw[:, :-bpp]])
    upleft = np.hstack([zero_col, prior[:, :-bpp]])
    p = left + prior - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
    preds = {0: 0, 1: left, 2: prior, 3: (left + prior) >> 1, 4: paeth}
    cand = np.stack([(raw - preds[f]) % 256 for f in filters])       # (F, H, stride)
    cost = np.minimum(cand, 256 - cand).sum(-1)                       # (F, H)
    pick = np.argmin(cost, axis=0)
    rows = np.take_along_axis(cand, pick[None, :, None], 0)[0].astype(np.uint8)
    kinds = np.asarray(filters, np.uint8)[pick][:, None]
    ctype = 0 if img.ndim == 2 else 2

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.hstack([kinds, rows]).tobytes(), 6))
                + chunk(b"IEND", b""))
    return np.bincount(pick, minlength=len(filters))


def _run_tool(main, argv):
    """A tool's main(argv) with its stdout captured and logged; returns
    (exit code, printed lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"    {line}")
    return rc, lines


def write_cli_sequence(root, frames):
    """Phase 20's files: the bench sequence (make_synth_sequence's seed 3,
    radius 0.8, revisit 0.2; 150 frames) cut to its first len(`frames`)
    frames, written to root/seq as the tool lays it out: the rendered
    `frames` through filtered_png (libpng's adaptive row filters, as real
    sequences are saved), the text files through the tool's poses_for and
    write_sequence_files. The tool itself writes the first N_TOOL_FRAMES
    frames to root/tool; its PNGs must equal io/png.write_png's files of
    the same rendered frames (root/ref) byte for byte, and its text files
    must be the first lines of these. Returns (root/seq, failures)."""
    import numpy as np

    from anyfeature_vslam_tpu_torch.io import png
    from anyfeature_vslam_tpu_torch.tools import make_synth_sequence as mss

    seq, tool = os.path.join(root, "seq"), os.path.join(root, "tool")
    t0 = time.perf_counter()
    rc, _ = _run_tool(mss.main, [f"out_dir:{tool}", "n_frames:150",
                                 f"max_frames:{N_TOOL_FRAMES}", f"width:{W}", f"height:{H}",
                                 "revisit:0.2", "radius:0.8", "seed:3"])
    t_tool = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(os.path.join(seq, "rgb"))
    used = sum(filtered_png(os.path.join(seq, f"rgb/{i:06d}.png"), np.ascontiguousarray(img))
               for i, img in enumerate(frames))
    mss.write_sequence_files(seq, mss.poses_for("circle", 150, 0.2, 0.8)[:len(frames)], 30.0,
                             W, H)
    t_write = time.perf_counter() - t0
    ref = os.path.join(root, "ref")
    os.makedirs(ref)
    for i in range(N_TOOL_FRAMES):
        png.write_png(os.path.join(ref, f"{i:06d}.png"), np.ascontiguousarray(frames[i]))

    def read(*parts):
        with open(os.path.join(*parts), "rb") as f:
            return f.read()

    same_png = all(read(tool, f"rgb/{i:06d}.png") == read(ref, f"{i:06d}.png")
                   for i in range(N_TOOL_FRAMES))
    same_text = all(read(seq, name).startswith(read(tool, name).rstrip(b"\n"))
                    for name in ("rgb.csv", "groundtruth.csv")) and \
        read(seq, "calibration.yaml") == read(tool, "calibration.yaml")
    log(f"[cli] make_synth_sequence rendered and wrote frames 0-{N_TOOL_FRAMES - 1} in "
        f"{t_tool:.1f} s; the rendered bench frames written as its {len(frames)}-frame "
        f"sequence in {t_write:.1f} s, rows by filter type (None, Sub, Up, Average, Paeth) "
        f"{used.tolist()}; its PNGs equal write_png's byte for byte: {same_png}, its text "
        f"files the first lines: {same_text}")
    fail = [] if rc == 0 else [f"make_synth_sequence exited {rc}"]
    if not (same_png and same_text):
        fail.append("the tool's files differ from the sequence written")
    return seq, fail


@contextlib.contextmanager
def probed_run_sequence(torch, device, sync_sites, sync_frames):
    """While active, the System that system.run_sequence builds runs under
    a SystemProbe (sync=False): each track_monocular call is tracked
    through probe.frame, host syncs counted into `sync_sites` over the
    first `sync_frames` frames. Yields a dict whose "probe" and "rows"
    (probe.frame's, with "sync_counted") fill in as the run goes."""
    from anyfeature_vslam_tpu_torch import system as system_mod

    base = system_mod.System
    got = dict(rows=[])
    probes = contextlib.ExitStack()

    class Probed(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._in_probe = False
            got["probe"] = probes.enter_context(
                SystemProbe(torch, self, device, sync_sites=sync_sites, sync=False))

        def track_monocular(self, img, ts, image_path=None):
            if self._in_probe:  # probe.frame's own call
                got["state"] = super().track_monocular(img, ts, image_path=image_path)
                return got["state"]
            counted = len(got["rows"]) < sync_frames
            self._in_probe = True
            try:
                with sync_counter(torch, sync_sites) if counted else contextlib.nullcontext():
                    row = got["probe"].frame(img, ts, image_path)
            finally:
                self._in_probe = False
            got["rows"].append(dict(row, sync_counted=counted))
            return got["state"]

    system_mod.System = Probed
    try:
        with probes:
            yield got
    finally:
        system_mod.System = base


def timed_decode(paths, unfilter):
    """load_gray of each path with io/png's unfilter swapped for
    `unfilter` (the compiled routine or its plain twin): (frames, ms per
    frame, of which unfilter's ms per frame)."""
    from anyfeature_vslam_tpu_torch.io import dataset, png

    spent = []

    def shim(*a):
        t0 = time.perf_counter()
        try:
            return unfilter(*a)
        finally:
            spent.append(time.perf_counter() - t0)

    base, png.unfilter = png.unfilter, shim
    try:
        t0 = time.perf_counter()
        imgs = [dataset.load_gray(p) for p in paths]
        wall = time.perf_counter() - t0
    finally:
        png.unfilter = base
    return imgs, wall * 1e3 / len(paths), sum(spent) * 1e3 / len(paths)


def loader_lines(system, n, wall, plain_ms, n_plain):
    """The run's FrameLoader readings (system.frame_loader, set by
    run_sequence): every frame read through it, the reader thread's decode
    and the tracking thread's wait in get(i). Returns failures."""
    import numpy as np

    ld = system.frame_loader
    dec = np.array(list(ld.decode_s.values())) * 1e3
    wait = np.array(ld.wait_s) * 1e3
    log(f"[native] FrameLoader over {n} adaptive-filter PNG frames {W}x{H}: the reader "
        f"thread's decode {dec.mean():.3f} ms per frame (median {np.median(dec):.3f}, max "
        f"{dec.max():.3f}); the tracking thread's wait in get(i) median "
        f"{np.median(wait):.3f} ms, p90 {np.percentile(wait, 90):.3f} ms, max "
        f"{wait.max():.3f} ms over {len(wait)} calls; run_mono {wall * 1e3 / n:.1f} ms per "
        f"frame; the plain unfilter's decode {plain_ms:.3f} ms per frame ({n_plain} of the "
        f"files, host); {CARD[0]}")
    if len(wait) != n or len(dec) != n:
        return [f"{len(wait)} frames of {n} read through the FrameLoader"]
    return []


def rgb_loader_check(root, frames):
    """8 RGB 640x480 frames with adaptive row filters: the FrameLoader's
    frames equal load_gray's through the plain unfilter, byte for byte;
    decode and unfilter ms per frame, compiled and plain. Returns
    failures."""
    import numpy as np

    from anyfeature_vslam_tpu_torch import native
    from anyfeature_vslam_tpu_torch.io import png

    os.makedirs(os.path.join(root, "rgb8"))
    paths, used = [], 0
    for i, f in enumerate(frames[:N_RGB_FRAMES]):
        paths.append(os.path.join(root, f"rgb8/{i}.png"))
        used = used + filtered_png(paths[-1], np.dstack([f, np.roll(f, 9, axis=1), 255 - f]))
    with native.FrameLoader(paths, H, W) as ld:
        got = [ld.get(i) for i in range(len(paths))]
        dec_ms = 1e3 * sum(ld.decode_s.values()) / len(paths)
    plain, plain_ms, plain_unf = timed_decode(paths, png.unfilter_plain)
    comp, comp_ms, comp_unf = timed_decode(paths, png.unfilter)
    same = all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(got, plain, comp))
    log(f"[native] {len(paths)} RGB frames {W}x{H}, rows by filter type {used.tolist()}: the "
        f"FrameLoader's frames equal the plain unfilter's decode byte for byte: {same}; "
        f"unfilter {comp_unf:.3f} ms per frame compiled, {plain_unf:.3f} ms plain; load_gray "
        f"{comp_ms:.3f} ms compiled, {plain_ms:.3f} ms plain; the reader thread "
        f"{dec_ms:.3f} ms per frame; {CARD[0]}")
    return [] if same else ["the FrameLoader's RGB frames differ from the plain decode"]


def map_kernels_check(slam_map):
    """The host library's map kernels on a System's final map against their
    numpy twins: counts, weights (every keyframe) and the covisibility
    matrix exactly, the point statistics of every valid point (on copies)
    bit for bit; ms per call. Returns failures."""
    import numpy as np

    from anyfeature_vslam_tpu_torch import native

    m = slam_map
    kfs = m.keyframe_ids()
    pts = np.nonzero(m.pt_valid)[0]

    def ms(fn, reps):
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            t.append(time.perf_counter() - t0)
        return out, 1e3 * statistics.median(t)

    def stats(fn):
        outs = [a.copy() for a in (m.pt_desc_bits, m.pt_normal, m.pt_ref_size, m.pt_ref_dist,
                                   m.pt_min_dist, m.pt_max_dist)]
        fn(m.kf_matches, m.kf_valid, m.kf_desc_bits, m.kf_size, m.kf_centers(), pts, m.pt_pos,
           m.pt_ref_kf, *outs)
        return outs

    rows, fail = [], []
    for name, comp, plain, reps in (
            ("point_obs_counts",
             lambda: native.point_obs_counts(m.kf_matches, m.kf_valid, m.max_pt),
             lambda: native.point_obs_counts_plain(m.kf_matches, m.kf_valid, m.max_pt), 5),
            ("covisibility_weights (every keyframe)",
             lambda: [native.covisibility_weights(m.kf_matches, m.kf_valid, k, m.max_pt)
                      for k in kfs],
             lambda: [native.covisibility_weights_plain(m.kf_matches, m.kf_valid, k, m.max_pt)
                      for k in kfs], 3),
            ("covisibility_matrix",
             lambda: native.covisibility_matrix(m.kf_matches, m.kf_valid, m.max_pt),
             lambda: native.covisibility_matrix_plain(m.kf_matches, m.kf_valid, m.max_pt), 5),
            ("update_point_stats (every valid point)", lambda: stats(native.update_point_stats),
             lambda: stats(native.update_point_stats_plain), 2)):
        got, c_ms = ms(comp, reps)
        want, p_ms = ms(plain, reps)
        same = all(np.array_equal(a, b) for a, b in zip(got, want)) \
            if isinstance(got, list) else np.array_equal(got, want)
        per = len(kfs) if name.startswith("covisibility_weights") else 1
        rows.append(f"{name} {c_ms / per:.3f} ms per call compiled, {p_ms / per:.3f} ms plain, "
                    f"equal: {same}")
        if not same:
            fail.append(f"the library's {name} differs from its twin")
    log(f"[native] map kernels on the final map ({len(kfs)} keyframes, {len(pts)} points, "
        f"max_pt {m.max_pt}): {'; '.join(rows)}; {CARD[0]}")
    return fail


def cli_phase(torch, device, frames):
    """Phases 11 and 20, one System run: run_mono.main (orb32, the JAX
    System's defaults: asynchronous mapping, each local BA issued on the
    mapping stream and folded later) on the card over the bench's first
    N_ASYNC_FRAMES frames, read from adaptive-filter PNG files
    (write_cli_sequence) by io/png on run_sequence's FrameLoader, with the
    System under a SystemProbe. Phase 20's checks: load_gray of frame
    FIRST_TRACKED equals the rendered frame (and an all-Paeth copy of it,
    and the plain unfilter's decode of every PLAIN_DECODE_EVERY-th file,
    decode equal), every frame read through the FrameLoader, the RGB frames
    (rgb_loader_check) and the map kernels (map_kernels_check) equal their
    plain twins, the port's evaluate_ate scores the keyframe and frame
    trajectories, PIL is never imported. Phase 11's
    readings: frames timed without a device sync (a deferred solve
    overlaps the next frames), host syncs over the first N_SYNC_FRAMES,
    where each fold landed. Gates: 0 resets, >= 45 tracked, keyframe ATE <
    5 cm (the probe's and evaluate_ate's), every local BA deferred, K1 on
    every frame, K2 and pack launched, the files equal, no PIL. Counts set
    to 0 just before run_mono, read just after. Returns (the temporary
    folder, the sequence path, launches (K1, K2, pack), K2 launches by
    search)."""
    import tempfile

    import numpy as np

    from anyfeature_vslam_tpu_torch import perfcount, run_mono
    from anyfeature_vslam_tpu_torch.io import dataset, png
    from anyfeature_vslam_tpu_torch.tools import evaluate_ate
    from torch_slice_scene import FIRST_TRACKED, SliceScene

    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "out")
    seq, fail = write_cli_sequence(tmp.name, frames[:N_ASYNC_FRAMES])
    paths = dataset.load_sequence(seq).image_paths
    decoded, decode_ms, unfilter_ms = timed_decode(paths, png.unfilter)
    same = np.array_equal(decoded[FIRST_TRACKED], frames[FIRST_TRACKED].astype(np.float32))
    plain_paths = paths[::PLAIN_DECODE_EVERY]
    plain, plain_dec_ms, plain_unf = timed_decode(plain_paths, png.unfilter_plain)
    same_plain = all(np.array_equal(a, b) for a, b in zip(plain, decoded[::PLAIN_DECODE_EVERY]))
    paeth = os.path.join(tmp.name, "paeth.png")
    filtered_png(paeth, frames[FIRST_TRACKED], (4,))
    t0 = time.perf_counter()
    paeth_img = dataset.load_gray(paeth)
    paeth_ms = (time.perf_counter() - t0) * 1e3
    log(f"[cli] load_gray of frame {FIRST_TRACKED} equals the in-memory frame: {same}; decode "
        f"{decode_ms:.3f} ms per frame (adaptive-filter rows, {len(paths)} frames, host; "
        f"unfilter {unfilter_ms:.3f} ms of it), with the plain unfilter {plain_dec_ms:.3f} ms "
        f"(unfilter {plain_unf:.3f} ms; {len(plain_paths)} frames, equal: {same_plain}); "
        f"{paeth_ms:.3f} ms for frame {FIRST_TRACKED} with every row Paeth-filtered (equal: "
        f"{np.array_equal(paeth_img, decoded[FIRST_TRACKED])}); {CARD[0]}")
    if not same or not same_plain or not np.array_equal(paeth_img, decoded[FIRST_TRACKED]):
        fail.append("the decoded frame differs from the rendered one")

    counters = _counters()
    torch.cuda.synchronize()
    perfcount.reset()
    record_spans()
    for c in counters:
        c.launches = 0
    sync_sites = {}
    t0 = time.perf_counter()
    with probed_run_sequence(torch, device, sync_sites, N_SYNC_FRAMES) as got:
        rc, lines = _run_tool(run_mono.main, [
            f"sequence_path:{seq}", f"exp_folder:{out}", "exp_id:cli", "feature:orb32",
            "verbose:0", "device:cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, pack = (c.launches for c in counters)
    if rc != 0:
        fail.append(f"run_mono exited {rc}")
    probe, rows = got["probe"], got["rows"]
    system, events, k2_by = probe.system, probe.events, probe.k2_by_label
    stats = system.tracker.stats
    kf_ate, fr_ate, n_kf, n_fr, _ = ate(system, SliceScene(W, H))
    plain_ms, n_plain, ev_ms, n_ev = _frame_stats(rows)
    lm = system.local_mapper
    log(f"[async] {len(rows)} frames {W}x{H} in {wall:.1f} s; tracked "
        f"{stats['tracked_frames']}, lost {stats['lost_frames']}, resets {stats['resets']}, "
        f"reinitializations {stats['reinitializations']}; "
        f"{system.map.n_keyframes()} keyframes, {system.map.n_points()} points; ATE "
        f"(Sim3-aligned) keyframes {kf_ate:.5f} m over {n_kf}, frames {fr_ate:.5f} m over {n_fr}")
    log(f"[async] median ms per frame after frame {N_SYNC_FRAMES - 1} (the frames before "
        f"count host syncs): without a keyframe event {plain_ms:.1f} "
        f"({n_plain} frames), with one {ev_ms:.1f} ({n_ev} frames); {len(events)} events, "
        f"median {statistics.median(e['ms'] for e in events) if events else float('nan'):.1f} "
        f"ms (host, no device sync)")
    map_stages = span_seconds("map.")
    for name, ts in map_stages.items():
        log(f"[async] event stage {name}: median {1e3 * statistics.median(ts):.2f} ms, max "
            f"{1e3 * max(ts):.2f} ms over {len(ts)} events")
    waits = map_stages.get("fold_wait", [])
    log(f"[async] folds landed by site {json.dumps(probe.folds)}; events waited on a solve's "
        f"readiness {len(waits)} times, {1e3 * sum(waits):.2f} ms in all, median "
        f"{1e3 * statistics.median(waits) if waits else float('nan'):.2f} ms")
    ba_lines(lm.ba_log, "async", "local BA (issue ms)")
    loop_stage_line(system, "async")
    log(f"[async] launches: K1 {k1}, K2 {k2} (by search {json.dumps(k2_by)}), pack {pack}")
    crows = [r for r in rows if r["sync_counted"]]
    plain_syncs = [r["syncs"] for r in crows if r["state"] == "OK" and not r["events"]]
    log(f"[async syncs] first {N_SYNC_FRAMES} frames: {sum(sync_sites.values())} host syncs; "
        f"per frame without an event {plain_syncs}; per frame with one "
        f"{[r['syncs'] for r in crows if r['events']]}")
    for site, n in sorted(sync_sites.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[async syncs]   {n:5d}x  {site}")

    scores = {}
    gt = os.path.join(seq, "groundtruth.csv")
    for what, name in (("keyframes", "cli_KeyFrameTrajectory.csv"),
                       ("frames", "cli_FrameTrajectory_TUM.txt")):
        _, lines_ate = _run_tool(evaluate_ate.main, [f"est:{os.path.join(out, name)}",
                                                    f"gt:{gt}"])
        scores[what] = json.loads(lines_ate[-1])
    median = next((line for line in lines if line.startswith("median tracking time")), "")
    log(f"[cli] run_mono over {len(rows)} PNG frames {W}x{H} on the card in {wall:.1f} s "
        f"({wall * 1e3 / len(rows):.1f} ms per frame, the System's build included; {median}); "
        f"evaluate_ate keyframes {scores['keyframes']}, frames {scores['frames']}")
    log(f"[cli] decode {decode_ms:.3f} ms per frame against {wall * 1e3 / len(rows):.1f} ms "
        f"per frame")
    fail += loader_lines(system, N_ASYNC_FRAMES, wall, plain_dec_ms, len(plain_paths))
    fail += rgb_loader_check(tmp.name, frames)
    fail += map_kernels_check(system.map)
    pil = "PIL" in sys.modules
    log(f"[cli] PIL loaded: {pil}")
    if len(rows) != N_ASYNC_FRAMES:
        fail.append(f"{len(rows)} frames tracked of {N_ASYNC_FRAMES}")
    if stats["resets"] != 0:
        fail.append(f"{stats['resets']} resets")
    if stats["tracked_frames"] < MIN_SYSTEM_TRACKED:
        fail.append(f"{stats['tracked_frames']} tracked frames")
    if not kf_ate < MAX_ATE_M or not scores["keyframes"]["ate_rmse"] < MAX_ATE_M:
        fail.append(f"keyframe ATE {kf_ate:.4f} m, {scores['keyframes']['ate_rmse']} m")
    if not events or not lm.ba_log or not all(b["deferred"] for b in lm.ba_log):
        fail.append("the local BAs were not deferred")
    if min(r["k1"] for r in rows) < 1 or k2 < 1 or pack < 1:
        fail.append("a kernel of the path was not launched")
    if pil:
        fail.append("PIL was imported")
    if fail:
        raise AssertionError(f"the asynchronous CLI phase failed: {fail}")
    return tmp, seq, (k1, k2, pack), k2_by


def vocabulary_phase(torch, device, seq, frames):
    """Phase 21: create_vocabulary (orb32, every 6th frame, 8 frames,
    branching 32, depth 2) on phase 20's folder on the card and on the
    CPU, each run's descriptor rows kept as the tool extracts them: at
    least MIN_VOCAB_AGREE of the rows equal on the card and the CPU, and
    where all are equal the trees (centroids and idf) are equal too; frame
    FIRST_TRACKED's words under the card's tree on the card equal the
    CPU's. Returns K1's launches in the card's run."""
    import tempfile

    import numpy as np

    from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, make_extractor
    from anyfeature_vslam_tpu_torch.place_recognition import vocab
    from anyfeature_vslam_tpu_torch.tools import create_vocabulary
    from torch_slice_scene import FIRST_TRACKED

    fail = []
    extract = create_vocabulary.extract_descriptors
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        vocs, ms = {}, {}
        counters = _counters()
        for dev in ("cuda", "cpu"):
            def keep(*a, _dev=dev, **kw):
                out = extract(*a, **kw)
                rows.setdefault(_dev, []).extend(out)
                return out

            for c in counters:
                c.launches = 0
            out = os.path.join(tmp, f"voc_{dev}.npz")
            t0 = time.perf_counter()
            create_vocabulary.extract_descriptors = keep
            try:
                rc, _ = _run_tool(create_vocabulary.main, [f"sequence_path:{seq}", f"out:{out}",
                                                            f"device:{dev}", *VOCAB_ARGS])
            finally:
                create_vocabulary.extract_descriptors = extract
            ms[dev] = (time.perf_counter() - t0) * 1e3
            if dev == "cuda":
                k1 = counters[0].launches
            if rc != 0:
                fail.append(f"create_vocabulary device:{dev} exited {rc}")
            vocs[dev] = vocab.Vocabulary.load(out)
    d_card, d_cpu = (np.concatenate(rows[dev]) for dev in ("cuda", "cpu"))
    n_frames = len(rows["cuda"])
    same_shape = d_card.shape == d_cpu.shape
    share = float((d_card == d_cpu).all(axis=1).mean()) if same_shape and len(d_card) else 0.0
    same_tree = (all(np.array_equal(x, y) for x, y in zip(vocs["cuda"].centroids,
                                                          vocs["cpu"].centroids))
                 and np.array_equal(vocs["cuda"].idf, vocs["cpu"].idf))
    log(f"[vocabulary] orb32, {n_frames} frames: {len(d_card)} descriptors on the card, "
        f"{len(d_cpu)} on the CPU, {100 * share:.2f}% of the rows equal (at least "
        f"{100 * MIN_VOCAB_AGREE:.1f}% required); the trees ({vocs['cuda'].n_words} words) "
        f"equal: {same_tree}; the tool took {ms['cuda']:.0f} ms (card) and {ms['cpu']:.0f} ms "
        f"(CPU); K1 launches on the card {k1}")
    if not share >= MIN_VOCAB_AGREE:
        fail.append(f"{100 * share:.2f}% of the descriptor rows equal on the card and the CPU")
    if share == 1.0 and not same_tree:
        fail.append("equal descriptors gave different trees")
    if k1 < n_frames:
        fail.append(f"K1 launched {k1} times for {n_frames} frames")
    cfg = ExtractorConfig.for_feature("orb32")
    ext = make_extractor(cfg, H, W).to(device)
    feats = ext(torch.from_numpy(frames[FIRST_TRACKED]).to(device).float())
    w_card = vocab.transform_words(vocs["cuda"], feats["desc_bits"], feats["valid"])
    w_cpu = vocab.transform_words(vocs["cuda"], feats["desc_bits"].cpu(), feats["valid"].cpu())
    same_words = bool(torch.equal(w_card.cpu(), w_cpu))
    log(f"[vocabulary] frame {FIRST_TRACKED}'s {int(feats['valid'].sum())} words under the "
        f"card's tree: card equals CPU {same_words}")
    if not same_words:
        fail.append("frame words differ between the card and the CPU")
    if fail:
        raise AssertionError(f"the vocabulary phase failed: {fail}")
    return k1


def training_phase(torch, device, frames):
    """Phase 22: train_patch_descriptor (sequence_path:synthetic, seed 0,
    batch 512; TRAIN_ARGS' cuts) on the card, then its first
    N_TRAIN_CPU_STEPS steps on the CPU: the step-0 losses within 1e-5
    relative, the last step's loss below step 0's, and the saved weights
    loaded through convert.learned48_from_numpy into an anyfeat_nonbin
    extractor whose frame-FIRST_TRACKED descriptors have norm 1 +- 1e-5.
    Prints ms per step and the suggested matchingTh."""
    import tempfile

    import numpy as np

    from anyfeature_vslam_tpu_torch import convert
    from anyfeature_vslam_tpu_torch.frontend.extractor import ExtractorConfig, make_extractor
    from anyfeature_vslam_tpu_torch.tools import train_patch_descriptor
    from torch_slice_scene import FIRST_TRACKED

    fail = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "learned48.npz")
        t0 = time.perf_counter()
        card = train_patch_descriptor.train(dict(TRAIN_ARGS, out=out, device="cuda"),
                                            log=lambda m, **k: log(f"    {m}"))
        t_card = time.perf_counter() - t0
        cpu = train_patch_descriptor.train(
            dict(TRAIN_ARGS, steps=str(N_TRAIN_CPU_STEPS), out=os.path.join(tmp, "cpu.npz"),
                 device="cpu"), log=lambda m, **k: None)
        params = dict(np.load(out))
    l_card, l_cpu = card.losses[0][1], cpu.losses[0][1]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    first, last = card.losses[0], card.losses[-1]
    log(f"[training] learned48 on the card: {len(card.losses)} steps of "
        f"{TRAIN_ARGS['steps']} taken in {t_card:.1f} s with the corpus; "
        f"{card.ms_per_step:.2f} ms per step (pairs included); loss step {first[0]} "
        f"{first[1]:.6f}, step {last[0]} {last[1]:.6f}; step-0 loss card {l_card:.8f} CPU "
        f"{l_cpu:.8f} ({rel:.2e} relative; CPU steps 0-{cpu.losses[-1][0]}: "
        f"{[round(l[1], 6) for l in cpu.losses]}); suggested matchingTh {card.threshold:.3f}")
    if first[0] != 0 or cpu.losses[0][0] != 0 or not rel <= MAX_TRAIN_LOSS_REL:
        fail.append(f"step-0 losses {l_card} (card) and {l_cpu} (CPU)")
    if last[0] != int(TRAIN_ARGS["steps"]) - 1 or not last[1] < first[1]:
        fail.append(f"the loss did not fall: {first} -> {last}")
    ext = make_extractor(ExtractorConfig.for_feature("anyfeat_nonbin", N_FEATURES), H, W)
    ext.mlp = convert.learned48_from_numpy(params, "cpu")
    ext = ext.to(device)
    feats = ext(torch.from_numpy(frames[FIRST_TRACKED]).to(device).float())
    norms = torch.linalg.vector_norm(feats["desc_bits"][feats["valid"]], dim=1)
    err = float((norms - 1).abs().max())
    log(f"[training] the trained weights in an anyfeat_nonbin extractor: frame "
        f"{FIRST_TRACKED}'s {len(norms)} descriptors, norms within {err:.2e} of 1")
    if not err <= MAX_DESC_NORM_ERR or len(norms) == 0:
        fail.append(f"descriptor norms {err}")
    if fail:
        raise AssertionError(f"the training phase failed: {fail}")
    return card


def tools_phase(torch, device):
    """Phase 23: bench_ba (local- and global-BA problems with points and
    observations cut 16-fold, --mesh 2: one rank on one card), then
    profile_detect and profile_tracking over 8 frames, each once."""
    from anyfeature_vslam_tpu_torch.tools import bench_ba, profile_detect, profile_tracking

    fail = []
    for name, main, argv in (
            ("bench_ba", bench_ba.main, ["--mesh", "2", "--scale", "16"]),
            ("profile_detect", profile_detect.main, ["n_frames:8", "device:cuda"]),
            ("profile_tracking", profile_tracking.main, ["n_frames:8", "device:cuda"])):
        t0 = time.perf_counter()
        log(f"[tools] {name} {' '.join(argv)}:")
        rc, _ = _run_tool(main, argv)
        log(f"[tools] {name} exited {rc} in {time.perf_counter() - t0:.1f} s")
        if rc != 0:
            fail.append(f"{name} exited {rc}")
    if fail:
        raise AssertionError(f"the tools phase failed: {fail}")


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
    CARD[0] = smi.stdout.strip().splitlines()[0]
    log(CARD[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- the rendered scenes (the bench's frames, phase 10's loop scene,
    # phases 15-16's plane scene), on the host's cores while the kernels
    # build: every frame is ready before anything is timed
    from concurrent.futures import ThreadPoolExecutor

    from torch_slice_scene import LoopScene

    t_render = time.perf_counter()
    loop_sc = LoopScene(LOOP_W, LOOP_H)
    # one pool for the three scenes (three pools oversubscribe the cores)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    workers = ProcessPoolExecutor(N_RENDER_PROCS, mp_context=multiprocessing.get_context("spawn"))
    renders = ThreadPoolExecutor(3)
    bench_job = renders.submit(render_slice_frames, W, H, N_THREADED_FRAMES, workers)
    loop_job = renders.submit(render_loop_frames, LOOP_W, LOOP_H,
                              list(loop_sc.session_a) + list(loop_sc.session_b), workers)
    plane_job = renders.submit(render_plane_frames, workers)

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 1 begins")
    # ---- 1. build: one nvcc per source, all started together
    names = ("fast_nms", "best_two")
    t0 = time.perf_counter()

    def timed(fn, name):
        fn(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(names) + 1) as pool:
        host_job = pool.submit(timed, cuda_build.build_host, "slam_native")
        list(pool.map(cuda_build.build, names))
    log(f"[build] {', '.join(names)} in parallel: {time.perf_counter() - t0:.1f} s; the host "
        f"library slam_native ({cuda_build.find_cxx()}) in {host_job.result():.2f} s, "
        f"{CARD[0]}")
    from anyfeature_vslam_tpu_torch import native

    native.lib()
    log(f"[build] slam_native -> {cuda_build.host_library_path('slam_native', cuda_build.find_cxx()).name}")
    for name in names:
        cuda_build.load(name)
        log(f"[build] {name} -> {cuda_build.library_path(name).name}")
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {line.strip()}")

    # ---- scenes: the bench's frames serve every phase that tracks them
    sc = SliceScene(W, H)
    bench_frames, loop_frames = bench_job.result(), loop_job.result()
    rgbd_frames, leg_frames, stereo_pairs = plane_job.result()
    renders.shutdown()
    workers.shutdown()
    frames = bench_frames[FIRST_TRACKED:FIRST_TRACKED + N_TRACKED]
    log(f"[scene] rendered the bench's {len(bench_frames)} frames, the loop scene's "
        f"{len(loop_frames)}, {len(rgbd_frames)} + {len(leg_frames)} RGB-D frames and "
        f"{len(stereo_pairs)} stereo pairs, {W}x{H}, in {time.perf_counter() - t_render:.1f} s "
        f"(while the kernels built)")
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

    def k2_case(nq, nc, binary, dim=128):
        if binary:
            q = rng.integers(0, 2, (nq, 256)).astype(np.uint8)
            c = rng.integers(0, 2, (nc, 256)).astype(np.uint8)
        else:
            # unit rows, as the learned48 descriptors are
            q = rng.normal(size=(nq, dim)).astype(np.float32)
            c = rng.normal(size=(nc, dim)).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            c /= np.linalg.norm(c, axis=1, keepdims=True)
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
    # the float search with random windows (as k2_case) and with none (as
    # the reference-keyframe search), every width, at the System's and the
    # local map's shapes and past the staging limit
    for dim in (48, 64, 128):
        for nq, nc in ((1000, 1000), (2000, 2000), (4096, 1000), (700, 5000)):
            args = k2_case(nq, nc, False, dim)
            for window in (True, False):
                a = list(args)
                if not window:
                    a[4] = torch.full_like(a[4], cuda_match.INF)
                    a[5] = torch.zeros_like(a[5])
                    a[6] = torch.full_like(a[6], cuda_match.INF)
                kw = dict(c_words=cuda_match.pack_candidates(a[1]))
                row = measure_k2(torch, a, kw,
                                 f"phase 3 float {'windowed' if window else 'no window'}")
                k2_err = max(k2_err, row["max_abs_err"])

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

    n_prof = 1  # the frame's kernels repeat per frame; parsing more costs tens of seconds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        track_frames(torch, sc, cam, ext, state, frames[:n_prof], device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_events(torch, prof)
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
    (sys_k1, sys_k2, sys_pack), k2_by, k2_sys, (system, ssc, align) = system_phase(
        torch, device, bench_frames)
    k2_err = max([k2_err] + [r["max_abs_err"] for r in k2_sys.values()])
    assert_no_jax()  # the System's modules are imported by now
    log(f"[phase 8] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 9 begins")
    # ---- 9. relocalization of phase 8's System
    t_phase = time.perf_counter()
    reloc_launches, reloc_by, reloc_rec, reloc_fid = reloc_phase(torch, device, system, ssc,
                                                                 align, bench_frames)
    log(f"[phase 9] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 9b begins")
    # ---- 9b. localization mode on phase 8's System, retracing backwards
    t_phase = time.perf_counter()
    monoloc_launches, monoloc_by = mono_localization_phase(torch, device, system, ssc,
                                                           reloc_fid, bench_frames)
    del system
    log(f"[phase 9b] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 10 begins")
    # ---- 10. the live loop closure: two sessions merged by a Sim3 closure
    t_phase = time.perf_counter()
    loop_launches, loop_by, loop_rec = loop_phase(torch, device, loop_sc, loop_frames)
    log(f"[phase 10] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 10b begins")
    # ---- 10b. the constructed loop map: the card against the CPU port
    t_phase = time.perf_counter()
    constructed_loop_phase(torch, device)
    log(f"[phase 10b] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phases 11 and 20 begin")
    # ---- 11 and 20. the JAX System's defaults (asynchronous mapping)
    # through the CLI, from PNG files: run_mono, evaluate_ate, no PIL
    t_phase = time.perf_counter()
    cli_tmp, cli_seq, async_launches, async_by = cli_phase(torch, device, bench_frames)
    log(f"[phases 11 and 20] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 12 begins")
    # ---- 12. the bench's schedule: the mapping worker, the pipelined tracker
    t_phase = time.perf_counter()
    threaded_launches, threaded_by = threaded_phase(torch, device, bench_frames)
    log(f"[phase 12] {time.perf_counter() - t_phase:.1f} s")

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

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 13 begins")
    # ---- 13. the other families: K1 on the FAST families' pyramids (none on
    # akaze61 / kaze64), their extraction, the System with the JAX
    # defaults, K2 (384 / 488 / 512 bits, float 48 / 64 / 128) held against
    # its twin at their recorded searches
    t_phase = time.perf_counter()
    fam, fam_failed = {}, []
    for feature in FAMILIES:
        # every family runs, so a failing one does not hide the others'
        # readings; any failure fails the phase below
        t_fam = time.perf_counter()
        try:
            fam[feature] = family_phase(torch, device, feature, bench_frames[:N_FAMILY_FRAMES])
        except AssertionError as e:
            log(f"[phase 13] {feature} failed: {e}")
            fam_failed.append(feature)
        log(f"[phase 13] {feature} {time.perf_counter() - t_fam:.1f} s")
    if fam_failed:
        raise AssertionError(f"phase 13 failed for {fam_failed}")
    log(f"[phase 13] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 14 begins")
    # ---- 14. r2d2_128: precomputed features, K2 at D = 128
    t_phase = time.perf_counter()
    fam["r2d2_128"] = r2d2_phase(torch, device)
    log(f"[phase 14] {time.perf_counter() - t_phase:.1f} s")
    k1_err = max([k1_err] + [r["k1_err"] for r in fam.values() if r["k1_err"] is not None])
    k2_err = max([k2_err] + [k["max_abs_err"] for r in fam.values()
                             for k in r["k2_rows"].values()])

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 15 begins")
    # ---- 15. RGB-D: the instant map from depth, the staged tracker,
    # depth-minted keyframes; then localization mode
    t_phase = time.perf_counter()
    (rgbd_launches, rgbd_by), (rgbdloc_launches, rgbdloc_by), k2_rgbd = rgbd_phase(
        torch, device, rgbd_frames, leg_frames)
    k2_err = max([k2_err] + [r["max_abs_err"] for r in k2_rgbd.values()])
    log(f"[phase 15] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 16 begins")
    # ---- 16. stereo: the row matcher, two extractions per frame
    t_phase = time.perf_counter()
    stereo_launches, stereo_by = stereo_phase(torch, device, stereo_pairs)
    log(f"[phase 16] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 17 begins")
    # ---- 17. DBoW2 text vocabularies: the shipped tree as .txt, an
    # ORBvoc.txt-shaped tree, phase 8's System on the .txt vocabulary
    t_phase = time.perf_counter()
    dsys, _, dtmp, dbow2_launches, dbow2_by, last_ba = dbow2_phase(
        torch, device, bench_frames[:N_SYSTEM_FRAMES], ext)
    log(f"[phase 17] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 18 begins")
    # ---- 18. the viewer: the map SVG and the frame overlay's PNG
    t_phase = time.perf_counter()
    viewer_phase(dsys, bench_frames[:N_SYSTEM_FRAMES])
    intrinsics = dsys.local_mapper.intrinsics
    del dsys
    dtmp.cleanup()
    log(f"[phase 18] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 19 begins")
    # ---- 19. BA layouts: sharded over one NCCL rank and two gloo ranks,
    # point-sharded, compensated; a System with use_mesh=True
    t_phase = time.perf_counter()
    mesh_launches, mesh_by = ba_layouts_phase(torch, device, last_ba, intrinsics,
                                              bench_frames[:N_MESH_FRAMES])
    log(f"[phase 19] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 21 begins")
    # ---- 21. a vocabulary from phase 20's folder, on the card and the CPU
    t_new = t_phase = time.perf_counter()
    voc_k1 = vocabulary_phase(torch, device, cli_seq, bench_frames)
    cli_tmp.cleanup()
    log(f"[phase 21] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 22 begins")
    # ---- 22. learned48 training on the card
    t_phase = time.perf_counter()
    training_phase(torch, device, bench_frames)
    log(f"[phase 22] {time.perf_counter() - t_phase:.1f} s")

    log(f"[time] {time.perf_counter() - T_START:.1f} s: phase 23 begins")
    # ---- 23. bench_ba, profile_detect, profile_tracking
    t_phase = time.perf_counter()
    tools_phase(torch, device)
    log(f"[phase 23] {time.perf_counter() - t_phase:.1f} s; phases 21-23 "
        f"{time.perf_counter() - t_new:.1f} s")

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
    phases = ("system", "reloc", "mono_localization", "loop", "async", "threaded", "rgbd",
              "rgbd_localization", "stereo", "dbow2_system", "mesh_system")
    by_phase = (k2_by, reloc_by, monoloc_by, loop_by, async_by, threaded_by, rgbd_by, rgbdloc_by,
                stereo_by, dbow2_by, mesh_by)
    by_search = {k: sum(b.get(k, 0) for b in by_phase) for k in SEARCHES + STAGED_SEARCHES}
    k2_entries = [dict(
        name="best_two[tracking]", search="tracking", **k2_src, launches=by_search["tracking"],
        launches_by_phase=dict(zip(phases, (b.get("tracking", 0) for b in by_phase))),
        launches_tracked_frame=k2_launches, launches_per_frame=k2_launches / n_frames,
        max_abs_err=frame_k2["max_abs_err"], ms=frame_k2["eager_ms"],
        eager_ms=frame_k2["eager_ms"], graph_ms=frame_k2["graph_ms"],
        device_ms=dev_frames["best_two_bits_kernel"][1] / N_PROFILED,
        plain_ms=frame_k2["plain_ms"], bound_ms=frame_k2["bound_ms"], bound_by=k2_bound_by,
        at=f"frame {FIRST_TRACKED}'s {frame_searches} searches, summed")]
    for label, r in list(k2_sys.items()) + list(k2_new.items()) + list(k2_rgbd.items()):
        k2_entries.append(dict(
            name=f"best_two[{'staged ' if label in STAGED_SEARCHES else ''}{label}]",
            search=label, **k2_src, launches=by_search[label],
            launches_by_phase=dict(zip(phases, (b.get(label, 0) for b in by_phase))),
            max_abs_err=r["max_abs_err"], ms=r["eager_ms"], eager_ms=r["eager_ms"],
            graph_ms=r["graph_ms"], device_ms=r["device_ms"], pack_device_ms=r["pack_device_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            at=r["label"], nq=r["nq"], nc=r["nc"], passes=r["passes"]))
    for feature, r in fam.items():
        for label, k in r["k2_rows"].items():
            k2_entries.append(dict(
                name=f"best_two[{feature} {label}]", search=label, feature=feature, **k2_src,
                launches=k["launches"], max_abs_err=k["max_abs_err"], ms=k["eager_ms"],
                eager_ms=k["eager_ms"], graph_ms=k["graph_ms"], device_ms=k["device_ms"],
                pack_device_ms=k["pack_device_ms"], plain_ms=k["plain_ms"],
                bound_ms=k["bound_ms"], bound_by=k["bound_by"], at=k["label"], nq=k["nq"],
                nc=k["nc"], passes=k["passes"]))
    launches_by_phase = dict(zip(phases, ((sys_k1, sys_k2, sys_pack), reloc_launches,
                                          monoloc_launches, loop_launches, async_launches,
                                          threaded_launches, rgbd_launches, rgbdloc_launches,
                                          stereo_launches, dbow2_launches, mesh_launches)))
    log(json.dumps({"kernels": [
        {"name": "fast_nms", "route": "cuda",
         "source": "anyfeature_vslam_tpu_torch/csrc/fast_nms.cu",
         "replaces": "anyfeature_vslam_tpu/frontend/pallas_fast.py:105",
         "launches": sys_k1, "launches_per_frame_system": sys_k1 / N_SYSTEM_FRAMES,
         "launches_by_phase": dict({k: v[0] for k, v in launches_by_phase.items()},
                                   vocabulary=voc_k1),
         "launches_by_family": {f: r["k1"] for f, r in fam.items()},
         "launches_tracked_frame": k1_launches, "launches_per_frame": k1_launches / n_frames,
         "max_abs_err": k1_err, "ms": k1_ms, "eager_ms": k1_ms, "graph_ms": k1_graph_ms,
         "device_ms": dev_frames["fast_nms_kernel"][1] / N_PROFILED, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None},
        {"name": "pack_bits", "route": "cuda",
         "source": "anyfeature_vslam_tpu_torch/csrc/best_two.cu",
         "replaces": "anyfeature_vslam_tpu/ops/pallas_match.py:179",
         "launches": sys_pack, "launches_by_phase": {k: v[2] for k, v in launches_by_phase.items()},
         "launches_by_family": {f: r["pack"] for f, r in fam.items()},
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

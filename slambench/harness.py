"""One run of one cell: set-up, the measured window, the comparison.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(the camera and feature settings, ``configs/<config>.json`` as the entry
names it) under a traffic mix (the scene, the camera's path, the sensor
noise and the warm-up, ``traffic/<traffic>.json``). Its limits for the
comparison are ``limits/<workload>.json`` and its per-layer metrics are
read by ``metrics/<name>.py``, each found by the name in
``BENCHMARK.json``. Nothing here names a cell.

Set-up renders every frame of the traffic file on the device (fixed path,
fixed scene; the seed draws only the per-frame read noise), copies them to
pinned host memory, builds the System and hands it frames until the
traffic's warm-up is done. The window then hands over the next frame as
soon as the call for the last one returns, for ``seconds``, and ends when
the System has retired the frames in flight and drained its mapping
worker (``System.shutdown``). The window keeps a sample of K2's searches
for the comparison; a traced run also profiles a slice of a few of its
frames.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, scene, stats
from .program import Program, SearchSample, free

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "anyfeature_vslam_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def configuration(raw: dict) -> dict:
    """The configuration as a run takes it, from its file, which states
    each value once: the camera from TUM1.yaml's ``Camera.*`` keys, the
    number of features from ``ORBextractor.nFeatures``, orb32's pyramid
    and threshold from the other ``ORBextractor.*`` keys, and a family
    with settings of its own from ``feature.settings``. ``check`` holds the
    comparison's own tolerances."""
    cam = {k: float(raw[f"Camera.{k}"]) for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1",
                                                   "p2", "k3", "fps")}
    cam.update(width=int(raw["Camera.width"]), height=int(raw["Camera.height"]))
    feat = dict(raw["feature"], n_features=int(raw["ORBextractor.nFeatures"]))
    if "settings" not in feat:
        feat["settings"] = dict(n_levels=int(raw["ORBextractor.nLevels"]),
                                scale_factor=float(raw["ORBextractor.scaleFactor"]),
                                detect_th=float(raw["ORBextractor.iniThFAST"]))
    return dict(raw, camera=cam, feature=feat)


def load_config(path: Path) -> dict:
    return configuration(load_json(path))


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration, traffic, limits, settings and
    metrics, found by name from `root`'s BENCHMARK.json and the benchmark's
    folder in `root`."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / HERE.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json (known: {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}

    def of_cell(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(cell=cell, dir=here, config=load_config(root / configs[cell["config"]]["file"]),
                traffic=load_json(here / "traffic" / f"{cell['traffic']}.json"),
                limits=load_json(here / "limits" / f"{workload}.json"),
                end_to_end=of_cell(bench["end_to_end"]), per_layer=of_cell(bench["per_layer"]),
                settings=load_json(here / "settings.json"))


def metric_reader(name: str, here: Path = HERE):
    """metrics/<name>.py's ``read(run) -> float | None``."""
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}",
                                                  here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _warm_up(prog: Program, frames_np, warmup: dict) -> tuple[int, int]:
    """Hand frames over until the map is initialized and the traffic's
    warm-up is done; returns (frames handed over, frame of the init)."""
    i, init_at = 0, None
    while True:
        if i >= min(len(frames_np), int(warmup["max_frames"])):
            raise RunError(f"no warm-up within {i} frames (initialized at {init_at})")
        prog.track(frames_np[i], i)
        i += 1
        if init_at is None and prog.initialized():
            init_at = i - 1
        if (init_at is not None and i - 1 - init_at >= int(warmup["tracked_after_init"])
                and i >= int(warmup["min_frames"])):
            return i, init_at


def run(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
        setup_t0: float | None = None, control: bool = False, tamper=None,
        window_frames: int | None = None) -> dict:
    """One run of the cell `spec` (``load_cell``); returns the result
    line's fields and the numbers compared. setup_t0: the perf_counter
    reading taken as the process's start. control: also judge, on the same run, the reference worked out in
    bfloat16 put in the program's place (the control a sound run must be
    told apart from), as ``control_checks``. tamper(prog): called on
    the built program to break the timed path (faults.py); it returns the
    callable that mends it once the window has closed. window_frames: close the
    window after that many frames instead (the CPU tests, where a frame
    takes seconds and a window of fixed time would hold a number of frames
    that follows the host's speed)."""
    from . import trace as tracing

    t_start = time.perf_counter() if setup_t0 is None else setup_t0
    cfg, traffic, settings = spec["config"], spec["traffic"], spec["settings"]
    cam = cfg["camera"]
    fps = float(cam["fps"])
    parts = {"start_s": time.perf_counter() - t_start}

    t = time.perf_counter()
    plane = scene.ReliefPlane(traffic["scene"], device)
    gt_poses = scene.camera_path(traffic["path"], int(traffic["frames"]), fps)
    frames = scene.render_frames(plane, cam, gt_poses, float(traffic["noise_sigma"]), seed,
                                 int(settings["render_chunk"]))
    frames_np = frames.numpy()
    del plane
    free(device)
    parts["render_s"] = time.perf_counter() - t

    t = time.perf_counter()
    prog = Program(cfg, device)
    parts["system_s"] = time.perf_counter() - t

    t = time.perf_counter()
    first, init_at = _warm_up(prog, frames_np, traffic["warmup"])
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; {first} warm-up frames, initialized at frame {init_at}; {len(frames_np)} frames "
        f"rendered")

    # a fault lies in the window's path; the sample of K2's searches is
    # taken around it, so that it keeps the answers the callers got
    undo = tamper(prog) if tamper is not None else None
    sample = prog.searches = SearchSample(seed, int(settings["k2_sample"]))
    sample.__enter__()
    before = prog.counters()
    host0 = host_times()
    # a traced run profiles `slice_frames` frames from `slice_at` of the
    # window on; its per-layer timings are read from the frames before
    slice_at = float(settings["profile_slice_at"]) * seconds
    slice_frames = int(settings["profile_slice_frames"])
    profiled = tracing.ProfiledSlice() if trace else None
    untraced = None
    handed = {}
    i = first
    t0 = time.perf_counter()
    try:
        while (time.perf_counter() - t0 < seconds if window_frames is None
               else i - first < window_frames):
            if i >= len(frames_np):
                raise RunError(f"the traffic's {len(frames_np)} frames ran out "
                               f"{time.perf_counter() - t0:.1f} s into a {seconds} s window")
            if profiled and untraced is None and time.perf_counter() - t0 >= slice_at:
                untraced = prog.counters()
                profiled.__enter__()
            handed[i] = time.perf_counter()
            prog.track(frames_np[i], i)
            i += 1
            if untraced is not None and profiled.frames < slice_frames:
                profiled.frames += 1
                if profiled.frames == slice_frames:
                    profiled.__exit__(None, None, None)
        if untraced is not None and profiled.frames < slice_frames:
            profiled.__exit__(None, None, None)
        prog.finish(float(settings["shutdown_timeout_s"]))
        t_end = time.perf_counter()
    finally:
        sample.__exit__(None, None, None)
        if undo is not None:
            undo()

    attempted = i - first
    host = {k: v - host0[k] for k, v in host_times().items()}
    latencies = [(prog.known.get(j, t_end) - handed[j]) * 1e3 for j in range(first, i)]
    after = prog.counters()
    memory = (torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda"
              else 0)
    outputs = prog.outputs(first)
    failed = sum(1 for j in range(first, i) if j not in prog.known)
    timings = prog.timings(before)
    traced_timings = prog.timings(before, untraced) if untraced is not None else None
    log(f"[window] {attempted} frames in {t_end - t0:.3f} s (drain included; the last call "
        f"returned at {max(handed.values(), default=t0) - t0:.3f} s, median call "
        f"{1e3 * (stats.median(timings['frame_times']) or 0):.1f} ms), "
        f"{len(timings['event_times'])} keyframe events ({sum(timings['event_times']):.3f} s), "
        f"K2 searches {sample.seen[True]} (tracker) and {sample.seen[False]} (others), "
        f"{failed} frames without a pose, process CPU {host['process_s']:.1f} s, host steal "
        f"{100 * host['steal'] / max(host['total'], 1):.2f}%, "
        f"lost {after['lost'] - before['lost']}, resets {after['resets'] - before['resets']}, "
        f"{len(outputs['keyframes'])} keyframes and {int(outputs['point_valid'].sum())} points "
        f"at the end")
    banned = forbidden_modules()
    if banned:
        raise RunError(f"modules of JAX or the JAX package were loaded: {banned}")
    prog.close()
    del prog
    free(device)

    result = dict(attempted=attempted, failed=failed, setup_s=setup_s)
    if trace:
        if untraced is None:
            raise RunError(f"the window ended before the profiled slice ({slice_at:.1f} s in)")
        summary = profiled.summarize()
        run_data = dict(frames=untraced["frame_times"] - before["frame_times"], config=cfg,
                        slice=summary, **traced_timings)
        metrics = {}
        for m in spec["per_layer"]:
            value = metric_reader(m["name"], spec["dir"])(run_data)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        log(f"[slice] {summary['frames']} frames from {slice_at:.1f} s into the window: "
            f"{summary['kernels']} kernels, {summary['syncs']} host syncs, "
            f"busy {summary['busy_s']:.6f} of {summary['wall_s']:.6f} s, launches "
            f"{summary['launches']}, events {summary['by_kind']}, profiler exit "
            f"{summary['profiler_exit_s']:.1f} s")
        result.update(metrics=metrics, busy_s=summary["busy_s"], window_s=summary["wall_s"],
                      breakdown=dict(device_ops=summary["device_ops"],
                                     idle_gaps=summary["idle_gaps"]))
    else:
        values = dict(frames_per_s=stats.rate(attempted, t0, t_end),
                      frame_ms_p90=stats.percentile(latencies, 90), setup_s=setup_s)
        result["metrics"] = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                             for m in spec["end_to_end"]}
    result.update(memory_peak_bytes=int(memory), kind=(
        torch.cuda.get_device_name(torch.device(device)) if torch.device(device).type == "cuda"
        else "cpu"))

    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    window = dict(first=first, init_at=init_at, attempted=attempted, failed=failed)
    for key, ctrl in (("checks", False),) + ((("control_checks", True),) if control else ()):
        got = check.numbers(outputs, frames, gt_poses, traffic, cfg, window, seed, device,
                            control=ctrl)
        result[key] = {k: dict(value=got[k], limit=v) for k, v in spec["limits"].items()}
        result[key.replace("checks", "readings")] = {k: v for k, v in got.items()
                                                      if k not in spec["limits"]}
    log("[readings] " + ", ".join(f"{k} {v:.6g}" for k, v in result["readings"].items())
        + " (not compared)")
    result["correct"] = passes(result["checks"])
    log(f"[check] {time.perf_counter() - t:.3f} s")
    return result


def passes(checks: dict) -> bool:
    """Every number compared is finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def result_line(result: dict, chips: int) -> dict:
    """The result's JSON object, its compared numbers last."""
    device = dict(platform="gpu" if result["kind"] != "cpu" else "cpu", kind=result["kind"],
                  count=chips, memory_peak_bytes=result["memory_peak_bytes"])
    if "busy_s" in result:
        device.update(busy_s=result["busy_s"], window_s=result["window_s"])
    line = dict(correct=result["correct"], attempted=result["attempted"],
                failed=result["failed"], metrics=result["metrics"], device=device)
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: dict(value=_finite(v["value"]), limit=v["limit"])
                      for k, v in result["checks"].items()}
    return line


def _finite(x: float):
    return x if math.isfinite(x) else None


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def host_times() -> dict:
    """This process's CPU seconds, and the host's jiffies in all and stolen
    by the hypervisor (/proc/stat), to tell a slow host from slow work."""
    t = os.times()
    with open("/proc/stat") as f:
        cpu = [int(x) for x in f.readline().split()[1:]]
    return dict(process_s=t.user + t.system, total=sum(cpu), steal=cpu[7] if len(cpu) > 7 else 0)


def _np_safe(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    raise TypeError(type(o))


def dumps(line: dict) -> str:
    return json.dumps(line, default=_np_safe)

"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the run's
answers (copied to the host by ``program.Program.outputs``) are judged
against the benchmark's own ground truth and the plain reference
(``reference/``), which takes nothing the program made:

- ``ate_cm``: every posed frame's camera centre, after the one similarity
  that best aligns the trajectory to the rendered path (Umeyama), against
  that path: root mean square, cm.
- ``map_err_pct``: the map's points seen from the keyframes that observe
  them: each point's depth in the keyframe (its estimated pose) against
  the rendered depth at the keypoint matched to it, after the one scale
  (the median ratio) that the monocular map leaves free: median relative
  error, %.
- ``bad_obs_pct``: the matched observations (the keyframes' and the last
  frame's keypoints matched to a map point): each point is back-projected
  from its first usable observation through the rendered depth and the
  true pose and projected into its other observing views; the share that
  lands further than ``obs_px`` pixels (at the keypoint's level) from the
  keypoint matched to it. A wrong K2 match lands on another part of the
  scene.
- ``frontend_bad_pct``: the keypoints of the last retired frame and of a
  few keyframes of the window, drawn from the seed: the largest share,
  over these frames, on which the reference disagrees
  (reference/frontend.py).
- ``k2_gap``: a sample of K2's searches in the window, drawn from the
  seed (``program.SearchSample``: the tracker's and the mapping
  worker's), searched again by the reference on the inputs each was
  handed (reference/search.py): the widest gap between K2's answers and
  the reference's, in bits (binary) or as a share of the query's distance
  scale (float); inf where K2 chose a candidate outside its gates, or
  none where one passed. The search's inputs are the program's own state;
  the stage that made them is judged by ``frontend_bad_pct``.
- ``lost_pct``: the window's frames whose pose never became known.

A cell's ``limits/<workload>.json`` names the numbers it compares, each
with its limit; a run is correct when none is exceeded. The others are
printed as readings: no control or fault separates them from sound runs
(PERF.md, section 2).
"""

from __future__ import annotations

import numpy as np
import torch

from . import scene
from .reference import frontend, geometry, search


def _frontend_views(outputs, window_first: int, n_keyframes: int, seed: int, init_at: int):
    """The last retired frame and up to `n_keyframes` keyframes made in the
    window (drawn from the seed; from all keyframes after the map's
    initialization if the window made fewer: the frames up to it are
    extracted with twice the features, as the reference initializes)."""
    kfs = [k for k in outputs["keyframes"] if k["frame"] > init_at]
    recent = [k for k in kfs if k["frame"] >= window_first]
    pool = recent if len(recent) >= n_keyframes else kfs
    rng = np.random.default_rng(seed)
    take = rng.choice(len(pool), size=min(n_keyframes, len(pool)), replace=False) if pool else []
    views = [pool[int(j)] for j in sorted(take)]
    if outputs["last"] is not None:
        views.append(outputs["last"])
    return views


def frontend_bad(views, frames, config: dict, device, control: bool = False):
    """(keypoints judged, keypoints the reference disagrees on). With
    `control`, the descriptors under test are the reference's own worked
    out in bfloat16, put in the program's place."""
    feature = config["feature"]
    cfg = dict(feature["settings"], n_features=feature["n_features"], **config["check"])
    n = bad = 0
    for v in views:
        img = frames[v["frame"]].to(device)
        uv = torch.from_numpy(np.asarray(v["uv"], np.float32)).to(device)
        octave = torch.from_numpy(np.asarray(v["octave"], np.int64)).to(device)
        desc = torch.from_numpy(np.asarray(v["desc"])).to(device)
        if feature["family"] == "orb32":
            if control:
                desc = frontend.orb_descriptors(img, uv, octave, cfg, torch.bfloat16)
            b, _, missing = frontend.orb_check(img, uv, octave, desc, cfg)
            n, bad = n + missing, bad + missing
        elif feature["family"] == "sift128":
            size = torch.from_numpy(np.asarray(v["size"], np.float32)).to(device)
            if control:
                desc = frontend.sift_descriptors(img, uv, octave, size, cfg, torch.bfloat16)
            b, _ = frontend.sift_check(img, uv, octave, size, desc, cfg)
        else:
            raise ValueError(f"no reference frontend for {feature['family']}")
        n += int(b.numel())
        bad += int(b.sum())
    return n, bad


def k2_gap(calls, device, control: bool = False):
    """(widest gap, queries judged) over the sampled searches. With
    `control`, the answers judged are the reference's own search in TF32
    (reference/search.py), put in K2's place."""
    widest, n = 0.0, 0
    for call in calls:
        c = {k: (tuple(t.to(device) for t in v) if isinstance(v, tuple)
                 else v.to(device) if isinstance(v, torch.Tensor) else v)
             for k, v in call.items() if k not in ("answer", "tracker")}
        answer = (search.search(c, "tf32") if control
                  else tuple(t.to(device) for t in call["answer"]))
        g, m = search.gap(c, *answer)
        widest, n = max(widest, g), n + m
    return (widest if n else float("inf")), n


def observations(views, gt_poses, plane, cam, scale: float, obs_px: float):
    """Over the matched observations: (compared, off their point's true
    projection by more than obs_px pixels at their level) and the
    keyframes' (estimated depth, rendered depth) pairs of their points."""
    views = sorted(views, key=lambda v: v["frame"])
    depth = {}
    for v in views:
        if v["frame"] not in depth:
            depth[v["frame"]] = plane.render(cam, gt_poses[v["frame"]][None])[1][0].cpu().numpy()
    anchor = {}  # point -> its true position, from its first usable observation
    usable = {}
    for v in views:
        has = np.nonzero(v["matches"] >= 0)[0]
        pts, ok = geometry.backproject(v["uv"][has], depth[v["frame"]], cam, gt_poses[v["frame"]])
        usable[id(v)] = (has[ok], pts[ok])
        for s, p in zip(has[ok], pts[ok]):
            anchor.setdefault(int(v["matches"][s]), p)
    n = bad = 0
    for v in views:
        has = np.array([s for s in np.nonzero(v["matches"] >= 0)[0]
                        if int(v["matches"][s]) in anchor], np.int64)
        if has.size == 0:
            continue
        x = np.stack([anchor[int(v["matches"][s])] for s in has])
        err = np.linalg.norm(geometry.project(x, cam, gt_poses[v["frame"]]) - v["uv"][has], axis=1)
        err = err / scale ** v["octave"][has].astype(np.float64)
        n += int(has.size)
        bad += int((err > obs_px).sum())
    return n, bad, depth, usable


def depth_pairs(keyframes, points, valid, depth, usable):
    """(estimated depth, rendered depth) of each keyframe's usable
    observations of a valid map point."""
    est, true = [], []
    for v in keyframes:
        slots, _ = usable[id(v)]
        ids = v["matches"][slots]
        keep = valid[ids]
        slots, ids = slots[keep], ids[keep]
        if slots.size == 0:
            continue
        t = v["pose"]
        z = points[ids] @ t[2, :3] + t[2, 3]
        h, w = depth[v["frame"]].shape
        xi = np.clip(np.round(v["uv"][slots, 0]).astype(np.int64), 0, w - 1)
        yi = np.clip(np.round(v["uv"][slots, 1]).astype(np.int64), 0, h - 1)
        est.append(z)
        true.append(depth[v["frame"]][yi, xi].astype(np.float64))
    if not est:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(est), np.concatenate(true)


def numbers(outputs, frames, gt_poses, traffic: dict, config: dict, window: dict, seed: int,
            device, control: bool = False) -> dict:
    """{name: value} of every number compared (see the module's doc)."""
    cam = config["camera"]
    feature = config["feature"]
    check = config["check"]
    plane = scene.ReliefPlane(traffic["scene"], device)
    got = {}
    posed = sorted(outputs["poses"])
    if len(posed) >= 3:
        est_poses = np.stack([outputs["poses"][j] for j in posed])
        sim = geometry.align(est_poses, gt_poses[posed])
        est, true = geometry.centres(est_poses), geometry.centres(gt_poses[posed])
        got["ate_cm"] = 100.0 * float(np.sqrt(np.mean(np.sum(
            (geometry.apply(sim, est) - true) ** 2, axis=1))))
    else:
        got["ate_cm"] = float("inf")
    views = list(outputs["keyframes"]) + ([outputs["last"]] if outputs["last"] else [])
    n_obs, n_bad, depth, usable = observations(views, gt_poses, plane, cam,
                                               float(feature["settings"]["scale_factor"]),
                                               float(check["obs_px"]))
    z_est, z_true = depth_pairs(outputs["keyframes"], outputs["points"], outputs["point_valid"],
                                depth, usable)
    ok = z_est > 0
    if ok.sum() >= 10:
        s = float(np.median(z_true[ok] / z_est[ok]))
        got["map_err_pct"] = 100.0 * float(np.median(np.abs(s * z_est[ok] - z_true[ok])
                                                     / z_true[ok]))
    else:
        got["map_err_pct"] = float("inf")
    got["bad_obs_pct"] = 100.0 * n_bad / n_obs if n_obs else float("inf")
    shares = []
    for v in _frontend_views(outputs, window["first"], int(check["keyframes"]), seed,
                             window["init_at"]):
        n_kp, n_kp_bad = frontend_bad([v], frames, config, device, control)
        shares.append(100.0 * n_kp_bad / n_kp if n_kp else float("inf"))
    got["frontend_bad_pct"] = max(shares, default=float("inf"))
    got["k2_gap"], got["k2_queries"] = k2_gap(outputs["searches"], device, control)
    got["lost_pct"] = 100.0 * window["failed"] / max(window["attempted"], 1)
    return got

"""Frame-by-frame trace of the synchronous System of either package, to
find where the two part (the brisk48 trace of ROADMAP.md section 3).

    JAX_PLATFORMS=cpu python tests/system_trace.py trace jax out_jax.pkl [n] [feature]
    python tests/system_trace.py trace port out_port.pkl [n] [feature]
    python tests/system_trace.py trace port_jax_features out_pj.pkl [n] [feature]
    python tests/system_trace.py compare out_jax.pkl out_port.pkl
    JAX_PLATFORMS=cpu python tests/system_trace.py replay_ba out_port.pkl

``trace`` runs the System (``async_mapping=False``, loop closing on, the
shipped vocabulary) over the first n frames (default 48) of
tests/torch_slice_scene.py's bench sequence at 640x480 with 1000 features
(default feature brisk48) on the CPU, with every BLAS / OpenMP pool and
torch's intra-op pool at one thread (tests/torch_system_parity.py), and
pickles per frame the state, keyframe and point counts, inliers, the
frame's matches, the keyframe poses by frame, and every local BA's
problem and result. ``port_jax_features`` is the port's System fed the
JAX package's extraction of each frame. ``compare`` prints the two runs
side by side (counts, the largest keyframe-centre difference, the
keyframe ATE) and the BA problems they share; ``replay_ba`` solves each
recorded port BA problem with the JAX package's solver and prints how far
its keyframe centres land from the port's.
"""

import os
import pickle
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

W, H, N_FEATURES = 640, 480, 1000


def _centre(t):
    import numpy as np

    t = np.asarray(t, np.float64)
    return -t[:3, :3].T @ t[:3, 3]


def _jax_feature_extractor(ext):
    """The port's extractor `ext` replaced by the JAX package's extraction
    with the same settings (its outputs cast to the port's dtypes)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from anyfeature_vslam_tpu.frontend import extractor as jext

    cfg = ext.cfg
    jcfg = jext.ExtractorConfig(n_features=cfg.n_features, n_levels=cfg.n_levels,
                                scale_factor=cfg.scale_factor, detect_th=cfg.detect_th,
                                detector=cfg.detector, descriptor=cfg.descriptor)
    fn = jax.jit(lambda im: jext.extract_features(im, jcfg, H, W))

    def call(img):
        ref = ext(img)
        return {k: torch.from_numpy(np.asarray(v).copy()).to(ref[k].dtype)
                for k, v in fn(jnp.asarray(img.cpu().numpy())).items()}
    return call


def trace(package, out, n_frames=48, feature="brisk48"):
    import numpy as np
    import torch
    from threadpoolctl import threadpool_limits

    from torch_slice_scene import SliceScene

    sc = SliceScene(W, H)
    rec_ba = []
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from anyfeature_vslam_tpu.ops.camera import CameraParams
        from anyfeature_vslam_tpu.slam import local_mapping as lm
        from anyfeature_vslam_tpu.system import System

        system = System(CameraParams.create(**sc.camera), feature=feature,
                        n_features=N_FEATURES, use_mesh=False, async_mapping=False)
        host = np.asarray
    else:
        from types import SimpleNamespace

        from anyfeature_vslam_tpu_torch.slam import local_mapping as lm
        from anyfeature_vslam_tpu_torch.system import System

        system = System(SimpleNamespace(**sc.camera), feature=feature, n_features=N_FEATURES,
                        device="cpu", async_mapping=False)
        host = lambda x: x.cpu().numpy()  # noqa: E731
        if package == "port_jax_features":
            import jax

            jax.config.update("jax_platforms", "cpu")
            system.tracker.extractor = _jax_feature_extractor(system.tracker.extractor)
            system.tracker.extractor_init = _jax_feature_extractor(system.tracker.extractor_init)
    solve = lm.ba_ops.bundle_adjust_two_stage

    def recording(*a, **kw):
        res = solve(*a, **kw)
        rec_ba.append(dict(frame=system.tracker.frame_id - 1, kw=kw,
                           args=[host(x).copy() if hasattr(x, "shape") else x for x in a],
                           out=[host(x).copy() for x in res]))
        return res

    lm.ba_ops.bundle_adjust_two_stage = recording
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rows = []
    t0 = time.perf_counter()
    try:
        with threadpool_limits(limits=1):
            for i in range(n_frames):
                state = system.track_monocular(sc.render(i)[0], i / 30.0)
                m, tr = system.map, system.tracker
                last = getattr(tr, "last", None)
                matches = getattr(last, "matches", None) if last is not None else None
                rows.append(dict(
                    i=i, state=state.name, n_kf=m.n_keyframes(), n_pts=m.n_points(),
                    inliers=int(tr.n_inliers),
                    n_matches=-1 if matches is None else int((np.asarray(matches) >= 0).sum()),
                    kf_poses={int(m.kf_frame_id[k]): np.asarray(m.kf_pose[k]).copy()
                              for k in m.keyframe_ids()},
                    last_kf_frame=int(tr.last_kf_frame_id)))
                r = rows[-1]
                print(i, r["state"], r["n_kf"], r["n_pts"], r["inliers"], r["n_matches"],
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        lm.ba_ops.bundle_adjust_two_stage = solve
        torch.set_num_threads(n_threads)
    with open(out, "wb") as f:
        pickle.dump(dict(rows=rows, stats=dict(system.tracker.stats), ba=rec_ba), f)
    system.shutdown()


def _keyframe_ate(row, sc):
    import numpy as np

    from anyfeature_vslam_tpu_torch.io import evaluation

    kp = row["kf_poses"]
    if len(kp) < 3:
        return float("nan")
    est = np.stack([_centre(kp[f]) for f in sorted(kp)])
    gt = np.stack([_centre(sc.poses[f]) for f in sorted(kp)])
    return evaluation.ate_rmse(est, gt)[0]


def compare(path_a, path_b):
    import numpy as np

    from torch_slice_scene import SliceScene

    sc = SliceScene(W, H)
    with open(path_a, "rb") as f:
        a = pickle.load(f)
    with open(path_b, "rb") as f:
        b = pickle.load(f)
    print("stats", a["stats"], b["stats"])
    for ra, rb in zip(a["rows"], b["rows"]):
        common = sorted(set(ra["kf_poses"]) & set(rb["kf_poses"]))
        dk = max([np.linalg.norm(_centre(ra["kf_poses"][f]) - _centre(rb["kf_poses"][f]))
                  for f in common] or [0.0])
        print(ra["i"], ra["state"], rb["state"],
              *(f"{k} {ra[k]} {rb[k]}" for k in ("n_kf", "n_pts", "inliers", "n_matches",
                                                  "last_kf_frame")),
              f"max keyframe centre diff {dk:.2e}",
              "same keyframes" if sorted(ra["kf_poses"]) == sorted(rb["kf_poses"]) else "",
              f"keyframe ATE cm {100 * _keyframe_ate(ra, sc):.3f} {100 * _keyframe_ate(rb, sc):.3f}")
    names = ("poses", "points", "free", "obs_kf", "obs_pt", "obs_uv", "obs_w", "obs_valid")
    for ra, rb in zip(a["ba"], b["ba"]):
        parts = []
        for name, x, y in zip(names, ra["args"], rb["args"]):
            x, y = np.asarray(x), np.asarray(y)
            if x.shape != y.shape:
                parts.append(f"{name} shapes {x.shape} {y.shape}")
            elif x.dtype == bool or np.issubdtype(x.dtype, np.integer):
                parts.append(f"{name} {int((x != y).sum())} differ")
            else:
                parts.append(f"{name} {np.abs(x.astype(np.float64) - y).max():.1e}")
        free = np.asarray(ra["args"][2])
        d = max(np.linalg.norm(_centre(ra["out"][0][k]) - _centre(rb["out"][0][k]))
                for k in np.nonzero(free)[0])
        print(f"BA at frame {ra['frame']}:", ", ".join(parts),
              f"| solved keyframe centres {d:.2e} apart")


def replay_ba(path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from threadpoolctl import threadpool_limits

    from anyfeature_vslam_tpu.ops import ba as jba

    with open(path, "rb") as f:
        recs = pickle.load(f)["ba"]
    with threadpool_limits(limits=1):
        for r in recs:
            res = jba.bundle_adjust_two_stage(
                *(jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in r["args"]),
                **r["kw"])
            free = np.asarray(r["args"][2])
            d = max(np.linalg.norm(_centre(np.asarray(res[0])[k]) - _centre(r["out"][0][k]))
                    for k in np.nonzero(free)[0])
            print(f"BA at frame {r['frame']}: {int(free.sum())} free keyframes; JAX's solve "
                  f"of the port's problem {d:.2e} from the port's keyframe centres, points "
                  f"{np.abs(np.asarray(res[1]) - r['out'][1]).max():.2e}")


if __name__ == "__main__":
    cmd, rest = sys.argv[1], sys.argv[2:]
    if cmd == "trace":
        trace(rest[0], rest[1], *(int(x) for x in rest[2:3]), *rest[3:4])
    elif cmd == "compare":
        compare(*rest)
    else:
        replay_ba(*rest)

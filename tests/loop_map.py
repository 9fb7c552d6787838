"""A constructed loop map in numpy only, for the loop-closing tests of
both packages and for chip_smoke.py (which may not import JAX).

The keyframes of ``tests/test_loop_closing_unit.py:build_loop_map``: a
circle of keyframes whose points live in tracks observed by consecutive
keyframes (a covisibility chain); the last three keyframes re-observe
duplicates of the first ones' points (same descriptors, drift-displaced
positions) and a smooth SE3 drift corrupts the second half, so only
the loop discrepancy carries the error. ``map_cls`` is either package's
SlamMap (with its constructor arguments bound); the drift's SE3
exponential is computed here in float64.
"""

import numpy as np

FX = FY = 300.0
CX, CY = 160.0, 120.0
WIDTH, HEIGHT = 320, 240
N_FEAT = 256
CAMERA = dict(fx=FX, fy=FY, cx=CX, cy=CY, width=WIDTH, height=HEIGHT)


def se3_exp(xi):
    """(6,) tangent (rho, phi) -> 4x4 float32 transform (closed form)."""
    rho, phi = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(phi)
    k = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-8:
        a, b, c = 1.0, 0.5, 1.0 / 6.0
    else:
        a, b, c = np.sin(th) / th, (1 - np.cos(th)) / th ** 2, (th - np.sin(th)) / th ** 3
    t = np.eye(4)
    t[:3, :3] = np.eye(3) + a * k + b * k @ k
    t[:3, 3] = (np.eye(3) + b * k + c * k @ k) @ rho
    return t.astype(np.float32)


def _empty_feats():
    return dict(uv_und=np.zeros((N_FEAT, 2), np.float32),
                desc_bits=np.zeros((N_FEAT, 256), np.uint8),
                octave=np.zeros(N_FEAT, np.int32), size=np.ones(N_FEAT, np.float32),
                angle=np.zeros(N_FEAT, np.float32), inv_sigma2=np.ones(N_FEAT, np.float32),
                valid=np.zeros(N_FEAT, bool))


def build_loop_map(map_cls, n_kf=26, drift_deg=8.0, seed=0):
    """Returns (map, gt_pose): gt_pose(i) is keyframe i's true 4x4 T_cw."""
    rng = np.random.default_rng(seed)
    m = map_cls(max_kf=32, max_pt=8000, n_feat=N_FEAT)

    def gt_pose(i):
        ang = 2 * np.pi * i / (n_kf - 3)
        c = np.array([2.0 * np.cos(ang), 2.0 * np.sin(ang), 0.0])
        zax = np.array([np.cos(ang), np.sin(ang), 0.0])
        xax = np.array([-np.sin(ang), np.cos(ang), 0.0])
        t_wc = np.eye(4)
        t_wc[:3, :3] = np.stack([xax, np.cross(zax, xax), zax], axis=1)
        t_wc[:3, 3] = c
        return np.linalg.inv(t_wc).astype(np.float32)

    def drift(i):
        if i <= n_kf // 2:
            return np.eye(4, dtype=np.float32)
        frac = (i - n_kf // 2) / (n_kf // 2)
        return se3_exp(np.array([0.08 * frac, 0.02 * frac, 0, 0, 0,
                                 np.radians(drift_deg) * frac], np.float32))

    n_new = 60
    track_pts = {}
    per_kf_obs = {i: [] for i in range(n_kf)}
    for i in range(n_kf - 3):
        t_wc_gt = np.linalg.inv(gt_pose(i))
        uv0 = rng.uniform([20, 20], [300, 220], (n_new, 2))
        z = rng.uniform(3.0, 5.0, n_new)
        pc = np.stack([(uv0[:, 0] - CX) / FX * z, (uv0[:, 1] - CY) / FY * z, z], -1)
        pw_true = pc @ t_wc_gt[:3, :3].T + t_wc_gt[:3, 3]
        d = drift(i)
        pw_stored = pw_true @ d[:3, :3].T + d[:3, 3]
        descs = rng.integers(0, 2, (n_new, 256)).astype(np.uint8)
        ids = m.add_points(pw_stored.astype(np.float32), descs, ref_kf=i,
                           ref_sizes=np.ones(n_new, np.float32))
        track_pts[i] = (ids, pw_stored, descs)
        for k in range(i, min(i + 4, n_kf - 3)):
            per_kf_obs[k].append((ids, pw_stored, descs))
    # revisit keyframes: duplicates of KF0 / KF1 / KF2 points plus the last
    # regular tracks
    for j, i in enumerate((n_kf - 3, n_kf - 2, n_kf - 1)):
        _, src_pw, src_descs = track_pts[j]
        d = drift(i)
        pw_dup = src_pw @ d[:3, :3].T + d[:3, 3]
        dup_ids = m.add_points(pw_dup.astype(np.float32), src_descs, ref_kf=i,
                               ref_sizes=np.ones(len(src_pw), np.float32))
        per_kf_obs[i].append((dup_ids, pw_dup, src_descs))
        for back in (n_kf - 4, n_kf - 5, n_kf - 6):
            per_kf_obs[i].append(track_pts[back])
    for i in range(n_kf):
        t_d = gt_pose(i) @ np.linalg.inv(drift(i))
        feats = _empty_feats()
        matches = np.full(N_FEAT, -1, np.int32)
        slot = 0
        for ids, pw, descs in per_kf_obs[i]:
            pc = pw @ t_d[:3, :3].T + t_d[:3, 3]
            vis = pc[:, 2] > 0.5
            uv = np.stack([FX * pc[:, 0] / np.clip(pc[:, 2], 1e-6, None) + CX,
                           FY * pc[:, 1] / np.clip(pc[:, 2], 1e-6, None) + CY], -1)
            vis &= (uv[:, 0] > 0) & (uv[:, 0] < WIDTH) & (uv[:, 1] > 0) & (uv[:, 1] < HEIGHT)
            for t_idx in np.nonzero(vis)[0]:
                if slot >= N_FEAT:
                    break
                feats["uv_und"][slot] = uv[t_idx]
                feats["desc_bits"][slot] = descs[t_idx]
                feats["valid"][slot] = True
                matches[slot] = ids[t_idx]
                slot += 1
        m.add_keyframe(t_d, ts=i / 30.0, frame_id=i, feats=feats, matches=matches)
    m.update_point_stats()
    return m, gt_pose


def end_drift(m, gt_pose, n_kf):
    """Largest pose discrepancy (max abs of the relative pose's rotation
    vector and translation) of the last two keyframes against truth."""
    errs = []
    for i in (n_kf - 2, n_kf - 1):
        rel = (m.kf_pose[i] @ np.linalg.inv(gt_pose(i))).astype(np.float64)
        r = rel[:3, :3]
        w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
        th = np.arctan2(0.5 * np.linalg.norm(w), 0.5 * (np.trace(r) - 1))
        errs.append(max(th, np.abs(rel[:3, 3]).max()))
    return max(errs)


def train_map_vocabulary(m, train_vocabulary, branching=16, depth=2, iters=4):
    """A vocabulary trained on the map's keyframe descriptors."""
    descs = np.concatenate([m.kf_desc_bits[k][m.kf_feat_valid[k]] for k in m.keyframe_ids()])
    return train_vocabulary(descs, branching=branching, depth=depth, iters=iters)

"""Point-sharded bundle adjustment over a torch.distributed process group
(port of anyfeature_vslam_tpu/parallel/point_sharded_ba.py): for maps too
large to replicate on every rank.

The point blocks are split over the ranks and every observation is placed
on the rank that owns its point, so:

  - point Hessian blocks, gradients and Y^T products are complete on
    their rank: no communication;
  - only the camera-side sums (Hcc, bc, Y products: O(K*36) floats) and
    the cost are summed over the group, whatever the observation count
    and the map size.

The reference has no counterpart (its global BA is one g2o solve on one
thread, reference src/Optimizer.cc:61-243; SURVEY 2.7).

Host numpy ``partition_by_point`` reorders the COO observation arrays
into per-rank blocks of contiguous point ranges, with point ids made
local; ``unpartition`` maps per-observation outputs back (both copied
from the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba
from .sharded_ba import Mesh


def partition_by_point(pts, obs_kf, obs_pt, obs_uv, obs_w, obs_valid, n_dev: int):
    """Reorder observations into per-rank blocks by point ownership.

    Points are block-partitioned: rank d owns global points
    [d*chunk, (d+1)*chunk). Returns (pts_padded, obs dict with per-rank
    blocks of equal length, perm) where obs_pt holds LOCAL point indices
    and `perm` maps packed order -> original order (for unpartition).
    """
    p = len(pts)
    chunk = -(-p // n_dev)
    pts_pad = np.zeros((chunk * n_dev, 3), np.float32)
    pts_pad[:p] = pts

    owner = np.asarray(obs_pt) // chunk
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_dev)
    per_dev = int(counts.max()) if len(counts) else 1
    # round up so every rank's block has identical length
    o_kf = np.zeros(per_dev * n_dev, np.int32)
    o_pt = np.zeros(per_dev * n_dev, np.int32)
    o_uv = np.zeros((per_dev * n_dev, 2), np.float32)
    o_w = np.zeros(per_dev * n_dev, np.float32)
    o_val = np.zeros(per_dev * n_dev, bool)
    perm = np.full(per_dev * n_dev, -1, np.int64)
    start = 0
    for d in range(n_dev):
        idx = order[start:start + counts[d]]
        start += counts[d]
        base = d * per_dev
        n = len(idx)
        o_kf[base:base + n] = obs_kf[idx]
        o_pt[base:base + n] = obs_pt[idx] - d * chunk  # local index
        o_uv[base:base + n] = obs_uv[idx]
        o_w[base:base + n] = obs_w[idx]
        o_val[base:base + n] = obs_valid[idx]
        perm[base:base + n] = idx
    return pts_pad, dict(obs_kf=o_kf, obs_pt=o_pt, obs_uv=o_uv, obs_w=o_w,
                         obs_valid=o_val), perm


def unpartition(values, perm, n_orig: int, fill=np.inf):
    """Map packed per-rank outputs back to original observation order."""
    out = np.full((n_orig,) + values.shape[1:], fill, values.dtype)
    ok = perm >= 0
    out[perm[ok]] = values[ok]
    return out


def point_sharded_bundle_adjust(mesh: Mesh, poses, pts_pad, kf_free, obs, fx, fy, cx, cy,
                                n_iters: int = 10, n_cg: int = 25, use_huber: bool = True):
    """BA with points and observations split by rank. `pts_pad` (tensor)
    and `obs` (dict of tensors) come from partition_by_point with n_dev ==
    mesh.size, the same on every rank. Returns (poses, pts_pad, chi2_packed,
    z_packed) on every rank, in the partitioned layout."""
    n_pts, n_obs = pts_pad.shape[0], obs["obs_kf"].shape[0]
    if n_pts % mesh.size or n_obs % mesh.size:
        raise ValueError(f"{n_pts} points / {n_obs} observations do not split over "
                         f"{mesh.size} ranks")
    ps = slice(mesh.rank * n_pts // mesh.size, (mesh.rank + 1) * n_pts // mesh.size)
    os_ = slice(mesh.rank * n_obs // mesh.size, (mesh.rank + 1) * n_obs // mesh.size)
    poses, pts, chi2, z = ba._bundle_adjust_impl(
        poses, pts_pad[ps], kf_free, *(obs[k][os_] for k in (
            "obs_kf", "obs_pt", "obs_uv", "obs_w", "obs_valid")),
        fx, fy, cx, cy, n_iters=n_iters, n_cg=n_cg, use_huber=use_huber,
        all_reduce=mesh.all_reduce, points_sharded=True)
    return poses, mesh.all_gather(pts), mesh.all_gather(chi2), mesh.all_gather(z)


def global_ba_point_sharded(poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w, obs_valid,
                            fx, fy, cx, cy, *, mesh: Mesh, n_iters: int = 10, n_cg: int = 25):
    """Partition, solve, unpartition: the global-map BA over a mesh. The
    arrays are tensors on one device (where the solve runs), the same on
    every rank (Mesh.check_same raises otherwise). Returns numpy (poses,
    pts, chi2, z) in the original order, as the JAX package does."""
    device = poses.device
    host = [t.cpu().numpy() for t in (pts, obs_kf, obs_pt, obs_uv, obs_w, obs_valid)]
    mesh.check_same(poses.cpu().numpy(), kf_free.cpu().numpy(), *host,
                    np.array([fx, fy, cx, cy, n_iters, n_cg], np.float64))
    pts_pad, obs, perm = partition_by_point(*host, mesh.size)
    poses2, pts2, chi2, z = point_sharded_bundle_adjust(
        mesh, poses, torch.from_numpy(pts_pad).to(device), kf_free,
        {k: torch.from_numpy(v).to(device) for k, v in obs.items()}, fx, fy, cx, cy,
        n_iters=n_iters, n_cg=n_cg)
    n_orig = len(host[1])
    return (poses2.cpu().numpy(), pts2.cpu().numpy()[:len(host[0])],
            unpartition(chi2.cpu().numpy(), perm, n_orig, fill=np.inf),
            unpartition(z.cpu().numpy(), perm, n_orig, fill=0.0))

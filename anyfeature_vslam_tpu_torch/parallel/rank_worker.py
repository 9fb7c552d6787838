"""One rank of the port's BA spread over a gloo process group.

    python -m anyfeature_vslam_tpu_torch.parallel.rank_worker <problem.npz> \
        <rank> <world> <store file> <device> <out.npz>

Run one process per rank, each from the repository root (or with it on
PYTHONPATH). The ranks meet through a file store (no network). Each loads
a BA problem (poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w,
obs_valid, intr = (fx, fy, cx, cy), n_iters and, optionally, solves: a
comma list of "obs", "two_stage", "point"), runs the observation-sharded
solve, the sharded two-stage schedule and the point-sharded global solve
on `device` (``cpu`` or ``cuda``: gloo reduces CUDA tensors through the
host), and writes their outputs and milliseconds (ms_<solve>) to
<out.npz>. The first all-reduce runs before the timed windows. Every rank
must be given the same problem: the point-sharded solve raises otherwise.
"""

from __future__ import annotations

import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from . import point_sharded_ba, sharded_ba

KEYS = ("poses", "pts", "kf_free", "obs_kf", "obs_pt", "obs_uv", "obs_w", "obs_valid")


def main(argv):
    prob_path, rank, world, store, device, out_path = argv
    rank, world, device = int(rank), int(world), torch.device(device)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = sharded_ba.make_mesh(device)
        assert (mesh.size, mesh.rank) == (world, rank)
        z = np.load(prob_path)
        args = [torch.from_numpy(z[k]).to(device) for k in KEYS]
        args += [float(v) for v in z["intr"]]
        n_iters = int(z["n_iters"])
        mesh.all_reduce(torch.zeros(1, device=device))

        def timed(fn):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return out, (time.perf_counter() - t0) * 1e3

        host = lambda t: t.cpu().numpy()  # noqa: E731
        out, ms = {}, {}
        solves = str(z["solves"]).split(",") if "solves" in z else ["obs", "two_stage", "point"]
        if "obs" in solves:
            (p, x, c, zz), ms["obs"] = timed(
                lambda: sharded_ba.sharded_bundle_adjust(mesh, *args, n_iters=n_iters))
            out.update(poses=host(p), pts=host(x), chi2=host(c), z=host(zz))
        if "two_stage" in solves:
            (p, x, c, zz, v), ms["two_stage"] = timed(
                lambda: sharded_ba.sharded_bundle_adjust_two_stage(mesh, *args))
            out.update(ts_poses=host(p), ts_pts=host(x), ts_chi2=host(c), ts_valid=host(v))
        if "point" in solves:
            (p, x, c, zz), ms["point"] = timed(
                lambda: point_sharded_ba.global_ba_point_sharded(*args, mesh=mesh,
                                                                 n_iters=n_iters))
            out.update(ps_poses=p, ps_pts=x, ps_chi2=c, ps_z=zz)
        np.savez(out_path, **out, **{f"ms_{k}": v for k, v in ms.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

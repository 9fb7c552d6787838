"""Bundle-adjustment throughput benchmark of the port. Port of
tools/bench_ba.py: the same synthetic problems (noisy poses / points /
observations with a known ground truth, numpy, seeded) through
``ops/ba.bundle_adjust`` on `device`, reporting wall time, time per LM
iteration and observation throughput, each line with the card's name and
power limit. With --mesh N it also times ``parallel/point_sharded_ba``
over 1, 2, 4, 8 ranks up to N: NCCL with one card per rank on the card
(rank counts above the cards present are skipped, and the line says so),
gloo ranks on the CPU with --cpu, each rank a spawned process meeting the
others through a file store.

Usage:
  python -m anyfeature_vslam_tpu_torch.tools.bench_ba                # the card
  python -m anyfeature_vslam_tpu_torch.tools.bench_ba --cpu --mesh 2 # CPU ranks

--scale F divides the points and observations of both problems by F (a
quick run at a small size); the default 1 is the JAX tool's sizes.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ._timing import card_label

# (label, K cams, P points, O observations): local-BA and global-BA scale
SIZES = (("local_ba", 16, 4096, 16384), ("global_ba", 128, 32768, 262144))


def make_problem(k: int, p: int, o: int, seed: int = 0):
    """Synthetic forward-motion scene with reprojection-consistent obs
    (tools/bench_ba.py's generator, draw for draw)."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    for i in range(k):
        poses[i, 0, 3] = 0.05 * i
        poses[i, 1, 3] = 0.02 * np.sin(0.3 * i)
    pts = rng.uniform([-2, -2, 4], [2, 2, 12], (p, 3)).astype(np.float32)
    obs_kf = rng.integers(0, k, o).astype(np.int32)
    obs_pt = rng.integers(0, p, o).astype(np.int32)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    pc = (np.einsum("oij,oj->oi", poses[obs_kf][:, :3, :3], pts[obs_pt])
          + poses[obs_kf][:, :3, 3])
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)  # 0.5 px noise
    # perturb the state the solver starts from
    poses_n = poses.copy()
    poses_n[1:, :3, 3] += rng.normal(0, 0.02, (k - 1, 3))
    pts_n = pts + rng.normal(0, 0.05, pts.shape)
    free = np.ones(k, bool)
    free[0] = False
    w = np.ones(o, np.float32)
    valid = np.ones(o, bool)
    return (poses_n.astype(np.float32), pts_n.astype(np.float32), free,
            obs_kf, obs_pt, uv.astype(np.float32), w, valid, fx, fy, cx, cy)


def sizes(scale: float):
    return [(label, k, max(int(p / scale), 8), max(int(o / scale), 64))
            for label, k, p, o in SIZES]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensors(prob, device):
    import torch

    return [torch.from_numpy(x).to(device) if isinstance(x, np.ndarray) else x for x in prob]


def _point_sharded_ms(prob, mesh, device, iters):
    """(first call ms, second call ms) of the point-sharded global BA."""
    from ..parallel import point_sharded_ba

    args = _tensors(prob, device)
    times = []
    for _ in range(2):
        _sync(device)
        t0 = time.perf_counter()
        point_sharded_ba.global_ba_point_sharded(*args[:8], *args[8:], mesh=mesh,
                                                 n_iters=iters, n_cg=25)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _rank(rank, world, store, use_cpu, prob, iters, out_path):
    """One rank of a spawned point-sharded run; rank 0 saves its times."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from ..parallel import sharded_ba

    device = torch.device("cpu") if use_cpu else torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo" if use_cpu else "nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=300))
    try:
        times = _point_sharded_ms(prob, sharded_ba.make_mesh(device), device, iters)
        if rank == 0:
            np.save(out_path, np.array(times))
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    from ..ops import ba

    device = torch.device("cpu" if args.cpu else "cuda")
    n_cards = 0 if args.cpu else torch.cuda.device_count()
    card = card_label(device)
    print(f"backend: {device.type}  devices: {n_cards if n_cards else 1}  ({card})", flush=True)

    for label, k, p, o in sizes(args.scale):
        prob = _tensors(make_problem(k, p, o), device)

        def solve():
            return ba.bundle_adjust(*prob, n_iters=args.iters, n_cg=25)

        out = solve()  # warm
        _sync(device)
        t0 = time.perf_counter()
        n_rounds = 3
        for _ in range(n_rounds):
            out = solve()
        _sync(device)
        dt = (time.perf_counter() - t0) / n_rounds
        chi2 = out[2].cpu().numpy()
        mean_chi2 = float(np.nanmean(np.where(np.isfinite(chi2), chi2, np.nan)))
        print(f"{label}: K={k} P={p} O={o}  {dt*1e3:.1f} ms "
              f"({dt/args.iters*1e3:.2f} ms/LM-iter, "
              f"{o*args.iters/dt/1e6:.1f} M obs-iters/s)  mean chi2={mean_chi2:.3f}  ({card})",
              flush=True)

    if args.mesh:
        import multiprocessing

        from ..parallel import sharded_ba

        label, k, p, o = sizes(args.scale)[-1]
        prob = make_problem(k, p, o)
        for n_dev in [d for d in (1, 2, 4, 8) if d <= args.mesh]:
            if n_dev > 1 and not args.cpu and n_dev > n_cards:
                print(f"point_sharded global_ba on {n_dev} devices: skipped, {n_cards} "
                      f"card(s) here and NCCL takes one card per rank ({card})", flush=True)
                continue
            if n_dev == 1:
                mesh = sharded_ba.make_mesh(device)
                try:
                    warm, dt = _point_sharded_ms(prob, mesh, device, args.iters)
                finally:
                    mesh.close()
            else:
                with tempfile.TemporaryDirectory() as tmp:
                    out_path = os.path.join(tmp, "times.npy")
                    ctx = multiprocessing.get_context("spawn")
                    procs = [ctx.Process(target=_rank, args=(r, n_dev, os.path.join(tmp, "store"),
                                                             args.cpu, prob, args.iters,
                                                             out_path))
                             for r in range(n_dev)]
                    for proc in procs:
                        proc.start()
                    for proc in procs:
                        proc.join()
                    if any(proc.exitcode != 0 for proc in procs):
                        raise RuntimeError(f"a rank of the {n_dev}-rank run failed: "
                                           f"{[proc.exitcode for proc in procs]}")
                    warm, dt = np.load(out_path)
            print(f"point_sharded global_ba on {n_dev} devices: {dt:.1f} ms "
                  f"(first call incl. partition {warm:.0f} ms)  ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

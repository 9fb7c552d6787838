"""Observation-sharded bundle adjustment over a torch.distributed process
group (port of anyfeature_vslam_tpu/parallel/sharded_ba.py).

The reference has no distributed backend (SURVEY 2.7): its global BA is
one g2o solve on one CPU thread. Here the factor graph's observations are
split by rank while poses and points stay replicated: every rank is given
the whole problem, solves its slice of the observations with
``ops.ba._bundle_adjust_impl`` and sums the camera blocks, point blocks,
Schur products and the cost over the group with
``torch.distributed.all_reduce``. Per iteration the ranks exchange O(K*36
+ P*9) floats, whatever the observation count. As in the JAX package the
sharded solve is always the matrix-free CG path, never the dense one.

A ``Mesh`` is a handle on the default process group and its size (the
JAX package's device mesh). ``make_mesh`` takes the default group, or
makes a one-rank group (NCCL for a CUDA device, gloo otherwise) when none
is initialized: the path of a one-card user. Every rank must run each
solve, in the same order, on the same problem; ``Mesh.check_same`` holds
the ranks to that before a solve.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

from .. import perfcount
from ..ops import ba


@dataclass
class Mesh:
    size: int
    rank: int
    device: torch.device  # where the group's collectives take tensors
    owns_group: bool = False  # make_mesh initialized the default group

    def all_reduce(self, x):
        """x summed over the ranks, in place; returns x."""
        dist.all_reduce(x)
        return x

    def all_gather(self, x):
        """The ranks' x concatenated along the first axis, in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def check_same(self, *arrays):
        """Raise ValueError unless every rank passed equal host arrays
        (dtypes, shapes and bytes, by CRC-32 and Adler-32). Ranks that
        solve different problems would otherwise add each other's blocks
        into one solve when their shapes agree, or stop at mismatched
        collectives when they do not. One blocking fetch; nothing at one
        rank. A rank that issues no further solve still leaves the others
        waiting until the group's timeout."""
        if self.size == 1:
            return
        crc, adler = 0, 1
        for a in arrays:
            a = np.ascontiguousarray(a)
            for b in (f"{a.dtype.str}{a.shape}".encode(), a.reshape(-1).view(np.uint8)):
                crc, adler = zlib.crc32(b, crc), zlib.adler32(b, adler)
        mine = torch.tensor([len(arrays), crc, adler], dtype=torch.int64, device=self.device)
        with perfcount.timed_fetch():
            every = self.all_gather(mine).view(self.size, -1).cpu()
        if not bool((every == every[0]).all()):
            raise ValueError(f"rank {self.rank}: the ranks' BA problems differ (fingerprints "
                             f"{every.tolist()}); every rank must run the same solves on the "
                             f"same data")

    def close(self):
        """Destroy the default group if make_mesh created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def make_mesh(device) -> Mesh:
    """A Mesh over the default group, whose collectives take tensors on
    `device`. Without an initialized default group, a one-rank one is made:
    NCCL for a CUDA device, gloo otherwise (an in-memory store, no
    network)."""
    device = torch.device(device)
    owns = False
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        owns = True
    return Mesh(size=dist.get_world_size(), rank=dist.get_rank(), device=device,
                owns_group=owns)


def _shard(mesh: Mesh, n: int) -> slice:
    if n % mesh.size != 0:
        raise ValueError(f"obs count {n} not divisible by mesh size {mesh.size}")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def sharded_bundle_adjust(mesh: Mesh, poses, pts, kf_free, obs_kf, obs_pt, obs_uv, obs_w,
                          obs_valid, fx, fy, cx, cy, n_iters: int = 10, n_cg: int = 25,
                          use_huber: bool = True):
    """BA with the observations split by rank (ops.ba.bundle_adjust's
    arguments, the same on every rank; the observation count divisible by
    the mesh size: pad with obs_valid False). Returns bundle_adjust's
    outputs on every rank, chi2 and z gathered over the ranks."""
    sl = _shard(mesh, obs_kf.shape[0])
    poses, pts, chi2, z = ba._bundle_adjust_impl(
        poses, pts, kf_free, obs_kf[sl], obs_pt[sl], obs_uv[sl], obs_w[sl], obs_valid[sl],
        fx, fy, cx, cy, n_iters=n_iters, n_cg=n_cg, use_huber=use_huber,
        all_reduce=mesh.all_reduce)
    return poses, pts, mesh.all_gather(chi2), mesh.all_gather(z)


def sharded_bundle_adjust_two_stage(mesh: Mesh, poses, pts, kf_free, obs_kf, obs_pt, obs_uv,
                                    obs_w, obs_valid, fx, fy, cx, cy, n_iters_a: int = 5,
                                    n_iters_b: int = 10, n_cg: int = 25):
    """The reference's local-BA schedule (ops.ba.two_stage: Huber
    iterations, the outlier pass at chi2 > 5.991 / negative depth, more
    iterations; src/Optimizer.cc:649-699), each stage sharded over the
    mesh."""
    return ba.two_stage(partial(sharded_bundle_adjust, mesh), poses, pts, kf_free, obs_kf,
                        obs_pt, obs_uv, obs_w, obs_valid, fx, fy, cx, cy, n_iters_a=n_iters_a,
                        n_iters_b=n_iters_b, n_cg=n_cg)

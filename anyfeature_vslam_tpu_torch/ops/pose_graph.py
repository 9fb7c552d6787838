"""Sim3 pose-graph optimization of the essential graph after a loop
closure (port of anyfeature_vslam_tpu/ops/pose_graph.py).

The counterpart of Optimizer::OptimizeEssentialGraph (reference
src/Optimizer.cc:771-1031): a 7-dof Sim3 vertex per keyframe, edges from
the loop closure, the spanning tree, earlier loop edges and strong
covisibility, identity information, Levenberg-Marquardt with a fixed trip
count. Residuals e = log_Sim3(S_ij^-1 o S_i o S_j^-1) for all edges at
once, their 7-dim left-perturbation Jacobians by forward-mode autodiff
over the edge batch (``se3.jacfwd``; the JAX package vmaps ``jax.jacfwd``
over the edges), the normal equations of the free vertices scattered into
a dense system and solved. The JAX ``lax.scan`` is a fixed loop whose
state is selected with ``torch.where``: no host sync per step.
"""

from __future__ import annotations

import torch

from . import se3

N_ITERS = 20


def _edge_residual(eps_i, eps_j, ri, ti, si, rj, tj, sj, rm, tm, sm):
    """eps: (7,) perturbations of the two vertices; measurement S_ij ~
    S_i o S_j^-1."""
    s_i = se3.sim3_compose(se3.sim3_exp7(eps_i), (ri, ti, si))
    s_j = se3.sim3_compose(se3.sim3_exp7(eps_j), (rj, tj, sj))
    rel = se3.sim3_compose(se3.sim3_inv((rm, tm, sm)),
                           se3.sim3_compose(s_i, se3.sim3_inv(s_j)))
    return se3.sim3_log7(*rel)


def _edges(*args):
    """Residuals (E, 7) and their Jacobians (E, 7, 7) in both vertices."""
    zero = torch.zeros(args[0].shape[0], 7, dtype=args[0].dtype, device=args[0].device)
    e0 = _edge_residual(zero, zero, *args)
    ((ji,), (jj,)) = se3.jacfwd(lambda a, b: (_edge_residual(a, b, *args),), zero, zero)
    return e0, ji, jj


def optimize_pose_graph(r_all, t_all, s_all, kf_valid, kf_fixed, edge_i, edge_j, edge_r,
                        edge_t, edge_s, edge_w, edge_valid, n_iters: int = N_ITERS):
    """Optimize Sim3 keyframe poses over relative-Sim3 edges.

    r_all, t_all, s_all: (K, 3, 3), (K, 3), (K,) vertex Sim3 (world ->
    keyframe); kf_valid, kf_fixed (K,) bool; edge_i, edge_j (E,) vertex
    indices; edge_r / t / s the measurements S_ij; edge_w (E,) weights;
    edge_valid (E,) bool. Returns (r, t, s)."""
    k = r_all.shape[0]
    dev = r_all.device
    f32 = torch.float32
    edge_i = edge_i.to(torch.int64)
    edge_j = edge_j.to(torch.int64)
    # the normal equations over the free vertices only: the JAX package
    # solves all 7K rows with identity rows for fixed and absent vertices,
    # whose solution on the free rows is this one (one host sync, here)
    free_idx = torch.nonzero(kf_valid & ~kf_fixed)[:, 0]
    nf = int(free_idx.numel())
    if nf == 0:
        return r_all, t_all, s_all
    pos = torch.full((k,), -1, dtype=torch.int64, device=dev)
    pos[free_idx] = torch.arange(nf, device=dev)
    pi, pj = pos[edge_i], pos[edge_j]
    w = torch.where(edge_valid, edge_w, torch.zeros_like(edge_w))
    fi, fj = (pi >= 0).to(f32), (pj >= 0).to(f32)
    wi, wj, wij = w * fi, w * fj, w * fi * fj
    pi, pj = torch.clamp(pi, min=0), torch.clamp(pj, min=0)
    ar7 = torch.arange(7, device=dev)

    def residuals_and_jac(r, t, s):
        return _edges(r[edge_i], t[edge_i], s[edge_i], r[edge_j], t[edge_j], s[edge_j],
                      edge_r, edge_t, edge_s)

    def cost_of(e):
        return torch.sum(torch.where(edge_valid, torch.sum(e * e, -1) * edge_w,
                                     torch.zeros_like(edge_w)))

    def scatter_block(h, bi, bj, blk):
        rows = (bi[:, None, None] * 7 + ar7[None, :, None]).expand(blk.shape)
        cols = (bj[:, None, None] * 7 + ar7[None, None, :]).expand(blk.shape)
        h.index_put_((rows.reshape(-1), cols.reshape(-1)), blk.reshape(-1), accumulate=True)

    r, t, s = r_all, t_all, s_all
    cost = cost_of(residuals_and_jac(r, t, s)[0])
    lam = torch.tensor(1e-8, dtype=f32, device=dev)
    eye = torch.eye(nf * 7, dtype=f32, device=dev)
    for _ in range(n_iters):
        e, ji, jj = residuals_and_jac(r, t, s)  # (E, 7), (E, 7, 7) x 2
        h = torch.zeros((nf * 7, nf * 7), dtype=f32, device=dev)
        g = torch.zeros(nf * 7, dtype=f32, device=dev)
        h_ij = torch.einsum("eai,eaj->eij", ji, jj) * wij[:, None, None]
        scatter_block(h, pi, pi, torch.einsum("eai,eaj->eij", ji, ji) * wi[:, None, None])
        scatter_block(h, pj, pj, torch.einsum("eai,eaj->eij", jj, jj) * wj[:, None, None])
        scatter_block(h, pi, pj, h_ij)
        scatter_block(h, pj, pi, h_ij.transpose(-1, -2))
        g.index_add_(0, (pi[:, None] * 7 + ar7).reshape(-1),
                     (torch.einsum("eai,ea->ei", ji, e) * wi[:, None]).reshape(-1))
        g.index_add_(0, (pj[:, None] * 7 + ar7).reshape(-1),
                     (torch.einsum("eai,ea->ei", jj, e) * wj[:, None]).reshape(-1))
        dx_free = -torch.linalg.solve_ex(h + (lam + 1e-9) * eye, g[:, None])[0][:, 0]
        dx = torch.zeros((k, 7), dtype=f32, device=dev).index_copy_(
            0, free_idx, dx_free.reshape(nf, 7))
        dr, dt, ds = se3.sim3_exp7(dx)
        r_new = dr @ r
        t_new = ds[:, None] * (dr @ t[..., None])[..., 0] + dt
        s_new = ds * s
        new_cost = cost_of(residuals_and_jac(r_new, t_new, s_new)[0])
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        r = torch.where(accept, r_new, r)
        t = torch.where(accept, t_new, t)
        s = torch.where(accept, s_new, s)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 10.0), 1e-16, 1e6)
    return r, t, s

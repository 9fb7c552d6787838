"""Offline training for the learned48 descriptor (frontend/learned48.py).
Port of tools/train_patch_descriptor.py on torch: the same corpus, pairs,
loss, optimiser and threshold calibration, on `device`.

Self-supervised patch correspondence training, HardNet-style (Mishchuk et
al. 2017, "Working hard to know your neighbor's margins"): anchors are
textured patches from rendered sequence images; positives are the same
scene points re-sampled after a random similarity warp (rotation, scale,
sub-pixel shift) plus photometric jitter and noise; negatives are the
hardest other patches in the batch. Loss: margin triplet against the
hardest in-batch negative.

The draws come from ``np.random.default_rng(seed)`` in the JAX tool's
order (corpus, then per step the pair's image, points, angles, warp,
jitter and noise), so both tools train on the same pairs. Patches are
sampled by the port's ``sample_canonical_patches`` on `device` (operands
rounded to bf16, as in JAX), the MLP is ``Learned48``, gradients come from
``torch.autograd`` and the step from ``torch.optim.Adam`` (betas 0.9 /
0.999, eps 1e-8: optax ``adam``'s defaults and update). The products are
fp32 ``torch.matmul`` (TF32 stays off, as the package sets it).

Usage:
    python -m anyfeature_vslam_tpu_torch.tools.train_patch_descriptor \\
        sequence_path:/tmp/seq_a,/tmp/seq_b steps:2000 batch:512 device:cuda

``sequence_path:synthetic`` trains on a procedural corpus (scipy);
``out:`` defaults to the port's weights file
(anyfeature_vslam_tpu_torch/frontend/weights/learned48.npz). Also prints a
suggested NORM_L2SQR matching threshold (the midpoint of the positive /
hardest-negative squared-distance modes on held-out pairs).
"""

from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from ..run_mono import parse_args


def synthetic_corpus(rng, n: int, h: int = 480, w: int = 640):
    """A diverse procedural corpus (multi-scale filtered noise + random
    oriented structures): the rendered sequences' blob texture is too
    self-similar for metric learning (hardest in-batch negatives are true
    near-duplicates, which collapses the embedding)."""
    from scipy.ndimage import gaussian_filter, rotate

    imgs = []
    for _ in range(n):
        rng.normal(0, 1, (h, w))  # drawn (and unused) by the JAX tool too
        im = np.zeros((h, w))
        for sigma, amp in ((1.5, 1.0), (4.0, 1.5), (12.0, 2.0)):
            im += amp * gaussian_filter(rng.normal(0, 1, (h, w)), sigma)
        # oriented structures: rotated rectangles and lines
        for _ in range(40):
            y0 = rng.integers(0, h - 40)
            x0 = rng.integers(0, w - 40)
            hh = rng.integers(4, 40)
            ww = rng.integers(4, 40)
            im[y0:y0 + hh, x0:x0 + ww] += rng.uniform(-3, 3)
        im = rotate(im, float(rng.uniform(0, 180)), reshape=False, order=1, mode="reflect")
        im = im - im.min()
        im = im / max(im.max(), 1e-6) * 255.0
        imgs.append(im.astype(np.float32))
    return imgs


class PairSampler:
    """(anchor, positive) patch pairs from a corpus, drawn from `rng` in the
    JAX tool's order."""

    def __init__(self, imgs, rng, device, rot_sign: float = 1.0):
        from ..frontend import graddesc

        self.imgs, self.rng, self.device, self.rot_sign = imgs, rng, device, rot_sign
        self.h, self.w = imgs[0].shape
        self.margin_px = graddesc.PATCH_RADIUS + 6
        self.sample_mat = graddesc.sample_tensor().to(device)

    def textured_points(self, im, n):
        """Random positions with local contrast (flat patches are useless
        training signal)."""
        rng, h, w, m = self.rng, self.h, self.w, self.margin_px
        xs = rng.uniform(m, w - m, 4 * n)
        ys = rng.uniform(m, h - m, 4 * n)
        g = np.abs(np.diff(im, axis=1))
        score = g[np.clip(ys.astype(int), 0, h - 1), np.clip(xs.astype(int), 0, w - 2)]
        order = np.argsort(-score)[:n]
        return np.stack([xs[order], ys[order]], -1).astype(np.float32)

    def patches(self, img, xy, ang):
        import torch

        from ..frontend.learned48 import sample_canonical_patches

        dev = self.device
        return sample_canonical_patches(torch.from_numpy(np.ascontiguousarray(img)).to(dev),
                                        torch.from_numpy(xy).to(dev),
                                        torch.from_numpy(ang).to(dev), self.sample_mat)

    def __call__(self, n):
        """(anchor patches, positive patches) as (m, 400) tensors on the
        device, m <= n (pairs warped out of the image are dropped)."""
        from scipy.ndimage import map_coordinates
        import torch

        rng, h, w, margin_px = self.rng, self.h, self.w, self.margin_px
        im = self.imgs[rng.integers(0, len(self.imgs))]
        xy = self.textured_points(im, n)
        ang = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        # similarity warp of the image: rotation r, scale s about center
        r = rng.uniform(-0.35, 0.35)
        s = float(np.exp(rng.uniform(-0.15, 0.15)))
        ca, sa = np.cos(r) / s, np.sin(r) / s
        cx, cy = w / 2.0, h / 2.0
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        # source coords of each warped pixel (inverse map)
        sx = ca * (xx - cx) - sa * (yy - cy) + cx
        sy = sa * (xx - cx) + ca * (yy - cy) + cy
        warped = map_coordinates(im, [sy, sx], order=1, mode="nearest")
        # photometric jitter + noise
        gain = float(np.exp(rng.uniform(-0.25, 0.25)))
        bias = float(rng.uniform(-16, 16))
        warped = np.clip(warped * gain + bias, 0, 255)
        warped = warped + rng.normal(0, 3.0, warped.shape)
        # forward-map the anchor points into the warped image
        fx = (ca * s * s) * (xy[:, 0] - cx) + (sa * s * s) * (xy[:, 1] - cy) + cx
        fy = (-sa * s * s) * (xy[:, 0] - cx) + (ca * s * s) * (xy[:, 1] - cy) + cy
        xy_b = np.stack([fx, fy], -1).astype(np.float32)
        xy_b += rng.normal(0, 0.6, xy_b.shape)  # sub-pixel localization noise
        ok = ((xy_b[:, 0] > margin_px) & (xy_b[:, 0] < w - margin_px)
              & (xy_b[:, 1] > margin_px) & (xy_b[:, 1] < h - margin_px))
        # orientation estimate follows the warp rotation, with estimator noise
        ang_b = (ang + self.rot_sign * r + rng.normal(0, 0.06, n)).astype(np.float32)
        with torch.no_grad():
            pa = self.patches(im, xy, ang)
            pb = self.patches(warped.astype(np.float32), xy_b, ang_b)
        keep = torch.from_numpy(ok).to(self.device)
        return pa[keep], pb[keep]


def loss_fn(mlp, pa, pb, margin: float):
    """(loss, mean positive distance, mean hardest-negative distance):
    tools/train_patch_descriptor.py's hardest-in-batch margin loss."""
    import torch

    da = mlp(pa)
    db = mlp(pb)
    # squared L2 distance matrix on unit vectors
    d2 = torch.clamp(2.0 - 2.0 * da @ db.T, min=0.0)
    d = torch.sqrt(d2 + 1e-9)
    pos = torch.diagonal(d)
    big = 10.0 * torch.eye(d.shape[0], device=d.device, dtype=d.dtype)
    # amin spreads the gradient over ties as jnp.min does
    neg_row = torch.amin(d + big, dim=1)   # hardest neg for anchor
    neg_col = torch.amin(d + big, dim=0)   # hardest neg for positive
    neg = torch.minimum(neg_row, neg_col)
    loss = torch.relu(margin + pos - neg).mean()
    return loss, pos.mean(), neg.mean()


def make_optimizer(mlp, lr: float = 1e-3):
    """Adam with optax ``adam``'s defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0)."""
    import torch

    return torch.optim.Adam(mlp.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def load_corpus(seq_path: str, rng, n_corpus: int):
    if seq_path == "synthetic":
        return synthetic_corpus(rng, n_corpus)
    from ..io import dataset

    imgs = []
    for sp in seq_path.split(","):
        seq = dataset.load_sequence(sp)
        for p in seq.image_paths[::3][:120]:
            imgs.append(dataset.load_gray(p).astype(np.float32))
    return imgs


def train(args: dict, log=print):
    """Train from the tool's arguments. Returns a namespace: the losses
    ((step, loss, mean positive, mean negative) per step taken), the
    trained ``Learned48``, the suggested threshold, the output path and
    the ms per training step (pairs included)."""
    import torch

    from .. import convert
    from ..frontend import learned48

    steps = int(args.get("steps", 2000))
    batch = int(args.get("batch", 512))
    margin = float(args.get("margin", 1.0))
    out = args.get("out", learned48.WEIGHTS_PATH)
    seed = int(args.get("seed", 0))
    device = torch.device(args.get("device", "cuda"))
    rng = np.random.default_rng(seed)

    imgs = load_corpus(args["sequence_path"], rng, int(args.get("n_corpus", 160)))
    log(f"corpus: {len(imgs)} images", flush=True)
    h, w = imgs[0].shape
    imgs = np.stack([im for im in imgs if im.shape == (h, w)])
    make_pairs = PairSampler(imgs, rng, device, float(args.get("rot_sign", "1")))

    mlp = convert.learned48_from_numpy(learned48.init_params(seed), device).requires_grad_(True)
    opt = make_optimizer(mlp, float(args.get("lr", 1e-3)))
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for step in range(steps):
        pa, pb = make_pairs(batch)
        if len(pa) < 32:
            continue
        opt.zero_grad(set_to_none=True)
        loss, mp, mn = loss_fn(mlp, pa, pb, margin)
        loss.backward()
        opt.step()
        losses.append((step, *(float(v.detach()) for v in (loss, mp, mn))))
        if step % 100 == 0:
            log(f"step {step}: loss {losses[-1][1]:.4f} "
                f"pos {losses[-1][2]:.3f} neg {losses[-1][3]:.3f}", flush=True)
    ms_per_step = (time.perf_counter() - t0) * 1e3 / max(steps, 1)

    # ---- threshold calibration on held-out pairs
    pos_d2, neg_d2 = [], []
    mlp.requires_grad_(False)
    for _ in range(8):
        pa, pb = make_pairs(batch)
        with torch.no_grad():
            da = mlp(pa).cpu().numpy()
            db = mlp(pb).cpu().numpy()
        d2 = np.clip(2.0 - 2.0 * da @ db.T, 0, None)
        pos_d2.append(np.diagonal(d2))
        big = 10.0 * np.eye(d2.shape[0])
        neg_d2.append((d2 + big).min(axis=1))
    pos_d2 = np.concatenate(pos_d2)
    neg_d2 = np.concatenate(neg_d2)
    p90 = float(np.percentile(pos_d2, 90))
    n10 = float(np.percentile(neg_d2, 10))
    log(f"pos d2 median {np.median(pos_d2):.3f} p90 {p90:.3f}; "
        f"hardest-neg d2 median {np.median(neg_d2):.3f} p10 {n10:.3f}")
    threshold = 0.5 * (p90 + n10)
    log(f"suggested matchingTh (L2SQR): {threshold:.3f}")

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **convert.learned48_to_numpy(mlp))
    log(f"saved {out}")
    return SimpleNamespace(losses=losses, mlp=mlp, threshold=threshold, out=out,
                           ms_per_step=ms_per_step)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args.get("sequence_path"):
        print(__doc__)
        return 1
    train(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

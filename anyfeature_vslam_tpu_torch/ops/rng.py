"""The JAX package's RANSAC draws, reproduced bit for bit in numpy.

The JAX initializer draws ``jax.random.uniform(jax.random.PRNGKey(seed),
(200, N))`` (anyfeature_vslam_tpu/ops/initializer.py:59, :275). That is
the threefry-2x32 counter hash (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC 2011; 20 rounds) applied to the flat element index
under the key (0, seed), the two output words xor-ed (JAX's partitionable
threefry layout, ``jax_threefry_partitionable=True``), and the top 23 bits
of each word made the mantissa of a float32 in [1, 2), minus 1. With these
draws the port samples the same RANSAC hypotheses as the JAX package for
the same seed; tests/test_torch_constants.py holds them equal to
``jax.random.uniform``.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 arrays x0, x1 under the key
    (k0, k1). Returns the two output words."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform(seed: int, shape) -> np.ndarray:
    """float32 draws in [0, 1), equal to ``jax.random.uniform(
    jax.random.PRNGKey(seed), shape)`` for a 32-bit seed."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    seed = int(seed) & 0xFFFFFFFF
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(0, seed, hi, lo)
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)

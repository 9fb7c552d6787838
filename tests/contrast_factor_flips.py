"""The nonlinear scale space's contrast factor in both packages, frame by
frame, on the CPU: where the port's and the JAX package's differ, and why.

    JAX_PLATFORMS=cpu python tests/contrast_factor_flips.py [width] [height] [n_frames]

For the first n_frames (default 48) of tests/torch_slice_scene.py's bench
sequence at width x height (default 640x480), prints per frame JAX's k
(jitted, as inside its extractor) and the port's, their histogram bins
(k = hmax (bin + 0.5) / 300), and the pixels whose smoothed gradient
magnitude is exactly 0 in the port's blur but not in JAX's (and the
largest such JAX magnitude), then the count of frames one bin or more
apart.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]


def main(width: int = 640, height: int = 480, n_frames: int = 48):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from anyfeature_vslam_tpu.frontend import nonlinear as jnl
    from anyfeature_vslam_tpu.frontend import pyramid as jpyr
    from anyfeature_vslam_tpu_torch.frontend import nonlinear as tnl
    from anyfeature_vslam_tpu_torch.frontend import pyramid as tpyr
    from torch_slice_scene import SliceScene

    @jax.jit
    def jax_k_and_mag(img01):
        smooth = jpyr.gaussian_blur(img01, 1.0, radius=2)
        gx = 0.5 * (jnl._shift(smooth, 0, 1) - jnl._shift(smooth, 0, -1))
        gy = 0.5 * (jnl._shift(smooth, 1, 0) - jnl._shift(smooth, -1, 0))
        return jnl.contrast_factor(img01), jnp.sqrt(gx * gx + gy * gy)[1:-1, 1:-1]

    taps = tnl.Constants(height, width).smooth
    sc = SliceScene(width, height)
    apart = 0
    for i in range(n_frames):
        img01 = sc.render(i)[0].astype(np.float32) * np.float32(1.0 / 255.0)
        jk, jmag = (np.asarray(a) for a in jax_k_and_mag(jnp.asarray(img01)))
        x = torch.from_numpy(img01)
        tk = float(tnl.contrast_factor(x, taps))
        tmag = torch.sqrt(tnl._gradient_sq(tpyr.gaussian_blur(x, taps)))[1:-1, 1:-1].numpy()
        jbin = int(round(float(jk) * tnl.K_NBINS / float(jmag.max()) - 0.5))
        tbin = int(round(tk * tnl.K_NBINS / float(tmag.max()) - 0.5))
        only_jax = (jmag > 0) & (tmag == 0)
        apart += jbin != tbin
        print(f"frame {i}: k JAX {float(jk)!r} (bin {jbin}), port {tk!r} (bin {tbin}); "
              f"{int(only_jax.sum())} pixels with gradient 0 in the port only (JAX's largest "
              f"there {float(jmag[only_jax].max()) if only_jax.any() else 0.0:.3g}), "
              f"{int(((tmag > 0) & (jmag == 0)).sum())} the other way", flush=True)
    print(f"{width}x{height}: {apart} of {n_frames} frames with the contrast factor in "
          "another bin")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))

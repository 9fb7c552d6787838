"""PyTorch + CUDA port of anyfeature_vslam_tpu (monocular V-SLAM).

The JAX package ``anyfeature_vslam_tpu`` is the reference; this package
mirrors its module paths (``anyfeature_vslam_tpu/ops/matching.py`` ->
``anyfeature_vslam_tpu_torch/ops/matching.py``) and keeps its array layouts
at every public function. It imports torch and numpy only: never jax, and
nothing of the JAX package (whose ``__init__`` imports jax).

Entry points: ``system.System`` (the monocular SLAM system of the FAST
feature families: orb32, brisk48, anyfeat_bin, anyfeat_nonbin),
``system.run_sequence`` and the ``run_mono`` CLI; they run on the card
unless the caller passes ``device="cpu"``.

Plain tensor code is PyTorch. The two Pallas TPU kernels of the JAX
package are hand-written CUDA C++ for Hopper under ``csrc/``, built with
nvcc at first use (``cuda_build.py``):

  K1  frontend/cuda_fast.py  <- frontend/pallas_fast.py  FAST-9/16 + 3x3 NMS
  K2  ops/cuda_match.py      <- ops/pallas_match.py      masked best/second

Each kernel wrapper takes its plain PyTorch twin for CPU tensors only; for
a CUDA tensor it launches the kernel or raises. No function here picks a
device: callers pass tensors (or a ``device``) explicitly.
"""

__version__ = "0.1.0"

import torch as _torch

# The JAX package pins jax_default_matmul_precision="highest": geometry and
# pose math run in full float32. Match it on the card, where TF32 would
# otherwise keep only ~3 decimal digits in matmuls and convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

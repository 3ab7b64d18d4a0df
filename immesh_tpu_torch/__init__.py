"""immesh_tpu_torch — PyTorch/CUDA port of the immesh_tpu odometry + meshing
pipeline.

The JAX package `immesh_tpu` stays the reference; this package keeps its
module paths and names (core/, map/, lio/, mesh/, runtime/) so every
counterpart is easy to find, and imports neither `jax` nor `immesh_tpu`.
Hand-written CUDA kernels live in `csrc/` and are bound in `kernels/`; each
has a plain PyTorch version beside it that CPU tensors take.

Every entry point takes an explicit `device` (default "cuda") and raises
when the card is asked for but absent — it never drops to the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Exact f32 everywhere — the counterpart of immesh_tpu/__init__.py's
# jax_default_matmul_precision="float32": TF32 keeps ~10 mantissa bits,
# which degrades SLAM geometry (deskew rotations, HᵀR⁻¹H assembly) with
# map extent.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from immesh_tpu_torch.config import ImMeshConfig  # noqa: E402,F401

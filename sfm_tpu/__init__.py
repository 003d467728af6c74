"""sfm_tpu — an accelerator-native SfM/SLAM framework in JAX / XLA.

A from-scratch re-design of the hulop/SfM monocular 3D-scanning pipeline
(see SURVEY.md) for accelerators: fixed-shape masked SoA state, jitted step
functions, and mesh-sharded distributed bundle adjustment.  It runs on an
NVIDIA GPU (chip_smoke.py) and, for tests, on the CPU.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry, descriptor, and normal-equation matmuls are all
# precision-sensitive: reduced-precision f32 matmuls (TF32 on the GPU's
# tensor cores) add descriptor-bit noise and degrade H/F/PnP estimates
# enough to stall bootstrap.  Default to full f32 matmuls; perf-critical
# paths opt into lower precision explicitly where it is safe.
_jax.config.update("jax_default_matmul_precision", "float32")

from .config import SfMConfig, DEFAULT_CONFIG


def __getattr__(name):
    # lazy top-level conveniences (importing the engine pulls in the full
    # stack; keep `import sfm_tpu` light)
    if name == "SfMEngine":
        from .engine import SfMEngine
        return SfMEngine
    if name == "PointCloud":
        from .io import PointCloud
        return PointCloud
    raise AttributeError(name)

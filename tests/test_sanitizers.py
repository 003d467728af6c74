"""Numeric-sanitizer CI hook (SURVEY.md §5: this build's answer to the
reference's absent TSan/ASan story is jit purity + NaN checking in CI).

Runs a small end-to-end scan with ``jax_debug_nans`` enabled: any NaN
produced by a jitted computation on the engine's hot path raises
immediately with the offending primitive.  The engine is designed to be
NaN-free even in masked lanes (safe denominators / sentinel indices
everywhere), so the whole bootstrap->tracking->mapping->BA path runs under
the sanitizer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sfm_tpu.config import SfMConfig
from sfm_tpu.engine import SfMEngine

from render import SpriteScene, strafe_trajectory


@pytest.mark.fast
def test_engine_scan_is_nan_free_under_debug_nans():
    cfg = SfMConfig(max_keypoints=96, max_keyframes=6, max_landmarks=512,
                    image_height=120, image_width=160, pyramid_levels=2,
                    ransac_hypotheses=32, pnp_hypotheses=16,
                    ba_iterations=3, keyframe_min_tracked=20,
                    keyframe_time_lag=4, min_init_matches=20,
                    mapping_tri_keyframes=3, mapping_reobs_keyframes=3,
                    guidance_enabled=False)
    K = np.array([[120.0, 0, 80.0], [0, 120.0, 60.0], [0, 0, 1]],
                 np.float32)
    rng = np.random.default_rng(3)
    scene = SpriteScene(rng, n_sprites=60, spread=1.8)
    rvecs, tvecs = strafe_trajectory(16, step=0.05)
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        eng = SfMEngine(K, (120, 160), config=cfg)
        for i in range(16):
            eng.add_frame(scene.render(K, rvecs[i], tvecs[i], 120, 160))
    finally:
        jax.config.update("jax_debug_nans", old)
    # the sanitizer passing IS the assertion; also require the scan to
    # have actually exercised the RUNNING path
    assert eng.status == 1

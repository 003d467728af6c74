"""Device-trace attribution of the steady-state tracking chunk (no
keyframe insertion): top device ops by exclusive time, plus the
device-total vs wall-clock gap per frame.  Complements
bench_tracking_profile.py's scan-loop component numbers."""

import collections
import glob
import gzip
import json
import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

import __graft_entry__ as g
from sfm_tpu.config import SfMConfig
from sfm_tpu.engine.state import CameraParams, init_state
from sfm_tpu.engine.step import build_video_step
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from bench_mapping_profile import trace_and_report, REPS


def main():
    cfg = SfMConfig(**g.FLAGSHIP)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))
    chunk_step = jax.jit(build_video_step(cfg, cam))

    rng = np.random.default_rng(11)
    scene = SpriteScene(rng, n_sprites=260, spread=2.4)
    rvecs, tvecs = strafe_trajectory(64, step=0.06, yaw_rate=0.001)
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(64)])
    state = init_state(cfg)
    for i in range(0, 48, 16):
        state, m = chunk_step(state, jnp.asarray(frames[i:i + 16]))
    jax.block_until_ready(m)
    print(f"warmup: kfs={int(np.asarray(m.n_keyframes)[-1])}, "
          f"lms={int(np.asarray(m.n_landmarks)[-1])}", file=sys.stderr)

    # a low-motion chunk: tiny in-place jitter around the last frame so
    # tracking succeeds but the keyframe policy never fires
    slow_r, slow_t = strafe_trajectory(16, step=0.002, yaw_rate=0.0002)
    base_r, base_t = rvecs[47], tvecs[47]
    chunk = np.stack([
        scene.render(K, base_r + slow_r[i], base_t + slow_t[i], 480, 640)
        for i in range(16)])
    chunk = jnp.asarray(chunk)

    def pure(state, chunk):
        st, m = chunk_step(state, chunk)
        return m

    # wall-clock per frame (excludes compile)
    jax.block_until_ready(pure(state, chunk))
    t0 = time.time()
    for _ in range(5):
        m = jax.block_until_ready(pure(state, chunk))
    wall_ms = (time.time() - t0) / 5 / 16 * 1000
    n_kf_added = int(np.asarray(m.keyframe_added).sum())
    print(f"pure chunk wall: {wall_ms:.2f} ms/frame "
          f"(kf_added={n_kf_added})", file=sys.stderr)

    trace_and_report("purechunk", pure, state, chunk)


if __name__ == "__main__":
    main()

"""Device-trace attribution of the fleet driver's two hot calls:
the chunked vmapped tracking step and the map-all mapping dispatch.

Usage: python benchmarks/bench_fleet_trace.py [batch]"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

from sfm_tpu.config import SfMConfig
from sfm_tpu.engine.state import CameraParams
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu.parallel.multiscan import MultiScanDriver

import bench_mapping_profile as prof

prof.REPS = 4


def main(batch=64):
    cfg = SfMConfig(max_keypoints=256, max_keyframes=8, max_landmarks=2048,
                    image_height=240, image_width=320, pyramid_levels=3,
                    ransac_hypotheses=64, pnp_hypotheses=32,
                    ba_iterations=4, keyframe_min_tracked=25,
                    track_refine_iters=2,
                    keyframe_time_lag=8, min_init_matches=25,
                    mapping_tri_keyframes=4, mapping_reobs_keyframes=4,
                    detector_approx_topk=True, feature_dtype="bfloat16",
                    ba_landmark_capacity=768)
    K = np.array([[250.0, 0, 160], [0, 250.0, 120], [0, 0, 1]], np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))

    rngs = [np.random.default_rng(100 + b) for b in range(batch)]
    scenes = [SpriteScene(r, n_sprites=120) for r in rngs]
    trajs = [strafe_trajectory(24, step=0.05 + 0.004 * (b % 8),
                               yaw_rate=0.001) for b in range(batch)]
    drv = MultiScanDriver(cfg, cam, batch=batch, bucket=8)
    T = cfg.keyframe_time_lag
    print("rendering...", file=sys.stderr)
    chunks = [jnp.asarray(np.stack([np.stack(
        [s.render(K, trajs[b][0][c * T + i], trajs[b][1][c * T + i],
                  240, 320) for b, s in enumerate(scenes)])
        for i in range(T)])) for c in range(3)]
    jax.block_until_ready(chunks)
    drv.step_chunk(chunks[0])
    drv.step_chunk(chunks[1])
    jax.block_until_ready(drv.states.status)

    # trace the tracking chunk (not donating so we can repeat on same state)
    states = drv.states

    def track(states, ch):
        return drv._track_chunk.__wrapped__(states, ch)

    tfn = jax.jit(track)
    prof.trace_and_report("track_chunk", tfn, states, chunks[2])

    # trace map-all at full pending
    st2, _ = tfn(states, chunks[2])
    pend = int(np.asarray(st2.pending_map_slot >= 0).sum())
    print(f"{pend} scans pending mapping", file=sys.stderr)

    def mapall(states):
        return drv._map_all.__wrapped__(states)

    prof.trace_and_report("map_all", jax.jit(mapall), st2)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

"""Phase attribution for the 64-scan fleet driver: times the chunked
tracking call, the bucketed full-step (bootstrap/reloc) chunks, and the
mapping dispatch separately per chunk.

Usage: python benchmarks/bench_multiscan_profile.py [batch] [n_frames]"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def main(batch=64, n_frames=48):
    import jax
    import jax.numpy as jnp
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine.state import CameraParams
    from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
    from sfm_tpu.parallel.multiscan import MultiScanDriver
    from benchmarks.bench_multiscan import main as _  # noqa: F401  (unused)

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
    trajs = [strafe_trajectory(n_frames, step=0.05 + 0.004 * (b % 8),
                               yaw_rate=0.001) for b in range(batch)]

    drv = MultiScanDriver(cfg, cam, batch=batch, bucket=8)
    T = cfg.keyframe_time_lag
    n_frames -= n_frames % T
    print("rendering frames...", file=sys.stderr)
    all_chunks = [jnp.asarray(np.stack([np.stack(
        [s.render(K, trajs[b][0][c * T + i], trajs[b][1][c * T + i],
                  240, 320) for b, s in enumerate(scenes)])
        for i in range(T)])) for c in range(n_frames // T)]
    jax.block_until_ready(all_chunks)

    m = drv.step_chunk(all_chunks[0])  # warmup/compile
    jax.block_until_ready(m)
    # force-compile the map_all path too
    drv._dispatch_mapping()

    for ci, ch in enumerate(all_chunks[1:]):
        t0 = time.time()
        status_before = np.asarray(drv.states.status)
        t_sync = time.time() - t0

        t0 = time.time()
        drv.states, metrics = drv._track_chunk(drv.states, ch)
        jax.block_until_ready(metrics)
        t_track = time.time() - t0

        t0 = time.time()
        not_running = status_before != 1
        for sel in drv._buckets(np.nonzero(not_running)[0]):
            drv.states = drv._full_chunk(drv.states, jnp.asarray(sel), ch)
        jax.block_until_ready(drv.states.status)
        t_full = time.time() - t0

        t0 = time.time()
        pending = int(np.asarray(drv.states.pending_map_slot >= 0).sum())
        drv._dispatch_mapping()
        jax.block_until_ready(drv.states.status)
        t_map = time.time() - t0

        tot = t_sync + t_track + t_full + t_map
        print(f"chunk {ci+1}: sync {t_sync*1e3:6.1f}  track {t_track*1e3:7.1f}"
              f"  full {t_full*1e3:6.1f} ({int(not_running.sum())} scans)"
              f"  map {t_map*1e3:7.1f} ({pending} pending)"
              f"  total {tot*1e3:7.1f} ms"
              f"  -> {batch*T/tot:6.1f} agg fps", file=sys.stderr)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

"""Why does the longscan map stall at ~200 landmarks?  Run the first N
frames of the longscan workload and dump per-chunk map dynamics: creation
vs culling, keyframe-view histograms of live landmarks, ages.

python benchmarks/diag_longscan_map.py [n_frames]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

from bench_longscan import LARGE, make_scene


def main(n_frames=160):
    import jax
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine import SfMEngine
    from sfm_tpu.mapstore import kf_view_counts

    cfg = SfMConfig(**LARGE)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    scene, rvecs, tvecs = make_scene(1024)

    CHUNK = 16
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(n_frames)])
    eng = SfMEngine(K, (480, 640), None, cfg)
    prev_valid = np.zeros(cfg.max_landmarks, bool)
    ever_valid = np.zeros(cfg.max_landmarks, bool)
    for s in range(0, n_frames, CHUNK):
        eng.add_frames(frames[s:s + CHUNK])
        lms = eng.state.lms
        valid = np.asarray(lms.valid)
        created = (valid & ~ever_valid).sum()
        culled = (prev_valid & ~valid).sum()
        ever_valid |= valid
        prev_valid = valid.copy()
        kfv = np.asarray(kf_view_counts(eng.state.kfs, cfg.max_landmarks))
        kfv = kfv[valid]
        ages = np.asarray(lms.kf_alive)[valid]
        views = np.asarray(lms.n_views)[valid]
        talive = np.asarray(lms.t_alive)[valid]
        ratio = views / np.maximum(talive, 1)
        hist = np.bincount(np.clip(kfv, 0, 6), minlength=7)
        print(f"f{s+CHUNK:4d}: live {valid.sum():5d} (+{created} new, "
              f"-{culled} culled), kf_views hist(0-6+) {hist.tolist()}, "
              f"age med {np.median(ages) if len(ages) else 0:.0f}, "
              f"ratio med {np.median(ratio) if len(ratio) else 0:.2f}, "
              f"KFs {int(np.asarray(eng.state.kfs.valid).sum())}",
              flush=True)


    eng.save("/tmp/longscan_state.npz")
    print("state saved to /tmp/longscan_state.npz", flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

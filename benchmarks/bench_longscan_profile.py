"""Attribute longscan per-frame cost: chunk times vs keyframes inserted
(mapping-pass cost) and explicit global-BA timing, as the map grows.

python benchmarks/bench_longscan_profile.py [n_frames]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

from bench_longscan import LARGE, make_scene


def main(n_frames=320):
    import jax
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine import SfMEngine

    kw = dict(LARGE)
    kw["global_ba_every"] = 0          # manual, timed below
    cfg = SfMConfig(**kw)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    scene, rvecs, tvecs = make_scene(n_frames)
    CHUNK = 16
    n_frames -= n_frames % CHUNK
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(n_frames)])
    eng = SfMEngine(K, (480, 640), None, cfg)
    t0 = time.time()
    eng.add_frames(frames[:CHUNK])
    print(f"compile+chunk0: {time.time()-t0:.1f}s", flush=True)

    kf_since_gba = 0
    for s in range(CHUNK, n_frames, CHUNK):
        t0 = time.time()
        out = eng.add_frames(frames[s:s + CHUNK])
        jax.block_until_ready(eng.state.status)
        dt = time.time() - t0
        nkf = sum(int(m["keyframe_added"]) for m in out)
        n_live_kf = int(np.asarray(eng.state.kfs.valid).sum())
        n_lm = int(np.asarray(eng.state.lms.valid).sum())
        per_kf = (dt * 1e3) / max(nkf, 1)
        print(f"f{s+CHUNK:4d}: chunk {dt*1e3:6.0f} ms, {nkf} KF "
              f"-> ~{per_kf:5.0f} ms/KF-frame | {n_live_kf} KFs "
              f"{n_lm} lms", flush=True)
        kf_since_gba += nkf
        if kf_since_gba >= 24:
            t0 = time.time()
            stats = eng.global_ba()
            dt = time.time() - t0
            print(f"  global BA: {dt*1e3:.0f} ms "
                  f"(cost {float(stats['initial_cost']):.3e} -> "
                  f"{float(stats['final_cost']):.3e}, "
                  f"{int(stats['accepted'])} acc, "
                  f"dropped {int(stats['dropped_obs'])})", flush=True)
            kf_since_gba = 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

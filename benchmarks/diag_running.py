"""Diagnose the round-2 RUNNING regression in the driver bench (VERDICT
item 2: 117/128 -> 75/128 between rounds on the SAME bench.py).

Replicates bench.py's exact scene (seed 11), trajectory, chunking, and
status accounting on CPU, with config overrides so the three round-2
suspects can be bisected:
  - closed-form PnP eigensolves (da48753)          -> pnp_solver
  - FLAGSHIP ba_huber_delta=2.0 (76c4866)          -> ba_huber_delta
  - covisibility mapping window default (4f4c5b9)  -> mapping_use_covisibility

Usage: JAX_PLATFORMS=cpu python benchmarks/diag_running.py [key=val ...]
Prints per-chunk status strings + the 128-frame RUNNING count.
"""

import os
import sys

import numpy as np


def run(overrides):
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine.state import CameraParams, init_state
    from sfm_tpu.engine.step import build_video_step
    from sfm_tpu.synthetic import SpriteScene, strafe_trajectory

    kw = dict(g.FLAGSHIP)
    kw.update(overrides)
    cfg = SfMConfig(**kw)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))
    CHUNK = 16
    chunk_step = jax.jit(build_video_step(cfg, cam), donate_argnums=(0,))

    rng = np.random.default_rng(11)
    scene = SpriteScene(rng, n_sprites=260, spread=2.4)
    n_frames = 80
    rvecs, tvecs = strafe_trajectory(n_frames, step=0.06, yaw_rate=0.001)
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(n_frames)])
    chunks = [jnp.asarray(frames[i:i + CHUNK])
              for i in range(0, n_frames, CHUNK)]

    state = init_state(cfg)
    state, m = chunk_step(state, chunks[0])
    statuses = []
    ntrk = []
    for ci, ch in enumerate(chunks[1:]):
        state, m = chunk_step(state, ch)
        m = jax.block_until_ready(m)
        st = np.asarray(m.status).tolist()
        statuses.extend(st)
        ntrk.extend(np.asarray(m.n_tracked).tolist())
        print(f"chunk {ci+1}: status {''.join(str(s) for s in st)} "
              f"kf={int(np.asarray(m.keyframe_added).sum())}",
              file=sys.stderr)

    slow_r, slow_t = strafe_trajectory(CHUNK, step=0.002, yaw_rate=0.0002)
    base_r, base_t = rvecs[-1], tvecs[-1]
    jitter = jnp.asarray(np.stack([
        scene.render(K, base_r + slow_r[i], base_t + slow_t[i], 480, 640)
        for i in range(CHUNK)]))
    for j in range(4):
        state, m = chunk_step(state, jitter)
        m = jax.block_until_ready(m)
        st = np.asarray(m.status).tolist()
        statuses.extend(st)
        ntrk.extend(np.asarray(m.n_tracked).tolist())
        print(f"jitter {j}: status {''.join(str(s) for s in st)} "
              f"kf={int(np.asarray(m.keyframe_added).sum())}",
              file=sys.stderr)
        print(f"  n_matches {np.asarray(m.n_matches).tolist()}",
              file=sys.stderr)
        print(f"  n_inliers {np.asarray(m.n_inliers).tolist()}",
              file=sys.stderr)
        print(f"  n_detected {np.asarray(m.n_detected).tolist()}",
              file=sys.stderr)

    statuses = np.array(statuses)
    ntrk = np.array(ntrk)
    n_run = int((statuses == 1).sum())
    print(f"overrides={overrides}")
    print(f"running {n_run}/{len(statuses)}  "
          f"median n_tracked (running) "
          f"{np.median(ntrk[statuses == 1]) if n_run else 0}")
    return n_run


if __name__ == "__main__":
    ov = {}
    for a in sys.argv[1:]:
        k, v = a.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                v = {"True": True, "False": False}.get(v, v)
        ov[k] = v
    run(ov)

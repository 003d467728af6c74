"""Device-trace attribution of the FLAGSHIP 64-scan fleet's two hot calls
(chunked vmapped tracking + map-all mapping dispatch).

Usage: python benchmarks/bench_fleet_flagship_trace.py [batch]"""

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
from sfm_tpu.engine.state import CameraParams
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
from sfm_tpu.parallel.multiscan import MultiScanDriver

import bench_mapping_profile as prof

prof.REPS = 3


def main(batch=64):
    cfg = g.flagship_config()
    h, w = cfg.image_height, cfg.image_width
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))

    rngs = [np.random.default_rng(100 + b) for b in range(batch)]
    scenes = [SpriteScene(r, n_sprites=260, spread=2.4) for r in rngs]
    trajs = [strafe_trajectory(30, step=0.06 + 0.004 * (b % 8),
                               yaw_rate=0.001) for b in range(batch)]
    drv = MultiScanDriver(cfg, cam, batch=batch, bucket=8)
    T = cfg.keyframe_time_lag
    print("rendering...", file=sys.stderr)
    chunks = [jnp.asarray(np.stack([np.stack(
        [s.render(K, trajs[b][0][c * T + i], trajs[b][1][c * T + i],
                  h, w) for b, s in enumerate(scenes)])
        for i in range(T)]).astype(np.uint8)) for c in range(3)]
    jax.block_until_ready(chunks)
    drv.step_chunk(chunks[0])
    drv.step_chunk(chunks[1])
    jax.block_until_ready(drv.states.status)

    states = drv.states

    def track(states, ch):
        return drv._track_chunk.__wrapped__(states, ch)

    tfn = jax.jit(track)
    prof.trace_and_report("fltrack", tfn, states, chunks[2])

    st2, _ = tfn(states, chunks[2])
    pend = int(np.asarray(st2.pending_map_slot >= 0).sum())
    print(f"{pend} scans pending mapping", file=sys.stderr)

    def mapall(states):
        return drv._map_all.__wrapped__(states)

    prof.trace_and_report("flmap", jax.jit(mapall), st2)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

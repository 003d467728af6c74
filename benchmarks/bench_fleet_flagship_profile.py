"""Phase attribution for the FLAGSHIP 64-scan fleet (BASELINE config 4).

Times, per chunk: the vmapped tracking chunk, the bucketed full-step
(bootstrap/reloc) chunks, and the mapping dispatch.  Then sub-profiles one
vmapped mapping pass (triangulate / reobserve / cull / BA) on the final
fleet state to attribute the dominant term.

Usage: python benchmarks/bench_fleet_flagship_profile.py [batch] [n_frames]"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def main(batch=64, n_frames=30):
    import jax
    import jax.numpy as jnp
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import __graft_entry__ as g
    from sfm_tpu.engine.state import CameraParams
    from sfm_tpu.synthetic import SpriteScene, strafe_trajectory
    from sfm_tpu.parallel.multiscan import MultiScanDriver

    cfg = g.flagship_config()
    h, w = cfg.image_height, cfg.image_width
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))

    rngs = [np.random.default_rng(100 + b) for b in range(batch)]
    scenes = [SpriteScene(r, n_sprites=260, spread=2.4) for r in rngs]
    trajs = [strafe_trajectory(n_frames, step=0.06 + 0.004 * (b % 8),
                               yaw_rate=0.001) for b in range(batch)]

    drv = MultiScanDriver(cfg, cam, batch=batch, bucket=8)
    T = cfg.keyframe_time_lag
    n_frames -= n_frames % T
    print("rendering frames...", file=sys.stderr)
    all_chunks = [jnp.asarray(np.stack([np.stack(
        [s.render(K, trajs[b][0][c * T + i], trajs[b][1][c * T + i],
                  h, w) for b, s in enumerate(scenes)])
        for i in range(T)]).astype(np.uint8)) for c in range(n_frames // T)]
    jax.block_until_ready(all_chunks)

    print("warmup...", file=sys.stderr)
    t0 = time.time()
    drv.warmup(all_chunks[0])
    print(f"warmup compile: {time.time() - t0:.1f}s", file=sys.stderr)
    m = drv.step_chunk(all_chunks[0])
    jax.block_until_ready(m)

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

    # ---- sub-profile one vmapped mapping pass on the final state ----
    from sfm_tpu.engine import mapping as M
    from sfm_tpu.mapstore import (kf_view_counts, cull_landmarks,
                                  cull_keyframes, clear_links,
                                  representative_descriptors)

    states = drv.states
    slot = jnp.maximum(states.pending_map_slot, 0)
    # force a pending slot everywhere so the sub-phases run for all scans
    L = cfg.max_landmarks

    def tri(st, sl):
        return M._triangulate_all_pairs(cfg, cam, st, sl)

    def reobs(st, sl):
        return M._reobserve_all(cfg, cam, st, sl)

    def cull(st):
        views = kf_view_counts(st.kfs, L)
        lms, tomb = cull_landmarks(
            st.lms, views, min_views=cfg.cull_min_views,
            young_age=cfg.cull_young_kf_age, view_ratio=cfg.cull_view_ratio)
        fr = st.kfs.frames
        landmark = jax.vmap(clear_links, in_axes=(0, None))(fr.landmark, tomb)
        kfs = st.kfs._replace(frames=fr._replace(landmark=landmark))
        kfs, _ = cull_keyframes(kfs, L, redundancy=cfg.kf_cull_redundancy,
                                min_others=cfg.kf_cull_min_others)
        return st._replace(kfs=kfs, lms=lms)

    def rep(st):
        return st._replace(rep_desc=representative_descriptors(st.lms))

    jtri = jax.jit(jax.vmap(tri))
    jreobs = jax.jit(jax.vmap(reobs))
    jcull = jax.jit(jax.vmap(cull))
    jrep = jax.jit(jax.vmap(rep))

    for name, fn, args in [("tri", jtri, (states, slot)),
                           ("reobs", jreobs, (states, slot)),
                           ("cull", jcull, (states,)),
                           ("repdesc", jrep, (states,))]:
        out = fn(*args)   # compile
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(3):
            out = fn(*args)
            jax.block_until_ready(out)
        dt = (time.time() - t0) / 3
        print(f"mapping sub-phase {name:15s}: {dt*1e3:8.1f} ms (vmapped x"
              f"{batch})", file=sys.stderr)

    # map_all donates its input: time with reassignment (under vmap the
    # pending-slot cond is a select, so a -1 slot still pays the full pass)
    st = states
    st = drv._map_all(st)
    jax.block_until_ready(st.status)
    t0 = time.time()
    for _ in range(3):
        st = drv._map_all(st)
        jax.block_until_ready(st.status)
    dt = (time.time() - t0) / 3
    print(f"mapping sub-phase {'map_all(full)':15s}: {dt*1e3:8.1f} ms "
          f"(vmapped x{batch})", file=sys.stderr)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

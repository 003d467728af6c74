"""Loop-closure demonstration (VERDICT r3 task 5).

A camera orbits the INSIDE of a sprite ring looking outward, returning to
its starting view after a 300+-keyframe excursion (the trajectory runs
past 2*pi so the tail revisits the start).  Accumulated odometry drift at
the revisit must be corrected by the covisibility machinery: the hybrid
triangulation/re-observation window (engine/mapping.py:_hybrid_slots)
links revisit keyframes against bootstrap-era keyframes, and the periodic
+ final global BA pulls the loop shut.

The reference has nothing here — its covisibility graph is commented out
(/root/reference/CMap.h:94-95) and "connected" means all keyframes
(/root/reference/CSfM.cpp:123-126); at this scale that is unaffordable,
so this is a beat-the-reference demonstration, not parity.

Reported: drift at the loop-closing keyframe BEFORE the final global BA
vs AFTER (alignment fixed on the first quarter of the trajectory — NOT
whole-trajectory sim(3), which would smear the drift over the loop), and
the same run with covisibility windows disabled (pure recency) as the
ablation.

Usage: python benchmarks/bench_loop_closure.py [n_frames] [--no-covis]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

from bench_longscan import LARGE


def ring_loop_trajectory(n_frames, radius=6.0, turns=1.12):
    """Outward-looking orbit: position on a circle of ``radius`` in the
    x-z plane, viewing direction radial.  ``turns`` > 1 revisits the
    start region.  Handheld shake keeps the min-motion gate satisfied."""
    from sfm_tpu.np_geometry import log_rotation
    rvecs, tvecs = [], []
    for k in range(n_frames):
        ph = 2 * np.pi * turns * k / n_frames
        shake = np.array([0.028 * np.sin(2 * np.pi * k / 5.0),
                          0.022 * np.sin(2 * np.pi * k / 7.0),
                          0.012 * np.sin(2 * np.pi * k / 11.0)])
        u = np.array([np.sin(ph), 0.0, np.cos(ph)])
        c = radius * u + shake
        # camera z-axis = outward radial: R_wc = Ry(ph)
        R_wc = np.array([[np.cos(ph), 0, np.sin(ph)],
                         [0, 1, 0],
                         [-np.sin(ph), 0, np.cos(ph)]])
        R = R_wc.T
        rvecs.append(log_rotation(R))
        tvecs.append((-R @ c).astype(np.float32))
    return np.asarray(rvecs, np.float32), np.asarray(tvecs, np.float32)


def make_ring_scene(radius=6.0, r_in=10.0, r_out=13.0, n_sprites=2600):
    from sfm_tpu.synthetic import SpriteScene
    rng = np.random.default_rng(7)
    scene = SpriteScene(rng, n_sprites=n_sprites, sprite_size=0.85)
    ψ = rng.uniform(0, 2 * np.pi, n_sprites)
    r = rng.uniform(r_in, r_out, n_sprites)
    scene.centers = np.stack([
        r * np.sin(ψ), rng.uniform(-2.5, 2.5, n_sprites),
        r * np.cos(ψ)], axis=1)
    return scene


def centers_of(rv, tv):
    from sfm_tpu.np_geometry import rodrigues_np
    return np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in range(len(rv))])


def main(n_frames=1280, covis=True, turns=1.12, scale=True):
    import jax
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine import SfMEngine

    cfg_kw = dict(LARGE)
    cfg_kw["mapping_use_covisibility"] = covis
    # loop-closure detection (engine/loop.py): probe every 8 keyframes;
    # landmarks older than 60 KFs count as a different era; accept at
    # >= 25 PnP inliers with > 0.3 m of pose disagreement.  The covis=off
    # ablation also disables detection (pure odometry baseline).
    cfg_kw.update(loop_detect_every=8 if covis else 0, loop_min_age=60,
                  loop_min_inliers=25, loop_min_drift=0.3,
                  loop_use_scale=scale)
    cfg = SfMConfig(**cfg_kw)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    scene = make_ring_scene()
    rvecs, tvecs = ring_loop_trajectory(n_frames, turns=turns)

    CHUNK = cfg.keyframe_time_lag  # deferred-mapping add_frames path
    n_frames -= n_frames % CHUNK
    print(f"rendering {n_frames} frames...", file=sys.stderr)
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(n_frames)])

    eng = SfMEngine(K, (480, 640), None, cfg)
    chunks = [jax.device_put(jnp.asarray(frames[s:s + CHUNK]))
              for s in range(0, n_frames, CHUNK)]
    jax.block_until_ready(chunks)
    t0 = time.time()
    eng.add_frames(chunks[0])
    print(f"compile+chunk0: {time.time()-t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    for s in range(CHUNK, n_frames, CHUNK):
        eng.add_frames(chunks[s // CHUNK])
        if (s // CHUNK) % 16 == 0:
            recent = eng.metrics_log[-64:]
            st = np.array([m["status"] for m in recent])
            print(f"  frame {s + CHUNK}: RUNNING "
                  f"{100.0 * (st == 1).mean():.0f}%, "
                  f"{int(np.asarray(eng.state.kfs.valid).sum())} KFs, "
                  f"{int(np.asarray(eng.state.lms.valid).sum())} lms",
                  file=sys.stderr)
    dt = time.time() - t0
    statuses = np.array([m["status"] for m in eng.metrics_log])
    running_pct = 100.0 * (statuses == 1).mean()
    n_kf = int(np.asarray(eng.state.kfs.valid).sum())
    print(f"scan: {running_pct:.1f}% RUNNING, {n_kf} keyframes, "
          f"{(n_frames - CHUNK)/dt:.1f} fps; loop closures detected: "
          f"{eng.loop_closures}", file=sys.stderr)

    def loop_drift():
        """Position error of the LAST keyframe under an alignment fitted
        on the first-quarter keyframes only (drift is not smeared away)."""
        kfs = eng.state.kfs
        valid = np.asarray(kfs.valid)
        fns = np.asarray(kfs.frames.frame_no)[valid]
        order = np.argsort(fns)
        rv = np.asarray(kfs.frames.rvec)[valid][order]
        tv = np.asarray(kfs.frames.tvec)[valid][order]
        fns = fns[order]
        est = centers_of(rv, tv)
        gt = centers_of(rvecs[fns], tvecs[fns])
        q = max(len(est) // 4, 3)
        # similarity fit on the first quarter (Umeyama)
        mu_e, mu_g = est[:q].mean(0), gt[:q].mean(0)
        E, G = est[:q] - mu_e, gt[:q] - mu_g
        S = G.T @ E / q
        U, D, Vt = np.linalg.svd(S)
        sgn = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            sgn[2, 2] = -1
        R = U @ sgn @ Vt
        s = np.trace(np.diag(D) @ sgn) / max((E ** 2).sum() / q, 1e-12)
        est_al = (s * (R @ (est - mu_e).T)).T + mu_g
        err = np.linalg.norm(est_al - gt, axis=1)
        return float(err[-1]), float(err.max()), len(est), fns

    d_before, dmax_before, n_est, fns = loop_drift()
    print(f"drift before final global BA: end {d_before:.3f} m, "
          f"max {dmax_before:.3f} m over {n_est} KFs", file=sys.stderr)
    for _ in range(2):
        stats = eng.global_ba()
        print(f"global BA: cost {float(stats['initial_cost']):.3e} -> "
              f"{float(stats['final_cost']):.3e} "
              f"({int(stats['accepted'])} accepted)", file=sys.stderr)
    d_after, dmax_after, _, _ = loop_drift()
    extent = 2 * 6.0  # loop diameter
    print(f"drift after final global BA: end {d_after:.3f} m, "
          f"max {dmax_after:.3f} m (loop diameter {extent} m)",
          file=sys.stderr)

    print(json.dumps({
        "metric": "loop_closure_end_drift",
        "value": round(d_after, 4),
        "unit": f"m at loop-closing KF (before final gBA {d_before:.3f}; "
                f"covisibility={'on' if covis else 'off'}; {n_kf} KFs, "
                f"RUNNING {running_pct:.1f}%)",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    covis = "--no-covis" not in sys.argv[1:]
    scale = "--no-scale" not in sys.argv[1:]
    turns = 1.12
    for a in sys.argv[1:]:
        if a.startswith("--turns="):
            turns = float(a.split("=")[1])
    args = [int(a) for a in sys.argv[1:] if not a.startswith("--")]
    main(*args, covis=covis, turns=turns, scale=scale)

"""Engine-scale benchmark at the fr2/desk operating point (BASELINE.json
config 3: "global BA over ~500 KFs / 50k landmarks"): a 1k+-frame loopy
synthetic sequence through the FULL engine with the 512-keyframe / 64k-
landmark capacities, windowed-local mapping BA (implicit-Schur device
tables) and periodic global BA (Pallas camera-window plan).

The reference ran all-keyframe BA inline every mapping pass
(/root/reference/CSfM.cpp:250-259) and was capped at tens of keyframes;
this is that loop at 10x the map size.

Done-criteria (VERDICT item 4): RUNNING >= 95% of frames, bounded memory
(fixed capacities by construction), amortized >= 30 fps, ATE gate.

Usage: python benchmarks/bench_longscan.py [n_frames]"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

LARGE = dict(
    max_keypoints=512, max_keyframes=512, max_landmarks=65536,
    image_height=480, image_width=640, pyramid_levels=4,
    detector_approx_topk=True,
    feature_dtype="bfloat16", ba_huber_delta=2.0,
    # keyframe cadence: the serpentine keeps entering fresh territory, so
    # the track-ratio policy fires at nearly every lag boundary; lag 4
    # admits ~1 KF / 4 frames (~500 KFs over the 2048-frame sequence).
    # keyframe_min_tracked drops from the reference's 50 (CSfM.cpp:485 —
    # tuned for orbiting a small object, where tracks stay dense) to
    # ORB-SLAM's ~15-inlier floor: during exploration the track count
    # RISES only after a keyframe triangulates fresh territory, so a high
    # floor deadlocks map growth (measured: KFs freeze at 7 / 181
    # landmarks and the scan starves by frame ~300)
    keyframe_time_lag=4, keyframe_min_tracked=15,
    # windowed-local mapping BA through the device-table implicit-Schur
    # solver; only the most recent poses are free per pass
    ba_solver="large", ba_kmax=8, ba_iterations=3, ba_cg_iterations=12,
    ba_local_window=24,
    # truly-local mapping BA: obs from the 48 most recent KFs only, over
    # a compacted landmark axis (the window observes ~10k of 64k slots)
    ba_landmark_capacity=16384,
    # periodic global BA (all poses/structure free) every 32 insertions
    global_ba_every=32, global_ba_iterations=10, global_ba_cg_iterations=25,
    global_ba_kmax=16, global_ba_huber_delta=7.0,
    mapping_tri_keyframes=8, mapping_reobs_keyframes=16,
    mapping_reobs_capacity=8192,
)


def serpentine_trajectory(n_frames, amp=5.0, period=256, drift=0.012,
                          yaw_amp=0.10):
    """Loopy lateral sweep: x oscillates (amplitude ``amp``) while y drifts
    slowly, so the camera revisits each x-column every ``period`` frames —
    the covisibility window must reconnect revisited regions to old
    keyframes (TUM fr2/desk's loop structure, abstractly).

    A deterministic handheld shake rides on top: at the sweep apexes the
    serpentine's own velocity crosses zero, and a perfectly-still camera
    sits below the engine's (reference-parity) 1.5 px min-match-motion
    window for ~26 straight frames — longer than the 10-frame lost
    tolerance.  Real handheld scans (the TUM workload this models) always
    jitter; the shake is part of the GROUND-TRUTH poses used for both
    rendering and ATE, so accuracy accounting stays honest."""
    from sfm_tpu.np_geometry import log_rotation
    rvecs, tvecs = [], []
    for k in range(n_frames):
        ph = 2 * np.pi * k / period
        shake = np.array([0.028 * np.sin(2 * np.pi * k / 5.0),
                          0.022 * np.sin(2 * np.pi * k / 7.0),
                          0.012 * np.sin(2 * np.pi * k / 11.0)])
        c = np.array([amp * np.sin(ph), drift * k, 0.0]) + shake
        yaw = -yaw_amp * np.cos(ph)  # gentle look-into-the-turn
        R = np.array([[np.cos(yaw), 0, -np.sin(yaw)],
                      [0, 1, 0],
                      [np.sin(yaw), 0, np.cos(yaw)]])
        rvecs.append(log_rotation(R))
        tvecs.append((-R @ c).astype(np.float32))
    return np.asarray(rvecs, np.float32), np.asarray(tvecs, np.float32)


def make_scene(n_frames):
    """The longscan scene + trajectory (shared with the diag scripts).

    Sprite size 0.85 at depths 6-11 gives ~40-75 px apparent size —
    comparable to the flagship scene's texture scale.  At the earlier 0.5
    (~24-44 px) the descriptor sampling pattern spilled past sprite
    borders onto parallax-shifting background, making descriptors
    non-repeatable (median best-match Hamming 131 bits vs the 90 gate ->
    triangulation yield 0 and map starvation)."""
    from sfm_tpu.synthetic import SpriteScene
    rng = np.random.default_rng(3)
    scene = SpriteScene(rng, n_sprites=2600, spread=7.0, depth=(6.0, 11.0),
                        sprite_size=0.85)
    scene.centers[:, 1] = rng.uniform(-2.0, 2.0 + 0.012 * n_frames, 2600)
    rvecs, tvecs = serpentine_trajectory(n_frames)
    return scene, rvecs, tvecs


def main(n_frames=2048):
    import jax
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine import SfMEngine
    from sfm_tpu.synthetic import umeyama_ate
    from sfm_tpu.np_geometry import rodrigues_np

    cfg = SfMConfig(**LARGE)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    scene, rvecs, tvecs = make_scene(n_frames)

    # chunk = keyframe lag: add_frames then takes the deferred-mapping
    # split (separate mapping jit), which compiles ~5x faster than the
    # inline-mapping scan program (round 4)
    CHUNK = cfg.keyframe_time_lag
    n_frames -= n_frames % CHUNK
    print(f"rendering {n_frames} frames...", file=sys.stderr)
    t0 = time.time()
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(n_frames)])
    print(f"rendered in {time.time()-t0:.0f}s", file=sys.stderr)

    eng = SfMEngine(K, (480, 640), None, cfg)
    # pre-stage all chunks in device memory (1024 frames f32 = 1.26 GB):
    # the bench measures the engine, not host->device bandwidth; a
    # production feed would double-buffer uploads behind compute
    chunks = [jax.device_put(jnp.asarray(frames[s:s + CHUNK]))
              for s in range(0, n_frames, CHUNK)]
    jax.block_until_ready(chunks)
    t0 = time.time()
    eng.add_frames(chunks[0])  # compile + bootstrap (untimed)
    print(f"compile+chunk0: {time.time()-t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    for s in range(CHUNK, n_frames, CHUNK):
        eng.add_frames(chunks[s // CHUNK])
        if (s // CHUNK) % 4 == 0:
            recent = eng.metrics_log[-64:]
            st = np.array([m["status"] for m in recent])
            trk = np.array([m["n_tracked"] for m in recent])
            mat = np.array([m["n_matches"] for m in recent])
            print(f"  frame {s + CHUNK}: RUNNING "
                  f"{100.0 * (st == 1).mean():.0f}% (last 64), "
                  f"med tracked {int(np.median(trk))} "
                  f"matches {int(np.median(mat))}, "
                  f"{int(np.asarray(eng.state.kfs.valid).sum())} KFs, "
                  f"{int(np.asarray(eng.state.lms.valid).sum())} lms, "
                  f"{(time.time() - t0) / s * 1e3:.1f} ms/frame",
                  file=sys.stderr)
    jax.block_until_ready(eng.state.status)
    dt = time.time() - t0
    timed = n_frames - CHUNK
    fps = timed / dt

    statuses = np.array([m["status"] for m in eng.metrics_log])
    kf_added = np.array([m["keyframe_added"] for m in eng.metrics_log])
    running_pct = 100.0 * (statuses == 1).mean()
    n_kf = int(np.asarray(eng.state.kfs.valid).sum())
    n_lm = int(np.asarray(eng.state.lms.valid).sum())
    print(f"{timed} frames in {dt:.1f}s = {fps:.1f} fps amortized; "
          f"RUNNING {running_pct:.1f}%, {int(kf_added.sum())} KF inserted "
          f"({n_kf} live), {n_lm} live landmarks", file=sys.stderr)

    # final global BA (two rounds: the second relinearizes at the
    # improved state), then ATE over the full keyframe trajectory
    for _ in range(2):
        stats = eng.global_ba()
        print(f"final global BA: cost {float(stats['initial_cost']):.3e} "
              f"-> {float(stats['final_cost']):.3e} "
              f"({int(stats['accepted'])} accepted, "
              f"dropped {int(stats['dropped_obs'])})", file=sys.stderr)
    kfs = eng.state.kfs
    valid = np.asarray(kfs.valid)
    fns = np.asarray(kfs.frames.frame_no)[valid]
    rv = np.asarray(kfs.frames.rvec)[valid]
    tv = np.asarray(kfs.frames.tvec)[valid]
    order = np.argsort(fns)
    est_c = np.stack([-rodrigues_np(rv[i]).T @ tv[i] for i in order])
    gt_c = np.stack([-rodrigues_np(rvecs[f]).T @ tvecs[f]
                     for f in fns[order]])
    ate = umeyama_ate(est_c, gt_c)
    extent = float(np.ptp(gt_c, axis=0).max())
    print(f"ATE {ate:.4f} over {extent:.2f} extent "
          f"({100*ate/extent:.2f}%), {len(est_c)} keyframes",
          file=sys.stderr)

    print(json.dumps({
        "metric": "large_engine_fps",
        "value": round(fps, 1),
        "unit": f"frames/s amortized, {n_kf} KFs / {n_lm} lms at end, "
                f"RUNNING {running_pct:.1f}%, ATE {100*ate/extent:.2f}% "
                f"of extent",
        "vs_baseline": round(fps / 30.0, 2),
    }))


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

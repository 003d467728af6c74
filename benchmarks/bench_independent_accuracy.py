"""Flagship-scale accuracy on INDEPENDENT imagery (VERDICT r3 task 4).

Runs the flagship engine configuration on frames from the ray-traced
validation renderer (sfm_tpu/raytrace.py — zero code shared with the
sprite renderer the engine was developed against), with whole-frame lens
distortion and sensor noise, and gates the sim(3) ATE.  This is the
engine equivalent of the reference's real-video acceptance workload
(tissuebox.mov, /root/reference/main/main.cpp:39) until a real dataset
can be mounted (io/tum.py + `cli tum` are ready).

Usage: python benchmarks/bench_independent_accuracy.py [n_frames]
Exit code 1 if the ATE gate fails.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

ATE_GATE_PCT = 2.0   # % of trajectory extent


def main(n_frames=60):
    import jax
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import __graft_entry__ as g
    from sfm_tpu.engine import SfMEngine
    from sfm_tpu.raytrace import (RayScene, orbit_arc_trajectory, sim3_ate,
                                  _rot)

    # UNMODIFIED flagship config (round 5): keyframe_min_tracked stays at
    # the reference's 50 (CSfM.cpp:485).  The round-4 gate relaxed it to
    # 20 because the DEFAULT 12-box ray scene tracks only ~35-45 points —
    # a property of that sparse scene, not of the policy: at 24 boxes
    # (smartphone-video texture density) the unmodified policy tracks a
    # median ~112 points/frame (measured round 5).
    cfg = g.flagship_config()
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    dist = [-0.22, 0.06, 0.0009, -0.0007, 0.0]
    scene = RayScene(seed=11, n_boxes=24)
    # ~0.012 rad/frame: keyframe spacing must subtend a healthy
    # baseline-to-depth ratio — at 1/3 this speed adjacent keyframes
    # triangulate from near-degenerate baselines and ATE degrades 9-16%
    # (measured round 4)
    rvecs, tvecs = orbit_arc_trajectory(n_frames, radius=5.5,
                                        arc=0.7 * n_frames / 60.0)
    print(f"rendering {n_frames} ray-traced frames...", file=sys.stderr)
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640,
                                    d=dist, noise_std=2.5, frame_no=i)
                       for i in range(n_frames)])

    eng = SfMEngine(K, (480, 640), dist, cfg)
    T = cfg.keyframe_time_lag
    t0 = time.time()
    for s in range(0, n_frames - n_frames % T, T):
        eng.add_frames(frames[s:s + T])
    print(f"scan in {time.time()-t0:.1f}s (incl. compile)", file=sys.stderr)
    statuses = np.array([m["status"] for m in eng.metrics_log])
    running_pct = 100.0 * (statuses == 1).mean()
    kfs = eng.state.kfs
    valid = np.asarray(kfs.valid)
    fns = np.asarray(kfs.frames.frame_no)[valid]
    order = np.argsort(fns)
    rv = np.asarray(kfs.frames.rvec)[valid][order]
    tv = np.asarray(kfs.frames.tvec)[valid][order]
    est_c = np.stack([-_rot(rv[i]).T @ tv[i] for i in range(len(rv))])
    gt_c = np.stack([-_rot(rvecs[f]).T @ tvecs[f] for f in fns[order]])
    ate = sim3_ate(est_c, gt_c)
    extent = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    pct = 100 * ate / max(extent, 1e-9)
    n_lms = int(np.asarray(eng.state.lms.valid).sum())
    print(f"RUNNING {running_pct:.1f}%, {len(est_c)} KFs, {n_lms} lms, "
          f"ATE {ate:.4f} over {extent:.2f} m extent ({pct:.2f}%)",
          file=sys.stderr)
    print(json.dumps({
        "metric": "independent_ate_pct",
        "value": round(pct, 3),
        "unit": f"% of {extent:.2f} m extent (ray-traced renderer, lens "
                f"distortion + noise, RUNNING {running_pct:.1f}%)",
        "vs_baseline": None,
    }))
    if pct > ATE_GATE_PCT or running_pct < 90.0 or len(est_c) < 6 \
            or extent < 1.0:
        print(f"GATE FAILED: ATE {pct:.2f}% > {ATE_GATE_PCT}% or RUNNING "
              f"{running_pct:.1f}% < 90% or {len(est_c)} KFs < 6 or "
              f"extent {extent:.2f} m < 1", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

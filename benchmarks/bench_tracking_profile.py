"""Component-attribution profile of the per-frame tracking step on the real
chip.  Each component is looped on-device via lax.scan (with a
data-dependent salt so XLA cannot hoist the body), so per-dispatch host
overhead does not enter the numbers.  Prints ms/call per component."""

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
from sfm_tpu.config import SfMConfig
from sfm_tpu.engine.state import CameraParams, init_state, make_frame
from sfm_tpu.engine.step import build_step, build_video_step
from sfm_tpu.engine.tracking import widen_tracks
from sfm_tpu.features.match import match_features
from sfm_tpu.geometry.pnp import refine_pose
from sfm_tpu.ransac import ransac_pnp
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory

REPS = 50


def timed(name, fn, *args):
    fn_j = jax.jit(fn)
    out = jax.block_until_ready(fn_j(*args))  # compile
    t0 = time.time()
    out = jax.block_until_ready(fn_j(*args))
    dt = (time.time() - t0) * 1000.0 / REPS
    print(f"{name:28s} {dt:8.3f} ms/call")
    return dt


def salted(u32s, salt):
    return u32s ^ salt


def resalt(x):
    """Data-dependent value that is always 0 but not constant-foldable."""
    return (jnp.sum(x.astype(jnp.int32)) >> 31).astype(jnp.uint32)


def main():
    cfg = SfMConfig(**g.FLAGSHIP)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))
    chunk_step = jax.jit(build_video_step(cfg, cam))

    rng = np.random.default_rng(11)
    scene = SpriteScene(rng, n_sprites=260, spread=2.4)
    rvecs, tvecs = strafe_trajectory(32, step=0.06, yaw_rate=0.001)
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(32)])
    state = init_state(cfg)
    t0 = time.time()
    state, m = chunk_step(state, jnp.asarray(frames[:16]))
    state, m = chunk_step(state, jnp.asarray(frames[16:]))
    jax.block_until_ready(m)
    print(f"bootstrap: {time.time() - t0:.1f}s, status="
          f"{int(np.asarray(m.status)[-1])}, "
          f"lms={int(np.asarray(m.n_landmarks)[-1])}", file=sys.stderr)

    img = jnp.asarray(frames[-1])
    frame = jax.jit(lambda im: make_frame(cfg, cam, im, state.frame_count))(img)
    frame = jax.block_until_ready(frame)
    prev, lms = state.prev, state.lms

    # --- full step looped (state-carried: naturally data-dependent)
    step = build_step(cfg, cam)

    def full_loop(st, im):
        def body(s, _):
            s, mm = step(s, im)
            return s, mm.n_tracked
        return jax.lax.scan(body, st, None, length=REPS)[1]
    timed("full step", full_loop, state, img)

    # --- make_frame (detect + describe + undistort)
    def mf_loop(im):
        def body(carry, _):
            f = make_frame(cfg, cam, im + carry, state.frame_count)
            return jnp.sum(f.desc).astype(jnp.float32) * 0 + \
                (jnp.sum(f.level) >> 31).astype(jnp.float32), f.xy[0, 0]
        return jax.lax.scan(body, jnp.float32(0), None, length=REPS)[1]
    timed("make_frame", mf_loop, img)

    # --- frame-to-frame matcher (512 x 512)
    src_valid = prev.kp_valid & (prev.landmark >= 0)

    def match_loop(d0, d1):
        def body(salt, _):
            res = match_features(
                salted(d0, salt), prev.xy, src_valid,
                salted(d1, salt), frame.xy, frame.kp_valid,
                min_radius=cfg.match_min_radius,
                max_radius=cfg.match_max_radius,
                max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
            return resalt(res.idx), res.idx[0]
        return jax.lax.scan(body, jnp.uint32(0), None, length=REPS)[1]
    timed("match prev->curr", match_loop, prev.desc, frame.desc)

    # --- PnP RANSAC
    res = match_features(
        prev.desc, prev.xy, src_valid, frame.desc, frame.xy, frame.kp_valid,
        min_radius=cfg.match_min_radius, max_radius=cfg.match_max_radius,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    safe_lm = jnp.where(src_valid, prev.landmark, 0)
    xyz = lms.xyz[safe_lm]
    uv = frame.xy[jnp.where(res.mask, res.idx, 0)]
    pnp_valid = res.mask & lms.valid[safe_lm]

    def pnp_loop(xyz, uv):
        def body(salt, k):
            p = ransac_pnp(
                k, cam.Kopt, xyz + salt, uv, pnp_valid,
                n_hypotheses=cfg.pnp_hypotheses,
                sample_size=cfg.pnp_sample_size,
                threshold=cfg.max_reproj_error,
                refine_iters=cfg.pnp_refine_iters,
                min_inliers=cfg.min_features,
                prior_rvec=prev.rvec, prior_tvec=prev.tvec,
                fast_path_ratio=cfg.pnp_fast_path_ratio)
            return (jnp.sum(p.n_inliers) >> 31).astype(jnp.float32), p.rvec[0]
        keys = jax.random.split(jax.random.PRNGKey(0), REPS)
        return jax.lax.scan(body, jnp.float32(0), keys)[1]
    timed("ransac_pnp", pnp_loop, xyz, uv)

    # --- widen_tracks (8192 landmarks x 512 detections)
    def widen_loop(rep):
        def body(salt, _):
            f2, n = widen_tracks(cfg, cam, lms, frame, salted(rep, salt))
            return resalt(n), n
        return jax.lax.scan(body, jnp.uint32(0), None, length=REPS)[1]
    timed("widen_tracks", widen_loop, state.rep_desc)

    # --- pose refinement
    linked = frame.kp_valid & (frame.landmark >= 0)
    safe = jnp.where(linked, frame.landmark, 0)
    w = (linked & lms.valid[safe]).astype(jnp.float32)

    def refine_loop(pts):
        def body(salt, _):
            rv, tv = refine_pose(cam.Kopt, prev.rvec, prev.tvec, pts + salt,
                                 frame.xy, w, iters=cfg.track_refine_iters)
            return (jnp.sum(rv) * 0).astype(jnp.float32), rv[0]
        return jax.lax.scan(body, jnp.float32(0), None, length=REPS)[1]
    timed("refine_pose", refine_loop, lms.xyz[safe])


if __name__ == "__main__":
    main()

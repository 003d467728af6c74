"""Deep-dive the reloc failure behind the 75/128 RUNNING regression
(VERDICT round 2, weak #1): run the bench trajectory, force LOST, then
dissect the reloc pipeline on one jitter frame — match correctness vs the
engine's own map geometry, per-hypothesis PnP inlier counts.

JAX_PLATFORMS=cpu python benchmarks/diag_reloc.py
"""

import os
import sys

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.engine.state import CameraParams, init_state, make_frame
    from sfm_tpu.engine.step import build_video_step
    from sfm_tpu.synthetic import SpriteScene, strafe_trajectory

    cfg = SfMConfig(**g.FLAGSHIP)
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
    state = init_state(cfg)
    for i in range(0, n_frames, CHUNK):
        state, m = chunk_step(state, jnp.asarray(frames[i:i + CHUNK]))
    jax.block_until_ready(m)
    print("main trajectory done; status", int(state.status), file=sys.stderr)

    # one jitter frame at the final pose
    img = jnp.asarray(scene.render(K, rvecs[-1], tvecs[-1], 480, 640)
                      .astype(np.float32))
    frame = make_frame(cfg, cam, img, state.frame_count)

    lms = state.lms
    rep = state.rep_desc
    from sfm_tpu.features.match import match_features
    res = match_features(
        rep, jnp.zeros((lms.valid.shape[0], 2)), lms.valid,
        frame.desc, frame.xy, frame.kp_valid,
        min_radius=0.0, max_radius=1e9,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    mask = np.asarray(res.mask & lms.valid)
    print(f"valid landmarks: {int(np.asarray(lms.valid).sum())}, "
          f"global matches: {mask.sum()}")

    # geometric correctness of matches vs the engine's own map: project
    # each matched landmark with the engine's final tracked pose (prev)
    from sfm_tpu.geometry.camera import project
    prev = state.prev
    proj = np.asarray(project(cam.Kopt, prev.rvec, prev.tvec, lms.xyz))
    uv = np.asarray(frame.xy)[np.asarray(res.idx)]
    d = np.linalg.norm(proj - uv, axis=1)
    dm = d[mask]
    print(f"match->projection dist px: median {np.median(dm):.1f}, "
          f"<7px: {(dm < 7).sum()}/{len(dm)}")

    np.savez("/tmp/reloc_case.npz", xyz=np.asarray(lms.xyz), uv=uv,
             mask=mask, d=d, valid=np.asarray(lms.valid),
             K=np.asarray(cam.Kopt))
    # run the actual reloc PnP and per-hypothesis counts
    from sfm_tpu.ransac import ransac_pnp, sample_masked
    from sfm_tpu.geometry.pnp import pnp_dlt, reprojection_errors
    key = jax.random.PRNGKey(0)
    pnp = ransac_pnp(
        key, cam.Kopt, lms.xyz, jnp.asarray(uv), jnp.asarray(mask),
        n_hypotheses=cfg.pnp_hypotheses, sample_size=cfg.pnp_sample_size,
        threshold=cfg.max_reproj_error, refine_iters=cfg.pnp_refine_iters,
        min_inliers=max(cfg.min_features * 3, 15), solver=cfg.pnp_solver)
    print(f"reloc PnP: ok={bool(pnp.ok)} n_inliers={int(pnp.n_inliers)}")

    samples = sample_masked(key, jnp.asarray(mask), cfg.pnp_hypotheses, 6)
    sn = np.asarray(samples)
    good_samples = mask[sn].all(axis=1).sum()
    print(f"hypothesis samples drawing only valid idx: "
          f"{good_samples}/{len(sn)}")
    # correctness of sampled points (within 7px of engine-pose projection)
    corr = (d[sn] < 7).all(axis=1).sum()
    print(f"all-6-correct samples: {corr}/{len(sn)}")
    for hi in range(min(4, len(sn))):
        idx = samples[hi]
        w = jnp.zeros_like(jnp.asarray(mask), jnp.float32).at[idx].set(
            1.0) * jnp.asarray(mask)
        rv, tv = pnp_dlt(cam.Kopt, lms.xyz, jnp.asarray(uv), w)
        err = np.asarray(reprojection_errors(cam.Kopt, rv, tv, lms.xyz,
                                             jnp.asarray(uv)))
        print(f"hyp {hi}: sample d_px={np.round(d[sn[hi]], 1).tolist()} "
              f"inliers={(err[mask] < 7).sum()}")


if __name__ == "__main__":
    main()

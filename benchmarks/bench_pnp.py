"""PnP RANSAC solver comparison on the real chip: 6-pt DLT (eigh-based)
vs P3P minimal (closed-form).  The tracking-step profile attributes
a large share to ransac_pnp — per-hypothesis 12x12 eigh batches are
costly inside a vmap; P3P replaces them with a quartic solve.

Synthetic task matches the flagship operating point: 512 candidate
matches, ~35% outliers, prior pose available (one-frame-old motion).
Prints ms/call and rotation/translation errors per solver.
"""

import os
import sys
import time

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

from sfm_tpu.ransac import ransac_pnp
from sfm_tpu.np_geometry import rodrigues_np

REPS = 50


def make_problem(rng, n=512, outlier_frac=0.35):
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    xyz = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    rvec = rng.normal(0, 0.1, 3).astype(np.float32)
    tvec = rng.normal(0, 0.2, 3).astype(np.float32)
    R = rodrigues_np(rvec)
    cam = xyz @ R.T + tvec
    uv = (cam[:, :2] / cam[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv += rng.normal(0, 0.5, uv.shape)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    valid = np.ones(n, bool)
    # prior: last frame's pose (small motion away)
    prior_rv = rvec + rng.normal(0, 0.02, 3).astype(np.float32)
    prior_tv = tvec + rng.normal(0, 0.05, 3).astype(np.float32)
    return (K, xyz.astype(np.float32), uv.astype(np.float32), valid,
            rvec, tvec, prior_rv, prior_tv)


def bench(solver, n_hyp, refine_iters=6):
    rng = np.random.default_rng(7)
    K, xyz, uv, valid, rv_gt, tv_gt, prv, ptv = make_problem(rng)
    Kj = jnp.asarray(K)

    def run(key, uvj):
        return ransac_pnp(key, Kj, jnp.asarray(xyz), uvj,
                          jnp.asarray(valid), n_hypotheses=n_hyp,
                          sample_size=6, threshold=7.0,
                          refine_iters=refine_iters, min_inliers=5,
                          prior_rvec=jnp.asarray(prv),
                          prior_tvec=jnp.asarray(ptv), solver=solver)

    def loop(key, uvj):
        def body(k, _):
            k, sub = jax.random.split(k)
            r = run(sub, uvj)
            # fold result into the carry so nothing is dead code
            k = k ^ (r.n_inliers.astype(jnp.uint32) >> 30)
            return k, (r.rvec, r.tvec, r.n_inliers)
        return jax.lax.scan(body, key, None, length=REPS)[1]

    loop_j = jax.jit(loop)
    key = jax.random.PRNGKey(3)
    uvj = jnp.asarray(uv)
    out = jax.block_until_ready(loop_j(key, uvj))
    t0 = time.time()
    out = jax.block_until_ready(loop_j(key, uvj))
    dt = (time.time() - t0) * 1000 / REPS
    rv = np.asarray(out[0][-1])
    tv = np.asarray(out[1][-1])
    n_inl = int(np.asarray(out[2][-1]))
    rot_err = np.degrees(np.linalg.norm(rv - rv_gt))
    t_err = np.linalg.norm(tv - tv_gt)
    print(f"{solver:4s} hyp={n_hyp:3d} refine={refine_iters}: "
          f"{dt:7.3f} ms/call  inl={n_inl:3d}  "
          f"rot_err={rot_err:.4f}deg  t_err={t_err:.5f}")
    return dt


def main():
    for solver, hyp in [("dlt", 32), ("dlt", 16), ("p3p", 32), ("p3p", 16),
                        ("p3p", 8)]:
        bench(solver, hyp)
    bench("p3p", 16, refine_iters=4)


if __name__ == "__main__":
    main()

"""Device-trace attribution of large-BA linearization alone (the dominant
cost after the matvec fixes: ~29 of 36.5 ms/LM-iter at 1k KF / 100k lm)."""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

from sfm_tpu.ba import Observations
from sfm_tpu.ba.large import (build_tables, _blocks_lm_major,
                              _blocks_cam_major)
from sfm_tpu.geometry.rotations import exp_so3
from bench_mapping_profile import trace_and_report


def main(n_cams=1000, n_lms=100_000, obs_per_lm=6):
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-50, 50, n_lms), rng.uniform(-10, 10, n_lms),
                  rng.uniform(20, 60, n_lms)], 1).astype(np.float32)
    K = np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]], np.float32)
    cam_t = np.stack([np.linspace(-40, 40, n_cams), np.zeros(n_cams),
                      np.zeros(n_cams)], 1).astype(np.float32)
    base = rng.integers(0, n_cams - obs_per_lm, n_lms)
    lm_idx = np.repeat(np.arange(n_lms), obs_per_lm).astype(np.int32)
    cam_idx = (base[:, None] + np.arange(obs_per_lm)[None, :]) \
        .reshape(-1).astype(np.int32)
    p = X[lm_idx] + cam_t[cam_idx]
    uv = (p[:, :2] / p[:, 2:]) * 525.0 + np.array([320.0, 240.0])
    obs = Observations(jnp.asarray(cam_idx), jnp.asarray(lm_idx),
                       jnp.asarray(uv.astype(np.float32)),
                       jnp.ones(len(cam_idx), jnp.float32))
    nmax = int(np.bincount(cam_idx, minlength=n_cams).max())
    tables = build_tables(obs, n_cams, n_lms, nmax=nmax, kmax=obs_per_lm)

    rv = jnp.zeros((n_cams, 3))
    tv = jnp.asarray(cam_t)
    Xj = jnp.asarray(X)
    cam_free_f = jnp.ones(n_cams)
    lm_free_f = jnp.ones(n_lms)
    Kj = jnp.asarray(K)

    def linearize(rv, tv, xyz):
        R = exp_so3(rv)
        r_l, A_l, B_l, rw_l, w_l = _blocks_lm_major(
            Kj, R, tv, xyz, tables, cam_free_f, lm_free_f, 0.0)
        r_c, A_c, B_c, rw_c, w_c = _blocks_cam_major(
            Kj, R, tv, xyz, tables, cam_free_f, lm_free_f, 0.0)
        U = jnp.sum(A_c[..., :, None] * A_c[..., None, :], axis=(1, 2))
        g_cam = -jnp.sum(A_c * rw_c[..., None], axis=(1, 2))
        V = jnp.sum(B_l[..., :, None] * B_l[..., None, :], axis=(1, 2))
        g_lm = -jnp.sum(B_l * rw_l[..., None], axis=(1, 2))
        W_l = jnp.sum(A_l[..., :, None] * B_l[..., None, :], axis=2)
        cost = jnp.sum(jnp.sum(r_l * r_l, -1) * w_l)
        return U, g_cam, V, g_lm, W_l, cost

    fn = jax.jit(linearize)
    out = jax.block_until_ready(fn(rv, tv, Xj))
    t0 = time.time()
    for _ in range(10):
        out = jax.block_until_ready(fn(rv, tv, Xj))
    print(f"linearize: {(time.time()-t0)*100:.2f} ms/call", file=sys.stderr)
    trace_and_report("linearize", fn, rv, tv, Xj)


if __name__ == "__main__":
    main()

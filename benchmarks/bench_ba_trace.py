"""Device-trace attribution of one large-BA solve: sums device op
durations inside the jitted run_large_ba call."""

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
from sfm_tpu.ba.large import build_tables, run_large_ba
from bench_mapping_profile import trace_and_report


def main(n_cams=1000, n_lms=100_000, obs_per_lm=6, iters=2,
         cg_iters=25):
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

    rv0 = jnp.zeros((n_cams, 3)).at[1:].add(0.002)
    tv0 = jnp.asarray(cam_t)
    X0 = jnp.asarray(X) + 0.05
    cam_free = jnp.ones(n_cams, bool).at[0].set(False)
    lm_free = jnp.ones(n_lms, bool)

    def solve(rv, tv, X):
        return run_large_ba(
            jnp.asarray(K), rv, tv, X, tables, cam_free=cam_free,
            lm_free=lm_free, iterations=iters, cg_iterations=cg_iters,
            tol=0.0)

    t0 = time.time()
    out = jax.block_until_ready(jax.jit(solve)(rv0, tv0, X0))
    print(f"compile+first: {time.time()-t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    out = jax.block_until_ready(jax.jit(solve)(rv0, tv0, X0))
    print(f"second call: {(time.time()-t0)*1000:.1f} ms "
          f"({(time.time()-t0)*1000/iters:.1f} ms/LM-iter)", file=sys.stderr)
    trace_and_report("large_ba", jax.jit(solve), rv0, tv0, X0)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

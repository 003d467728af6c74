"""BA speed benchmark: ms per LM iteration at the BASELINE.json operating
points (global BA at ~500-1000 keyframes, 50k-100k landmarks) using the
implicit-Schur PCG solver.

Usage: python benchmarks/bench_ba.py [n_cams] [n_landmarks]
Prints one JSON line: {"metric": "ba_ms_per_iter", ..., "device": ...}."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def main(n_cams=1000, n_lms=100_000, obs_per_lm=6, iters=8, cg_iters=25):
    import jax
    import jax.numpy as jnp
    from bench import require_gpu
    from sfm_tpu.utils.cache import enable_compile_cache
    from sfm_tpu.ba import Observations
    from sfm_tpu.ba.large import build_tables, run_large_ba
    from sfm_tpu.synthetic import banded_ba_problem

    info = require_gpu()
    enable_compile_cache()
    pb = banded_ba_problem(n_cams, n_lms, obs_per_lm)
    obs = Observations(jnp.asarray(pb["cam_idx"]), jnp.asarray(pb["lm_idx"]),
                       jnp.asarray(pb["uv"]),
                       jnp.ones(len(pb["cam_idx"]), jnp.float32))
    nmax = int(np.bincount(pb["cam_idx"], minlength=n_cams).max())
    print(f"building tables: {len(pb['cam_idx'])} obs, nmax={nmax}",
          file=sys.stderr)
    tables = build_tables(obs, n_cams, n_lms, nmax=nmax, kmax=obs_per_lm)
    cam_free = jnp.ones(n_cams, bool).at[0].set(False)
    lm_free = jnp.ones(n_lms, bool)

    f = jax.jit(lambda rv, tv, X: run_large_ba(
        jnp.asarray(pb["K"]), rv, tv, X, tables, cam_free=cam_free,
        lm_free=lm_free, iterations=iters, cg_iterations=cg_iters, tol=0.0))
    args = (jnp.asarray(pb["rvec0"]), jnp.asarray(pb["tvec0"]),
            jnp.asarray(pb["xyz0"]))
    t0 = time.time()
    out = f(*args)
    jax.block_until_ready(out)
    print(f"compile+first: {time.time()-t0:.1f}s, accepted "
          f"{int(out[3].accepted)}, cost {float(out[3].initial_cost):.3e} "
          f"-> {float(out[3].final_cost):.3e}", file=sys.stderr)
    t0 = time.time()
    out = f(*args)
    _ = float(np.asarray(out[3].final_cost))
    ms_per_iter = (time.time() - t0) / iters * 1000

    print(json.dumps({
        "metric": "ba_ms_per_iter",
        "value": round(ms_per_iter, 2),
        "unit": f"ms/LM-iter @ {n_cams} KFs, {n_lms} landmarks, "
                f"{len(pb['cam_idx'])} obs (incl. {cg_iters} PCG iters "
                "each)",
        "vs_baseline": None,
        "device": info,
    }))


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])

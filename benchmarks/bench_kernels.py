"""Per-kernel performance benchmarks (SURVEY.md §4.5: per-kernel roofline
benchmarks for the hot ops).  Run on the GPU; prints one JSON line per
kernel.

Usage: python benchmarks/bench_kernels.py"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def bench(name, f, n=50, **extra):
    import jax
    o = f()
    jax.block_until_ready(o)
    t0 = time.time()
    for _ in range(n):
        o = f()
    jax.block_until_ready(o)
    ms = (time.time() - t0) / n * 1000
    print(json.dumps({"kernel": name, "ms": round(ms, 3), **extra}))
    return ms


def main():
    import jax
    import jax.numpy as jnp
    from sfm_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from sfm_tpu.features import detect, describe, build_pyramid
    from sfm_tpu.features.bits import pack_bits
    from sfm_tpu.features.match import match_features
    from sfm_tpu.ba import Observations, run_ba
    from sfm_tpu.geometry.triangulate import triangulate_pair

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (480, 640)).astype(np.float32))

    d_fn = jax.jit(lambda im: detect(im, max_keypoints=512, levels=4,
                                     threshold=20.0))
    kps = d_fn(img)
    bench("fast_detect_480x640_4lvl", lambda: d_fn(img))

    pyr = jax.jit(lambda im: build_pyramid(im, 4))(img)
    desc_fn = jax.jit(lambda: describe(pyr, kps, 512))
    bench("describe_512kp_512bit", desc_fn)

    L, N = 8192, 512
    d0 = pack_bits(jnp.asarray(rng.integers(0, 2, (L, 512)).astype(np.float32)))
    d1 = pack_bits(jnp.asarray(rng.integers(0, 2, (N, 512)).astype(np.float32)))
    xy0 = jnp.asarray(rng.uniform(0, 600, (L, 2)).astype(np.float32))
    xy1 = jnp.asarray(rng.uniform(0, 600, (N, 2)).astype(np.float32))
    v0, v1 = jnp.ones(L, bool), jnp.ones(N, bool)
    kw = dict(min_radius=0.0, max_radius=50.0, max_distance=260.0, ratio=0.9)
    mx = jax.jit(lambda: match_features(d0, xy0, v0, d1, xy1, v1, **kw))
    bench("hamming_match_xla_8192x512", mx)

    K = jnp.asarray([[525., 0, 320], [0, 525., 240], [0, 0, 1]],
                    dtype=jnp.float32)
    P0 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], 1)
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.ones((3, 1))], 1)
    uv = jnp.asarray(rng.uniform(0, 480, (512, 2)).astype(np.float32))
    tri = jax.jit(lambda: triangulate_pair(P0, P1, uv, uv + 2.0))
    bench("triangulate_512pts", tri)

    C, Lb, O = 32, 8192, 32 * 512
    obs = Observations(
        jnp.asarray(rng.integers(0, C, O).astype(np.int32)),
        jnp.asarray(rng.integers(0, Lb, O).astype(np.int32)),
        jnp.asarray(rng.uniform(0, 480, (O, 2)).astype(np.float32)),
        jnp.asarray((rng.uniform(0, 1, O) < 0.5).astype(np.float32)))
    rv = jnp.asarray(rng.normal(0, 0.01, (C, 3)).astype(np.float32))
    tv = jnp.asarray(rng.normal(0, 0.1, (C, 3)).astype(np.float32))
    X = jnp.asarray(rng.normal(0, 1, (Lb, 3)).astype(np.float32)
                    + np.array([0, 0, 6]))
    ba = jax.jit(lambda: run_ba(
        K, rv, tv, X, obs, cam_free=jnp.ones(C, bool).at[0].set(False),
        lm_free=jnp.ones(Lb, bool), iterations=20, tol=0.0))
    ms = bench("run_ba_32kf_8192lm_20it", ba, n=5)
    print(json.dumps({"kernel": "ba_ms_per_lm_iter_scan_scale",
                      "ms": round(ms / 20, 3)}))


if __name__ == "__main__":
    main()

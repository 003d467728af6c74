"""Closed-form small-inverse parity vs LAPACK (the custom calls they
replace on hot paths)."""

import numpy as np
import jax.numpy as jnp

from sfm_tpu.geometry.smallinv import inv3x3, solve3, solve6, inv6x6


def test_inv3x3_general(rng):
    M = rng.normal(0, 1, (50, 3, 3)) + 3 * np.eye(3)
    got = np.asarray(inv3x3(jnp.asarray(M, jnp.float32)))
    ref = np.linalg.inv(M)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_solve3(rng):
    M = rng.normal(0, 1, (20, 3, 3)) + 3 * np.eye(3)
    v = rng.normal(0, 1, (20, 3))
    got = np.asarray(solve3(jnp.asarray(M, jnp.float32),
                            jnp.asarray(v, jnp.float32)))
    ref = np.linalg.solve(M, v[..., None])[..., 0]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _spd6(rng, n):
    A = rng.normal(0, 1, (n, 6, 6))
    return A @ A.transpose(0, 2, 1) + 2 * np.eye(6)


def test_solve6(rng):
    H = _spd6(rng, 30)
    g = rng.normal(0, 1, (30, 6))
    got = np.asarray(solve6(jnp.asarray(H, jnp.float32),
                            jnp.asarray(g, jnp.float32)))
    ref = np.linalg.solve(H, g[..., None])[..., 0]
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_inv6x6(rng):
    H = _spd6(rng, 30)
    got = np.asarray(inv6x6(jnp.asarray(H, jnp.float32)))
    np.testing.assert_allclose(got, np.linalg.inv(H), rtol=1e-3, atol=2e-3)


def test_intrinsics_inverse():
    K = np.array([[525.0, 0.5, 320.0], [0, 520.0, 240.0], [0, 0, 1]])
    got = np.asarray(inv3x3(jnp.asarray(K, jnp.float32)))
    np.testing.assert_allclose(got, np.linalg.inv(K), rtol=1e-5, atol=1e-6)

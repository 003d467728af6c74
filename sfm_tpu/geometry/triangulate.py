"""Multi-view DLT triangulation.

Replaces GeometryUtils::triangulatePoints (called at CSfM.cpp:156, 918).
Batched over points with vmap; fp32-safe via per-point row normalization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .rotations import exp_so3


def projection_matrix(rvec: jnp.ndarray, tvec: jnp.ndarray) -> jnp.ndarray:
    """[R|t] 3x4 (no intrinsics — matching CFrame.cpp:244-249's _P)."""
    R = exp_so3(rvec)
    return jnp.concatenate([R, tvec[:, None]], axis=1)


def _dlt_rows(P: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Two DLT rows for one view: u*P3 - P1, v*P3 - P2.  P is K-premultiplied
    or uv is in normalized coords — caller's choice, must be consistent."""
    r1 = uv[0] * P[2] - P[0]
    r2 = uv[1] * P[2] - P[1]
    return jnp.stack([r1, r2])


def triangulate_pair(P0: jnp.ndarray, P1: jnp.ndarray,
                     uv0: jnp.ndarray, uv1: jnp.ndarray) -> jnp.ndarray:
    """Two-view DLT for batches of correspondences (inhomogeneous form).

    P0, P1: 3x4 projection matrices (K @ [R|t]).
    uv0, uv1: [N,2] pixel coords.  Returns [N,3] world points.

    Fixes the homogeneous coordinate w=1 and solves the 4x3 least-squares
    system through closed-form 3x3 normal equations — much cheaper than
    the eigendecomposition form, exact for finite
    points (SLAM scans have no points at infinity; the homogeneous variant
    remains available as triangulate_pair_h)."""
    def one(uv0_i, uv1_i):
        A = jnp.concatenate([_dlt_rows(P0, uv0_i), _dlt_rows(P1, uv1_i)])
        # row-normalize for fp32 conditioning
        A = A / (jnp.linalg.norm(A, axis=1, keepdims=True) + 1e-12)
        A3 = A[:, :3]
        b = -A[:, 3]
        M = A3.T @ A3
        rhs = A3.T @ b
        return _solve3_sym(M, rhs)

    return jax.vmap(one)(uv0, uv1)


def _solve3_sym(M, rhs):
    """Closed-form solve of a symmetric 3x3 system (adjugate)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    e, f = M[1, 1], M[1, 2]
    i = M[2, 2]
    A_ = e * i - f * f
    B_ = c * f - b * i
    C_ = b * f - c * e
    E_ = a * i - c * c
    F_ = b * c - a * f
    I_ = a * e - b * b
    det = a * A_ + b * B_ + c * C_
    det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    inv = jnp.stack([
        jnp.stack([A_, B_, C_]),
        jnp.stack([B_, E_, F_]),
        jnp.stack([C_, F_, I_]),
    ])
    return (inv @ rhs) / det


def triangulate_pair_h(P0: jnp.ndarray, P1: jnp.ndarray,
                       uv0: jnp.ndarray, uv1: jnp.ndarray) -> jnp.ndarray:
    """Homogeneous two-view DLT (smallest eigenvector of A^T A) — handles
    near-infinite points; slower than the inhomogeneous form."""
    def one(uv0_i, uv1_i):
        A = jnp.concatenate([_dlt_rows(P0, uv0_i), _dlt_rows(P1, uv1_i)])
        A = A / (jnp.linalg.norm(A, axis=1, keepdims=True) + 1e-12)
        AtA = A.T @ A
        w, V = jnp.linalg.eigh(AtA)
        X = V[:, 0]
        return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12,
                                 jnp.sign(X[3]) * 1e-12 + 1e-12, X[3])

    return jax.vmap(one)(uv0, uv1)


def triangulate_nviews(Ps: jnp.ndarray, uvs: jnp.ndarray,
                       mask: jnp.ndarray) -> jnp.ndarray:
    """N-view DLT for one point: Ps [V,3,4], uvs [V,2], mask [V] bool.

    Masked views contribute zero rows.  Returns [3]."""
    rows = jax.vmap(_dlt_rows)(Ps, uvs)            # [V,2,4]
    rows = rows / (jnp.linalg.norm(rows, axis=-1, keepdims=True) + 1e-12)
    rows = rows * mask[:, None, None]
    A = rows.reshape(-1, 4)
    AtA = A.T @ A
    w, V = jnp.linalg.eigh(AtA)
    X = V[:, 0]
    return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12,
                             jnp.sign(X[3]) * 1e-12 + 1e-12, X[3])

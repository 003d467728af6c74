"""Closed-form small-matrix inverses/solves.

``jnp.linalg.inv``/``solve`` on 3x3 / 6x6 operands lower to LU /
triangular-solve custom calls; inside a vmapped or scanned hot loop those
serialized and dominated on the backend this was first tuned for.  These
closed forms are pure elementwise arithmetic: they fuse and vmap.

Numerics: adjugate/det for 3x3 (exact to fp rounding), 2x2-of-3x3-blocks
Schur for 6x6.  Fine for the well-conditioned, damped systems used here
(intrinsics, damped Gauss-Newton Hessians); NOT a general replacement for
LAPACK on ill-conditioned input."""

from __future__ import annotations

import jax.numpy as jnp


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """General [..., 3, 3] inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-20,
                    jnp.where(det < 0, -1e-20, 1e-20), det)
    adj = jnp.stack([
        jnp.stack([A, B, C], -1),
        jnp.stack([D, E, F], -1),
        jnp.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Tiny batched matmul as a broadcast multiply-reduce (see
    ba/residuals.bmm_small)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _mv(a: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * v[..., None, :], axis=-1)


def solve3(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] @ x = v [..., 3]."""
    return _mv(inv3x3(M), v)


def solve6(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """[..., 6, 6] @ x = g [..., 6] via 3x3-block Schur elimination.
    Assumes the leading 3x3 block is invertible (true for damped
    Gauss-Newton Hessians)."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, :3]
    D = H[..., 3:, 3:]
    g1, g2 = g[..., :3], g[..., 3:]
    Ainv = inv3x3(A)
    CAinv = _mm(C, Ainv)
    S = D - _mm(CAinv, B)
    x2 = solve3(S, g2 - _mv(CAinv, g1))
    x1 = _mv(Ainv, g1 - _mv(B, x2))
    return jnp.concatenate([x1, x2], axis=-1)


def solve12(M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """[..., 12, 12] @ x = v [..., 12] via 6x6-block Schur elimination
    (each 6x6 handled by the 3x3-block forms above).  Same caveat: the
    leading blocks must be invertible — true for the regularized normal
    matrices this serves (DLT A^T A + eps I in geometry/pnp.py)."""
    A = M[..., :6, :6]
    B = M[..., :6, 6:]
    C = M[..., 6:, :6]
    D = M[..., 6:, 6:]
    g1, g2 = v[..., :6], v[..., 6:]
    Ainv = inv6x6(A)
    CAinv = _mm(C, Ainv)
    S = D - _mm(CAinv, B)
    x2 = _mv(inv6x6(S), g2 - _mv(CAinv, g1))
    x1 = _mv(Ainv, g1 - _mv(B, x2))
    return jnp.concatenate([x1, x2], axis=-1)


def min_eigvec(M: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """Smallest-eigenvalue eigenvector of a symmetric PSD [..., 12, 12]
    matrix by regularized inverse iteration (each step a closed-form
    blocked solve).  Replaces jnp.linalg.eigh on the DLT normal matrix,
    whose custom call serialized inside vmapped hypothesis batches on
    the backend this was first tuned for.

    For DLT null-space problems the smallest eigenvalue is ~0 while the
    rest are O(1) after Hartley normalization, so each iteration shrinks
    off-axis error by ~eps/lam_2: 2-3 iterations reach fp32 noise."""
    n = M.shape[-1]
    tr = jnp.trace(M, axis1=-2, axis2=-1)[..., None, None]
    reg = M + (1e-7 / n) * tr * jnp.eye(n, dtype=M.dtype)
    v = jnp.ones(M.shape[:-2] + (n,), M.dtype)
    for _ in range(iters):
        v = solve12(reg, v)
        v = v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
    return v


def inv6x6(H: jnp.ndarray) -> jnp.ndarray:
    """[..., 6, 6] inverse via 3x3-block Schur (same caveat as solve6)."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    C = H[..., 3:, :3]
    D = H[..., 3:, 3:]
    Ainv = inv3x3(A)
    AinvB = _mm(Ainv, B)
    CAinv = _mm(C, Ainv)
    Sinv = inv3x3(D - _mm(C, AinvB))
    TL = Ainv + _mm(AinvB, _mm(Sinv, CAinv))
    TR = -_mm(AinvB, Sinv)
    BL = -_mm(Sinv, CAinv)
    return jnp.concatenate([
        jnp.concatenate([TL, TR], axis=-1),
        jnp.concatenate([BL, Sinv], axis=-1),
    ], axis=-2)

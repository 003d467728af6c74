"""SO(3) utilities: Rodrigues exp/log maps.

Replaces cv::Rodrigues usage in the reference (CSfM.cpp:564,
CFrame.cpp:232/239/246) and ceres::AngleAxisRotatePoint (CTracker.cpp:588).
All functions are pure, fp32-safe (Taylor fallbacks near theta=0), and
batchable with vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix [w]_x of a 3-vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(rvec: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: angle-axis vector -> 3x3 rotation matrix.

    Uses the exact Rodrigues formula with series expansion of the
    sin(t)/t and (1-cos t)/t^2 coefficients near zero so the function is
    smooth and auto-differentiable at the identity.
    """
    theta2 = jnp.sum(rvec * rvec, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS)
    # coefficients a = sin(t)/t, b = (1 - cos t)/t^2
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = hat(rvec)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    # K @ K as a broadcast multiply-reduce: XLA lowered BATCHED 3x3
    # dot_generals to dilated-convolution kernels far off the roofline on
    # the backend this was first tuned for (same pathology
    # ba/residuals.bmm_small documents)
    KK = jnp.sum(K[..., :, :, None] * K[..., None, :, :], axis=-2)
    return eye + a * K + b * KK


def log_so3(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse Rodrigues: rotation matrix -> angle-axis vector.

    Stable for angles in [0, pi); the pi-singular case resolves the axis
    from the diagonal of (R + I)/2.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # antisymmetric part gives axis*sin(theta)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)[..., None]
    # generic: w / (2 sin t) * theta; near 0: w/2 (since sin t ~ t)
    generic = w * (theta[..., None] / (2.0 * sin_t + _EPS))
    near_zero = w * 0.5
    rvec = jnp.where(theta[..., None] < 1e-4, near_zero, generic)
    # near pi: axis^2 = diag((R+I)/2); signs from off-diagonals
    def near_pi_axis(R, theta):
        d = jnp.clip(jnp.stack(
            [R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1) * 0.5 + 0.5,
            0.0, 1.0)
        axis = jnp.sqrt(d)
        # fix signs using the largest component as positive anchor
        imax = jnp.argmax(axis, axis=-1)
        off = jnp.stack(
            [
                R[..., 1, 0] + R[..., 0, 1],  # relates sign(x*y)
                R[..., 2, 0] + R[..., 0, 2],  # sign(x*z)
                R[..., 2, 1] + R[..., 1, 2],  # sign(y*z)
            ],
            axis=-1,
        )
        sx = jnp.where(imax == 0, 1.0, jnp.where(imax == 1, jnp.sign(off[..., 0] + _EPS), jnp.sign(off[..., 1] + _EPS)))
        sy = jnp.where(imax == 1, 1.0, jnp.where(imax == 0, jnp.sign(off[..., 0] + _EPS), jnp.sign(off[..., 2] + _EPS)))
        sz = jnp.where(imax == 2, 1.0, jnp.where(imax == 0, jnp.sign(off[..., 1] + _EPS), jnp.sign(off[..., 2] + _EPS)))
        axis = axis * jnp.stack([sx, sy, sz], axis=-1)
        axis = axis / (jnp.linalg.norm(axis, axis=-1, keepdims=True) + _EPS)
        return axis * theta[..., None]

    rvec = jnp.where(theta[..., None] > 3.1066, near_pi_axis(R, theta), rvec)
    return rvec


def _mm4(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Tiny batched 4x4 matmul as a broadcast multiply-reduce (see
    ba/residuals.bmm_small)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def _adjugate4(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate of [..., 4, 4]: adj[i, j] = (-1)^{i+j} *
    det(A minor(j, i)).  For (near-)singular A the columns of adj span the
    null space — used below to extract an eigenvector without any
    iterative or LAPACK machinery."""
    def det3(rs, cs):
        a, b, c = (A[..., rs[0], cs[0]], A[..., rs[0], cs[1]],
                   A[..., rs[0], cs[2]])
        d, e, f = (A[..., rs[1], cs[0]], A[..., rs[1], cs[1]],
                   A[..., rs[1], cs[2]])
        g, h, i = (A[..., rs[2], cs[0]], A[..., rs[2], cs[1]],
                   A[..., rs[2], cs[2]])
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)

    idx = (0, 1, 2, 3)
    rows = []
    for i in range(4):
        row = []
        for j in range(4):
            rs = tuple(r for r in idx if r != j)   # minor deletes row j
            cs = tuple(c for c in idx if c != i)   # ... and column i
            row.append(((-1.0) ** (i + j)) * det3(rs, cs))
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], axis=-1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], axis=-1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)


def nearest_rotation(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form nearest rotation: argmax_{R in SO(3)} tr(R^T M) for
    [..., 3, 3] M (= U diag(1, 1, det(UV^T)) V^T from the SVD of M).

    jnp.linalg.svd on tiny batched 3x3 operands lowered to an iterative
    while-loop with custom calls on the backend this was first tuned for,
    which serialized inside vmapped hot paths.  This is Horn's quaternion
    method instead: the optimum is the largest eigenvector of a 4x4
    symmetric matrix, computed via the closed-form quartic characteristic
    polynomial (the matrix is traceless, so the quartic is depressed) and
    an adjugate null-space
    extraction — pure elementwise arithmetic, batches perfectly."""
    from .poly import quartic_roots

    # scale-normalize (R is scale-invariant; conditions the quartic)
    nrm = jnp.sqrt(jnp.sum(M * M, axis=(-2, -1), keepdims=True))
    Mn = M / jnp.maximum(nrm, 1e-12)
    Sxx, Sxy, Sxz = Mn[..., 0, 0], Mn[..., 0, 1], Mn[..., 0, 2]
    Syx, Syy, Syz = Mn[..., 1, 0], Mn[..., 1, 1], Mn[..., 1, 2]
    Szx, Szy, Szz = Mn[..., 2, 0], Mn[..., 2, 1], Mn[..., 2, 2]
    N = jnp.stack([
        jnp.stack([Sxx + Syy + Szz, Szy - Syz, Sxz - Szx, Syx - Sxy], -1),
        jnp.stack([Szy - Syz, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        jnp.stack([Sxz - Szx, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        jnp.stack([Syx - Sxy, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], axis=-2)
    # characteristic polynomial of the traceless symmetric N:
    # lambda^4 + c2 lambda^2 + c1 lambda + c0
    t2 = jnp.sum(N * N, axis=(-2, -1))
    N2 = _mm4(N, N)
    t3 = jnp.sum(N2 * N, axis=(-2, -1))
    t4 = jnp.sum(N2 * N2, axis=(-2, -1))
    c2 = -t2 / 2.0
    c1 = -t3 / 3.0
    c0 = t2 * t2 / 8.0 - t4 / 4.0
    one = jnp.ones_like(c2)
    roots, ok = quartic_roots(one, jnp.zeros_like(c2), c2, c1, c0)
    lam = jnp.max(jnp.where(ok, roots, -jnp.inf), axis=-1)
    A = N - lam[..., None, None] * jnp.eye(4, dtype=M.dtype)
    adj = _adjugate4(A)
    # any nonzero column of adj(A) spans the eigenvector; take the largest
    norms = jnp.sum(adj * adj, axis=-2)
    best = jnp.argmax(norms, axis=-1)
    q = jnp.take_along_axis(
        adj, best[..., None, None].repeat(4, axis=-2), axis=-1)[..., 0]
    nq = jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True))
    # degenerate (repeated top eigenvalue): fall back to identity — callers
    # (RANSAC hypothesis scoring / GN refinement) discard or fix it up
    q = jnp.where(nq > 1e-12, q / jnp.maximum(nq, 1e-12),
                  jnp.array([1.0, 0.0, 0.0, 0.0], M.dtype))
    return quat_to_matrix(q)


def rotate_points(rvec: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Rotate points [..., N, 3] by angle-axis rvec [..., 3].

    Direct Rodrigues point rotation (the AngleAxisRotatePoint analogue):
    p' = p cos t + (w x p) sin t + w (w . p)(1 - cos t).
    """
    R = exp_so3(rvec)
    return pts @ jnp.swapaxes(R, -1, -2)

"""Perspective-n-Point: DLT pose from 2D-3D correspondences + Gauss-Newton
pose refinement.

Replaces cv::solvePnPRansac(SOLVEPNP_ITERATIVE) (CSfM.cpp:552-560).  The
RANSAC harness (hypothesis sampling / inlier voting) lives in
sfm_tpu/ransac.py; here:
  - ``pnp_dlt``: 6+ point DLT of the 3x4 projection matrix, R extracted by
    orthogonal Procrustes, cheirality-corrected.
  - ``refine_pose``: fixed-iteration damped Gauss-Newton on the masked
    reprojection residual (the "iterative" part of SOLVEPNP_ITERATIVE).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .rotations import log_so3, nearest_rotation
from .camera import project
from .poly import quartic_roots as _quartic_roots
from .smallinv import inv3x3, min_eigvec, solve6


def pnp_dlt(K: jnp.ndarray, xyz: jnp.ndarray, uv: jnp.ndarray,
            w: jnp.ndarray):
    """Weighted DLT pose.  xyz [N,3] world, uv [N,2] pixels, w [N] weights.

    Works in normalized camera coords (K removed) for conditioning.
    Returns (rvec, tvec).  Needs >= 6 effective points, non-coplanar."""
    wf = w.astype(xyz.dtype)
    Kinv = inv3x3(K)
    ones = jnp.ones((uv.shape[0], 1), uv.dtype)
    xn = (jnp.concatenate([uv, ones], axis=1) @ Kinv.T)[:, :2]
    # normalize 3D points: center + scale (Hartley-style) for fp32
    wsum = jnp.maximum(jnp.sum(wf), 1e-6)
    mean3 = jnp.sum(xyz * wf[:, None], axis=0) / wsum
    Xc = xyz - mean3
    scale3 = jnp.sum(jnp.linalg.norm(Xc, axis=-1) * wf) / wsum
    s3 = jnp.sqrt(3.0) / jnp.maximum(scale3, 1e-9)
    Xn = Xc * s3

    x, y = xn[:, 0], xn[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    X0, X1, X2 = Xn[:, 0], Xn[:, 1], Xn[:, 2]
    # P rows p1,p2,p3 (12 unknowns): x = p1.X / p3.X, y = p2.X / p3.X
    r1 = jnp.stack([X0, X1, X2, one, zero, zero, zero, zero,
                    -x * X0, -x * X1, -x * X2, -x], axis=-1)
    r2 = jnp.stack([zero, zero, zero, zero, X0, X1, X2, one,
                    -y * X0, -y * X1, -y * X2, -y], axis=-1)
    A = jnp.concatenate([r1 * wf[:, None], r2 * wf[:, None]], axis=0)
    # null vector of A^T A by closed-form blocked inverse iteration
    # (jnp.linalg.eigh is a custom call that serialized inside the vmapped
    # RANSAC hypothesis batch — see smallinv.min_eigvec)
    p = min_eigvec(A.T @ A)
    P = p.reshape(3, 4)
    M = P[:, :3]
    # fix global sign so that most weighted points have positive depth
    z_sign = jnp.sum(jnp.sign(Xn @ M[2] + P[2, 3]) * wf)
    P = P * jnp.where(z_sign < 0, -1.0, 1.0)
    M = P[:, :3]
    # orthogonal Procrustes: nearest rotation (Horn quaternion closed
    # form); scale = mean "signed singular value" = tr(R^T M) / 3
    R = nearest_rotation(M)
    scale = jnp.sum(R * M) / 3.0
    t_n = P[:, 3] / jnp.maximum(scale, 1e-12)
    # undo 3D normalization: x_cam = R (s3 (X - mean3)) + t_n
    #                              = s3 R X + (t_n - s3 R mean3)
    # true pose: x_cam' = R X + t  with t = (t_n / s3... )
    # x_cam is only defined up to the projective scale, so recover
    # t = t_n / s3 ... careful: P was estimated on Xn, so R Xn + t_n ~ cam.
    # cam = R (s3(X-mean3)) + t_n = s3 (R X + (t_n/s3 - R mean3)).
    # Projection is scale-invariant in cam -> t = t_n/s3 - R mean3.
    t = t_n / s3 - R @ mean3
    return log_so3(R), t


def p3p(K: jnp.ndarray, xyz3: jnp.ndarray, uv3: jnp.ndarray):
    """Grunert P3P: up to 4 camera poses from exactly 3 correspondences
    (the minimal PnP solver — 3-point RANSAC samples survive far lower
    inlier ratios than the 6-point DLT).  xyz3 [3,3] world points, uv3
    [3,2] pixels.  Returns (rvecs [4,3], tvecs [4,3], valid [4]).

    Derivation follows Grunert's distance-equation system (see Haralick et
    al., "Review and analysis of solutions of the three point perspective
    pose estimation problem"): quartic in the distance ratio v = s3/s1,
    Newton-polished, then 3-point Kabsch for the rigid transform."""
    Kinv = inv3x3(K)
    ones = jnp.ones((3, 1), uv3.dtype)
    f = jnp.concatenate([uv3, ones], axis=1) @ Kinv.T
    f = f / jnp.linalg.norm(f, axis=1, keepdims=True)   # bearing vectors
    P1, P2, P3 = xyz3[0], xyz3[1], xyz3[2]
    ca = jnp.dot(f[1], f[2])      # angle opposite side a = |P2-P3|
    cb = jnp.dot(f[0], f[2])      # angle opposite side b = |P1-P3|
    cg = jnp.dot(f[0], f[1])      # angle opposite side c = |P1-P2|
    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.maximum(jnp.sum((P1 - P3) ** 2), 1e-12)
    c2 = jnp.sum((P1 - P2) ** 2)
    A = a2 / b2
    C = c2 / b2
    qr = (a2 - c2) / b2
    A4 = (qr - 1.0) ** 2 - 4.0 * C * ca * ca
    A3 = 4.0 * (qr * (1.0 - qr) * cb - (1.0 - (A + C)) * ca * cg
                + 2.0 * C * ca * ca * cb)
    A2_ = 2.0 * (qr * qr - 1.0 + 2.0 * qr * qr * cb * cb
                 + 2.0 * (1.0 - C) * ca * ca
                 - 4.0 * (A + C) * ca * cb * cg + 2.0 * (1.0 - A) * cg * cg)
    A1 = 4.0 * (-qr * (1.0 + qr) * cb + 2.0 * A * cg * cg * cb
                - (1.0 - (A + C)) * ca * cg)
    A0 = (1.0 + qr) ** 2 - 4.0 * A * cg * cg
    v, v_ok = _quartic_roots(A4, A3, A2_, A1, A0)       # [4]

    den = 2.0 * (cg - v * ca)
    den = jnp.where(jnp.abs(den) < 1e-9, jnp.sign(den) * 1e-9 + 1e-12, den)
    u = ((qr - 1.0) * v * v - 2.0 * qr * cb * v + 1.0 + qr) / den

    # Newton-polish (u, v) on the two distance-ratio equations
    def g_and_J(u, v):
        g1 = u * u + v * v - 2 * u * v * ca - A * (1 + v * v - 2 * v * cb)
        g2 = 1 + u * u - 2 * u * cg - C * (1 + v * v - 2 * v * cb)
        J11 = 2 * u - 2 * v * ca
        J12 = 2 * v - 2 * u * ca - A * (2 * v - 2 * cb)
        J21 = 2 * u - 2 * cg
        J22 = -C * (2 * v - 2 * cb)
        return g1, g2, J11, J12, J21, J22
    for _ in range(3):
        g1, g2, J11, J12, J21, J22 = g_and_J(u, v)
        det = J11 * J22 - J12 * J21
        det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
        u = u - (J22 * g1 - J12 * g2) / det
        v = v - (-J21 * g1 + J11 * g2) / det

    s1 = jnp.sqrt(b2 / jnp.maximum(1 + v * v - 2 * v * cb, 1e-12))  # [4]
    s2 = u * s1
    s3 = v * s1
    ok = v_ok & (s1 > 0) & (s2 > 0) & (s3 > 0)

    def pose_of(s123):
        C_pts = s123[:, None] * f                       # camera-frame points
        Pm = jnp.mean(xyz3, axis=0)
        Cm = jnp.mean(C_pts, axis=0)
        M = (C_pts - Cm).T @ (xyz3 - Pm)
        R = nearest_rotation(M)   # closed-form Kabsch (no svd custom call)
        t = Cm - R @ Pm
        return log_so3(R), t

    rvs, tvs = jax.vmap(pose_of)(jnp.stack([s1, s2, s3], axis=1))
    finite = jnp.all(jnp.isfinite(rvs), -1) & jnp.all(jnp.isfinite(tvs), -1)
    ok = ok & finite
    rvs = jnp.where(ok[:, None], jnp.nan_to_num(rvs), 0.0)
    tvs = jnp.where(ok[:, None], jnp.nan_to_num(tvs), 0.0)
    return rvs, tvs, ok


def _pose_residual_jac(K, rvec, tvec, xyz, uv, w):
    """Masked residuals [N,2] and analytic pose-Jacobian blocks [N,2,6]
    under the local left-multiplicative parameterization
    (R <- exp(dw) R, t <- t + dt) — the same closed forms as the BA blocks
    (sfm_tpu/ba/residuals.py)."""
    from .rotations import exp_so3 as _exp, hat as _hat
    R = _exp(rvec)
    RX = xyz @ R.T
    p = RX + tvec
    z = p[:, 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, jnp.where(z < 0, -1e-6, 1e-6), z)
    inv_z = 1.0 / z_safe
    fx, fy, skew = K[0, 0], K[1, 1], K[0, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * p[:, 0] * inv_z + skew * p[:, 1] * inv_z + cx
    v = fy * p[:, 1] * inv_z + cy
    r = (jnp.stack([u, v], -1) - uv) * w[:, None]
    zero = jnp.zeros_like(inv_z)
    duv_dp = jnp.stack([
        jnp.stack([fx * inv_z, skew * inv_z,
                   -(fx * p[:, 0] + skew * p[:, 1]) * inv_z * inv_z], -1),
        jnp.stack([zero, fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], -1),
    ], axis=1)
    # tiny batched matmul as broadcast multiply-reduce (a [N,2,3]x[N,3,3]
    # dot_general lowered to a slow conv kernel — see smallinv._mm)
    A_w = jnp.sum(duv_dp[..., :, :, None] * (-_hat(RX))[..., None, :, :],
                  axis=-2)
    A = jnp.concatenate([A_w, duv_dp], -1) * w[:, None, None]
    return r, A


def refine_pose(K: jnp.ndarray, rvec: jnp.ndarray, tvec: jnp.ndarray,
                xyz: jnp.ndarray, uv: jnp.ndarray, w: jnp.ndarray,
                iters: int = 10, damping: float = 1e-4):
    """Pose-only damped Gauss-Newton (Levenberg) on masked reprojection,
    with analytic Jacobians and a local pose parameterization.

    Fixed trip count; jit/vmap-friendly.  Returns (rvec, tvec)."""
    from .rotations import exp_so3 as _exp, log_so3 as _log

    def cost_of(rv, tv):
        pred = project(K, rv, tv, xyz)
        return jnp.sum(((pred - uv) * w[:, None]) ** 2)

    def body(_, carry):
        rv, tv, cost = carry
        r, A = _pose_residual_jac(K, rv, tv, xyz, uv, w)
        H = jnp.einsum("oia,oib->ab", A, A)
        g = jnp.einsum("oia,oi->a", A, r)
        H = H + damping * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
        step = solve6(H, g)
        rv_new = _log(_exp(-step[:3]) @ _exp(rv))
        tv_new = tv - step[3:]
        new_cost = cost_of(rv_new, tv_new)
        ok = new_cost < cost
        return (jnp.where(ok, rv_new, rv), jnp.where(ok, tv_new, tv),
                jnp.where(ok, new_cost, cost))

    rv, tv, _ = jax.lax.fori_loop(0, iters, body,
                                  (rvec, tvec, cost_of(rvec, tvec)))
    return rv, tv


def reprojection_errors(K, rvec, tvec, xyz, uv):
    """Per-point reprojection error in pixels [N]."""
    pred = project(K, rvec, tvec, xyz)
    return jnp.linalg.norm(pred - uv, axis=-1)

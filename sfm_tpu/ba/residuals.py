"""Reprojection residuals and analytic Jacobian blocks for bundle adjustment.

Replaces the Ceres auto-diff cost functors (BAStructAndPoseFunctor /
BAPoseFunctor / BAStructFunctor, CTracker.h:101-151, CTracker.cpp:579-668):
2 residuals per observation, intrinsics applied with the skew term, no
distortion (points are pre-undistorted — CTracker.cpp:597).

Pose increments use the LOCAL left-multiplicative parameterization
(R <- exp(dw) R, t <- t + dt), which gives closed-form 2x3 Jacobian blocks:
    d(cam)/d(dw) = -[R X + t - t]_x = -[p_cam - t... ] == -hat(R X)
    d(cam)/d(dt) = I
    d(cam)/d(X)  = R
and the pixel chain rule d(uv)/d(cam) is the standard pinhole 2x3.
This is equivalent at the optimum to Ceres's global angle-axis blocks but
keeps every Jacobian a tiny closed form that fuses elementwise.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.rotations import exp_so3, hat, log_so3


def bmm_small(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched tiny matmul [..., m, k] @ [..., k, n] as a broadcast
    multiply-reduce.  XLA lowered batched dot_generals with m, n <= 6 to
    convolution-style kernels far off the bandwidth roofline on the backend
    this was first tuned for; the elementwise form fuses into one pass.
    Whether the GPU needs it is open (ROADMAP Design 5)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def bmv_small(a: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched tiny matrix-vector [..., m, k] @ [..., k] as a broadcast
    multiply-reduce (same rationale as bmm_small)."""
    return jnp.sum(a * v[..., None, :], axis=-1)


class Observations(NamedTuple):
    """COO observation list (the AddResidualBlock loop's data,
    CTracker.cpp:676-696, as flat tensors)."""
    cam_idx: jnp.ndarray   # [O] int32
    lm_idx: jnp.ndarray    # [O] int32
    uv: jnp.ndarray        # [O, 2] f32 measured (undistorted) pixels
    w: jnp.ndarray         # [O] f32 weights (0 = padding/invalid)


def residuals_and_jacobians_gathered(K: jnp.ndarray, Rc: jnp.ndarray,
                                     tc: jnp.ndarray, X: jnp.ndarray,
                                     uv: jnp.ndarray):
    """Residual r [...,2] and blocks A [...,2,6], B [...,2,3] from
    ALREADY-gathered (or broadcast) per-observation pose/point tensors:
    Rc [...,3,3], tc [...,3], X [...,3], uv [...,2].  Pure elementwise —
    callers that hold observations in table layouts pass one side as a
    broadcast view and skip its gather entirely (the per-observation
    gathers were the dominant cost of large-BA linearization,
    benchmarks/bench_ba_trace.py)."""
    RX = jnp.sum(Rc * X[..., None, :], axis=-1)       # ...ij,...j->...i
    p = RX + tc                           # camera-frame point
    z = p[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, jnp.where(z < 0, -1e-6, 1e-6), z)
    inv_z = 1.0 / z_safe
    fx, fy, skew = K[0, 0], K[1, 1], K[0, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = fx * p[..., 0] * inv_z + skew * p[..., 1] * inv_z + cx
    v = fy * p[..., 1] * inv_z + cy
    r = jnp.stack([u, v], axis=-1) - uv

    # d(uv)/d(p_cam): [...,2,3]
    zero = jnp.zeros_like(inv_z)
    duv_dp = jnp.stack([
        jnp.stack([fx * inv_z, skew * inv_z,
                   -(fx * p[..., 0] + skew * p[..., 1]) * inv_z * inv_z],
                  -1),
        jnp.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z], -1),
    ], axis=-2)

    # d(p_cam)/d(dw) = -hat(R X); d(p_cam)/d(dt) = I; d(p_cam)/dX = R
    dp_dw = -hat(RX)                      # [...,3,3]
    A_w = bmm_small(duv_dp, dp_dw)
    A_t = duv_dp
    A = jnp.concatenate([A_w, A_t], axis=-1)          # [...,2,6]
    B = bmm_small(duv_dp, Rc)             # broadcasts if Rc has a 1-dim
    return r, A, B


def residuals_and_jacobians(K: jnp.ndarray, R: jnp.ndarray,
                            tvec: jnp.ndarray, xyz: jnp.ndarray,
                            obs: Observations):
    """Per-observation residual r [O,2] and blocks A=dr/d(dw,dt) [O,2,6],
    B=dr/dX [O,2,3].

    R: [C,3,3] rotation matrices, tvec: [C,3], xyz: [L,3]."""
    Rc = R[obs.cam_idx]                   # [O,3,3]
    tc = tvec[obs.cam_idx]                # [O,3]
    X = xyz[obs.lm_idx]                   # [O,3]
    return residuals_and_jacobians_gathered(K, Rc, tc, X, obs.uv)


def huber_weights(r: jnp.ndarray, delta: float) -> jnp.ndarray:
    """Per-observation IRLS weight for the Huber loss; delta<=0 -> all ones
    (the reference uses a NULL loss, CTracker.cpp:682)."""
    if delta <= 0:
        return jnp.ones(r.shape[0], r.dtype)
    nrm = jnp.linalg.norm(r, axis=-1)
    return jnp.where(nrm <= delta, 1.0, delta / jnp.maximum(nrm, 1e-12))


def apply_pose_update(rvec, tvec, dw, dt):
    """Left-multiplicative pose update: R <- exp(dw) R, t <- t + dt.
    (bmm_small, not @ — see bmm_small's note.)"""
    R_new = bmm_small(exp_so3(dw), exp_so3(rvec))
    return log_so3(R_new), tvec + dt


def total_cost(K, rvec, tvec, xyz, obs: Observations,
               huber_delta: float = 0.0):
    """Sum of (robustified) squared reprojection residuals."""
    R = exp_so3(rvec)
    r, _, _ = residuals_and_jacobians(K, R, tvec, xyz, obs)
    sq = jnp.sum(r * r, axis=-1)
    if huber_delta > 0:
        d = huber_delta
        nrm = jnp.sqrt(sq + 1e-12)
        rho = jnp.where(nrm <= d, sq, 2 * d * nrm - d * d)
        return jnp.sum(rho * obs.w)
    return jnp.sum(sq * obs.w)

"""Independent float64 NumPy reference bundle-adjustment solver.

This is the accuracy anchor for every JAX solver in this package
(BASELINE.json's "ATE vs Ceres baseline" criterion): a self-contained
dense-Schur Levenberg-Marquardt implementation of the same problem Ceres
solves for the reference (auto-diff reprojection functors +
ceres::Solve(DENSE_SCHUR), /root/reference/CTracker.cpp:571-577, 670-702),
written in double precision with no shared code with the JAX solvers —
rotations, Jacobians, assembly and the linear solve are all re-derived
here in NumPy.  Parity tests (tests/test_ba_reference.py) require
run_ba / run_ba_cg / run_large_ba to land within 1% of this solver's
final cost from the same start point.

Deliberately NOT fast (dense [C, L] coupling, f64): it exists to be
trusted, not to be used in the engine loop.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- rotations

def _exp_so3(w):
    """Rodrigues' formula, f64.  w [3] -> R [3,3]."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        W = _hat(w)
        return np.eye(3) + W + 0.5 * W @ W
    k = w / th
    K = _hat(k)
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def _log_so3(R):
    """Inverse Rodrigues, f64.  R [3,3] -> w [3]."""
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-9:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) * 0.5
    if abs(np.pi - th) < 1e-6:
        # near pi: axis from the largest diagonal of (R + I) / 2
        A = (R + np.eye(3)) / 2.0
        i = int(np.argmax(np.diag(A)))
        axis = A[:, i] / np.sqrt(max(A[i, i], 1e-18))
        axis = axis / np.linalg.norm(axis)
        return th * axis
    return th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _hat(w):
    return np.array([[0.0, -w[2], w[1]],
                     [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]])


# ------------------------------------------------------------ linearization

def _linearize(K, Rs, ts, X, cam_idx, lm_idx, uv, w, huber_delta):
    """Residuals r [O,2], pose blocks A [O,2,6] (local left-multiplicative
    increment, like the JAX solvers: R <- exp(dw) R, t <- t + dt), point
    blocks B [O,2,3], effective IRLS weights, and the robustified cost."""
    Rc = Rs[cam_idx]                       # [O,3,3]
    tc = ts[cam_idx]
    Xo = X[lm_idx]
    RX = np.einsum("oij,oj->oi", Rc, Xo)
    p = RX + tc
    z = p[:, 2].copy()
    z[np.abs(z) < 1e-9] = 1e-9
    inv_z = 1.0 / z
    fx, fy, skew = K[0, 0], K[1, 1], K[0, 1]
    u = fx * p[:, 0] * inv_z + skew * p[:, 1] * inv_z + K[0, 2]
    v = fy * p[:, 1] * inv_z + K[1, 2]
    r = np.stack([u, v], axis=-1) - uv

    O = len(cam_idx)
    duv_dp = np.zeros((O, 2, 3))
    duv_dp[:, 0, 0] = fx * inv_z
    duv_dp[:, 0, 1] = skew * inv_z
    duv_dp[:, 0, 2] = -(fx * p[:, 0] + skew * p[:, 1]) * inv_z ** 2
    duv_dp[:, 1, 1] = fy * inv_z
    duv_dp[:, 1, 2] = -fy * p[:, 1] * inv_z ** 2

    # d(p)/d(dw) = -hat(R X), d(p)/d(dt) = I, d(p)/dX = R
    hatRX = np.zeros((O, 3, 3))
    hatRX[:, 0, 1] = -RX[:, 2]
    hatRX[:, 0, 2] = RX[:, 1]
    hatRX[:, 1, 0] = RX[:, 2]
    hatRX[:, 1, 2] = -RX[:, 0]
    hatRX[:, 2, 0] = -RX[:, 1]
    hatRX[:, 2, 1] = RX[:, 0]
    A = np.concatenate([np.einsum("oij,ojk->oik", duv_dp, -hatRX), duv_dp],
                       axis=-1)                       # [O,2,6]
    B = np.einsum("oij,ojk->oik", duv_dp, Rc)         # [O,2,3]

    sq = np.sum(r * r, axis=-1)
    if huber_delta > 0:
        nrm = np.sqrt(sq)
        w_irls = np.where(nrm <= huber_delta, 1.0,
                          huber_delta / np.maximum(nrm, 1e-12))
        rho = np.where(nrm <= huber_delta, sq,
                       2 * huber_delta * nrm - huber_delta ** 2)
        cost = float(np.sum(rho * w))
    else:
        w_irls = np.ones(O)
        cost = float(np.sum(sq * w))
    return r, A, B, w * w_irls, cost


def _cost_only(K, rvec, tvec, X, cam_idx, lm_idx, uv, w, huber_delta):
    Rs = np.stack([_exp_so3(rv) for rv in rvec])
    return _linearize(K, Rs, tvec, X, cam_idx, lm_idx, uv, w, huber_delta)[4]


# ------------------------------------------------------------------ solver

def reference_ba(K, rvec, tvec, xyz, cam_idx, lm_idx, uv, w, *,
                 cam_free, lm_free, iterations=30, lam0=1e-3,
                 lam_up=4.0, lam_down=2.0, huber_delta=0.0, tol=1e-6):
    """Dense-Schur LM in f64.  Inputs are NumPy-convertible; observations
    with w == 0 are padding.  Returns (rvec, tvec, xyz, costs) where costs
    is the list of accepted costs (costs[0] = initial)."""
    K = np.asarray(K, np.float64)
    rvec = np.array(rvec, np.float64)
    tvec = np.array(tvec, np.float64)
    xyz = np.array(xyz, np.float64)
    cam_idx = np.asarray(cam_idx, np.int64)
    lm_idx = np.asarray(lm_idx, np.int64)
    uv = np.asarray(uv, np.float64)
    w = np.asarray(w, np.float64)
    cam_free = np.asarray(cam_free, bool)
    lm_free = np.asarray(lm_free, bool)
    live = w > 0
    cam_idx, lm_idx, uv, w = (cam_idx[live], lm_idx[live], uv[live], w[live])

    C, L = len(rvec), len(xyz)
    lam = float(lam0)
    costs = [_cost_only(K, rvec, tvec, xyz, cam_idx, lm_idx, uv, w,
                        huber_delta)]
    for _ in range(iterations):
        Rs = np.stack([_exp_so3(rv) for rv in rvec])
        r, A, B, we, cost = _linearize(K, Rs, tvec, xyz, cam_idx, lm_idx,
                                       uv, w, huber_delta)
        A = A * (we * cam_free[cam_idx])[:, None, None]
        B = B * (we * lm_free[lm_idx])[:, None, None]
        rw = r * we[:, None]

        U = np.zeros((C, 6, 6))
        V = np.zeros((L, 3, 3))
        W = np.zeros((C, L, 6, 3))
        g_cam = np.zeros((C, 6))
        g_lm = np.zeros((L, 3))
        np.add.at(U, cam_idx, np.einsum("oia,oib->oab", A, A))
        np.add.at(V, lm_idx, np.einsum("oia,oib->oab", B, B))
        np.add.at(W, (cam_idx, lm_idx), np.einsum("oia,oib->oab", A, B))
        np.add.at(g_cam, cam_idx, -np.einsum("oia,oi->oa", A, rw))
        np.add.at(g_lm, lm_idx, -np.einsum("oia,oi->oa", B, rw))

        def damp(M, lam):
            d = M.shape[-1]
            eye = np.eye(d)
            return M + lam * M * eye + 1e-6 * eye

        Vinv = np.linalg.inv(damp(V, lam))
        Y = np.einsum("clab,lbd->clad", W, Vinv)
        S = np.zeros((C, C, 6, 6))
        S[np.arange(C), np.arange(C)] = damp(U, lam)
        S -= np.einsum("clad,mled->cmae", Y, W)
        rhs = g_cam - np.einsum("clad,ld->ca", Y, g_lm)
        d_cam = np.linalg.solve(
            S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C),
            rhs.reshape(-1)).reshape(C, 6)
        d_cam = d_cam * cam_free[:, None]
        Wt_dc = np.einsum("clad,ca->ld", W, d_cam)
        d_lm = np.einsum("lab,lb->la", Vinv, g_lm - Wt_dc) * lm_free[:, None]

        rv_new = np.stack([_log_so3(_exp_so3(d_cam[c, :3]) @ Rs[c])
                           for c in range(C)])
        tv_new = tvec + d_cam[:, 3:]
        xyz_new = xyz + d_lm
        new_cost = _cost_only(K, rv_new, tv_new, xyz_new, cam_idx, lm_idx,
                              uv, w, huber_delta)
        if np.isfinite(new_cost) and new_cost < cost:
            rvec, tvec, xyz = rv_new, tv_new, xyz_new
            lam = max(lam / lam_down, 1e-9)
            improved = cost - new_cost
            costs.append(new_cost)
            if improved < tol * max(cost, 1.0):
                break
        else:
            lam = min(lam * lam_up, 1e9)
    return rvec, tvec, xyz, costs


def reference_ba_obs(K, rvec, tvec, xyz, obs, **kw):
    """Convenience wrapper taking a ba.residuals.Observations pytree."""
    return reference_ba(K, rvec, tvec, xyz, np.asarray(obs.cam_idx),
                        np.asarray(obs.lm_idx), np.asarray(obs.uv),
                        np.asarray(obs.w), **kw)

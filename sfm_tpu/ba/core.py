"""Levenberg-Marquardt bundle adjustment with Schur-complement elimination.

Replaces ceres::Solve(DENSE_SCHUR) (CTracker.cpp:670-702): build normal
equations in block form from the COO observation list, eliminate the
landmark blocks (3x3 closed-form inverses), solve the reduced camera system
densely (6C x 6C — C is the keyframe count, small), back-substitute, and
iterate with Levenberg damping and accept/reject steps.

Modes mirror CTracker::BA_TYPE (CTracker.h:67): STRUCT_AND_POSE,
POSE_ONLY (landmarks frozen), STRUCT_ONLY (poses frozen).

Assembly is scatter-add over observations; the cam-landmark coupling W is
materialized as [C, L, 6, 3] which is exact and fast for the single-scan
operating point (C<=64, L<=16k -> 75 MB HBM).  The distributed/Pallas path
for pod-scale problems lives in sfm_tpu/parallel/dist_ba.py, which shards
the landmark axis and psums the reduced camera system.
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry.rotations import exp_so3
from ..geometry.smallinv import inv6x6
from .residuals import (Observations, residuals_and_jacobians, huber_weights,
                        apply_pose_update, bmv_small)


class BAMode(enum.IntEnum):
    STRUCT_AND_POSE = 0
    POSE_ONLY = 1
    STRUCT_ONLY = 2


class BAStats(NamedTuple):
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray
    lam: jnp.ndarray
    accepted: jnp.ndarray   # number of accepted LM steps
    # observations dropped by table capacity clamps feeding this solve
    # (attached by callers that build tables; 0 when nothing was dropped)
    dropped_obs: jnp.ndarray = jnp.asarray(0, jnp.int32)


def _assemble(K, rvec, tvec, xyz, obs: Observations, cam_free, lm_free,
              huber_delta: float, mode: "BAMode" = None,
              cam_major: bool = False):
    """Normal-equation blocks U [C,6,6], V [L,3,3], W [C,L,6,3],
    g_cam [C,6], g_lm [L,3] AND the (robustified) cost at the current
    linearization point — one residual evaluation serves both.  The
    (large) W coupling is only materialized when the mode needs it.

    With ``cam_major=True`` (valid when obs.cam_idx is the canonical
    ``repeat(arange(C), O // C)`` layout that observations_from_keyframes
    emits) every index-space reduction is scatter-free: camera-side sums
    are plain reshape-reductions and landmark-side sums ride one one-hot
    matmul (scatter-adds over 16k observations serialized on the backend
    this was first tuned for)."""
    C = rvec.shape[0]
    L = xyz.shape[0]
    R = exp_so3(rvec)
    r, A, B = residuals_and_jacobians(K, R, tvec, xyz, obs)
    w = obs.w * huber_weights(r, huber_delta)
    # freeze cameras/landmarks by zeroing their Jacobian blocks
    A = A * (w * cam_free[obs.cam_idx])[:, None, None]
    B = B * (w * lm_free[obs.lm_idx])[:, None, None]
    rw = r * w[:, None]

    # per-observation block products as broadcast multiply-reduces (tiny
    # batched dot_generals lowered to slow convolution kernels on the
    # first backend — see residuals.bmm_small)
    AtA = jnp.sum(A[:, :, :, None] * A[:, :, None, :], axis=1)  # [O,6,6]
    BtB = jnp.sum(B[:, :, :, None] * B[:, :, None, :], axis=1)  # [O,3,3]
    AtB = jnp.sum(A[:, :, :, None] * B[:, :, None, :], axis=1)  # [O,6,3]
    Atr = jnp.sum(A * rw[:, :, None], axis=1)                   # [O,6]
    Btr = jnp.sum(B * rw[:, :, None], axis=1)                   # [O,3]

    want_W = mode == BAMode.STRUCT_AND_POSE or mode is None
    if cam_major:
        N = obs.cam_idx.shape[0] // C
        U = AtA.reshape(C, N, 6, 6).sum(1)
        g_cam = -Atr.reshape(C, N, 6).sum(1)
        # one shared landmark one-hot feeds V, g_lm and (batched) W
        E = (obs.lm_idx[:, None] ==
             jnp.arange(L, dtype=jnp.int32)).astype(jnp.float32)  # [O,L]
        dot = functools.partial(jax.lax.dot_general,
                                preferred_element_type=jnp.float32)
        VG = dot(E, jnp.concatenate(
            [BtB.reshape(-1, 9), Btr], axis=1),
            (((0,), (0,)), ((), ())))                            # [L,12]
        V = VG[:, :9].reshape(L, 3, 3)
        g_lm = -VG[:, 9:]
        if want_W:
            W = dot(E.reshape(C, N, L), AtB.reshape(C, N, 18),
                    (((1,), (1,)), ((0,), (0,)))).reshape(C, L, 6, 3)
        else:
            W = jnp.zeros((1, 1, 6, 3))
    else:
        U = jnp.zeros((C, 6, 6)).at[obs.cam_idx].add(AtA)
        V = jnp.zeros((L, 3, 3)).at[obs.lm_idx].add(BtB)
        if want_W:
            W = jnp.zeros((C, L, 6, 3)).at[obs.cam_idx, obs.lm_idx].add(AtB)
        else:
            W = jnp.zeros((1, 1, 6, 3))  # unused placeholder
        g_cam = jnp.zeros((C, 6)).at[obs.cam_idx].add(-Atr)
        g_lm = jnp.zeros((L, 3)).at[obs.lm_idx].add(-Btr)

    sq = jnp.sum(r * r, axis=-1)
    if huber_delta > 0:
        d = huber_delta
        nrm = jnp.sqrt(sq + 1e-12)
        rho = jnp.where(nrm <= d, sq, 2 * d * nrm - d * d)
        cost = jnp.sum(rho * obs.w)
    else:
        cost = jnp.sum(sq * obs.w)
    return (U, V, W, g_cam, g_lm), cost


def _damp(M, lam):
    """Levenberg damping: multiply block diagonals by (1 + lam) and add an
    absolute floor so empty blocks stay invertible."""
    d = M.shape[-1]
    eye = jnp.eye(d, dtype=M.dtype)
    diag = M * eye
    return M + lam * diag + 1e-6 * eye


def inv3_sym(M):
    """Closed-form inverse of symmetric 3x3 blocks [..., 3, 3] (no batched
    LU custom call for the landmark blocks)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    e, f = M[..., 1, 1], M[..., 1, 2]
    i = M[..., 2, 2]
    A_ = e * i - f * f
    B_ = c * f - b * i
    C_ = b * f - c * e
    E_ = a * i - c * c
    F_ = b * c - a * f
    I_ = a * e - b * b
    det = a * A_ + b * B_ + c * C_
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    inv = jnp.stack([
        jnp.stack([A_, B_, C_], -1),
        jnp.stack([B_, E_, F_], -1),
        jnp.stack([C_, F_, I_], -1),
    ], -2)
    return inv / det[..., None, None]


def _solve_step(U, V, W, g_cam, g_lm, lam, mode: BAMode):
    """One damped Gauss-Newton step via Schur elimination of the landmarks.
    Returns (d_cam [C,6], d_lm [L,3])."""
    C = U.shape[0]
    L = V.shape[0]
    Ud = _damp(U, lam)
    Vd = _damp(V, lam)

    if mode == BAMode.STRUCT_ONLY:
        d_lm = bmv_small(inv3_sym(Vd), g_lm)
        return jnp.zeros((C, 6), U.dtype), d_lm

    if mode == BAMode.POSE_ONLY:
        S = _dense_cam_system(Ud)
        d = jnp.linalg.solve(S, g_cam.reshape(-1))
        return d.reshape(C, 6), jnp.zeros((L, 3), V.dtype)

    Vinv = inv3_sym(Vd)                               # [L,3,3]
    Y = jnp.einsum("clab,lbd->clad", W, Vinv)         # [C,L,6,3]
    S_blocks = jnp.einsum("clad,mled->cmae", Y, W)    # [C,C,6,6]
    S = _dense_cam_system(Ud) - S_blocks.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
    rhs = g_cam - jnp.einsum("clad,ld->ca", Y, g_lm)
    d_cam = jnp.linalg.solve(S, rhs.reshape(-1)).reshape(C, 6)
    # back-substitution: V d_lm = g_lm - W^T d_cam
    Wt_dc = jnp.einsum("clad,ca->ld", W, d_cam)
    d_lm = bmv_small(Vinv, g_lm - Wt_dc)
    return d_cam, d_lm


def _dense_cam_system(U):
    """Block-diagonal U as a dense [6C, 6C] matrix."""
    C = U.shape[0]
    S = jnp.zeros((C, C, 6, 6), U.dtype)
    S = S.at[jnp.arange(C), jnp.arange(C)].set(U)
    return S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)


def run_ba(K, rvec, tvec, xyz, obs: Observations, *,
           cam_free, lm_free, mode: BAMode = BAMode.STRUCT_AND_POSE,
           iterations: int = 20, lam0: float = 1e-3, lam_up: float = 4.0,
           lam_down: float = 2.0, huber_delta: float = 0.0,
           tol: float = 1e-4, cam_major: bool = False
           ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, BAStats]:
    """CTracker::bundleAdjustmentStructAndPose equivalent.

    cam_free [C] / lm_free [L] bool masks freeze parameters (gauge fixing,
    padding slots).  Fixed trip count; one residual/assembly evaluation per
    iteration: a trial step is assembled at the proposed point, which yields
    both its cost (accept/reject) and — when accepted — the next
    linearization; a rejected step reuses the carried linearization with a
    larger lambda (classic LM, no wasted assembly).  ``cam_major=True``
    selects scatter-free assembly; only valid when obs.cam_idx is the
    canonical repeat(arange(C), O//C) layout (observations_from_keyframes
    emits exactly that)."""
    cam_free_f = cam_free.astype(jnp.float32)
    lm_free_f = lm_free.astype(jnp.float32)
    blocks, cost0 = _assemble(K, rvec, tvec, xyz, obs, cam_free_f,
                              lm_free_f, huber_delta, mode, cam_major)

    def real_body(carry):
        rvec, tvec, xyz, blocks, lam, cost, accepted, done = carry
        U, V, W, g_cam, g_lm = blocks
        d_cam, d_lm = _solve_step(U, V, W, g_cam, g_lm, lam, mode)
        d_cam = d_cam * cam_free_f[:, None]
        d_lm = d_lm * lm_free_f[:, None]
        rv_new, tv_new = jax.vmap(apply_pose_update)(
            rvec, tvec, d_cam[:, :3], d_cam[:, 3:])
        xyz_new = xyz + d_lm
        blocks_new, new_cost = _assemble(K, rv_new, tv_new, xyz_new, obs,
                                         cam_free_f, lm_free_f, huber_delta,
                                         mode, cam_major)
        ok = (new_cost < cost) & jnp.isfinite(new_cost)
        rvec = jnp.where(ok, rv_new, rvec)
        tvec = jnp.where(ok, tv_new, tvec)
        xyz = jnp.where(ok, xyz_new, xyz)
        blocks = jax.tree.map(lambda n, o: jnp.where(ok, n, o),
                              blocks_new, blocks)
        lam = jnp.where(ok, jnp.maximum(lam / lam_down, 1e-9),
                        jnp.minimum(lam * lam_up, 1e6))
        # converged: accepted step improved cost by less than tol (relative)
        done = done | (ok & (cost - new_cost < tol * jnp.maximum(cost, 1.0)))
        cost = jnp.where(ok, new_cost, cost)
        return (rvec, tvec, xyz, blocks, lam, cost,
                accepted + ok.astype(jnp.int32), done)

    def body(_, carry):
        # converged iterations skip the assembly/solve entirely (the branch
        # predicate is scalar, so XLA executes only the taken side)
        return jax.lax.cond(carry[-1], lambda c: c, real_body, carry)

    rvec, tvec, xyz, blocks, lam, cost, accepted, done = jax.lax.fori_loop(
        0, iterations, body,
        (rvec, tvec, xyz, blocks, jnp.asarray(lam0, jnp.float32), cost0,
         jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return rvec, tvec, xyz, BAStats(cost0, cost, lam, accepted)


def _onehot_matmul_T(idx, n, vals):
    """Scatter-free segment-sum: out[i] = sum_{o: idx[o]==i} vals[o].
    idx [O] int32, vals [O, d] -> [n, d].  The one-hot operand is a fused
    iota-compare feeding a matmul (same trick as ba/large.py's coupling
    ops)."""
    E = (idx[:, None] == jnp.arange(n, dtype=jnp.int32)).astype(jnp.float32)
    return jax.lax.dot_general(
        E, vals, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def _onehot_gather(idx, n, table):
    """Gather rows: out[o] = table[idx[o]].  table [n, d] -> [O, d]."""
    E = (idx[:, None] == jnp.arange(n, dtype=jnp.int32)).astype(jnp.float32)
    return jax.lax.dot_general(
        E, table, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def _assemble_cg(K, rvec, tvec, xyz, obs: Observations, cam_free, lm_free,
                 huber_delta: float):
    """Normal-equation blocks WITHOUT materializing the [C, L] coupling:
    U [C,6,6], V [L,3,3], per-observation W_o [O,6,3], g_cam, g_lm, cost.
    All index-space reductions are one-hot matmuls (scatter-free)."""
    C = rvec.shape[0]
    L = xyz.shape[0]
    R = exp_so3(rvec)
    r, A, B = residuals_and_jacobians(K, R, tvec, xyz, obs)
    w = obs.w * huber_weights(r, huber_delta)
    A = A * (w * cam_free[obs.cam_idx])[:, None, None]
    B = B * (w * lm_free[obs.lm_idx])[:, None, None]
    rw = r * w[:, None]

    AtA = jnp.sum(A[:, :, :, None] * A[:, :, None, :], axis=1) \
        .reshape(-1, 36)
    BtB = jnp.sum(B[:, :, :, None] * B[:, :, None, :], axis=1) \
        .reshape(-1, 9)
    W_o = jnp.sum(A[:, :, :, None] * B[:, :, None, :], axis=1)  # [O,6,3]
    Atr = jnp.sum(A * rw[:, :, None], axis=1)
    Btr = jnp.sum(B * rw[:, :, None], axis=1)

    U = _onehot_matmul_T(obs.cam_idx, C, AtA).reshape(C, 6, 6)
    g_cam = -_onehot_matmul_T(obs.cam_idx, C, Atr)
    V = _onehot_matmul_T(obs.lm_idx, L, BtB).reshape(L, 3, 3)
    g_lm = -_onehot_matmul_T(obs.lm_idx, L, Btr)

    sq = jnp.sum(r * r, axis=-1)
    if huber_delta > 0:
        d = huber_delta
        nrm = jnp.sqrt(sq + 1e-12)
        rho = jnp.where(nrm <= d, sq, 2 * d * nrm - d * d)
        cost = jnp.sum(rho * obs.w)
    else:
        cost = jnp.sum(sq * obs.w)
    return (U, V, W_o, g_cam, g_lm), cost


def run_ba_cg(K, rvec, tvec, xyz, obs: Observations, *,
              cam_free, lm_free, iterations: int = 20,
              cg_iterations: int = 15, lam0: float = 1e-3,
              lam_up: float = 4.0, lam_down: float = 2.0,
              huber_delta: float = 0.0, tol: float = 1e-4
              ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, BAStats]:
    """STRUCT_AND_POSE LM with the reduced camera system solved by
    block-Jacobi PCG through per-observation tables — no [C, L] coupling
    tensor, no scatters.  Same contract as run_ba(mode=STRUCT_AND_POSE).

    At flagship mapping shapes (C=32, L=8k, O=16k) prefer run_ba's exact
    dense solve; this path is for when the dense [6C, 6C] Schur complement
    or the [C, L] coupling no longer fits: C >~ 128 with large maps (and see
    ba/large.py + parallel/dist_large_ba.py for the 1k-camera/pod-scale
    dual-table formulation)."""
    C = rvec.shape[0]
    L = xyz.shape[0]
    cam_free_f = cam_free.astype(jnp.float32)
    lm_free_f = lm_free.astype(jnp.float32)
    cam_idx, lm_idx = obs.cam_idx, obs.lm_idx

    blocks, cost0 = _assemble_cg(K, rvec, tvec, xyz, obs, cam_free_f,
                                 lm_free_f, huber_delta)

    def real_body(carry):
        rvec, tvec, xyz, blocks, lam, cost, accepted, done = carry
        U, V, W_o, g_cam, g_lm = blocks
        Ud = _damp(U, lam)
        Vinv = inv3_sym(_damp(V, lam))

        def wT_x(x):
            # t[l] = sum_{o: lm=l} W_o^T x[cam_o]
            x_at = _onehot_gather(cam_idx, C, x)           # [O,6]
            q = jnp.einsum("oab,oa->ob", W_o, x_at)        # [O,3]
            return _onehot_matmul_T(lm_idx, L, q)          # [L,3]

        def w_z(z):
            # y[c] = sum_{o: cam=c} W_o z[lm_o]
            z_at = _onehot_gather(lm_idx, L, z)            # [O,3]
            p = jnp.einsum("oab,ob->oa", W_o, z_at)        # [O,6]
            return _onehot_matmul_T(cam_idx, C, p)         # [C,6]

        def matvec(x):
            Ux = jnp.einsum("cab,cb->ca", Ud, x)
            z = bmv_small(Vinv, wT_x(x))
            return Ux - w_z(z)

        zg = bmv_small(Vinv, g_lm)
        rhs = g_cam - w_z(zg)
        M_inv = inv6x6(Ud + 1e-6 * jnp.eye(6))

        def precond(v):
            return jnp.einsum("cab,cb->ca", M_inv, v)

        x0 = jnp.zeros_like(rhs)
        r0 = rhs - matvec(x0)
        z0 = precond(r0)

        def cg_body(_, cg):
            x, r, z, p = cg
            Ap = matvec(p)
            rz = jnp.sum(r * z)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-12)
            x = x + alpha * p
            r_new = r - alpha * Ap
            z_new = precond(r_new)
            beta = jnp.sum(r_new * z_new) / jnp.maximum(rz, 1e-12)
            return x, r_new, z_new, z_new + beta * p

        d_cam, _, _, _ = jax.lax.fori_loop(
            0, cg_iterations, cg_body, (x0, r0, z0, z0))
        d_cam = d_cam * cam_free_f[:, None]
        d_lm = bmv_small(Vinv, g_lm - wT_x(d_cam)) * \
            lm_free_f[:, None]

        rv_new, tv_new = jax.vmap(apply_pose_update)(
            rvec, tvec, d_cam[:, :3], d_cam[:, 3:])
        xyz_new = xyz + d_lm
        blocks_new, new_cost = _assemble_cg(
            K, rv_new, tv_new, xyz_new, obs, cam_free_f, lm_free_f,
            huber_delta)
        ok = (new_cost < cost) & jnp.isfinite(new_cost)
        rvec = jnp.where(ok, rv_new, rvec)
        tvec = jnp.where(ok, tv_new, tvec)
        xyz = jnp.where(ok, xyz_new, xyz)
        blocks = jax.tree.map(lambda n, o: jnp.where(ok, n, o),
                              blocks_new, blocks)
        lam = jnp.where(ok, jnp.maximum(lam / lam_down, 1e-9),
                        jnp.minimum(lam * lam_up, 1e6))
        done = done | (ok & (cost - new_cost < tol * jnp.maximum(cost, 1.0)))
        cost = jnp.where(ok, new_cost, cost)
        return (rvec, tvec, xyz, blocks, lam, cost,
                accepted + ok.astype(jnp.int32), done)

    def body(_, carry):
        return jax.lax.cond(carry[-1], lambda c: c, real_body, carry)

    rvec, tvec, xyz, blocks, lam, cost, accepted, done = jax.lax.fori_loop(
        0, iterations, body,
        (rvec, tvec, xyz, blocks, jnp.asarray(lam0, jnp.float32), cost0,
         jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return rvec, tvec, xyz, BAStats(cost0, cost, lam, accepted)


def observations_from_keyframes(kfs, lm_valid) -> Observations:
    """Flatten the keyframe link matrix into the COO observation list
    (the CSfM::bundleAdjustment gather, CSfM.cpp:326-340)."""
    Kn, N = kfs.frames.landmark.shape
    cam_idx = jnp.repeat(jnp.arange(Kn, dtype=jnp.int32), N)
    lm_idx = kfs.frames.landmark.reshape(-1)
    uv = kfs.frames.xy.reshape(-1, 2)
    linked = (lm_idx >= 0) & kfs.frames.kp_valid.reshape(-1)
    linked = linked & kfs.valid[:, None].repeat(N, 1).reshape(-1)
    safe = jnp.where(lm_idx >= 0, lm_idx, 0)
    linked = linked & lm_valid[safe]
    return Observations(
        cam_idx=cam_idx,
        lm_idx=jnp.where(linked, lm_idx, 0),
        uv=uv,
        w=linked.astype(jnp.float32),
    )


def observations_from_keyframe_window(kfs, lm_valid, slots, slot_ok
                                      ) -> Observations:
    """COO observations restricted to a keyframe-slot window [W].

    The mapping-pass local BA frees only the recent poses; observations
    from older keyframes merely anchor structure that the window also
    sees — including them scales the (serialized-scatter) table build and
    every landmark-side tensor with the FULL keyframe capacity.  Camera
    indices remain original slot ids, so pose writeback is unchanged;
    landmarks unobserved in the window get zero-weight rows and stay
    fixed (ORB-SLAM's local-BA structure)."""
    fr = kfs.frames
    N = fr.landmark.shape[1]
    lm_idx = fr.landmark[slots].reshape(-1)
    uv = fr.xy[slots].reshape(-1, 2)
    ok_row = kfs.valid[slots] & slot_ok                       # [W]
    linked = (lm_idx >= 0) & fr.kp_valid[slots].reshape(-1)
    linked = linked & jnp.repeat(ok_row, N)
    safe = jnp.where(lm_idx >= 0, lm_idx, 0)
    linked = linked & lm_valid[safe]
    return Observations(
        cam_idx=jnp.repeat(slots.astype(jnp.int32), N),
        lm_idx=jnp.where(linked, lm_idx, 0),
        uv=uv,
        w=linked.astype(jnp.float32),
    )


def compact_landmarks(lm_valid, capacity: int):
    """Rank live landmark slots into a dense [capacity] range.

    The BA normal equations scale with the landmark AXIS LENGTH (the dense
    solver materializes a [C, L, 6, 3] coupling), but only live landmarks
    contribute; running BA over a compacted axis cuts every landmark-side
    tensor by L/capacity.  Returns ``rank`` [L] mapping slot -> compact id
    (== capacity for dead or overflow slots) and ``inv`` [capacity] mapping
    compact id -> slot (-1 for unused).  Live slots beyond ``capacity``
    overflow gracefully: they are simply left out (their observations get
    zero weight, their positions stay fixed)."""
    L = lm_valid.shape[0]
    rank = jnp.cumsum(lm_valid.astype(jnp.int32)) - 1          # [L]
    ok = lm_valid & (rank < capacity)
    rank = jnp.where(ok, rank, capacity)
    inv = jnp.full((capacity,), -1, jnp.int32).at[rank].set(
        jnp.arange(L, dtype=jnp.int32), mode="drop")
    return rank, inv


def compact_ba_problem(xyz, lm_valid, obs: Observations, capacity: int):
    """Remap (xyz, lm_free, obs) onto the compacted landmark axis.
    Returns (xyz_c [capacity,3], lm_free_c [capacity], obs_c, inv)."""
    rank, inv = compact_landmarks(lm_valid, capacity)
    lm_free_c = inv >= 0
    xyz_c = xyz[jnp.where(lm_free_c, inv, 0)]
    lm_c = rank[obs.lm_idx]                                    # [O]
    keep = lm_c < capacity
    obs_c = obs._replace(lm_idx=jnp.where(keep, lm_c, 0),
                         w=obs.w * keep.astype(jnp.float32))
    return xyz_c, lm_free_c, obs_c, inv


def scatter_back_landmarks(xyz, xyz_c, inv):
    """Write optimized compact positions back into the full store."""
    L = xyz.shape[0]
    return xyz.at[jnp.where(inv >= 0, inv, L)].set(xyz_c, mode="drop")

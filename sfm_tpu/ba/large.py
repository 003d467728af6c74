"""Large-scale bundle adjustment: implicit-Schur LM with preconditioned
conjugate gradients (the BASELINE.json "BA ms/iter at 1k keyframes / global
BA over ~500 KFs, 50k landmarks" operating point).

The single-scan solver (core.py) materializes the camera-landmark coupling
W as [C, L, 6, 3]; at 1k cameras x 100k landmarks that is terabytes.  Here
the reduced camera system S = U - W V^-1 W^T is never materialized: CG
computes S.x through the observation tables.

Scatter-free layout: observations are stored TWICE, in a camera-major
table [C, nmax] and a landmark-major table [L, kmax] (dual CSR).  Every
reduction in the solver is then a dense sum over a table axis in the
layout that makes it scatter-free:
  - U, g_cam: sum over the camera-major axis;
  - V, g_lm, W^T x: sum over the landmark-major axis;
  - W z (per camera): sum over the camera-major axis with z gathered.
Jacobian blocks are computed in both layouts (cheap, elementwise) — this
trades 2x flops on tiny closed forms for the removal of every scatter.
Gauge/padding freezes via masks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry.rotations import exp_so3
from ..geometry.smallinv import inv6x6
from .residuals import Observations, residuals_and_jacobians, \
    residuals_and_jacobians_gathered, huber_weights, \
    apply_pose_update, bmm_small, bmv_small
from .core import BAStats, inv3_sym, _damp


class ObsTables(NamedTuple):
    """Dual-layout observation tables.  Invalid slots have w == 0 and an
    in-range dummy index."""
    lm_cam: jnp.ndarray   # [L, kmax] int32 camera index
    lm_uv: jnp.ndarray    # [L, kmax, 2]
    lm_w: jnp.ndarray     # [L, kmax]
    cam_lm: jnp.ndarray   # [C, nmax] int32 landmark index
    cam_uv: jnp.ndarray   # [C, nmax, 2]
    cam_w: jnp.ndarray    # [C, nmax]


def build_tables(obs: Observations, n_cams: int, n_lms: int,
                 nmax: int, kmax: int) -> ObsTables:
    """Host-side: bucket a COO observation list into both table layouts.
    Overflowing observations are dropped (with a count available via the
    returned tables' weights vs the input)."""
    cam_idx = np.asarray(obs.cam_idx)
    lm_idx = np.asarray(obs.lm_idx)
    uv = np.asarray(obs.uv)
    w = np.asarray(obs.w)
    live = w > 0

    lm_cam = np.zeros((n_lms, kmax), np.int32)
    lm_uv = np.zeros((n_lms, kmax, 2), np.float32)
    lm_w = np.zeros((n_lms, kmax), np.float32)
    cam_lm = np.zeros((n_cams, nmax), np.int32)
    cam_uv = np.zeros((n_cams, nmax, 2), np.float32)
    cam_w = np.zeros((n_cams, nmax), np.float32)

    fill_l = np.zeros(n_lms, np.int32)
    fill_c = np.zeros(n_cams, np.int32)
    for o in np.nonzero(live)[0]:
        l, c = lm_idx[o], cam_idx[o]
        # an observation must fit in BOTH tables to stay consistent
        if fill_l[l] >= kmax or fill_c[c] >= nmax:
            continue
        lm_cam[l, fill_l[l]] = c
        lm_uv[l, fill_l[l]] = uv[o]
        lm_w[l, fill_l[l]] = w[o]
        fill_l[l] += 1
        cam_lm[c, fill_c[c]] = l
        cam_uv[c, fill_c[c]] = uv[o]
        cam_w[c, fill_c[c]] = w[o]
        fill_c[c] += 1
    return ObsTables(jnp.asarray(lm_cam), jnp.asarray(lm_uv),
                     jnp.asarray(lm_w), jnp.asarray(cam_lm),
                     jnp.asarray(cam_uv), jnp.asarray(cam_w))


def build_tables_device(obs: Observations, n_cams: int, n_lms: int,
                        nmax: int, kmax: int):
    """Jittable dual-table construction from the COO observation list —
    the device-side replacement for ``build_tables``'s host loop, usable
    per-keyframe inside the engine (VERDICT: ba/large.py:58-79 was
    host-only).

    Slot assignment: sort-by-index + rank-within-run (searchsorted), so
    each live observation gets a dense per-landmark / per-camera slot.
    An observation overflowing EITHER table is dropped from BOTH (its
    slots are left as zero-weight holes — harmless padding, exactly like
    table tail padding).  Under overflow the dropped SET can differ from
    the host builder's sequential choice; without overflow the tables
    hold identical observation multisets.

    Returns ``(tables, n_dropped)``: the dropped-observation count is a
    first-class output so callers can surface it (no-silent-caps rule —
    at engine kmax a well-observed landmark can overflow silently
    otherwise; VERDICT round 2 item 7)."""
    live = obs.w > 0
    slot_l = _rank_in_group(obs.lm_idx, live, n_lms)
    slot_c = _rank_in_group(obs.cam_idx, live, n_cams)
    keep = live & (slot_l < kmax) & (slot_c < nmax)
    l_idx = jnp.where(keep, obs.lm_idx, n_lms)
    c_idx = jnp.where(keep, obs.cam_idx, n_cams)

    lm_cam = jnp.zeros((n_lms, kmax), jnp.int32).at[l_idx, slot_l].set(
        obs.cam_idx, mode="drop")
    lm_uv = jnp.zeros((n_lms, kmax, 2), jnp.float32).at[l_idx, slot_l].set(
        obs.uv, mode="drop")
    lm_w = jnp.zeros((n_lms, kmax), jnp.float32).at[l_idx, slot_l].set(
        obs.w, mode="drop")
    cam_lm = jnp.zeros((n_cams, nmax), jnp.int32).at[c_idx, slot_c].set(
        obs.lm_idx, mode="drop")
    cam_uv = jnp.zeros((n_cams, nmax, 2), jnp.float32).at[c_idx, slot_c].set(
        obs.uv, mode="drop")
    cam_w = jnp.zeros((n_cams, nmax), jnp.float32).at[c_idx, slot_c].set(
        obs.w, mode="drop")
    n_dropped = (jnp.sum(live) - jnp.sum(keep)).astype(jnp.int32)
    return ObsTables(lm_cam, lm_uv, lm_w, cam_lm, cam_uv, cam_w), n_dropped


def _rank_in_group(idx, live, n):
    """Per-observation slot = rank within its equal-index group (stable).
    Run starts via a cummax over the sorted keys (one associative scan, no
    per-element binary search)."""
    O = idx.shape[0]
    key = jnp.where(live, idx, n).astype(jnp.int32)
    order = jnp.argsort(key, stable=True)
    s = key[order]
    iota = jnp.arange(O, dtype=jnp.int32)
    newrun = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    start = jax.lax.associative_scan(jnp.maximum,
                                     jnp.where(newrun, iota, 0))
    return jnp.zeros(O, jnp.int32).at[order].set(iota - start)


def build_lm_tables_device(obs: Observations, n_lms: int, kmax: int):
    """Landmark-major tables ONLY, as one fused payload scatter — for
    callers that never read the camera-major side (loop-closure
    re-triangulation).  Packs (cam, u, v, w) into a single [O, 4] f32
    scatter (camera indices < 2^24 are exact in f32).  The overflow rule
    is slot < kmax only (no camera table to keep consistent).  Returns
    (lm_cam, lm_uv, lm_w, n_dropped)."""
    live = obs.w > 0
    slot_l = _rank_in_group(obs.lm_idx, live, n_lms)
    keep = live & (slot_l < kmax)
    l_idx = jnp.where(keep, obs.lm_idx, n_lms)
    payload = jnp.concatenate(
        [obs.cam_idx[:, None].astype(jnp.float32), obs.uv,
         obs.w[:, None]], axis=1)                              # [O, 4]
    table = jnp.zeros((n_lms, kmax, 4), jnp.float32).at[
        l_idx, slot_l].set(payload, mode="drop")
    n_dropped = (jnp.sum(live) - jnp.sum(keep)).astype(jnp.int32)
    return (table[..., 0].astype(jnp.int32), table[..., 1:3],
            table[..., 3], n_dropped)


def make_coupling_ops(tables: ObsTables):
    """The two table-layout contractions of the implicit Schur complement,
    each a row gather feeding a dense sum over a table axis:
      wT_x(W_l, x):      t[l] = sum_k W_l[l,k]^T x[lm_cam[l,k]]   ([L,3])
      w_z(W_c, z):       y[c] = sum_j W_c[c,j] z[cam_lm[c,j]]      ([C,6])
    (A one-hot-matmul form of both ran 2.6x slower per LM iteration at
    32 cameras and 26x slower at 1k cameras on the H100; PERF.md.)"""

    def wT_x(W_l, x):
        return jnp.einsum("lkab,lka->lb", W_l, x[tables.lm_cam])

    def w_z(W_c, z):
        return jnp.einsum("cjab,cjb->ca", W_c, z[tables.cam_lm])

    return wT_x, w_z


def _huber_w(r, delta):
    if delta <= 0:
        return jnp.ones(r.shape[:-1], r.dtype)
    nrm = jnp.linalg.norm(r, axis=-1)
    return jnp.where(nrm <= delta, 1.0, delta / jnp.maximum(nrm, 1e-12))


def _blocks_lm_major(K, R, tvec, xyz, tables: ObsTables,
                     cam_free_f, lm_free_f, huber_delta):
    """Landmark-major blocks [L, kmax, ...].  The landmark side is a
    broadcast view (no gather); the camera side is ONE packed [C, 13]
    gather (R | t | cam_free) instead of three separate per-slot gathers."""
    C = R.shape[0]
    packed = jnp.concatenate(
        [R.reshape(C, 9), tvec, cam_free_f[:, None]], axis=1)  # [C, 13]
    g = packed[tables.lm_cam]                            # [L, kmax, 13]
    Rc = g[..., :9].reshape(*tables.lm_cam.shape, 3, 3)
    tc = g[..., 9:12]
    cfree = g[..., 12]
    X = xyz[:, None, :]                                  # broadcast view
    r, A, B = residuals_and_jacobians_gathered(K, Rc, tc, X, tables.lm_uv)
    w = tables.lm_w * _huber_w(r, huber_delta)
    A = A * (w * cfree)[..., None, None]
    B = B * (w * lm_free_f[:, None])[..., None, None]
    return r, A, B, r * w[..., None], w


def _blocks_cam_major(K, R, tvec, xyz, tables: ObsTables,
                      cam_free_f, lm_free_f, huber_delta):
    """Camera-major blocks [C, nmax, ...].  The camera side is a broadcast
    view; the landmark side is ONE packed [L, 4] gather (xyz | lm_free)."""
    L = xyz.shape[0]
    packed = jnp.concatenate([xyz, lm_free_f[:, None]], axis=1)  # [L, 4]
    g = packed[tables.cam_lm]                            # [C, nmax, 4]
    X = g[..., :3]
    lfree = g[..., 3]
    Rc = R[:, None]                                      # broadcast view
    tc = tvec[:, None]
    r, A, B = residuals_and_jacobians_gathered(K, Rc, tc, X, tables.cam_uv)
    w = tables.cam_w * _huber_w(r, huber_delta)
    A = A * (w * cam_free_f[:, None])[..., None, None]
    B = B * (w * lfree)[..., None, None]
    return r, A, B, r * w[..., None], w


def run_large_ba(K, rvec, tvec, xyz, tables: ObsTables, *,
                 cam_free, lm_free, iterations: int = 15,
                 cg_iterations: int = 25, lam0: float = 1e-3,
                 lam_up: float = 4.0, lam_down: float = 2.0,
                 huber_delta: float = 0.0, tol: float = 1e-4,
                 precond: str = "jacobi_u"
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, BAStats]:
    """Implicit-Schur LM: outer damping loop, inner block-Jacobi PCG on the
    reduced camera system.  All reductions are table-axis sums."""
    C = rvec.shape[0]

    cam_free_f = cam_free.astype(jnp.float32)
    lm_free_f = lm_free.astype(jnp.float32)
    wT_x, w_z = make_coupling_ops(tables)

    def linearize(rvec, tvec, xyz):
        R = exp_so3(rvec)
        # landmark-major blocks (landmark side broadcast, camera side one
        # packed gather) / camera-major blocks (vice versa)
        r_l, A_l, B_l, rw_l, w_l = _blocks_lm_major(
            K, R, tvec, xyz, tables, cam_free_f, lm_free_f, huber_delta)
        r_c, A_c, B_c, rw_c, w_c = _blocks_cam_major(
            K, R, tvec, xyz, tables, cam_free_f, lm_free_f, huber_delta)
        # block products as broadcast multiply-reduces, not dot_generals
        # (see residuals.bmm_small for why)
        U = jnp.sum(A_c[..., :, None] * A_c[..., None, :],
                    axis=(1, 2))                             # [C,6,6]
        g_cam = -jnp.sum(A_c * rw_c[..., None], axis=(1, 2))  # [C,6]
        V = jnp.sum(B_l[..., :, None] * B_l[..., None, :],
                    axis=(1, 2))                             # [L,3,3]
        g_lm = -jnp.sum(B_l * rw_l[..., None], axis=(1, 2))  # [L,3]
        W_l = jnp.sum(A_l[..., :, None] * B_l[..., None, :],
                      axis=2)                                # [L,kmax,6,3]
        W_c = jnp.sum(A_c[..., :, None] * B_c[..., None, :],
                      axis=2)                                # [C,nmax,6,3]
        cost = jnp.sum(jnp.sum(r_l * r_l, -1) * w_l)
        return (U, V, W_l, W_c, g_cam, g_lm), cost

    def _solve_and_accept(carry, U, matvec, rhs, backsub, M_inv=None):
        """LM-iteration tail: block-Jacobi PCG on the reduced camera
        system, back-substitution, accept/reject + relinearize."""
        rvec, tvec, xyz, blocks, cost, lam, accepted, done = carry
        if M_inv is None:
            # block-Jacobi preconditioner: damped U block inverses
            M_inv = inv6x6(_damp(U, lam) + 1e-6 * jnp.eye(6))

        def apply_precond(v):
            return jnp.einsum("cab,cb->ca", M_inv, v)

        # PCG, fixed trip count; x0 = 0 so r0 = rhs exactly (running
        # matvec(0) would cost one full W-table apply for a zero result)
        x0 = jnp.zeros_like(rhs)
        r0 = rhs
        z0 = apply_precond(r0)

        def cg_body(_, cg):
            x, r, z, p = cg
            Ap = matvec(p)
            rz = jnp.sum(r * z)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-12)
            x = x + alpha * p
            r_new = r - alpha * Ap
            z_new = apply_precond(r_new)
            beta = jnp.sum(r_new * z_new) / jnp.maximum(rz, 1e-12)
            p = z_new + beta * p
            return x, r_new, z_new, p

        d_cam, _, _, _ = jax.lax.fori_loop(
            0, cg_iterations, cg_body, (x0, r0, z0, z0))
        d_cam = d_cam * cam_free_f[:, None]
        d_lm = backsub(d_cam) * lm_free_f[:, None]

        rv_new, tv_new = jax.vmap(apply_pose_update)(
            rvec, tvec, d_cam[:, :3], d_cam[:, 3:])
        xyz_new = xyz + d_lm
        blocks_new, new_cost = linearize(rv_new, tv_new, xyz_new)
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
        return rvec, tvec, xyz, blocks, cost, lam, \
            accepted + ok.astype(jnp.int32), done

    def body(carry):
        rvec, tvec, xyz, blocks, cost, lam, accepted, done = carry
        U, V, W_l, W_c, g_cam, g_lm = blocks
        Vinv = inv3_sym(_damp(V, lam))

        def matvec(x):
            Ux = jnp.einsum("cab,cb->ca", _damp(U, lam), x)
            t = wT_x(W_l, x)
            z = bmv_small(Vinv, t)
            return Ux - w_z(W_c, z)

        # rhs = g_cam - W V^-1 g_lm
        zg = bmv_small(Vinv, g_lm)
        rhs = g_cam - w_z(W_c, zg)

        if precond == "schur_diag":
            Ud = _damp(U, lam)
            # block-Jacobi on the EXACT diagonal of S = damp(U) - W V^-1 W^T
            # (not just on U): S_cc = damp(U_cc) - sum_j W_cj Vinv_j W_cj^T.
            # the PCG iteration count did not drop on the banded camera
            # graphs of the 1k-KF bench; kept for problems with hub
            # cameras
            Vinv_c = Vinv[tables.cam_lm]             # [C, nmax, 3, 3]
            WV = bmm_small(W_c, Vinv_c)              # [C, nmax, 6, 3]
            P = jnp.sum(WV[..., :, None, :] * W_c[..., None, :, :],
                        axis=(1, 4))                 # [C, 6, 6]
            M_inv = inv6x6(Ud - P + 1e-6 * jnp.eye(6))
        else:
            M_inv = None  # default block-Jacobi built in _solve_and_accept

        # back-substitution: d_lm = Vinv (g_lm - W^T d_cam)
        backsub = lambda d_cam: bmv_small(Vinv, g_lm - wT_x(W_l, d_cam))
        return _solve_and_accept(carry, U, matvec, rhs, backsub, M_inv)

    blocks0, cost0 = linearize(rvec, tvec, xyz)

    def loop_body(_, carry):
        return jax.lax.cond(carry[-1], lambda c: c, body, carry)

    rvec, tvec, xyz, blocks, cost, lam, accepted, done = jax.lax.fori_loop(
        0, iterations, loop_body,
        (rvec, tvec, xyz, blocks0, cost0, jnp.asarray(lam0, jnp.float32),
         jnp.asarray(0, jnp.int32), jnp.asarray(False)))
    return rvec, tvec, xyz, BAStats(cost0, cost, lam, accepted)


"""Distributed implicit-Schur bundle adjustment: the multi-device config
(BASELINE.json: "large synthetic SfM (5k keyframes, 1M landmarks):
map-block-partitioned distributed BA").

Combines ba/large.py's dual-table implicit-Schur PCG with landmark
sharding over the ``map`` mesh axis:
  - each shard owns a contiguous landmark block with its landmark-major
    observation table AND a camera-major table of ITS OWN observations
    (per-cam rows partially filled per shard);
  - camera poses replicate; V, g_lm, W^T x and back-substitution are
    shard-local;
  - per-camera reductions (U, g_cam, and the W V^-1 W^T x term of every
    CG matvec) are shard-partial sums followed by one psum of a [C, 6]
    vector (or [C,6,6] for U at linearization) across devices —
    communication per CG iteration is 24C bytes, independent of the
    landmark count.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ba.residuals import Observations, apply_pose_update, bmv_small
from ..ba.core import BAStats, inv3_sym, _damp
from ..ba.large import ObsTables, build_tables, _blocks_lm_major, \
    _blocks_cam_major, make_coupling_ops
from ..geometry.rotations import exp_so3


def partition_tables(obs: Observations, n_cams: int, n_lms: int,
                     n_shards: int, nmax: int, kmax: int) -> ObsTables:
    """Host-side: split landmarks into contiguous shards and build each
    shard's dual tables (landmark indices shard-local).  Returns ObsTables
    with a leading [n_shards] axis; nmax is the per-shard camera-major row
    capacity."""
    shard_size = n_lms // n_shards
    cam_idx = np.asarray(obs.cam_idx)
    lm_idx = np.asarray(obs.lm_idx)
    uv = np.asarray(obs.uv)
    w = np.asarray(obs.w)
    parts = []
    for s in range(n_shards):
        sel = (w > 0) & (lm_idx // shard_size == s)
        sub = Observations(
            jnp.asarray(cam_idx[sel]),
            jnp.asarray(lm_idx[sel] - s * shard_size),
            jnp.asarray(uv[sel]), jnp.asarray(w[sel]))
        parts.append(build_tables(sub, n_cams, shard_size, nmax, kmax))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *parts), shard_size


def build_dist_large_ba(mesh: Mesh, axis: str, n_cams: int, shard_size: int,
                        *, iterations: int = 10, cg_iterations: int = 25,
                        lam0: float = 1e-3, lam_up: float = 4.0,
                        lam_down: float = 2.0, huber_delta: float = 0.0,
                        tol: float = 0.0):
    """Jitted landmark-sharded implicit-Schur LM solve.

    fn(K, rvec, tvec, xyz_sharded [L,3], tables (leading shard axis),
       cam_free [C], lm_free_sharded [L]) -> (rvec, tvec, xyz, stats)."""

    def body_shard(K, rvec, tvec, xyz_l, tables_l, cam_free, lm_free_l):
        tables_l = jax.tree.map(lambda x: x[0], tables_l)
        cam_free_f = cam_free.astype(jnp.float32)
        lm_free_f = lm_free_l.astype(jnp.float32)
        L_l = xyz_l.shape[0]
        wT_x, w_z = make_coupling_ops(tables_l)

        def linearize(rvec, tvec, xyz_l):
            R = exp_so3(rvec)
            r_l, A_l, B_l, rw_l, w_l = _blocks_lm_major(
                K, R, tvec, xyz_l, tables_l, cam_free_f, lm_free_f,
                huber_delta)
            _, A_c, B_c, rw_c, _ = _blocks_cam_major(
                K, R, tvec, xyz_l, tables_l, cam_free_f, lm_free_f,
                huber_delta)
            # shard-partial camera terms -> one fused psum; block products
            # as broadcast multiply-reduces (see residuals.bmm_small)
            U_p = jnp.sum(A_c[..., :, None] * A_c[..., None, :],
                          axis=(1, 2))
            gc_p = -jnp.sum(A_c * rw_c[..., None], axis=(1, 2))
            cost_p = jnp.sum(jnp.sum(r_l * r_l, -1) * w_l)
            U, g_cam, cost = jax.lax.psum((U_p, gc_p, cost_p), axis)
            V = jnp.sum(B_l[..., :, None] * B_l[..., None, :], axis=(1, 2))
            g_lm = -jnp.sum(B_l * rw_l[..., None], axis=(1, 2))
            W_l_ = jnp.sum(A_l[..., :, None] * B_l[..., None, :], axis=2)
            W_c_ = jnp.sum(A_c[..., :, None] * B_c[..., None, :], axis=2)
            return (U, V, W_l_, W_c_, g_cam, g_lm), cost

        blocks0, cost0 = linearize(rvec, tvec, xyz_l)

        def iter_body(_, carry):
            rvec, tvec, xyz_l, blocks, cost, lam, accepted = carry
            U, V, W_l, W_c, g_cam, g_lm = blocks
            Vinv = inv3_sym(_damp(V, lam))
            Ud = _damp(U, lam)

            def matvec(x):
                Ux = jnp.einsum("cab,cb->ca", Ud, x)
                t = wT_x(W_l, x)
                z = bmv_small(Vinv, t)
                # the Schur term sums over ALL landmarks -> psum the
                # shard-partial per-camera contribution ([C, 6])
                y = jax.lax.psum(w_z(W_c, z), axis)
                return Ux - y

            zg = bmv_small(Vinv, g_lm)
            rhs = g_cam - jax.lax.psum(w_z(W_c, zg), axis)

            M_inv = jnp.linalg.inv(Ud + 1e-6 * jnp.eye(6))

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

            t = wT_x(W_l, d_cam)
            d_lm = bmv_small(Vinv, g_lm - t) * \
                lm_free_f[:, None]

            rv_new, tv_new = jax.vmap(apply_pose_update)(
                rvec, tvec, d_cam[:, :3], d_cam[:, 3:])
            xyz_new = xyz_l + d_lm
            blocks_new, new_cost = linearize(rv_new, tv_new, xyz_new)
            ok = (new_cost < cost) & jnp.isfinite(new_cost)
            rvec = jnp.where(ok, rv_new, rvec)
            tvec = jnp.where(ok, tv_new, tvec)
            xyz_l = jnp.where(ok, xyz_new, xyz_l)
            blocks = jax.tree.map(lambda n, o: jnp.where(ok, n, o),
                                  blocks_new, blocks)
            lam = jnp.where(ok, jnp.maximum(lam / lam_down, 1e-9),
                            jnp.minimum(lam * lam_up, 1e6))
            cost = jnp.where(ok, new_cost, cost)
            return (rvec, tvec, xyz_l, blocks, cost, lam,
                    accepted + ok.astype(jnp.int32))

        rvec, tvec, xyz_l, blocks, cost, lam, accepted = jax.lax.fori_loop(
            0, iterations, iter_body,
            (rvec, tvec, xyz_l, blocks0, cost0,
             jnp.asarray(lam0, jnp.float32), jnp.asarray(0, jnp.int32)))
        return rvec, tvec, xyz_l, BAStats(cost0, cost, lam, accepted)

    tab_spec = ObsTables(*([P(axis)] * 6))
    fn = shard_map(
        body_shard, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), tab_spec, P(), P(axis)),
        out_specs=(P(), P(), P(axis), BAStats(P(), P(), P(), P(), P())))
    return jax.jit(fn)

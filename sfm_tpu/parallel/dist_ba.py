"""Distributed bundle adjustment: landmark-sharded Schur reduction with XLA
collectives over the device mesh (the SfM analogue of tensor parallelism —
SURVEY.md §2.14; BASELINE.json's ">=70% BA scaling efficiency" target).

Decomposition: landmarks (and their observations) are sharded over the
``map`` mesh axis; camera poses are replicated.  Each shard assembles its
local normal-equation blocks, the reduced camera system
S = U - W V^-1 W^T and its rhs are psum-reduced across devices, every device
solves the (small, replicated) camera system redundantly, and landmark
back-substitution happens shard-locally with zero further communication.
One psum pair per LM iteration is the entire communication cost.

The observation list must be partitioned by owning landmark shard with
shard-local landmark indices — see ``partition_observations``."""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ba.residuals import (Observations, residuals_and_jacobians,
                            huber_weights, apply_pose_update)
from ..ba.core import BAStats, _damp, _dense_cam_system, inv3_sym
from ..geometry.rotations import exp_so3


def partition_observations(obs: Observations, n_landmarks: int,
                           n_shards: int, cap_per_shard: int):
    """Host-side: bucket observations by owning landmark shard (owner =
    lm_idx // shard_size), convert landmark indices to shard-local, and pad
    each bucket to ``cap_per_shard``.  Returns sharded Observations with
    leading axis [n_shards] and the shard size."""
    shard_size = n_landmarks // n_shards
    cam_idx = np.asarray(obs.cam_idx)
    lm_idx = np.asarray(obs.lm_idx)
    uv = np.asarray(obs.uv)
    w = np.asarray(obs.w)
    out_cam = np.zeros((n_shards, cap_per_shard), np.int32)
    out_lm = np.zeros((n_shards, cap_per_shard), np.int32)
    out_uv = np.zeros((n_shards, cap_per_shard, 2), np.float32)
    out_w = np.zeros((n_shards, cap_per_shard), np.float32)
    dropped = 0
    for s in range(n_shards):
        mask = (w > 0) & (lm_idx // shard_size == s)
        n = int(mask.sum())
        if n > cap_per_shard:
            dropped += n - cap_per_shard
            idx = np.nonzero(mask)[0][:cap_per_shard]
            n = cap_per_shard
        else:
            idx = np.nonzero(mask)[0]
        out_cam[s, :n] = cam_idx[idx]
        out_lm[s, :n] = lm_idx[idx] - s * shard_size
        out_uv[s, :n] = uv[idx]
        out_w[s, :n] = w[idx]
    return Observations(jnp.asarray(out_cam), jnp.asarray(out_lm),
                        jnp.asarray(out_uv), jnp.asarray(out_w)), shard_size


def build_dist_ba(mesh: Mesh, axis: str, n_cams: int, shard_size: int,
                  *, iterations: int = 20, lam0: float = 1e-3,
                  lam_up: float = 4.0, lam_down: float = 2.0,
                  huber_delta: float = 0.0):
    """Build the jitted distributed LM solve.

    Inputs to the returned fn:
      K [3,3] (replicated), rvec/tvec [C,3] (replicated),
      xyz [L,3] sharded on ``axis`` (L = n_shards * shard_size),
      obs with leading shard axis (from partition_observations),
      cam_free [C] bool, lm_free [L] bool sharded.
    Returns (rvec, tvec, xyz, stats)."""

    def local_assemble(K, rvec, tvec, xyz_l, obs_l, cam_free_f, lm_free_l):
        R = exp_so3(rvec)
        r, A, B = residuals_and_jacobians(K, R, tvec, xyz_l, obs_l)
        w = obs_l.w * huber_weights(r, huber_delta)
        A = A * (w * cam_free_f[obs_l.cam_idx])[:, None, None]
        B = B * (w * lm_free_l[obs_l.lm_idx])[:, None, None]
        rw = r * w[:, None]
        U = jnp.zeros((n_cams, 6, 6)).at[obs_l.cam_idx].add(
            jnp.einsum("oia,oib->oab", A, A))
        V = jnp.zeros((shard_size, 3, 3)).at[obs_l.lm_idx].add(
            jnp.einsum("oia,oib->oab", B, B))
        W = jnp.zeros((n_cams, shard_size, 6, 3)).at[
            obs_l.cam_idx, obs_l.lm_idx].add(jnp.einsum("oia,oib->oab", A, B))
        g_cam = jnp.zeros((n_cams, 6)).at[obs_l.cam_idx].add(
            -jnp.einsum("oia,oi->oa", A, rw))
        g_lm = jnp.zeros((shard_size, 3)).at[obs_l.lm_idx].add(
            -jnp.einsum("oia,oi->oa", B, rw))
        cost = jnp.sum(jnp.sum(r * r, -1) * w)
        return U, V, W, g_cam, g_lm, cost

    def local_cost(K, rvec, tvec, xyz_l, obs_l):
        R = exp_so3(rvec)
        r, _, _ = residuals_and_jacobians(K, R, tvec, xyz_l, obs_l)
        return jnp.sum(jnp.sum(r * r, -1) * obs_l.w)

    def body_shard(K, rvec, tvec, xyz_l, obs_l, cam_free, lm_free_l):
        """Runs per-device under shard_map; xyz_l/obs_l are the local shard."""
        # obs arrive with a leading [1] shard axis (one bucket per device)
        obs_l = jax.tree.map(lambda x: x[0], obs_l)
        cam_free_f = cam_free.astype(jnp.float32)
        lm_free_f = lm_free_l.astype(jnp.float32)
        U0, V0, W0, gc0, gl0, cost_l0 = local_assemble(
            K, rvec, tvec, xyz_l, obs_l, cam_free_f, lm_free_f)
        cost0 = jax.lax.psum(cost_l0, axis)

        def iter_body(_, carry):
            rvec, tvec, xyz_l, blocks, lam, cost, accepted = carry
            U_l, V_l, W_l, gc_l, gl_l = blocks
            # global camera-block terms: one fused psum for
            # {U, g_cam, Schur term, rhs term}
            Vinv = inv3_sym(_damp(V_l, lam))
            Y = jnp.einsum("clab,lbd->clad", W_l, Vinv)
            S_l = jnp.einsum("clad,mled->cmae", Y, W_l)
            rhs_l = jnp.einsum("clad,ld->ca", Y, gl_l)
            U, g_cam, S_red, rhs_red = jax.lax.psum(
                (U_l, gc_l, S_l, rhs_l), axis)
            Ud = _damp(U, lam)
            S = _dense_cam_system(Ud) - S_red.transpose(0, 2, 1, 3).reshape(
                6 * n_cams, 6 * n_cams)
            d_cam = jnp.linalg.solve(
                S, (g_cam - rhs_red).reshape(-1)).reshape(n_cams, 6)
            d_cam = d_cam * cam_free_f[:, None]
            # shard-local landmark back-substitution
            Wt_dc = jnp.einsum("clad,ca->ld", W_l, d_cam)
            d_lm = jnp.einsum("lab,lb->la", Vinv, gl_l - Wt_dc)
            d_lm = d_lm * lm_free_f[:, None]
            rv_new, tv_new = jax.vmap(apply_pose_update)(
                rvec, tvec, d_cam[:, :3], d_cam[:, 3:])
            xyz_new = xyz_l + d_lm
            # trial assembly doubles as the next linearization on accept
            blocks_new = local_assemble(
                K, rv_new, tv_new, xyz_new, obs_l, cam_free_f, lm_free_f)
            new_cost = jax.lax.psum(blocks_new[5], axis)
            ok = (new_cost < cost) & jnp.isfinite(new_cost)
            rvec = jnp.where(ok, rv_new, rvec)
            tvec = jnp.where(ok, tv_new, tvec)
            xyz_l = jnp.where(ok, xyz_new, xyz_l)
            blocks = jax.tree.map(lambda n, o: jnp.where(ok, n, o),
                                  blocks_new[:5], blocks)
            lam = jnp.where(ok, jnp.maximum(lam / lam_down, 1e-9),
                            jnp.minimum(lam * lam_up, 1e6))
            cost = jnp.where(ok, new_cost, cost)
            return rvec, tvec, xyz_l, blocks, lam, cost, accepted + ok.astype(jnp.int32)

        rvec, tvec, xyz_l, blocks, lam, cost, accepted = jax.lax.fori_loop(
            0, iterations, iter_body,
            (rvec, tvec, xyz_l, (U0, V0, W0, gc0, gl0),
             jnp.asarray(lam0, jnp.float32), cost0,
             jnp.asarray(0, jnp.int32)))
        return rvec, tvec, xyz_l, BAStats(cost0, cost, lam, accepted)

    obs_spec = Observations(P(axis), P(axis), P(axis), P(axis))
    fn = shard_map(
        body_shard, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), obs_spec, P(), P(axis)),
        out_specs=(P(), P(), P(axis),
                   BAStats(P(), P(), P(), P(), P())))
    return jax.jit(fn)

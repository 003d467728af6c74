"""Relocalization (real implementation of the reference's stub
CSfM::recovery, CSfM.cpp:774-778 — SURVEY.md flags this as a capability gap
to fill): global descriptor match of all landmarks against the current
frame (no motion window), PnP RANSAC without a pose prior, and resumption
of tracking when enough inliers support the pose."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SfMConfig
from ..features.match import match_features
from ..ransac import ransac_pnp
from .state import SfMState, zero_metrics, CameraParams, RUNNING


def reloc_step(cfg: SfMConfig, cam: CameraParams, state: SfMState,
               frame) -> tuple:
    lms = state.lms
    key, k_pnp = jax.random.split(state.key)
    rep = state.rep_desc
    # global match: no window (radius covers the whole image)
    res = match_features(
        rep, jnp.zeros((lms.valid.shape[0], 2)), lms.valid,
        frame.desc, frame.xy, frame.kp_valid,
        min_radius=0.0, max_radius=1e9,
        max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
    uv = frame.xy[jnp.where(res.mask, res.idx, 0)]
    pnp = ransac_pnp(
        k_pnp, cam.Kopt, lms.xyz, uv, res.mask & lms.valid,
        n_hypotheses=cfg.pnp_hypotheses, sample_size=cfg.pnp_sample_size,
        threshold=cfg.max_reproj_error, refine_iters=cfg.pnp_refine_iters,
        min_inliers=max(cfg.min_features, cfg.reloc_min_inliers),
        solver=cfg.reloc_solver)

    def recovered(_):
        L = lms.valid.shape[0]
        lm_ids = jnp.arange(L, dtype=jnp.int32)
        linked = frame._replace(
            rvec=pnp.rvec, tvec=pnp.tvec,
            landmark=frame.landmark.at[
                jnp.where(pnp.inliers, res.idx, frame.landmark.shape[0])
            ].set(lm_ids, mode="drop"))
        st = state._replace(
            status=jnp.asarray(RUNNING, jnp.int32), prev=linked,
            lost_count=jnp.asarray(0, jnp.int32), key=key)
        m = zero_metrics()._replace(
            status=st.status, n_detected=jnp.sum(frame.kp_valid),
            n_matches=jnp.sum(res.mask).astype(jnp.int32),
            n_inliers=pnp.n_inliers.astype(jnp.int32),
            n_tracked=pnp.n_inliers.astype(jnp.int32),
            n_landmarks=jnp.sum(lms.valid).astype(jnp.int32),
            n_keyframes=jnp.sum(state.kfs.valid).astype(jnp.int32),
            rvec=pnp.rvec, tvec=pnp.tvec)
        return st, m

    def still_lost(_):
        st = state._replace(key=key)
        m = zero_metrics()._replace(
            status=st.status, n_detected=jnp.sum(frame.kp_valid),
            n_matches=jnp.sum(res.mask).astype(jnp.int32),
            n_landmarks=jnp.sum(lms.valid).astype(jnp.int32),
            n_keyframes=jnp.sum(state.kfs.valid).astype(jnp.int32),
            rvec=state.prev.rvec, tvec=state.prev.tvec)
        return st, m

    return jax.lax.cond(pnp.ok, recovered, still_lost, None)

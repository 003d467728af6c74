"""Periodic global bundle adjustment over the full keyframe/landmark set.

The reference runs all-keyframe BA inside every mapping pass
(reference CSfM.cpp:250-259), which caps it at tens of keyframes.
At the 500-keyframe / 50k-landmark operating point (BASELINE.json config 3)
the engine instead runs windowed-local BA per keyframe (config.py
ba_local_window) and THIS pass — all poses and structure free — every
``global_ba_every`` keyframe insertions, driven by the host
(SfMEngine / the CLI loop), like ORB-SLAM's global BA living outside the
per-frame path."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SfMConfig
from ..ba.core import observations_from_keyframes
from ..ba.large import build_tables_device, run_large_ba
from .state import SfMState, CameraParams


@functools.partial(jax.jit, static_argnames=("cfg",),
                   donate_argnames=("state",))
def run_global_ba(cfg: SfMConfig, cam: CameraParams, state: SfMState):
    """(state, stats): global BA on the engine state, gauge-fixed on the
    oldest keyframe; ``stats.dropped_obs`` counts the observations that
    overflowed the dual tables."""
    obs = observations_from_keyframes(state.kfs, state.lms.valid)
    tables, n_dropped = build_tables_device(
        obs, cfg.max_keyframes, cfg.max_landmarks,
        nmax=cfg.max_keypoints, kmax=cfg.global_ba_kmax or cfg.ba_kmax)
    kfs, lms = state.kfs, state.lms
    oldest = jnp.argmin(jnp.where(kfs.valid, kfs.frames.frame_no, 2**30))
    cam_free = kfs.valid.at[oldest].set(False)
    rv, tv, xyz, stats = run_large_ba(
        cam.Kopt, kfs.frames.rvec, kfs.frames.tvec, lms.xyz, tables,
        cam_free=cam_free, lm_free=lms.valid,
        iterations=cfg.global_ba_iterations,
        cg_iterations=cfg.global_ba_cg_iterations,
        lam0=cfg.ba_lambda_init, lam_up=cfg.ba_lambda_up,
        lam_down=cfg.ba_lambda_down,
        huber_delta=cfg.global_ba_huber_delta or cfg.ba_huber_delta,
        tol=cfg.ba_tol)
    kfs = kfs._replace(frames=kfs.frames._replace(rvec=rv, tvec=tv))
    state = state._replace(kfs=kfs, lms=lms._replace(xyz=xyz))
    return state, stats._replace(dropped_obs=n_dropped)

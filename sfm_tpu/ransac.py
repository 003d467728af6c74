"""Batched-hypothesis RANSAC: the accelerator replacement for OpenCV's
adaptive-iteration RANSAC solvers (cv::findFundamentalMat CV_FM_RANSAC,
cv::findHomography, cv::solvePnPRansac — CSfM.cpp:842-843, 552-560).

Instead of a data-dependent iteration count, a fixed batch of hypotheses is
sampled, solved, and scored entirely in parallel (vmap over the hypothesis
axis), then the best model is refit on its inlier set.  Oversampling the
batch substitutes for adaptivity (SURVEY.md §7 hard part 3)."""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .geometry.estimation import estimate_fundamental, estimate_homography
from .geometry.epipolar import epiline_distance_sq, homography_transfer_error_sq
from .geometry.pnp import p3p, pnp_dlt, refine_pose, reprojection_errors


def sample_masked(key: jnp.ndarray, valid: jnp.ndarray, n_hyp: int,
                  sample_size: int) -> jnp.ndarray:
    """[n_hyp, sample_size] index samples drawn from valid entries
    (without replacement within a hypothesis) via the Gumbel top-k trick.
    If fewer than sample_size valid entries exist, invalid indices appear;
    callers guard on the valid count."""
    n = valid.shape[0]
    g = jax.random.gumbel(key, (n_hyp, n))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, sample_size)
    return idx


class RansacModel(NamedTuple):
    model: jnp.ndarray      # best model parameters (refit on inliers)
    inliers: jnp.ndarray    # [N] bool
    n_inliers: jnp.ndarray  # scalar int
    score: jnp.ndarray      # scalar float (model score, higher better)


def ransac_fundamental(key, uv0, uv1, valid, *, n_hypotheses: int = 128,
                       threshold: float = 3.84) -> RansacModel:
    """8-point RANSAC for F (cv::findFundamentalMat(CV_FM_RANSAC, 3.84))."""
    samples = sample_masked(key, valid, n_hypotheses, 8)

    def one(idx):
        w = jnp.zeros_like(valid, jnp.float32).at[idx].set(1.0) * valid
        F = estimate_fundamental(uv0, uv1, w)
        d1, d0 = epiline_distance_sq(F, uv0, uv1)
        inl = (d1 < threshold) & (d0 < threshold) & valid
        return F, jnp.sum(inl)

    Fs, counts = jax.vmap(one)(samples)
    best = jnp.argmax(counts)
    F0 = Fs[best]
    # refit on the best inlier set
    d1, d0 = epiline_distance_sq(F0, uv0, uv1)
    inl = (d1 < threshold) & (d0 < threshold) & valid
    F = estimate_fundamental(uv0, uv1, inl.astype(jnp.float32))
    d1, d0 = epiline_distance_sq(F, uv0, uv1)
    inl = (d1 < threshold) & (d0 < threshold) & valid
    return RansacModel(F, inl, jnp.sum(inl), jnp.sum(inl).astype(jnp.float32))


def ransac_homography(key, uv0, uv1, valid, *, n_hypotheses: int = 128,
                      threshold: float = 5.99) -> RansacModel:
    """4-point RANSAC for H.  (The reference computes H by least squares over
    all matches — CSfM.cpp:838-841; use estimate_homography directly for
    that contract.  This variant covers cv::findHomography(RANSAC).)"""
    samples = sample_masked(key, valid, n_hypotheses, 4)

    def one(idx):
        w = jnp.zeros_like(valid, jnp.float32).at[idx].set(1.0) * valid
        H = estimate_homography(uv0, uv1, w)
        ef, eb = homography_transfer_error_sq(H, uv0, uv1)
        inl = (ef < threshold) & (eb < threshold) & valid
        return H, jnp.sum(inl)

    Hs, counts = jax.vmap(one)(samples)
    best = jnp.argmax(counts)
    H0 = Hs[best]
    ef, eb = homography_transfer_error_sq(H0, uv0, uv1)
    inl = (ef < threshold) & (eb < threshold) & valid
    H = estimate_homography(uv0, uv1, inl.astype(jnp.float32))
    ef, eb = homography_transfer_error_sq(H, uv0, uv1)
    inl = (ef < threshold) & (eb < threshold) & valid
    return RansacModel(H, inl, jnp.sum(inl), jnp.sum(inl).astype(jnp.float32))


class PnPResult(NamedTuple):
    rvec: jnp.ndarray
    tvec: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    ok: jnp.ndarray         # scalar bool: enough inliers to trust the pose


def ransac_pnp(key, K, xyz, uv, valid, *, n_hypotheses: int = 64,
               sample_size: int = 6, threshold: float = 7.0,
               refine_iters: int = 10, min_inliers: int = 5,
               prior_rvec=None, prior_tvec=None,
               fast_path_ratio: float = 0.0,
               solver: str = "dlt") -> PnPResult:
    """PnP RANSAC (cv::solvePnPRansac(ITERATIVE, 20 it, 7 px, 0.99)).

    Hypotheses: ``n_hypotheses`` 6-point DLT poses + (optionally) the prior
    pose (tracking always has last frame's pose — the reference feeds it as
    the iterative solver's starting point via useExtrinsicGuess semantics).
    The best hypothesis by inlier count is refined with damped Gauss-Newton
    on its inliers, then inliers are recomputed.

    fast_path_ratio > 0 enables the motion-model fast path (ORB-SLAM
    style): the refined prior pose is tried first, and when it already
    explains at least that fraction of the valid matches, the hypothesis
    batch is skipped entirely (a real branch under lax.cond — the
    steady-state tracking cost drops to one refinement)."""

    def refined(rv0, tv0):
        # two refine->recount rounds: the second round re-runs Gauss-Newton
        # on the GROWN inlier set, which matters when the initial pose only
        # captures part of the consensus (measured on the reloc scenario:
        # 12 -> 15 inliers; a third round gains nothing)
        rv, tv = rv0, tv0
        for _ in range(2):
            err = reprojection_errors(K, rv, tv, xyz, uv)
            inl = (err < threshold) & valid
            rv, tv = refine_pose(K, rv, tv, xyz, uv,
                                 inl.astype(jnp.float32), iters=refine_iters)
        err = reprojection_errors(K, rv, tv, xyz, uv)
        inl = (err < threshold) & valid
        return rv, tv, inl, jnp.sum(inl)

    def full_ransac(_):
        eff_size = 3 if solver == "p3p" else sample_size
        samples = sample_masked(key, valid, n_hypotheses, eff_size)

        if solver == "p3p":
            def one(idx):
                # sample_masked guarantees distinct in-hypothesis indices;
                # degenerate (collinear/invalid) samples yield ok=False
                # candidates which score -1 inliers below
                rvs4, tvs4, ok4 = p3p(K, xyz[idx], uv[idx])
                err = jax.vmap(
                    lambda rv, tv: reprojection_errors(K, rv, tv, xyz, uv)
                )(rvs4, tvs4)
                inl = (err < threshold) & valid[None, :]
                n = jnp.where(ok4, jnp.sum(inl, axis=1), -1)
                return rvs4, tvs4, n

            rvs, tvs, counts = jax.vmap(one)(samples)
            rvs = rvs.reshape(-1, 3)
            tvs = tvs.reshape(-1, 3)
            counts = counts.reshape(-1)
        else:
            def one(idx):
                w = jnp.zeros_like(valid, jnp.float32).at[idx].set(1.0) * valid
                rv, tv = pnp_dlt(K, xyz, uv, w)
                err = reprojection_errors(K, rv, tv, xyz, uv)
                inl = (err < threshold) & valid
                return rv, tv, jnp.sum(inl)

            rvs, tvs, counts = jax.vmap(one)(samples)
        if prior_rvec is not None:
            err_p = reprojection_errors(K, prior_rvec, prior_tvec, xyz, uv)
            n_p = jnp.sum((err_p < threshold) & valid)
            rvs = jnp.concatenate([rvs, prior_rvec[None]])
            tvs = jnp.concatenate([tvs, prior_tvec[None]])
            counts = jnp.concatenate([counts, n_p[None]])
        best = jnp.argmax(counts)
        rv, tv, inl, n = refined(rvs[best], tvs[best])
        return PnPResult(rv, tv, inl, n, n >= min_inliers)

    if prior_rvec is None or fast_path_ratio <= 0.0:
        return full_ransac(None)

    rv_f, tv_f, inl_f, n_f = refined(prior_rvec, prior_tvec)
    n_valid = jnp.sum(valid)
    good = (n_f >= fast_path_ratio * n_valid) & (n_f >= min_inliers)
    fast = PnPResult(rv_f, tv_f, inl_f, n_f, n_f >= min_inliers)
    return jax.lax.cond(good, lambda _: fast, full_ransac, None)

"""Descriptor matching: the contract of CTracker's 7-variant matcher family
(CTracker.cpp:56-477) as one masked argmin over a Hamming distance matrix.

Every reference variant implements: best-match by Hamming distance subject to
(i) a motion-radius window, (ii) the Lowe ratio test, (iii)
keep-best-per-target dedup (matches are not injective; the best source wins
each target — the matchedIdx/matchDistance bookkeeping at
CTracker.cpp:131-147).  Here that is a single fixed-shape kernel: distance
matrix (popcount-matmul) + masks + two argmin reductions.  Index-subset
variants (e.g. "only previously matched features", CTracker.cpp:368-417)
are expressed by passing the subset's validity mask."""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .bits import hamming_matrix

_INF = jnp.float32(1e9)


class MatchResult(NamedTuple):
    """Fixed-shape match output, one row per source feature."""
    idx: jnp.ndarray       # [N] int32 index into target set, -1 if unmatched
    dist: jnp.ndarray      # [N] float32 Hamming distance (INF if unmatched)
    mask: jnp.ndarray      # [N] bool


def match_features(
    desc0: jnp.ndarray, xy0: jnp.ndarray, valid0: jnp.ndarray,
    desc1: jnp.ndarray, xy1: jnp.ndarray, valid1: jnp.ndarray,
    *,
    min_radius: float = 0.0,
    max_radius: float = 1e9,
    max_distance: float = 90.0,
    ratio: float = 0.8,
    window_center0: Optional[jnp.ndarray] = None,
) -> MatchResult:
    """Match source features 0 -> target features 1.

    window_center0: optional [N,2] per-source window centers in the target
    image (for reprojection-guided matching, CSfM.cpp:208-210 — the window
    is around the projected landmark rather than the source point).  When
    None, the window centers on xy0 (frame-to-frame motion window).
    """
    D = hamming_matrix(desc0, desc1)                      # [N, M]
    centers = xy0 if window_center0 is None else window_center0
    d2 = jnp.sum((centers[:, None, :] - xy1[None, :, :]) ** 2, axis=-1)
    in_window = (d2 >= min_radius * min_radius) & (d2 <= max_radius * max_radius)
    feasible = in_window & valid0[:, None] & valid1[None, :]
    Dm = jnp.where(feasible, D, _INF)

    # best + second-best per source row (two-pass argmin, cheaper than sort)
    best_idx = jnp.argmin(Dm, axis=1).astype(jnp.int32)
    best = jnp.min(Dm, axis=1)
    row_ids = jnp.arange(Dm.shape[0])
    D_wo_best = Dm.at[row_ids, best_idx].set(_INF)
    second = jnp.min(D_wo_best, axis=1)

    ok = (best <= max_distance) & (best < ratio * second) & valid0
    # keep-best-per-target dedup: target j keeps only the lowest-distance
    # winning source (a segment-min over the selected matches).  Formulated
    # as masked column reductions over a [N, M] one-hot — scatter-min
    # (.at[].min) serializes under the fleet's scan x keypoint vmap
    # (2 x 10.7 ms per fleet tracking chunk, benchmarks/bench_fleet_trace)
    sel_dist = jnp.where(ok, best, _INF)
    M = Dm.shape[1]
    onehot = best_idx[:, None] == jnp.arange(M, dtype=jnp.int32)[None, :]
    per_target_best = jnp.min(
        jnp.where(onehot, sel_dist[:, None], _INF), axis=0)
    winner = sel_dist <= per_target_best[best_idx]
    # break exact ties deterministically: lowest source index wins
    N = Dm.shape[0]
    sel_src = jnp.where(winner & ok, row_ids, N)
    tie_winner_src = jnp.min(
        jnp.where(onehot, sel_src[:, None], N), axis=0)
    winner = winner & (row_ids == tie_winner_src[best_idx])
    ok = ok & winner

    return MatchResult(
        idx=jnp.where(ok, best_idx, -1),
        dist=jnp.where(ok, best, _INF),
        mask=ok,
    )


def match_pairs(result: MatchResult, cap: int):
    """Compact a MatchResult into fixed-size (idx0, idx1, valid) pair arrays.

    Masked stream compaction: matched sources are moved to the front in
    source order; at most ``cap`` pairs survive."""
    n = result.mask.shape[0]
    order = jnp.where(result.mask, jnp.arange(n), n)
    perm = jnp.argsort(order)[:cap]
    valid = result.mask[perm]
    idx0 = jnp.where(valid, perm, -1).astype(jnp.int32)
    idx1 = jnp.where(valid, result.idx[perm], -1)
    return idx0, idx1, valid

"""Plain NumPy brute-force descriptor matcher: the reference that
``match.match_features`` is checked against.

It shares no code with the JAX matcher: Hamming distances come from XOR +
popcount on the packed words (not from the bitplane matmul), and every
rule of the matcher contract — motion window, absolute distance gate, Lowe
ratio test, keep-best-per-target dedup with the lowest source index winning
exact ties — is a loop-free NumPy expression written from the contract in
match.py's docstring."""

from __future__ import annotations

import numpy as np

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def hamming_np(desc_a: np.ndarray, desc_b: np.ndarray) -> np.ndarray:
    """[N, W] x [M, W] packed uint32 -> [N, M] int32 Hamming distances."""
    a = np.ascontiguousarray(desc_a, np.uint32)
    b = np.ascontiguousarray(desc_b, np.uint32)
    out = np.zeros((a.shape[0], b.shape[0]), np.int32)
    for w in range(a.shape[1]):
        x = a[:, w, None] ^ b[None, :, w]                    # [N, M]
        out += _POPCOUNT8[x.view(np.uint8).reshape(*x.shape, 4)].sum(-1)
    return out


def brute_force_match(desc0, xy0, valid0, desc1, xy1, valid1, *,
                      min_radius=0.0, max_radius=1e9, max_distance=90.0,
                      ratio=0.8, window_center0=None):
    """Reference for ``match.match_features``: returns (idx [N] int32,
    dist [N] float32, mask [N] bool) with idx -1 / dist 1e9 where a source
    is unmatched."""
    desc0, desc1 = np.asarray(desc0), np.asarray(desc1)
    valid0 = np.asarray(valid0, bool)
    valid1 = np.asarray(valid1, bool)
    centers = np.asarray(xy0 if window_center0 is None else window_center0,
                         np.float32)
    xy1 = np.asarray(xy1, np.float32)
    n, m = desc0.shape[0], desc1.shape[0]
    inf = np.int64(10 ** 9)

    D = hamming_np(desc0, desc1).astype(np.int64)
    d2 = ((centers[:, None, :] - xy1[None, :, :]) ** 2).sum(-1)
    feasible = ((d2 >= np.float32(min_radius) ** 2)
                & (d2 <= np.float32(max_radius) ** 2)
                & valid0[:, None] & valid1[None, :])
    Dm = np.where(feasible, D, inf)

    rows = np.arange(n)
    best_idx = np.argmin(Dm, axis=1)          # first minimum: lowest index
    best = Dm[rows, best_idx]
    others = Dm.copy()
    others[rows, best_idx] = inf
    second = others.min(axis=1) if m > 1 else np.full(n, inf)
    ok = (valid0 & (best < inf) & (best <= max_distance)
          & (best < np.float32(ratio) * second.astype(np.float32)))

    # keep-best-per-target: order candidates by (target, dist, source) and
    # keep the first of each target
    cand = np.nonzero(ok)[0]
    order = np.lexsort((cand, best[cand], best_idx[cand]))
    cand = cand[order]
    first = np.ones(len(cand), bool)
    first[1:] = best_idx[cand][1:] != best_idx[cand][:-1]
    keep = np.zeros(n, bool)
    keep[cand[first]] = True

    idx = np.where(keep, best_idx, -1).astype(np.int32)
    dist = np.where(keep, best, 1e9).astype(np.float32)
    return idx, dist, keep


def random_case(rng, n_src, n_tgt, W=16):
    """(desc0, xy0, valid0, desc1, xy1, valid1) for a matcher check:
    sources are noisy copies of targets near their positions (1/16 of them
    duplicated exactly, to exercise the per-target tie-break) plus 20%
    random distractors; ~5% of either side invalid."""
    tgt = rng.integers(0, 2**32, (n_tgt, W), dtype=np.uint64).astype(
        np.uint32)
    xy1 = rng.uniform(0, 640, (n_tgt, 2)).astype(np.float32)
    pick = rng.integers(0, n_tgt, n_src)
    src = tgt[pick].copy()
    flips = rng.integers(0, 60, n_src)
    for i in range(n_src):
        for b in rng.choice(W * 32, flips[i], replace=False):
            src[i, b // 32] ^= np.uint32(1 << (b % 32))
    distract = rng.random(n_src) < 0.2
    src[distract] = rng.integers(0, 2**32, (distract.sum(), W),
                                 dtype=np.uint64).astype(np.uint32)
    dup = rng.choice(n_src, n_src // 16, replace=False)
    src[dup] = src[(dup + 1) % n_src]
    xy0 = (xy1[pick] + rng.normal(0, 12, (n_src, 2))).astype(np.float32)
    xy0[dup] = xy0[(dup + 1) % n_src]
    v0 = rng.random(n_src) > 0.05
    v1 = rng.random(n_tgt) > 0.05
    return src, xy0, v0, tgt, xy1, v1

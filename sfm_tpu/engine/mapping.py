"""Keyframe-rate mapping (CSfM::mapping, CSfM.cpp:109-308) — the throughput
path, run synchronously after keyframe insertion like the reference (which
collapsed ORB-SLAM's mapping thread into addFrame, CSfM.cpp:77-79).

Phases, mirroring §3.4 of SURVEY.md, but batched instead of the reference's
serial keyframe loop:
 1. new-point triangulation: the new keyframe is matched against ALL older
    keyframes in one vmap (the covisibility graph is "all keyframes" in the
    reference, CSfM.cpp:123-126); when several old keyframes match the same
    new-keyframe keypoint, the OLDEST wins (replacing the reference's
    serial leftover-matching semantics with an order-free equivalent), and
    all surviving candidates insert in one bulk add;
 2. re-observation: project unlinked landmarks into every keyframe and
    match with a reprojection-guided window (generalizes CSfM.cpp:190-221)
    — vmapped in chunks to bound the distance-matrix footprint;
 3. landmark culling (CMap policy) + link clearing;
 4. keyframe culling (CSfM.cpp:708-752);
 5. full-map bundle adjustment, gauge-fixed on the oldest keyframe;
 6. map aging."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SfMConfig
from ..ba import BAMode, observations_from_keyframes, run_ba, run_ba_cg
from ..ba.core import compact_ba_problem, scatter_back_landmarks
from ..features.match import match_features
from ..geometry.camera import project, depths
from ..geometry.epipolar import fundamental_from_poses, filter_matches_epipolar
from ..geometry.triangulate import triangulate_pair, projection_matrix
from ..mapstore import (add_landmarks, add_descriptors, clear_links,
                        cull_landmarks, cull_keyframes, kf_view_counts,
                        representative_descriptors, increment_age)
from .state import SfMState, CameraParams

_REOBS_CHUNK = 8   # keyframes re-observed per vmapped batch


def _recent_valid_slots(kfs, m: int):
    """Indices of the m most recent valid keyframe slots + usability mask
    (the recency window approximating the covisibility graph)."""
    score = jnp.where(kfs.valid, kfs.frames.frame_no, -1)
    _, slots = jax.lax.top_k(score, m)
    return slots, score[slots] >= 0


def _covisible_slots(kfs, new_slot, m: int, n_landmarks: int):
    """Indices of the m keyframes most covisible with ``new_slot`` (shared
    landmark links, recency as tiebreak) + usability mask.

    This is the covisibility graph the reference declared but commented
    out (CMap.h:94-95), substituting "all keyframes" (CSfM.cpp:123-126).
    Edge weight = one masked overlap count per keyframe: after a loop,
    old keyframes observing the revisited region outrank recent ones, so
    triangulation/re-observation reconnects to the old map — which a pure
    recency window provably cannot (tests/test_covisibility.py)."""
    fr = kfs.frames
    L = n_landmarks
    new_links = fr.landmark[new_slot]                       # [N]
    seen = jnp.zeros((L,), bool).at[
        jnp.where(new_links >= 0, new_links, L)].set(True, mode="drop")
    linked = fr.landmark >= 0                               # [K, N]
    overlap = jnp.sum(
        linked & seen[jnp.clip(fr.landmark, 0, L - 1)], axis=1)  # [K]
    # overlap-major, frame-no tiebreak; int32 bounds: overlap <= N <= 2^10,
    # frame_no < 2^20 -> max score < 2^31
    score = jnp.where(kfs.valid,
                      overlap.astype(jnp.int32) * (1 << 20)
                      + fr.frame_no.astype(jnp.int32),
                      jnp.asarray(-1, jnp.int32))
    _, slots = jax.lax.top_k(score, m)
    return slots.astype(jnp.int32), score[slots] >= 0


def _window_slots(cfg: SfMConfig, kfs, new_slot, m: int, n_landmarks: int):
    if cfg.mapping_use_covisibility:
        return _covisible_slots(kfs, new_slot, m, n_landmarks)
    return _recent_valid_slots(kfs, m)


def _hybrid_slots(cfg: SfMConfig, kfs, new_slot, m: int, n_landmarks: int):
    """Triangulation window: half most-RECENT keyframes, half most
    covisible (deduped, recency first).

    A pure covisibility window starves exploration: the new keyframe's
    links are to OLD map points, so the top-covisible keyframes are the
    ones that created those points — during a long sweep that is the
    bootstrap era, which cannot see the frontier at all (measured on the
    512-KF longscan: window = frames [143, 9, 3, 6, 1, 0, 15, 126] for a
    frame-148 keyframe, triangulation yield 0).  The recent half always
    covers the frontier; the covisible half keeps loop-closure
    reconnection (tests/test_covisibility.py)."""
    if not cfg.mapping_use_covisibility:
        return _recent_valid_slots(kfs, m)
    # floor-half recent: the recent head starts with the new keyframe
    # itself (skipped by the pair loop), so covisible slots keep the
    # majority — the loop-closure test's tiny 3-slot window still gets
    # its two genuine covisible pairs
    half = m // 2
    r_slots, r_ok = _recent_valid_slots(kfs, m)
    c_slots, c_ok = _covisible_slots(kfs, new_slot, m, n_landmarks)
    r_head, rok_head = r_slots[:half], r_ok[:half]
    dup = jnp.any((c_slots[:, None] == r_head[None, :]) & rok_head[None, :],
                  axis=1)
    cand = jnp.concatenate([r_head, c_slots])
    ok = jnp.concatenate([rok_head, c_ok & ~dup])
    # stable-select the first m valid candidates (recent half first)
    order = jnp.where(ok, jnp.arange(cand.shape[0]), cand.shape[0])
    pick = jnp.argsort(order)[:m]
    return cand[pick].astype(jnp.int32), ok[pick]


def _triangulate_all_pairs(cfg: SfMConfig, cam: CameraParams,
                           state: SfMState, new_slot) -> SfMState:
    """Batched CSfM.cpp:130-185: match unmatched(new KF) vs unmatched(the
    recent older keyframes), triangulate + filter each pair, resolve
    cross-pair conflicts oldest-first, bulk-insert, and link both sides."""
    kfs, lms = state.kfs, state.lms
    fr = kfs.frames
    Kn, N = fr.landmark.shape
    M = min(cfg.mapping_tri_keyframes + 1, Kn)  # +1: window includes newest
    slots, slot_ok = _hybrid_slots(cfg, kfs, new_slot, M, lms.valid.shape[0])
    new_f = jax.tree.map(lambda x: x[new_slot], fr)
    tgt_valid = new_f.kp_valid & (new_f.landmark < 0)
    P_new = cam.Kopt @ projection_matrix(new_f.rvec, new_f.tvec)

    def one_pair(old_slot, ok):
        old_f = jax.tree.map(lambda x: x[old_slot], fr)
        usable = (old_slot != new_slot) & ok
        src_valid = old_f.kp_valid & (old_f.landmark < 0) & usable
        res = match_features(
            old_f.desc, old_f.xy, src_valid,
            new_f.desc, new_f.xy, tgt_valid,
            min_radius=cfg.match_min_radius,
            max_radius=cfg.mapping_max_radius,
            max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
        uv0 = old_f.xy
        uv1 = new_f.xy[jnp.where(res.mask, res.idx, 0)]
        P0 = cam.Kopt @ projection_matrix(old_f.rvec, old_f.tvec)
        X = triangulate_pair(P0, P_new, uv0, uv1)
        F = fundamental_from_poses(cam.Kopt, old_f.rvec, old_f.tvec,
                                   cam.Kopt, new_f.rvec, new_f.tvec)
        keep = filter_matches_epipolar(
            F, uv0, uv1, X, old_f.rvec, old_f.tvec, new_f.rvec, new_f.tvec,
            cfg.epipolar_max_error, valid=res.mask)
        return res.idx, keep, X

    idxs, keeps, Xs = jax.vmap(one_pair)(slots, slot_ok)  # [M,N],[M,N],[M,N,3]

    # conflict resolution: per new-KF keypoint, the OLDEST keyframe's match
    # wins (the reference processes keyframes serially so earlier ones claim
    # targets first), as a one-hot column min
    prio = jnp.where(slot_ok, fr.frame_no[slots], 2**30)  # [M]
    tgt = jnp.where(keeps, idxs, N)                        # [M,N]
    cand_prio = jnp.broadcast_to(prio[:, None], tgt.shape)
    onehot = tgt.reshape(-1)[:, None] == jnp.arange(
        N + 1, dtype=jnp.int32)[None, :]                   # [M*N, N+1]
    best_prio = jnp.min(
        jnp.where(onehot, cand_prio.reshape(-1)[:, None], 2**30), axis=0)
    winner = keeps & (cand_prio == best_prio[tgt])

    # bulk insert all winners
    flat_keep = winner.reshape(-1)
    flat_tgt = jnp.where(flat_keep, tgt.reshape(-1), 0)
    lms, ids = add_landmarks(
        lms, Xs.reshape(-1, 3), new_f.desc[flat_tgt], flat_keep,
        jnp.full_like(flat_tgt, 2), colors=new_f.color[flat_tgt])
    # stack the old-keyframe observation descriptor too (candidate (k, i)
    # gathers from the windowed keyframe set)
    src_desc = fr.desc[slots].reshape(-1, fr.desc.shape[-1])
    src_color = fr.color[slots].reshape(-1, 3)
    lms = add_descriptors(lms, jnp.where(ids >= 0, ids, -1), src_desc,
                          colors=src_color)
    ok = ids >= 0

    # link old keyframes: candidate (k, i) -> ids at global flat index
    glob = (slots[:, None] * N
            + jnp.broadcast_to(jnp.arange(N)[None, :], (M, N))).reshape(-1)
    landmark = fr.landmark.reshape(-1).at[
        jnp.where(ok, glob, Kn * N)].set(ids, mode="drop").reshape(Kn, N)
    # link the new keyframe: target j -> ids
    new_links = landmark[new_slot].at[
        jnp.where(ok, tgt.reshape(-1), N)].set(ids, mode="drop")
    landmark = landmark.at[new_slot].set(new_links)
    kfs = kfs._replace(frames=fr._replace(landmark=landmark))
    return state._replace(kfs=kfs, lms=lms)


def _reobserve_all(cfg: SfMConfig, cam: CameraParams, state: SfMState,
                   new_slot) -> SfMState:
    """Batched re-observation over the covisible/recent keyframe window
    (chunked vmap).  The window anchors on the new keyframe: the landmarks
    just triangulated live around its view, so its covisible neighbors are
    where re-observation pays.

    With ``mapping_reobs_capacity`` > 0 the landmark axis is first
    compacted to the landmarks visible in >= 1 window keyframe: the
    matcher's [L, N] Hamming matrix grows with the map capacity while
    only a few thousand landmarks are actually in view.
    Overflowing candidates simply skip re-observation this pass (they
    retry on the next keyframe — opportunistic, not a correctness drop)."""
    kfs, lms = state.kfs, state.lms
    fr = kfs.frames
    Kn, N = fr.landmark.shape
    L = lms.valid.shape[0]
    H, W = cfg.image_size
    rep = state.rep_desc
    R = min(cfg.mapping_reobs_keyframes, Kn)
    slots, slot_ok = _window_slots(cfg, kfs, new_slot, R, L)

    Lc = cfg.mapping_reobs_capacity
    if 0 < Lc < L:
        # union candidacy over the window: projections are cheap compared
        # to the Hamming matrix the compaction shrinks
        def vis(slot, ok_slot):
            rvec, tvec = fr.rvec[slot], fr.tvec[slot]
            proj = project(cam.Kopt, rvec, tvec, lms.xyz)
            depth = depths(rvec, tvec, lms.xyz)
            return ((proj[:, 0] >= 0) & (proj[:, 0] < W) &
                    (proj[:, 1] >= 0) & (proj[:, 1] < H) & (depth > 0)
                    & ok_slot)
        in_any = jnp.any(jax.vmap(vis)(slots, slot_ok), axis=0)
        from ..ba.core import compact_landmarks
        _, inv = compact_landmarks(lms.valid & in_any, Lc)
        sel = jnp.where(inv >= 0, inv, 0)
        lm_ids = jnp.where(inv >= 0, inv, L)    # L = OOB drop sentinel
        xyz_m, rep_m = lms.xyz[sel], rep[sel]
        valid_m = inv >= 0
    else:
        lm_ids = jnp.arange(L, dtype=jnp.int32)
        xyz_m, rep_m, valid_m = lms.xyz, rep, lms.valid

    def one(slot, ok_slot):
        f = jax.tree.map(lambda x: x[slot], fr)
        linked = f.landmark >= 0
        # OOB sentinel + constant value: see tracking.widen_tracks
        already_full = jnp.zeros((L + 1,), bool).at[
            jnp.where(linked, f.landmark, L)].set(True, mode="drop")
        already = already_full[jnp.minimum(lm_ids, L)]
        proj = project(cam.Kopt, f.rvec, f.tvec, xyz_m)
        depth = depths(f.rvec, f.tvec, xyz_m)
        in_img = ((proj[:, 0] >= 0) & (proj[:, 0] < W) &
                  (proj[:, 1] >= 0) & (proj[:, 1] < H) & (depth > 0))
        cand = valid_m & ~already & in_img & ok_slot
        res = match_features(
            rep_m, proj, cand, f.desc, f.xy, f.kp_valid & ~linked,
            min_radius=0.0, max_radius=cfg.max_reproj_error,
            max_distance=cfg.match_max_distance, ratio=cfg.match_ratio,
            window_center0=proj)
        ok = res.mask
        links = f.landmark.at[
            jnp.where(ok, res.idx, N)].set(lm_ids, mode="drop")
        return links

    chunk = max(d for d in range(1, min(_REOBS_CHUNK, R) + 1) if R % d == 0)
    links_w = jax.lax.map(
        lambda sc: jax.vmap(one)(sc[0], sc[1]),
        (slots.reshape(-1, chunk), slot_ok.reshape(-1, chunk)))
    links_w = links_w.reshape(R, N)

    # newly created links get their observing frame's descriptor + color
    old_links_w = fr.landmark[slots]
    newly = (links_w >= 0) & (old_links_w < 0)
    flat_ids = jnp.where(newly, links_w, -1).reshape(-1)
    lms = add_descriptors(lms, flat_ids,
                          fr.desc[slots].reshape(-1, fr.desc.shape[-1]),
                          colors=fr.color[slots].reshape(-1, 3))
    # scatter window rows back (invalid window rows dropped)
    landmark = fr.landmark.at[
        jnp.where(slot_ok, slots, Kn)].set(links_w, mode="drop")
    kfs = kfs._replace(frames=fr._replace(landmark=landmark))
    return state._replace(kfs=kfs, lms=lms)


def mapping_pass(cfg: SfMConfig, cam: CameraParams, state: SfMState,
                 new_slot) -> SfMState:
    L = cfg.max_landmarks

    # 1. batched pairwise triangulation
    state = _triangulate_all_pairs(cfg, cam, state, new_slot)

    # 2. batched re-observation pass
    state = _reobserve_all(cfg, cam, state, new_slot)

    # 3. landmark culling + link clearing (CSfM.cpp:237, 692-706)
    views = kf_view_counts(state.kfs, L)
    lms, tomb = cull_landmarks(
        state.lms, views, min_views=cfg.cull_min_views,
        young_age=cfg.cull_young_kf_age, view_ratio=cfg.cull_view_ratio)
    fr = state.kfs.frames
    landmark = jax.vmap(clear_links, in_axes=(0, None))(fr.landmark, tomb)
    kfs = state.kfs._replace(frames=fr._replace(landmark=landmark))
    prev = state.prev._replace(
        landmark=clear_links(state.prev.landmark, tomb))

    # 4. keyframe culling (CSfM.cpp:245, 708-752)
    kfs, _ = cull_keyframes(
        kfs, L, redundancy=cfg.kf_cull_redundancy,
        min_others=cfg.kf_cull_min_others)

    # 5. full-map BA, gauge-fixed on the oldest keyframe (CSfM.cpp:250-259);
    #    with ba_local_window > 0 only the most recent poses are free.
    #    On the large solver, observations are ALSO restricted to a 2x
    #    window of recent keyframes (free recents + an equal anchor band
    #    of fixed older ones): the periodic global BA handles long-range
    #    consistency, and the full K x N observation list made the table
    #    build scale with capacity, not with the local problem
    oldest = jnp.argmin(jnp.where(kfs.valid, kfs.frames.frame_no, 2**30))
    cam_free = kfs.valid.at[oldest].set(False)
    local_obs_window = cfg.ba_solver == "large" and cfg.ba_local_window > 0
    if local_obs_window:
        from ..ba.core import observations_from_keyframe_window
        Wn = min(2 * cfg.ba_local_window, cfg.max_keyframes)
        w_slots, w_ok = _recent_valid_slots(kfs, Wn)
        obs = observations_from_keyframe_window(kfs, lms.valid,
                                                w_slots, w_ok)
    else:
        obs = observations_from_keyframes(kfs, lms.valid)
    if cfg.ba_local_window > 0:
        recent, recent_ok = _recent_valid_slots(
            kfs, min(cfg.ba_local_window, cfg.max_keyframes))
        in_window = jnp.zeros_like(kfs.valid).at[
            jnp.where(recent_ok, recent, cfg.max_keyframes)].set(
                True, mode="drop")
        cam_free = cam_free & in_window

    # optional landmark-axis compaction: only live landmarks enter the
    # normal equations (cuts the dense solver's [C, L, 6, 3] coupling and
    # every other landmark-side tensor by max_landmarks/capacity).  With
    # the local observation window, compaction ranks only the landmarks
    # the window actually observes
    ba_valid = lms.valid
    if local_obs_window:
        L_ = lms.valid.shape[0]
        ba_valid = lms.valid & jnp.zeros_like(lms.valid).at[
            jnp.where(obs.w > 0, obs.lm_idx, L_)].set(True, mode="drop")
    ba_xyz, ba_lm_free, ba_obs = lms.xyz, ba_valid, obs
    inv = None
    if 0 < cfg.ba_landmark_capacity < cfg.max_landmarks:
        ba_xyz, ba_lm_free, ba_obs, inv = compact_ba_problem(
            lms.xyz, ba_valid, obs, cfg.ba_landmark_capacity)

    if cfg.ba_solver == "large":
        # device-built tables + implicit-Schur PCG: the mapping-pass BA
        # at 500+-keyframe capacities
        from ..ba.large import build_tables_device, run_large_ba
        tables, n_dropped = build_tables_device(
            ba_obs, cfg.max_keyframes, ba_xyz.shape[0],
            nmax=cfg.max_keypoints, kmax=cfg.ba_kmax)
        state = state._replace(ba_dropped_obs=n_dropped)
        rv, tv, xyz, stats = run_large_ba(
            cam.Kopt, kfs.frames.rvec, kfs.frames.tvec, ba_xyz, tables,
            cam_free=cam_free, lm_free=ba_lm_free,
            iterations=cfg.ba_iterations,
            cg_iterations=cfg.ba_cg_iterations,
            lam0=cfg.ba_lambda_init, lam_up=cfg.ba_lambda_up,
            lam_down=cfg.ba_lambda_down, huber_delta=cfg.ba_huber_delta,
            tol=cfg.ba_tol)
    elif cfg.ba_solver == "cg":
        rv, tv, xyz, stats = run_ba_cg(
            cam.Kopt, kfs.frames.rvec, kfs.frames.tvec, ba_xyz, ba_obs,
            cam_free=cam_free, lm_free=ba_lm_free,
            iterations=cfg.ba_iterations,
            cg_iterations=cfg.ba_cg_iterations,
            lam0=cfg.ba_lambda_init, lam_up=cfg.ba_lambda_up,
            lam_down=cfg.ba_lambda_down, huber_delta=cfg.ba_huber_delta,
            tol=cfg.ba_tol)
    else:
        rv, tv, xyz, stats = run_ba(
            cam.Kopt, kfs.frames.rvec, kfs.frames.tvec, ba_xyz, ba_obs,
            cam_free=cam_free, lm_free=ba_lm_free,
            mode=BAMode.STRUCT_AND_POSE, iterations=cfg.ba_iterations,
            lam0=cfg.ba_lambda_init, lam_up=cfg.ba_lambda_up,
            lam_down=cfg.ba_lambda_down, huber_delta=cfg.ba_huber_delta,
            tol=cfg.ba_tol,
            # scatter-free assembly (the obs list is keyframe-ordered):
            # only on the compacted landmark axis, where the [O, L]
            # one-hot pays for itself; small problems keep the scatter
            # path (fast enough there, and its accumulation order is
            # independent of the host backend's GEMM partitioning)
            cam_major=inv is not None)
    if inv is not None:
        xyz = scatter_back_landmarks(lms.xyz, xyz, inv)
    kfs = kfs._replace(frames=kfs.frames._replace(rvec=rv, tvec=tv))
    lms = lms._replace(xyz=xyz)

    # 6. age the map in keyframes (CSfM.cpp:304)
    lms = increment_age(lms, 0, 1)
    return state._replace(kfs=kfs, lms=lms, prev=prev,
                          rep_desc=representative_descriptors(lms))

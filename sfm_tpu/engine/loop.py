"""Loop-closure detection and correction.

The reference has no loop closure at all (its covisibility graph is
commented out, /root/reference/CMap.h:94-95, and recovery() is a stub,
CSfM.cpp:774-778) — this module is a beat-the-reference capability built
from parts the engine already has:

 1. DETECT (jitted ``loop_probe``): globally match a new keyframe's
    unlinked detections against the representative descriptors of OLD
    landmarks (created >= ``min_age`` keyframes ago) — the reloc
    machinery's windowless match — and PnP-RANSAC a pose against the old
    map.  A confident pose that disagrees with the keyframe's odometry
    pose by more than the drift gate IS a detected loop.
 2. CORRECT (host ``close_loop``): monocular odometry accumulates drift
    along the excursion; the PnP pose pins the loop keyframe to the
    old-map frame.  The per-keyframe correction is interpolated in SE(3)
    (log-linear in chain position — the single-loop special case of
    pose-graph relaxation), applied to every keyframe after the loop
    start era.
 3. RESTRUCTURE: landmarks are re-triangulated from their (corrected)
    observing keyframes via a vmapped DLT, the detected old-landmark
    links are written into the loop keyframe, and a global BA polish
    distributes the remaining error (engine/global_ba.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SfMConfig
from ..features.match import match_features
from ..geometry.triangulate import projection_matrix
from ..ransac import ransac_pnp
from .state import SfMState, CameraParams


class LoopProbe(NamedTuple):
    ok: jnp.ndarray          # confident old-map pose found
    rvec: jnp.ndarray        # [3] PnP pose in the old-map frame
    tvec: jnp.ndarray        # [3]
    n_inliers: jnp.ndarray
    drift: jnp.ndarray       # camera-center disagreement odo vs PnP (m)
    links: jnp.ndarray       # [N] landmark id per keyframe keypoint (-1)
    min_lm_birth: jnp.ndarray  # oldest matched landmark's birth keyframe
    scale: jnp.ndarray       # monocular scale-drift estimate s
                             # (x_old ~ s * x_drift); 1.0 when unreliable
    scale_ok: jnp.ndarray    # pair-based estimate passed count+dispersion
    n_pairs: jnp.ndarray     # old<->current landmark pairs behind it


def build_loop_probe(cfg: SfMConfig, cam: CameraParams):
    """Jitted (state, kf_slot) -> LoopProbe."""

    def probe(state: SfMState, slot) -> LoopProbe:
        lms, fr = state.lms, state.kfs.frames
        desc = fr.desc[slot]
        xy = fr.xy[slot]
        kp_valid = fr.kp_valid[slot] & (fr.landmark[slot] < 0)
        # candidates: live landmarks old enough to be a different era.
        # Landmarks the mapping pass already re-observed in this keyframe
        # STAY in the candidate set — they anchor the PnP against
        # texture aliasing (excluding them measurably let a coherent
        # aliased cluster win RANSAC on the ring bench: a 148 m spurious
        # "closure") — but are masked out of the LINK writing below so a
        # second match can never duplicate a per-camera observation
        L0 = lms.valid.shape[0]
        kf_links = fr.landmark[slot]
        already = jnp.zeros((L0,), bool).at[
            jnp.where(kf_links >= 0, kf_links, L0)].set(True, mode="drop")
        old = lms.valid & (lms.kf_alive >= cfg.loop_min_age)
        res = match_features(
            state.rep_desc, jnp.zeros((lms.valid.shape[0], 2)), old,
            desc, xy, kp_valid,
            min_radius=0.0, max_radius=1e9,
            max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
        uv = xy[jnp.where(res.mask, res.idx, 0)]
        key = jax.random.fold_in(state.key, 17)
        pnp = ransac_pnp(
            key, cam.Kopt, lms.xyz, uv, res.mask & old,
            n_hypotheses=cfg.pnp_hypotheses,
            sample_size=cfg.pnp_sample_size,
            threshold=cfg.max_reproj_error,
            refine_iters=cfg.pnp_refine_iters,
            min_inliers=cfg.loop_min_inliers, solver=cfg.reloc_solver)
        N = xy.shape[0]
        L = lms.valid.shape[0]
        lm_ids = jnp.arange(L, dtype=jnp.int32)
        links = jnp.full((N,), -1, jnp.int32).at[
            jnp.where(pnp.inliers & ~already, res.idx, N)].set(
                lm_ids, mode="drop")
        # drift gate: the PnP pose must disagree with the odometry pose
        # (else this is ordinary re-observation, nothing to correct)
        c_pnp = -(projection_matrix(pnp.rvec, pnp.tvec)[:, :3].T
                  @ pnp.tvec)
        c_odo = -(projection_matrix(fr.rvec[slot], fr.tvec[slot])[:, :3].T
                  @ fr.tvec[slot])
        moved = jnp.linalg.norm(c_pnp - c_odo)
        # birth keyframe rank of the oldest inlier landmark: the loop
        # start era (kf_alive counts keyframes since creation; res rows
        # are landmark-indexed, so the inlier mask aligns per landmark)
        n_kf_now = jnp.sum(state.kfs.valid)
        birth_min = jnp.min(jnp.where(
            (res.mask & old & pnp.inliers), n_kf_now - lms.kf_alive, 2**30))

        # monocular scale-drift estimate v2 (round 5): match OLD
        # landmarks against the keyframe's LINKED keypoints too — a
        # linked keypoint whose descriptor matches an old landmark pins
        # the SAME physical point in both maps (old position X_o, and
        # its current-era twin X_c through the keypoint's link).  The
        # scale is then the robust median of PAIRWISE-DISTANCE ratios
        # |X_o_i - X_o_j| / |X_c_i - X_c_j|, which is invariant to the
        # SE(3) part of the drift.  (The round-4 median-depth-ratio
        # estimate compared two DIFFERENT landmark populations and
        # measured unreliable — an honest negative result this replaces.)
        from ..geometry.camera import project, depths as cam_depths
        kp_linked = fr.kp_valid[slot] & (fr.landmark[slot] >= 0)
        res2 = match_features(
            state.rep_desc, jnp.zeros((L, 2)), old,
            desc, xy, kp_linked,
            min_radius=0.0, max_radius=1e9,
            max_distance=cfg.match_max_distance, ratio=cfg.match_ratio)
        kp2 = jnp.where(res2.mask, res2.idx, 0)
        cur_ids = fr.landmark[slot][kp2]
        # geometric gate: the old landmark must reproject onto the
        # matched keypoint under the PnP (old-map) pose
        proj_old = project(cam.Kopt, pnp.rvec, pnp.tvec, lms.xyz)
        gerr = jnp.linalg.norm(proj_old - xy[kp2], axis=-1)
        z_old = cam_depths(pnp.rvec, pnp.tvec, lms.xyz)
        safe_cur = jnp.where(cur_ids >= 0, cur_ids, 0)
        pair_ok = (res2.mask & old & pnp.ok & (z_old > 0)
                   & (gerr < 2.0 * cfg.max_reproj_error)
                   & (cur_ids >= 0) & lms.valid[safe_cur]
                   & (lms.kf_alive[safe_cur] < cfg.loop_min_age)
                   & (safe_cur != lm_ids))
        s, s_ok, n_pairs = _scale_from_pairs(
            lms.xyz, lms.xyz[safe_cur], pair_ok,
            min_pairs=cfg.loop_scale_min_pairs,
            max_dispersion=cfg.loop_scale_max_dispersion)
        return LoopProbe(
            ok=pnp.ok & (moved > cfg.loop_min_drift),
            rvec=pnp.rvec, tvec=pnp.tvec,
            n_inliers=pnp.n_inliers, drift=moved,
            links=links, min_lm_birth=birth_min, scale=s,
            scale_ok=s_ok, n_pairs=n_pairs)

    return probe


def _scale_from_pairs(Xo, Xc, mask, *, min_pairs: int = 8,
                      max_dispersion: float = 0.15, n_keep: int = 64):
    """Robust monocular scale from old<->current positions of the SAME
    physical points: median over pairs (i, j) of
    |Xo_i - Xo_j| / |Xc_i - Xc_j|.  Returns (s, ok, n_point_pairs); s is
    1.0 (identity) whenever the estimate fails its count or dispersion
    gate, so callers can apply it unconditionally."""
    order = jnp.argsort(~mask)              # matched rows first (stable)
    idx = order[:n_keep]
    m = mask[idx]
    xo, xc = Xo[idx], Xc[idx]
    ratios, valid = [], []
    for shift in (1, 2, 3, 5, 8, 13, 21):
        xo2 = jnp.roll(xo, shift, axis=0)
        xc2 = jnp.roll(xc, shift, axis=0)
        m2 = jnp.roll(m, shift)
        do = jnp.linalg.norm(xo - xo2, axis=-1)
        dc = jnp.linalg.norm(xc - xc2, axis=-1)
        ratios.append(do / jnp.maximum(dc, 1e-9))
        valid.append(m & m2 & (do > 1e-6) & (dc > 1e-6))
    r = jnp.concatenate(ratios)
    v = jnp.concatenate(valid)
    med = _masked_median(r, v)
    mad = _masked_median(jnp.abs(r - med), v)
    n_points = jnp.sum(mask)
    ok = ((n_points >= min_pairs) & jnp.isfinite(med)
          & (mad <= max_dispersion * med)
          & (med > 0.4) & (med < 2.5))
    s = jnp.where(ok, jnp.clip(med, 0.4, 2.5), 1.0)
    return s, ok, n_points


def _masked_median(vals, mask):
    """NaN-free masked (lower) median: sort with a +inf sentinel for
    masked-out lanes and gather the element at floor((count-1)/2) —
    keeps jitted loop probes clean under jax_debug_nans (the repo's
    sanitizer contract, tests/test_sanitizers.py)."""
    srt = jnp.sort(jnp.where(mask, vals, jnp.inf))
    cnt = jnp.sum(mask)
    idx = jnp.clip((cnt - 1) // 2, 0, vals.shape[0] - 1)
    return jnp.where(cnt > 0, srt[idx], jnp.inf)


# ------------------------------------------------------------- SE3 helpers

def _rodr(r):
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _log_so3(R):
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(c)
    if th < 1e-9:
        return np.zeros(3)
    if th > np.pi - 1e-4:
        # near pi the standard formula's sin(th) denominator vanishes —
        # recover the axis from the diagonal: (R + I)/2 == k k^T at pi,
        # signs of the minor components from the off-diagonals (same
        # stabilization the BA rotation code uses)
        A = (R + np.eye(3)) / 2
        k = np.sqrt(np.maximum(np.diag(A), 0.0))
        i = int(np.argmax(k))
        j, l = (i + 1) % 3, (i + 2) % 3
        k[j] = A[i, j] / max(k[i], 1e-12)
        k[l] = A[i, l] / max(k[i], 1e-12)
        n = np.linalg.norm(k)
        k = k / max(n, 1e-12)
        # resolve the overall sign (k and -k both satisfy kk^T) from the
        # skew part, which is ~2 sin(th) k and still carries the sign
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        if np.dot(w, k) < 0:
            k = -k
        return th * k
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def interpolate_corrections(rv, tv, fracs, d_rvec, d_tvec, scale=1.0):
    """Apply the fraction-scaled world-frame sim(3) correction to each
    pose.

    The full correction maps drifted world coords to old-map world
    coords: x_old = s·dR x_drift + dt (s = monocular scale-drift factor;
    1.0 gives the SE(3) special case).  At fraction a the family is
    (s^a, exp(a·log dR), a·dt) — continuous from identity (a=0) to the
    full correction (a=1).  Pose i (x_cam = R_i x + t_i) becomes
    R_i' = R_i dRa^T and camera center c_i' = s_a·dRa·c_i + a·dt, i.e.
    t_i' = -R_i' c_i'.  (Rotation parts of poses are scale-free; the
    scale enters through the centers and, downstream, through landmark
    re-triangulation.)"""
    dR = _rodr(d_rvec)
    w = _log_so3(dR)
    out_r = np.empty_like(rv)
    out_t = np.empty_like(tv)
    for i in range(len(rv)):
        a = float(fracs[i])
        if a == 0.0:
            # identity correction: leave the pose bit-exact (and avoid a
            # needless _rodr/_log_so3 round-trip on poses the closure
            # does not touch)
            out_r[i] = rv[i]
            out_t[i] = tv[i]
            continue
        dRi = _rodr(w * a)
        si = float(scale) ** a
        Ri = _rodr(rv[i])
        ci = -Ri.T @ tv[i]
        Rn = Ri @ dRi.T
        cn = si * (dRi @ ci) + a * d_tvec
        out_r[i] = _log_so3(Rn)
        out_t[i] = -Rn @ cn
    return out_r, out_t


def retriangulate_landmarks(cfg: SfMConfig, cam: CameraParams,
                            state: SfMState) -> SfMState:
    """Re-triangulate every multi-view landmark from its observing
    keyframes' (corrected) poses — a vmapped homogeneous DLT over the
    landmark-major observation tables.  Landmarks with < 2 observations
    keep their positions."""
    from ..ba import observations_from_keyframes
    from ..ba.large import build_lm_tables_device

    lms, kfs = state.lms, state.kfs
    L = lms.valid.shape[0]
    obs = observations_from_keyframes(kfs, lms.valid)
    lm_cam, lm_uv, lm_w, _ = build_lm_tables_device(
        obs, L, kmax=cfg.ba_kmax)

    Kopt = cam.Kopt

    def tri_one(cams, uvs, w):
        # DLT rows: for each obs, u * P3 - P1, v * P3 - P2 (P = K [R|t])
        def rows(c, uv, wi):
            P = Kopt @ projection_matrix(kfs.frames.rvec[c],
                                         kfs.frames.tvec[c])
            r1 = uv[0] * P[2] - P[0]
            r2 = uv[1] * P[2] - P[1]
            return jnp.stack([r1, r2]) * wi

        A = jax.vmap(rows)(cams, uvs, w).reshape(-1, 4)       # [2k, 4]
        AtA = A.T @ A
        # inhomogeneous solve: X = -inv(A[:, :3]) rhs with Tikhonov guard
        M = AtA[:3, :3] + 1e-6 * jnp.eye(3)
        rhs = AtA[:3, 3]
        X = -jnp.linalg.solve(M, rhs)
        return X

    xyz_new = jax.vmap(tri_one)(lm_cam, lm_uv, lm_w)
    n_obs = jnp.sum(lm_w > 0, axis=1)
    ok = lms.valid & (n_obs >= 2) & jnp.all(jnp.isfinite(xyz_new), axis=1)
    xyz = jnp.where(ok[:, None], xyz_new, lms.xyz)
    return state._replace(lms=lms._replace(xyz=xyz))


def _start_frame(fns, valid, probe) -> int:
    """Frame number where a closure's interpolation starts: the birth-era
    keyframe of the oldest matched landmark."""
    order = np.argsort(np.where(valid, fns, 2**30))
    n_valid = int(valid.sum())
    birth_rank = max(0, min(int(np.asarray(probe.min_lm_birth)),
                            n_valid - 1))
    return int(fns[order[birth_rank]])


def close_loop(cfg: SfMConfig, cam: CameraParams, state: SfMState,
               slot: int, probe: LoopProbe,
               corrected_spans=None) -> SfMState:
    """Host-level loop correction: interpolate the sim(3)/SE(3) drift
    correction along the keyframe chain, write the detected old-landmark
    links into the loop keyframe, re-triangulate, and return the
    corrected state (callers should run global BA afterwards).

    Multi-loop scoping (round 5, both points measured on the ring
    bench): each closure's SPAN is set by its matched-landmark birth
    era, never clamped by previous closures — consecutive closures at a
    revisit carry better information about the SAME drifted span and
    must re-correct it (clamping measured 0.35 -> 1.45 m end drift),
    while a genuinely disjoint second loop (figure-8 second lobe)
    matches landmarks born after the first closure, so its span starts
    there automatically.  The SCALE component, by contrast, is
    first-contact-only: pass ``corrected_spans`` (list of closed
    (start_fn, loop_fn) pairs) and any overlap forces the SE(3) special
    case (re-applying a scale ramp over an already-corrected span
    measured 0.35 -> 2.42 m)."""
    kfs = state.kfs
    valid = np.asarray(kfs.valid)
    fns = np.asarray(kfs.frames.frame_no)
    rv = np.asarray(kfs.frames.rvec).copy()
    tv = np.asarray(kfs.frames.tvec).copy()

    # correction at the loop keyframe: x_old = dR x + dt from the pose
    # pair (odometry vs PnP): R_p x + t_p == R_o (dR^T (x - ...)) —
    # solve dR = R_o^T R_p? Define via camera-to-world:
    # world_old = T_pnp^-1 cam, world_drift = T_odo^-1 cam
    # -> world_old = (T_pnp^-1 T_odo) world_drift
    # Same physical camera, two world frames: x_cam = R_o x_drift + t_o
    # (odometry) and x_cam = R_p x_old + t_p (PnP vs the old map).  The
    # sim(3) correction x_old = s·dR x_drift + dt uses the probe's
    # monocular scale-drift estimate s; rotation dR = R_p^T R_o, and dt
    # is fixed by the camera-center constraint c_pnp = s·dR·c_odo + dt.
    R_o = _rodr(rv[slot])
    t_o = tv[slot]
    R_p = _rodr(np.asarray(probe.rvec))
    t_p = np.asarray(probe.tvec)
    dR = R_p.T @ R_o
    s = float(np.asarray(probe.scale)) if cfg.loop_use_scale else 1.0
    # scale is FIRST-CONTACT-ONLY information: once a span has been
    # closed (+ re-triangulated + BA'd), its scale is pinned to the old
    # map; a later closure's pair estimate over the same span mixes
    # already-corrected and still-drifted structure, and re-applying a
    # scale ramp measurably reintroduces error (ring bench: 0.35 ->
    # 1.45-2.42 m end drift).  Callers pass corrected_spans; overlap
    # forces the SE(3) special case.
    if corrected_spans:
        loop_fn_i = int(fns[slot])
        start_probe = _start_frame(fns, valid, probe)
        for a, b in corrected_spans:
            if start_probe <= b and loop_fn_i >= a:
                s = 1.0
                break
    c_odo = -R_o.T @ t_o
    c_pnp = -R_p.T @ t_p
    dt = c_pnp - s * (dR @ c_odo)
    d_rvec = _log_so3(dR)

    # chain fractions: 0 at the loop-start era, 1 at the loop keyframe
    loop_fn = fns[slot]
    # oldest matched landmark's era keyframe (by insertion order)
    order = np.argsort(np.where(valid, fns, 2**30))
    n_valid = int(valid.sum())
    birth_rank = int(np.asarray(probe.min_lm_birth))
    birth_rank = max(0, min(birth_rank, n_valid - 1))
    start_fn = int(fns[order[birth_rank]])
    span = max(float(loop_fn - start_fn), 1.0)
    fracs = np.clip((fns - start_fn) / span, 0.0, 1.0) * valid
    rv2, tv2 = interpolate_corrections(rv, tv, fracs, d_rvec, dt, scale=s)

    frames = kfs.frames._replace(rvec=jnp.asarray(rv2.astype(np.float32)),
                                 tvec=jnp.asarray(tv2.astype(np.float32)))
    # write the loop links into the keyframe (old landmarks observed)
    links = np.asarray(kfs.frames.landmark).copy()
    new_links = np.asarray(probe.links)
    take = new_links >= 0
    links[slot][take] = new_links[take]
    frames = frames._replace(landmark=jnp.asarray(links))
    state = state._replace(kfs=kfs._replace(frames=frames))
    state = retriangulate_landmarks(cfg, cam, state)
    # the reference frame is temporally at/after the loop keyframe: apply
    # the full correction so the next tracking step's pose prior lives in
    # the corrected world frame (else the prior is off by the whole loop
    # correction and tracking would drop to relocalization)
    prev = state.prev
    pr, pt = interpolate_corrections(
        np.asarray(prev.rvec)[None], np.asarray(prev.tvec)[None],
        np.ones(1), d_rvec, dt, scale=s)
    prev = prev._replace(rvec=jnp.asarray(pr[0].astype(np.float32)),
                         tvec=jnp.asarray(pt[0].astype(np.float32)))
    state = state._replace(prev=prev)
    return state

"""Synthetic textured-sprite scan generator (shared by tests and benchmarks).

Replaces the reference's eyeball test on tissuebox.mov (main/main.cpp:39)
with a known-trajectory synthetic scan: textured square sprites at random
3D positions, rendered with painter's-algorithm z-ordering, viewed by a
camera on a known trajectory -> ATE is measurable."""

from __future__ import annotations

import numpy as np

from .np_geometry import rodrigues_np


class SpriteScene:
    def __init__(self, rng, n_sprites=140, spread=2.0, depth=(4.0, 7.0),
                 tex_res=6, sprite_size=0.4):
        self.centers = np.stack([
            rng.uniform(-spread, spread, n_sprites),
            rng.uniform(-spread * 0.75, spread * 0.75, n_sprites),
            rng.uniform(depth[0], depth[1], n_sprites)], axis=1)
        self.textures = rng.uniform(40, 250, (n_sprites, tex_res, tex_res))
        # per-sprite RGB tint for the color rendering path (distinct hues
        # so guidance's H-S histogram has something to segment)
        self.tints = rng.uniform(0.35, 1.0, (n_sprites, 3))
        self.size = sprite_size
        self.tex_res = tex_res

    def render(self, K, rvec, tvec, h, w, dist=None, rgb=False):
        """Render one frame: sprites are world-frontoparallel textured
        squares, painted far-to-near.  ``dist`` optionally applies the
        radial-tangential model (k1,k2,p1,p2,k3) to sprite centers so the
        engine's undistortion path can be exercised end-to-end.
        ``rgb=True`` returns [h, w, 3] with per-sprite color tints."""
        R = rodrigues_np(np.asarray(rvec, np.float64))
        t = np.asarray(tvec, np.float64)
        cam = self.centers @ R.T + t
        img = np.full((h, w, 3) if rgb else (h, w), 25.0, np.float32)
        order = np.argsort(-cam[:, 2])  # far first
        fx, fy = K[0, 0], K[1, 1]
        for i in order:
            z = cam[i, 2]
            if z < 0.5:
                continue
            xn, yn = cam[i, 0] / z, cam[i, 1] / z
            if dist is not None:
                k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
                r2 = xn * xn + yn * yn
                radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
                xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
                yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
                xn, yn = xd, yd
            u = fx * xn + K[0, 2]
            v = fy * yn + K[1, 2]
            half_u = fx * self.size / z / 2
            half_v = fy * self.size / z / 2
            u0, u1 = int(u - half_u), int(u + half_u)
            v0, v1 = int(v - half_v), int(v + half_v)
            if u1 <= 0 or v1 <= 0 or u0 >= w or v0 >= h or u1 <= u0 or v1 <= v0:
                continue
            cu0, cv0 = max(u0, 0), max(v0, 0)
            cu1, cv1 = min(u1, w), min(v1, h)
            tex = self.textures[i]
            ty = ((np.arange(cv0, cv1) - v0) * self.tex_res // max(v1 - v0, 1))
            tx = ((np.arange(cu0, cu1) - u0) * self.tex_res // max(u1 - u0, 1))
            ty = np.clip(ty, 0, self.tex_res - 1)
            tx = np.clip(tx, 0, self.tex_res - 1)
            patch = tex[np.ix_(ty, tx)]
            if rgb:
                img[cv0:cv1, cu0:cu1] = patch[:, :, None] * self.tints[i]
            else:
                img[cv0:cv1, cu0:cu1] = patch
        return img


def degrade(img, rng, noise_std=0.0, blur_len=0, occlusion=0.0):
    """Degradation model for robustness tests (SURVEY.md §4.3 — replaces
    the reference's eyeball tolerance of real-video artifacts):
    horizontal motion blur (box kernel of ``blur_len`` px), additive
    Gaussian photometric noise, and one random dark rectangle covering
    ``occlusion`` of the image area."""
    out = np.asarray(img, np.float32).copy()
    if blur_len > 1:
        k = np.ones(blur_len, np.float32) / blur_len
        if out.ndim == 2:
            out = np.stack([np.convolve(row, k, mode="same") for row in out])
        else:
            for c in range(out.shape[2]):
                out[:, :, c] = np.stack(
                    [np.convolve(row, k, mode="same")
                     for row in out[:, :, c]])
    if noise_std > 0:
        out = out + rng.normal(0.0, noise_std, out.shape)
    if occlusion > 0:
        h, w = out.shape[:2]
        area = occlusion * h * w
        rh = int(np.sqrt(area * rng.uniform(0.5, 2.0)))
        rh = min(max(rh, 1), h)
        rw = min(int(area / rh), w)
        y0 = int(rng.integers(0, max(h - rh, 1)))
        x0 = int(rng.integers(0, max(w - rw, 1)))
        out[y0:y0 + rh, x0:x0 + rw] = 20.0
    return np.clip(out, 0.0, 255.0)


def strafe_trajectory(n_frames, step=0.05, yaw_rate=0.004):
    """Mostly-lateral camera motion with mild yaw: every scene point has
    nonzero optical flow (the engine's min-motion matching window, mirrored
    from the reference's 1.5 px _minMatchMotion, filters static matches).
    Returns (rvecs, tvecs) world-to-camera."""
    from .np_geometry import log_rotation
    rvecs, tvecs = [], []
    for k in range(n_frames):
        c = np.array([step * k, 0.25 * step * np.sin(0.3 * k), 0.0])
        yaw = -yaw_rate * k
        R = np.array([[np.cos(yaw), 0, -np.sin(yaw)],
                      [0, 1, 0],
                      [np.sin(yaw), 0, np.cos(yaw)]])
        tvec = -R @ c
        rvecs.append(log_rotation(R))
        tvecs.append(tvec.astype(np.float32))
    return np.asarray(rvecs, np.float32), np.asarray(tvecs, np.float32)


def umeyama_ate(est_t, gt_t):
    """Similarity-aligned (Umeyama) absolute trajectory error: monocular
    reconstructions are gauge-free, so compare up to sim(3)."""
    mu_e = est_t.mean(0); mu_g = gt_t.mean(0)
    e = est_t - mu_e; g = gt_t - mu_g
    cov = g.T @ e / len(e)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    Rot = U @ S @ Vt
    var_e = (e ** 2).sum() / len(e)
    scale = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
    resid = g - scale * e @ Rot.T
    return float(np.sqrt((resid ** 2).sum(1).mean()))


def banded_ba_problem(n_cams, n_lms, obs_per_lm, seed=0, noise_px=0.0):
    """A bundle-adjustment problem with a banded camera graph: cameras on
    a line, each landmark seen by ``obs_per_lm`` consecutive cameras.
    Returns a dict of NumPy arrays: K, the ground-truth-near start
    (rvec0, tvec0, xyz0; rotations perturbed by 2 mrad, points by 5 cm)
    and the COO observations (cam_idx, lm_idx, uv)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-50, 50, n_lms), rng.uniform(-10, 10, n_lms),
                  rng.uniform(20, 60, n_lms)], 1).astype(np.float32)
    K = np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]], np.float32)
    cam_t = np.stack([np.linspace(-40, 40, n_cams), np.zeros(n_cams),
                      np.zeros(n_cams)], 1).astype(np.float32)
    base = rng.integers(0, n_cams - obs_per_lm, n_lms)
    lm_idx = np.repeat(np.arange(n_lms), obs_per_lm).astype(np.int32)
    cam_idx = (base[:, None] + np.arange(obs_per_lm)[None, :]).reshape(-1)
    cam_idx = cam_idx.astype(np.int32)
    p = X[lm_idx] + cam_t[cam_idx]
    uv = (p[:, :2] / p[:, 2:]) * 525.0 + np.array([320.0, 240.0])
    uv = uv + rng.normal(0, noise_px, uv.shape) if noise_px else uv
    rvec0 = np.full((n_cams, 3), 0.002, np.float32)
    rvec0[0] = 0.0
    xyz0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    return dict(K=K, rvec0=rvec0, tvec0=cam_t, xyz0=xyz0, cam_idx=cam_idx,
                lm_idx=lm_idx, uv=uv.astype(np.float32))

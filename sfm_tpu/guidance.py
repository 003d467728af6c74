"""Scan guidance: object centroid + color-histogram segmentation + oriented
bounding box (CScanGuidance, SURVEY.md §2.6) as vectorized JAX image ops.

Per RUNNING frame the reference (CScanGuidance.cpp:39-105): updates the 3D
centroid, projects all landmarks (clamped to the image), downscales 4x,
builds a convex-hull mask of the projections, computes a Hue-Saturation
histogram inside the mask, EMA-blends it with history (alpha 0.9),
back-projects, thresholds by backproj/hullArea > 0.01, and fits an oriented
bbox.

Accelerator-friendly substitutions:
  - convex hull -> support-function polygon: inside(p) iff p.d_k <= max_i
    x_i.d_k for K fixed directions (exact as K grows; no sequential hull);
  - minAreaRect -> PCA of thresholded pixel coordinates (principal-axis
    oriented box).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import SfMConfig
from .geometry.camera import project

_N_HULL_DIRS = 32


class GuidanceState(NamedTuple):
    centroid: jnp.ndarray    # [3] EMA 3D object centroid
    hist: jnp.ndarray        # [bins_h, bins_s] EMA H-S histogram
    initialized: jnp.ndarray  # scalar bool


class GuidanceOutput(NamedTuple):
    centroid: jnp.ndarray    # [3]
    bbox_center: jnp.ndarray  # [2] full-res pixels
    bbox_axes: jnp.ndarray   # [2, 2] principal axes (rows, unit)
    bbox_extent: jnp.ndarray  # [2] half-lengths along the axes, pixels
    mask: jnp.ndarray        # [H/ds, W/ds] float mask (downscaled)


def init_guidance(cfg: SfMConfig) -> GuidanceState:
    return GuidanceState(
        centroid=jnp.zeros(3, jnp.float32),
        hist=jnp.zeros((cfg.guidance_hist_bins_h, cfg.guidance_hist_bins_s),
                       jnp.float32),
        initialized=jnp.asarray(False),
    )


def rgb_to_hs(rgb: jnp.ndarray):
    """RGB [..., 3] in [0, 255] -> (hue [0, 360), saturation [0, 1])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    c = mx - mn
    safe_c = jnp.where(c < 1e-6, 1.0, c)
    h = jnp.where(
        mx == r, (g - b) / safe_c % 6.0,
        jnp.where(mx == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    h = jnp.where(c < 1e-6, 0.0, h * 60.0)
    s = jnp.where(mx < 1e-6, 0.0, c / jnp.maximum(mx, 1e-6))
    return h, s


def hull_mask(points: jnp.ndarray, valid: jnp.ndarray, h: int, w: int
              ) -> jnp.ndarray:
    """Convex-hull mask [h, w] of valid 2D points via support functions."""
    th = 2.0 * np.pi * np.arange(_N_HULL_DIRS) / _N_HULL_DIRS
    dirs = jnp.asarray(np.stack([np.cos(th), np.sin(th)], -1)
                       .astype(np.float32))                 # [D, 2]
    proj = points @ dirs.T                                   # [N, D]
    support = jnp.max(jnp.where(valid[:, None], proj, -1e9), axis=0)  # [D]
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    pix = jnp.stack([xx, yy], -1)                            # [h, w, 2]
    inside = jnp.all(pix @ dirs.T <= support + 0.5, axis=-1)
    return inside & (jnp.sum(valid) >= 3)


def _downscale(img: jnp.ndarray, ds: int) -> jnp.ndarray:
    h, w = img.shape[:2]
    hh, ww = h // ds, w // ds
    if img.ndim == 3:
        return img[:hh * ds, :ww * ds].reshape(hh, ds, ww, ds, -1).mean((1, 3))
    return img[:hh * ds, :ww * ds].reshape(hh, ds, ww, ds).mean((1, 3))


def update_guidance(cfg: SfMConfig, state: GuidanceState,
                    rgb: jnp.ndarray, lms_xyz: jnp.ndarray,
                    lms_valid: jnp.ndarray, K: jnp.ndarray,
                    rvec: jnp.ndarray, tvec: jnp.ndarray
                    ):
    """One guidance update (CScanGuidance::calculateMask).  rgb: [H, W, 3]
    in [0, 255].  Returns (state, GuidanceOutput)."""
    ds = cfg.guidance_downscale
    H, W = cfg.image_size
    hh, ww = H // ds, W // ds
    nb_h, nb_s = cfg.guidance_hist_bins_h, cfg.guidance_hist_bins_s

    # --- centroid: plain mean of the live map, recomputed every frame
    # like the reference (CScanGuidance.cpp:27-36 — no EMA there) ---
    n = jnp.maximum(jnp.sum(lms_valid), 1)
    centroid = jnp.sum(jnp.where(lms_valid[:, None], lms_xyz, 0.0),
                       axis=0) / n

    # --- project landmarks, clamp to image (GeometryUtils w/ Size) ---
    uv = project(K, rvec, tvec, lms_xyz)
    uv = jnp.stack([jnp.clip(uv[:, 0], 0.0, W - 1.0),
                    jnp.clip(uv[:, 1], 0.0, H - 1.0)], -1)

    # --- downscale + hull mask (CScanGuidance.cpp:52-69) ---
    small = _downscale(rgb, ds)
    mask = hull_mask(uv / ds, lms_valid, hh, ww)
    hull_area = jnp.maximum(jnp.sum(mask), 1.0)

    # --- H-S histogram inside the mask (CScanGuidance.cpp:72-76) ---
    hch, sch = rgb_to_hs(small)
    hb = jnp.clip((hch / 360.0 * nb_h).astype(jnp.int32), 0, nb_h - 1)
    sb = jnp.clip((sch * nb_s).astype(jnp.int32), 0, nb_s - 1)
    flat_bin = (hb * nb_s + sb).reshape(-1)
    wts = mask.reshape(-1).astype(jnp.float32)
    # histogram keeps raw pixel counts: the backproj/hullArea threshold
    # below expects count scale (as cv::calcBackProject does)
    hist = jnp.zeros((nb_h * nb_s,), jnp.float32).at[flat_bin].add(wts)
    hist = hist.reshape(nb_h, nb_s)

    # --- EMA blend (alpha 0.9, CScanGuidance.cpp:78-83) ---
    a = cfg.guidance_ema_alpha
    hist = jnp.where(state.initialized, a * state.hist + (1 - a) * hist, hist)

    # --- back-projection + threshold (CScanGuidance.cpp:85-96) ---
    backproj = hist.reshape(-1)[flat_bin].reshape(hh, ww)
    obj = (backproj / hull_area) > cfg.guidance_backproj_threshold
    obj = obj & mask

    # --- oriented bbox via PCA (minAreaRect substitute) ---
    yy = jax.lax.broadcasted_iota(jnp.float32, (hh, ww), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (hh, ww), 1)
    wobj = obj.astype(jnp.float32)
    m = jnp.maximum(jnp.sum(wobj), 1.0)
    cx = jnp.sum(xx * wobj) / m
    cy = jnp.sum(yy * wobj) / m
    dx = (xx - cx) * wobj
    dy = (yy - cy) * wobj
    cov = jnp.array([[jnp.sum(dx * dx), jnp.sum(dx * dy)],
                     [jnp.sum(dx * dy), jnp.sum(dy * dy)]]) / m
    evals, evecs = jnp.linalg.eigh(cov)
    axes = evecs.T[::-1]                       # major axis first
    pts = jnp.stack([xx - cx, yy - cy], -1)
    along = pts @ axes.T                       # [hh, ww, 2]
    ext = jnp.stack([
        jnp.max(jnp.where(obj, jnp.abs(along[..., 0]), 0.0)),
        jnp.max(jnp.where(obj, jnp.abs(along[..., 1]), 0.0))])

    out = GuidanceOutput(
        centroid=centroid,
        bbox_center=jnp.asarray([cx, cy]) * ds + (ds - 1) / 2.0,
        bbox_axes=axes,
        bbox_extent=ext * ds,
        mask=wobj,
    )
    new_state = GuidanceState(centroid=centroid, hist=hist,
                              initialized=jnp.asarray(True))
    return new_state, out

"""Scale-space FAST corner detection -> fixed-size keypoint tensor.

Accelerator replacement for the BRISK scale-space AGAST detector
(brisk::BriskFeatureDetector(60, 6, true), CTracker.cpp:43).  The reference
returns a dynamic keypoint vector; here detection is dense map algebra over
an image pyramid followed by non-max suppression and a global top-K — a
fixed-shape keypoint set with a validity mask.

Shi-Tomasi detection for the optical-flow path
(cv::goodFeaturesToTrack, CTracker.cpp:261) is ``shi_tomasi_score``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# FAST-16 Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
_CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)
_ARC = 9  # contiguous arc length for a corner (FAST-9/16)


class Keypoints(NamedTuple):
    """Fixed-capacity detected feature set (the CFrame keypoint analogue)."""
    xy: jnp.ndarray      # [N, 2] full-resolution (x, y) pixel coords
    score: jnp.ndarray   # [N] detector response
    level: jnp.ndarray   # [N] int32 pyramid level
    valid: jnp.ndarray   # [N] bool


def _avg2_matrix(n: int, dtype) -> jnp.ndarray:
    """[n//2, n] matrix averaging adjacent element pairs.  Constant, folded
    by XLA; the downsample then runs as two small matmuls — stride-2
    slicing lowered to gathers on the backend this was first tuned for."""
    m = np.zeros((n // 2, n), np.float32)
    idx = np.arange(n // 2)
    m[idx, 2 * idx] = 0.5
    m[idx, 2 * idx + 1] = 0.5
    return jnp.asarray(m, dtype)


def _down2(cur: jnp.ndarray) -> jnp.ndarray:
    """2x2 box downsample as matmuls: A @ cur @ B with averaging matrices.
    precision='highest' keeps the means exact in f32 (reduced-precision
    matmul passes round through bf16/TF32, which perturbs detector
    scores); the
    matmuls are ~100 MFLOP, far below a noticeable cost either way."""
    h, w = cur.shape
    A = _avg2_matrix(h, cur.dtype)
    B = _avg2_matrix(w, cur.dtype).T
    return jnp.dot(jnp.dot(A, cur[:h // 2 * 2, :w // 2 * 2],
                           precision="highest"), B,
                   preferred_element_type=cur.dtype, precision="highest")


def build_pyramid(img: jnp.ndarray, levels: int) -> jnp.ndarray:
    """Grey image [H, W] float32 -> [levels, H, W] pyramid; level l is the
    2^l-downsampled image stored in the top-left corner (zero padding keeps
    shapes static for stacked gathers)."""
    H, W = img.shape
    out = [img]
    cur = img
    for _ in range(levels - 1):
        cur = _down2(cur)
        pad = jnp.zeros((H, W), img.dtype).at[:cur.shape[0], :cur.shape[1]].set(cur)
        out.append(pad)
    return jnp.stack(out)


def fast_score(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9/16 corner response [H, W].

    A pixel is a corner if >= 9 contiguous circle pixels are all brighter
    than center + t or all darker than center - t.  Score is the AGAST-style
    sum of thresholded absolute differences over the circle, gated by the
    corner test.  Pure shift/compare map algebra, no gathers.  Written as
    an expression DAG over 16 shifted reads (no stacked [16,H,W]
    intermediate, which would be materialized in memory).

    Shifts are STATIC SLICES of one edge-padded copy, not jnp.roll: roll
    lowers to a two-slice concat per offset, and XLA cannot fuse the
    elementwise DAG across 16 concats — the sliced form fuses into far
    fewer HBM passes (round 4)."""
    threshold = jnp.asarray(threshold, img.dtype)
    H, W = img.shape
    pad = jnp.pad(img, ((3, 3), (3, 3)), mode="edge")
    shifted = [jax.lax.slice(pad, (3 + int(dy), 3 + int(dx)),
                             (3 + int(dy) + H, 3 + int(dx) + W))
               for dy, dx in _CIRCLE]
    # per-pixel 16-bit circle bitboards (bit k = circle position k passes),
    # then the contiguous-run test as log-doubling shift-ANDs: ~9x fewer
    # elementwise ops than materializing all 16 arc starts
    one = jnp.asarray(1, jnp.int32)
    bright = jnp.zeros(img.shape, jnp.int32)
    dark = jnp.zeros(img.shape, jnp.int32)
    for k, s in enumerate(shifted):
        diff = s - img
        bright = bright | jnp.where(diff > threshold, one << k, 0)
        dark = dark | jnp.where(-diff > threshold, one << k, 0)

    def has_run(m):
        # circular run of >= _ARC (9) set bits among the low 16
        m2 = m | (m << 16)
        a = m2 & (m2 >> 1)          # runs >= 2
        a = a & (a >> 2)            # runs >= 4
        a = a & (a >> 4)            # runs >= 8
        a = a & (m2 >> 8)           # runs >= 9
        return (a & 0xFFFF) != 0

    corner = has_run(bright) | has_run(dark)
    zero = jnp.asarray(0.0, img.dtype)
    score = sum(jnp.maximum(jnp.abs(s - img) - threshold, zero)
                for s in shifted)
    return jnp.where(corner, score, zero)


def shi_tomasi_score(img: jnp.ndarray, sigma_window: int = 3) -> jnp.ndarray:
    """Dense min-eigenvalue corner response (goodFeaturesToTrack analogue)."""
    dx = 0.5 * (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1))
    dy = 0.5 * (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0))
    def box(x):
        k = sigma_window
        w = jnp.ones((k, k), x.dtype) / (k * k)
        return jax.lax.conv_general_dilated(
            x[None, None], w[None, None], (1, 1), "SAME")[0, 0]
    a = box(dx * dx)
    b = box(dx * dy)
    c = box(dy * dy)
    tr = a + c
    det = a * c - b * b
    disc = jnp.sqrt(jnp.maximum(tr * tr / 4.0 - det, 0.0))
    return tr / 2.0 - disc


def nms(score: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Suppress non-maxima within a (2r+1)^2 window (ties keep all)."""
    k = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME")
    return jnp.where(score >= pooled, score, 0.0)


class CanvasLayout(NamedTuple):
    """Static geometry of the side-by-side pyramid canvas.

    All pyramid levels are packed into ONE [H, width] image, level l
    occupying columns [offsets[l], offsets[l] + W>>l) (top-aligned).  One
    dense FAST/NMS/smooth pass then covers every level in a single kernel
    — 4 full-resolution passes (the padded-stack layout) collapse to one
    1.33x-resolution pass, and patch extraction needs no [L,H,W] stack.
    Constant masks keep levels from bleeding into each other: the per-level
    detection border (>= patch radius + 2) guarantees neither NMS windows
    nor descriptor patches cross a level boundary."""
    offsets: tuple          # per-level first column (python ints, static)
    width: int              # total canvas width
    heights: tuple          # per-level content height
    widths: tuple           # per-level content width
    inside: "np.ndarray"    # [H, width] f32 border mask (numpy constant)
    lvl_of_col: "np.ndarray"   # [width] int32 level of each column
    xoff_of_col: "np.ndarray"  # [width] int32 offsets[level] per column


_LAYOUTS = {}


def canvas_layout(H: int, W: int, levels: int, border: int = 20
                  ) -> CanvasLayout:
    key = (H, W, levels, border)
    if key in _LAYOUTS:
        return _LAYOUTS[key]
    offsets, heights, widths = [], [], []
    off = 0
    h, w = H, W
    for _ in range(levels):
        offsets.append(off)
        heights.append(h)
        widths.append(w)
        off += w
        h, w = h // 2, w // 2
    width = off
    inside = np.zeros((H, width), np.float32)
    lvl_of_col = np.zeros(width, np.int32)
    xoff_of_col = np.zeros(width, np.int32)
    for l in range(levels):
        o, h, w = offsets[l], heights[l], widths[l]
        inside[border:h - border, o + border:o + w - border] = 1.0
        lvl_of_col[o:o + w] = l
        xoff_of_col[o:o + w] = o
    _LAYOUTS[key] = CanvasLayout(
        offsets=tuple(offsets), width=width, heights=tuple(heights),
        widths=tuple(widths), inside=inside, lvl_of_col=lvl_of_col,
        xoff_of_col=xoff_of_col)
    return _LAYOUTS[key]


def build_canvas(img: jnp.ndarray, levels: int,
                 dtype=None) -> jnp.ndarray:
    """Grey image [H, W] -> side-by-side pyramid canvas [H, sum(W>>l)].
    Level l is the 2^l box-downsampled image in its column band (zero
    padding below shorter levels)."""
    H, W = img.shape
    if dtype is not None:
        img = img.astype(dtype)
    cols = [img]
    cur = img
    for _ in range(levels - 1):
        cur = _down2(cur)
        cols.append(jnp.pad(cur, ((0, H - cur.shape[0]), (0, 0))))
    return jnp.concatenate(cols, axis=1)


def detect(img: jnp.ndarray, *, max_keypoints: int, levels: int = 4,
           threshold: float = 20.0, nms_radius: int = 2,
           border: int = 20, compute_dtype=None,
           return_canvas: bool = False, approx_topk: bool = False):
    """Full detection pipeline: pyramid canvas -> FAST score -> NMS ->
    global top-K -> subpixel refinement.

    Returns keypoints in full-resolution (distorted) pixel coordinates,
    sorted by descending score, with validity mask (score > 0).  With
    return_canvas=True also returns the pyramid canvas (reused by the
    descriptor, saving a rebuild).  compute_dtype (e.g. jnp.bfloat16)
    selects the dense-pass precision: detector scores are sums of
    thresholded intensity differences, robust to bf16 rounding, and the
    dense passes are memory-bound — bf16 halves their HBM traffic."""
    H, W = img.shape
    lay = canvas_layout(H, W, levels, border)
    canvas = build_canvas(img, levels, dtype=compute_dtype)
    WC = lay.width
    K = max_keypoints

    raw = fast_score(canvas, threshold)
    s = nms(raw, nms_radius) * jnp.asarray(lay.inside, raw.dtype)
    s = s.astype(jnp.float32)
    # tie-break equal scores toward finer pyramid levels (the finer level
    # localizes better); the bias is far below any real score spacing
    bias = jnp.asarray(
        1e-3 * (levels - 1 - lay.lvl_of_col)[None, :].astype(np.float32))
    s = jnp.where(s > 0, s + bias, 0.0)
    if approx_topk:
        # exact top_k lowers to a full stable sort of H*WC scores; backends
        # with an approximate top-k lowering trade >=95% recall (misses
        # among the weakest corners) for speed, the others run exact top-k
        top_vals, idx = jax.lax.approx_max_k(
            s.reshape(-1), K, recall_target=0.95)
        idx = idx.astype(jnp.int32)
    else:
        top_vals, idx = jax.lax.top_k(s.reshape(-1), K)
    yi = idx // WC
    xc = idx % WC
    sel_lvl = jnp.asarray(lay.lvl_of_col)[xc]
    xi = xc - jnp.asarray(lay.xoff_of_col)[xc]

    # subpixel refinement: 1D quadratic fit on the (pre-NMS) score surface
    # along each axis; offsets clamped to +-0.5
    f32 = jnp.float32
    s0 = raw[yi, xc].astype(f32)
    sl = raw[yi, jnp.maximum(xc - 1, 0)].astype(f32)
    sr = raw[yi, jnp.minimum(xc + 1, WC - 1)].astype(f32)
    su = raw[jnp.maximum(yi - 1, 0), xc].astype(f32)
    sd = raw[jnp.minimum(yi + 1, H - 1), xc].astype(f32)
    cx = sl + sr - 2 * s0
    cy = su + sd - 2 * s0
    dx = jnp.where(jnp.abs(cx) > 1e-6, (sl - sr) / (2 * cx), 0.0)
    dy = jnp.where(jnp.abs(cy) > 1e-6, (su - sd) / (2 * cy), 0.0)
    dx = jnp.clip(dx, -0.5, 0.5)
    dy = jnp.clip(dy, -0.5, 0.5)
    y = yi.astype(f32) + dy
    x = xi.astype(f32) + dx
    scale = jnp.exp2(sel_lvl.astype(f32))
    # full-res coordinate: center of the level pixel footprint
    xy = jnp.stack([x * scale + 0.5 * (scale - 1.0),
                    y * scale + 0.5 * (scale - 1.0)], axis=-1)
    kps = Keypoints(xy=xy, score=top_vals, level=sel_lvl,
                    valid=top_vals > 0.0)
    if return_canvas:
        return kps, canvas
    return kps

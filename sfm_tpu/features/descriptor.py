"""Oriented 512-bit binary descriptor, matmul-formulated.

Accelerator replacement for brisk::BriskDescriptorExtractor (rotation- and
scale-invariant, 512-bit; CTracker.cpp:44-45).  Semantics: BRISK-style
intensity comparisons on a fixed polar sampling pattern, steered by the
intensity-centroid orientation, sampled at the keypoint's pyramid level.

Formulation: gathers were slow on the backend this was first tuned for,
so sampling is restructured as matrix multiplies (whether the GPU wants a
direct gather instead is ROADMAP Speed 4) —
 1. subpixel-centered patches via two bilinear-selection matmuls against
    the smoothed pyramid canvas (_patches_matmul);
 2. orientation = intensity centroid of the patch via two dense moment
    masks (a matvec, no gathers);
 3. the patch is resampled onto a POLAR grid (N_RAD rings x N_PHI angles,
    BRISK's concentric-ring layout) with one fixed bilinear matmul;
    rotation steering is then a per-keypoint CIRCULAR SHIFT along the
    angle axis (a tiny [N_PHI, N_PHI] one-hot batched matmul), and the
    descriptor bits are signs of fixed sample-pair differences — one
    [polar_samples, bits] matmul.
The polar-shift steering replaces an earlier 32-bin masked-matmul design
that computed every keypoint's bits under all 32 rotation bins (32x the
needed matmul work);
angle quantization is the same 360/N_PHI = 11.25 degrees, costing ~2-3
bits of descriptor noise, far below the cross-frame sampling noise."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .detect import Keypoints
from .bits import pack_bits

PATCH_RADIUS = 16            # sampling pattern support, pixels
PATCH = 2 * PATCH_RADIUS + 1  # 33: centered patch side
N_PHI = 32                   # polar angle samples (= rotation quantization)
N_RAD = 16                   # polar rings


def _make_pairs(bits: int, n_samples: int, seed: int = 17) -> np.ndarray:
    """[bits, 2] comparison-pair indices into the polar sample set."""
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, n_samples, bits)
    jj = rng.integers(0, n_samples, bits)
    jj = np.where(jj == ii, (jj + 1) % n_samples, jj)
    return np.stack([ii, jj], 1).astype(np.int32)


def _bilinear_weight_rows(pts: np.ndarray) -> np.ndarray:
    """pts [M, 2] (x, y) offsets from patch center -> dense bilinear weight
    matrix [M, PATCH*PATCH]."""
    M = pts.shape[0]
    W = np.zeros((M, PATCH, PATCH), np.float32)
    x = pts[:, 0] + PATCH_RADIUS
    y = pts[:, 1] + PATCH_RADIUS
    x0 = np.clip(np.floor(x).astype(int), 0, PATCH - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, PATCH - 2)
    fx = x - x0
    fy = y - y0
    idx = np.arange(M)
    W[idx, y0, x0] = (1 - fy) * (1 - fx)
    W[idx, y0, x0 + 1] = (1 - fy) * fx
    W[idx, y0 + 1, x0] = fy * (1 - fx)
    W[idx, y0 + 1, x0 + 1] = fy * fx
    return W.reshape(M, PATCH * PATCH)


_CACHE = {}


def _tables(bits: int):
    """Precomputed (numpy) polar-resampling / pair-difference matrices and
    the orientation moment masks.  Cached as numpy so no tracer can leak.

    Returns (Wpol [N_RAD*N_PHI, PATCH^2] bilinear polar-grid sampling,
    Dsel [bits, N_RAD*N_PHI] +/-1 pair-difference selection, mx, my)."""
    if bits in _CACHE:
        return _CACHE[bits]
    radii = np.geomspace(1.5, PATCH_RADIUS - 1.5, N_RAD)
    ang = 2.0 * np.pi * np.arange(N_PHI) / N_PHI
    xs = radii[:, None] * np.cos(ang)[None, :]         # [N_RAD, N_PHI]
    ys = radii[:, None] * np.sin(ang)[None, :]
    pts = np.stack([xs.reshape(-1), ys.reshape(-1)], 1).astype(np.float32)
    Wpol = _bilinear_weight_rows(pts)                  # [S, PATCH^2]
    S = N_RAD * N_PHI
    pairs = _make_pairs(bits, S)
    Dsel = np.zeros((bits, S), np.float32)
    Dsel[np.arange(bits), pairs[:, 0]] += 1.0
    Dsel[np.arange(bits), pairs[:, 1]] -= 1.0
    # orientation disc moment masks (intensity centroid, ORB-style)
    ys2, xs2 = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                        -PATCH_RADIUS:PATCH_RADIUS + 1]
    disc = (xs2 ** 2 + ys2 ** 2 <= 7 ** 2).astype(np.float32)
    mx = (xs2 * disc).reshape(-1).astype(np.float32)
    my = (ys2 * disc).reshape(-1).astype(np.float32)
    _CACHE[bits] = (Wpol, Dsel, mx, my)
    return _CACHE[bits]


def bilinear(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img [H, W] at xy [..., 2] (x, y); clamped to edges.
    (Used by the LK flow path; the descriptor avoids per-sample gathers.)"""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def smooth(img: jnp.ndarray, k: int = 5) -> jnp.ndarray:
    """k x k box blur (the pre-descriptor smoothing BRIEF requires).

    Separable shift-add formulation: lax.conv on [H,W] images lowered to a
    pathologically slow kernel on the backend this was first tuned for.
    Shifts are static slices of an edge-padded copy rather than jnp.roll
    (roll = two-slice concat per offset, which blocks XLA fusion across
    the add chain — round 4; same change as detect.fast_score)."""
    r = k // 2
    H, W = img.shape
    pad_x = jnp.pad(img, ((0, 0), (r, r)), mode="edge")
    acc = img
    for d in range(1, r + 1):
        acc = acc + jax.lax.slice(pad_x, (0, r - d), (H, r - d + W)) \
            + jax.lax.slice(pad_x, (0, r + d), (H, r + d + W))
    pad_y = jnp.pad(acc, ((r, r), (0, 0)), mode="edge")
    out = acc
    for d in range(1, r + 1):
        out = out + jax.lax.slice(pad_y, (r - d, 0), (r - d + H, W)) \
            + jax.lax.slice(pad_y, (r + d, 0), (r + d + H, W))
    return out / (k * k)


def extract_patches(pyr_s: jnp.ndarray, level_xy: jnp.ndarray,
                    level: jnp.ndarray) -> jnp.ndarray:
    """Centered subpixel patches [N, PATCH, PATCH] around each keypoint on
    its own pyramid level: one dynamic slice + a 4-tap fractional lerp."""
    def one(xy, lvl):
        x0 = jnp.floor(xy[0]).astype(jnp.int32) - PATCH_RADIUS
        y0 = jnp.floor(xy[1]).astype(jnp.int32) - PATCH_RADIUS
        raw = jax.lax.dynamic_slice(pyr_s, (lvl, y0, x0),
                                    (1, PATCH + 1, PATCH + 1))[0]
        fx = xy[0] - jnp.floor(xy[0])
        fy = xy[1] - jnp.floor(xy[1])
        top = (1 - fx) * raw[:-1, :-1] + fx * raw[:-1, 1:]
        bot = (1 - fx) * raw[1:, :-1] + fx * raw[1:, 1:]
        return (1 - fy) * top + fy * bot

    return jax.vmap(one)(level_xy, level)


def orientation_from_patches(patches: jnp.ndarray, bits: int = 512
                             ) -> jnp.ndarray:
    """Intensity-centroid angle per patch: atan2(m01, m10)."""
    _, _, mx, my = _tables(bits)
    flat = patches.reshape(patches.shape[0], -1)
    m10 = jnp.dot(flat, jnp.asarray(mx, flat.dtype),
                  preferred_element_type=jnp.float32)
    m01 = jnp.dot(flat, jnp.asarray(my, flat.dtype),
                  preferred_element_type=jnp.float32)
    return jnp.arctan2(m01, m10)


def orientation(pyr_s: jnp.ndarray, level_xy: jnp.ndarray,
                level: jnp.ndarray) -> jnp.ndarray:
    """Back-compat API: orientation straight from the pyramid."""
    patches = extract_patches(pyr_s, level_xy, level)
    return orientation_from_patches(patches)


def _bits_from_patches(patches: jnp.ndarray, desc_bits: int,
                       compute_dtype=None) -> jnp.ndarray:
    """Orientation-steered comparison bits from centered patches [N,P,P].

    Polar-shift steering: resample each patch onto the polar grid (one
    fixed bilinear matmul), circular-shift the angle axis by the quantized
    orientation (a per-keypoint [N_PHI, N_PHI] one-hot batched matmul),
    and take signs of fixed sample-pair differences (one matmul).

    compute_dtype=bfloat16 halves the memory and matmul cost;
    descriptor bits are signs of intensity differences, so bf16 rounding
    only flips near-zero comparisons (noise far below the cross-frame
    sampling noise)."""
    N = patches.shape[0]
    theta = orientation_from_patches(patches, desc_bits)
    shift = jnp.round(theta / (2.0 * jnp.pi / N_PHI)).astype(jnp.int32) \
        % N_PHI
    Wpol_np, Dsel_np, _, _ = _tables(desc_bits)
    flat = patches.reshape(N, -1)                      # [N, PATCH^2]
    Wpol = jnp.asarray(Wpol_np)                        # [S, PATCH^2]
    Dsel = jnp.asarray(Dsel_np)                        # [bits, S]
    if compute_dtype is not None:
        flat = flat.astype(compute_dtype)
        Wpol = Wpol.astype(compute_dtype)
        Dsel = Dsel.astype(compute_dtype)
    pol = jax.lax.dot_general(
        flat, Wpol, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)            # [N, S]
    pol = pol.reshape(N, N_RAD, N_PHI)
    if compute_dtype is not None:
        pol = pol.astype(compute_dtype)
    # canonical orientation: sample ring angle psi from source angle
    # (psi + shift) mod N_PHI — a batched one-hot matmul (iota compares
    # fuse into the dot operand; a per-keypoint roll would be a gather)
    psi = jnp.arange(N_PHI, dtype=jnp.int32)
    src = (psi[None, :] + shift[:, None]) % N_PHI      # [N, N_PHI]
    rot = (src[:, None, :] == psi[None, :, None]).astype(pol.dtype)
    pol_c = jax.lax.dot_general(
        pol, rot, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)            # [N, N_RAD, N_PHI]
    vals = jax.lax.dot_general(
        pol_c.reshape(N, -1).astype(Dsel.dtype), Dsel,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)            # [N, bits]
    return pack_bits(vals > 0)


def describe(pyr: jnp.ndarray, kps: Keypoints, desc_bits: int = 512
             ) -> jnp.ndarray:
    """Packed descriptors [N, desc_bits//32] uint32 for a keypoint set
    (stacked-pyramid path, used by the flow pipeline and tests)."""
    pyr_s = jax.vmap(smooth)(pyr)
    scale = jnp.exp2(kps.level.astype(jnp.float32))
    level_xy = (kps.xy - 0.5 * (scale[:, None] - 1.0)) / scale[:, None]
    patches = extract_patches(pyr_s, level_xy, kps.level)
    return _bits_from_patches(patches, desc_bits)


def _patches_matmul(canvas_s: jnp.ndarray, cx: jnp.ndarray, cy: jnp.ndarray,
                    int8: bool = False) -> jnp.ndarray:
    """Subpixel-centered patches [N, PATCH, PATCH] via two bilinear
    selection matmuls (columns, then rows).

    A vmapped per-keypoint dynamic_slice lowered to a serial loop of tiny
    [1, 34, 34] slices on the backend this was first tuned for; instead the
    patch window + fractional lerp become TWO-nonzero selection operands
    of two matmuls:
        Z[n, c, h]       = sum_w canvas[h, w] * Cw[n, c, w]   (x-select+lerp)
        patch[n, r, c]   = sum_h Rw[n, r, h] * Z[n, c, h]     (y-select+lerp)
    The iota-compare operands fuse into the matmuls (same trick as
    ba/core._onehot_matmul_T); columns first because the
    canvas is wider than tall, minimizing the [N, PATCH, Hc] intermediate."""
    Hc, Wc = canvas_s.shape
    dt = canvas_s.dtype
    N = cx.shape[0]
    x0 = jnp.floor(cx).astype(jnp.int32) - PATCH_RADIUS
    y0 = jnp.floor(cy).astype(jnp.int32) - PATCH_RADIUS
    fx = (cx - jnp.floor(cx)).astype(dt)
    fy = (cy - jnp.floor(cy)).astype(dt)
    rr = jnp.arange(PATCH, dtype=jnp.int32)
    ww = jnp.arange(Wc, dtype=jnp.int32)
    hh = jnp.arange(Hc, dtype=jnp.int32)

    xb = x0[:, None] + rr[None, :]                       # [N, PATCH]
    if int8:
        # int8 operands for the DOMINANT first dot (contracts Wc=full
        # canvas width; the second dot is only PATCH/Wc ~ 3% of its
        # FLOPs): canvas centered to [-128, 127], lerp weights scaled by
        # 127.  Quantization error: 1/127 px on the subpixel lerp and
        # ~0.5 intensity level — both far below the sensor-noise floor
        # the descriptor bits already absorb.
        q_can = jnp.clip(jnp.round(canvas_s.astype(jnp.float32) - 128.0),
                         -128, 127).astype(jnp.int8)
        w_lo = jnp.round((1.0 - fx.astype(jnp.float32)) * 127.0)
        w_hi = jnp.round(fx.astype(jnp.float32) * 127.0)
        Cw = ((ww[None, None, :] == xb[:, :, None]) * w_lo[:, None, None]
              + (ww[None, None, :] == xb[:, :, None] + 1)
              * w_hi[:, None, None]).astype(jnp.int8)    # [N, PATCH, Wc]
        Zq = jax.lax.dot_general(
            Cw.reshape(N * PATCH, Wc), q_can,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32).reshape(N, PATCH, Hc)
        # back to intensity units: Z = Zq/127 + 128 * sum(weights ~ 1)
        Z = (Zq.astype(dt) * jnp.asarray(1.0 / 127.0, dt)
             + jnp.asarray(128.0, dt))
    else:
        Cw = ((ww[None, None, :] == xb[:, :, None]).astype(dt)
              * (1.0 - fx)[:, None, None]
              + (ww[None, None, :] == xb[:, :, None] + 1).astype(dt)
              * fx[:, None, None])                       # [N, PATCH, Wc]
        # emit Z in the compute dtype directly (the dot still accumulates
        # in f32 internally): a separate f32->bf16 convert would write and
        # re-read this [N, PATCH, Hc] intermediate
        Z = jax.lax.dot_general(
            Cw.reshape(N * PATCH, Wc), canvas_s,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=dt).reshape(N, PATCH, Hc)

    yb = y0[:, None] + rr[None, :]                       # [N, PATCH]
    Rw = ((hh[None, None, :] == yb[:, :, None]).astype(dt)
          * (1.0 - fy)[:, None, None]
          + (hh[None, None, :] == yb[:, :, None] + 1).astype(dt)
          * fy[:, None, None])                           # [N, PATCH, Hc]
    patches = jax.lax.dot_general(
        Rw, Z,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)              # [N, r, c]
    return patches


def describe_canvas(canvas: jnp.ndarray, kps: Keypoints, levels: int,
                    image_width: int, desc_bits: int = 512,
                    compute_dtype=None, patch_int8: bool = False
                    ) -> jnp.ndarray:
    """Packed descriptors from the side-by-side pyramid canvas (see
    detect.canvas_layout): ONE smoothing pass over the canvas, then
    bilinear-selection matmuls extract every keypoint's subpixel patch.
    The detection border guarantees patches never cross a level band."""
    from .detect import canvas_layout
    H = canvas.shape[0]
    lay = canvas_layout(H, image_width, levels)
    assert lay.width == canvas.shape[1], "canvas/layout mismatch"
    canvas_s = smooth(canvas)
    if compute_dtype is not None:
        canvas_s = canvas_s.astype(compute_dtype)
    scale = jnp.exp2(kps.level.astype(jnp.float32))
    level_xy = (kps.xy - 0.5 * (scale[:, None] - 1.0)) / scale[:, None]
    offs = jnp.asarray(np.array(lay.offsets, np.int32))
    cx = level_xy[:, 0] + offs[kps.level].astype(jnp.float32)
    cy = level_xy[:, 1]
    patches = _patches_matmul(canvas_s, cx, cy,
                              int8=patch_int8).astype(jnp.float32)
    return _bits_from_patches(patches, desc_bits, compute_dtype)

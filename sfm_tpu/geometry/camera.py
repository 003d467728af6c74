"""Pinhole camera model: projection, distortion, undistortion.

Replaces the reference's OpenCV camera surface:
  - GeometryUtils::projectPoints (CSfM.cpp:204, 274, 670; CScanGuidance.cpp:47)
  - cv::undistortPoints + getOptimalNewCameraMatrix (CFrame.cpp:33, 169, 189, 216)

The reference undistorts every detected point immediately and runs the whole
pipeline (matching windows, H/F/PnP, triangulation, BA) in the undistorted
pinhole model ``Kopt``; we keep that contract.  Distortion model is the
OpenCV 4/5-term radial-tangential (k1, k2, p1, p2[, k3]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .rotations import exp_so3


def project(K: jnp.ndarray, rvec: jnp.ndarray, tvec: jnp.ndarray,
            xyz: jnp.ndarray) -> jnp.ndarray:
    """Project world points [N,3] with pose (rvec, t) and intrinsics K -> [N,2].

    Pose is world-to-camera: x_cam = R x_world + t.  No distortion (the
    pipeline operates in the undistorted model, matching CTracker.cpp:597's
    BA residual which applies intrinsics with no distortion terms).
    """
    R = exp_so3(rvec)
    cam = xyz @ R.T + tvec
    return apply_intrinsics(K, cam)


def project_cam(K: jnp.ndarray, cam: jnp.ndarray) -> jnp.ndarray:
    """Project camera-frame points [N,3] -> pixel coords [N,2]."""
    return apply_intrinsics(K, cam)


def apply_intrinsics(K: jnp.ndarray, cam: jnp.ndarray) -> jnp.ndarray:
    z = cam[..., 2:3]
    z = jnp.where(jnp.abs(z) < 1e-9, jnp.where(z < 0, -1e-9, 1e-9), z)
    xy = cam[..., :2] / z
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    u = fx * xy[..., 0] + skew * xy[..., 1] + cx
    v = fy * xy[..., 1] + cy
    return jnp.stack([u, v], axis=-1)


def depths(rvec: jnp.ndarray, tvec: jnp.ndarray, xyz: jnp.ndarray) -> jnp.ndarray:
    """Camera-frame depth (z) of world points under pose (rvec, t)."""
    R = exp_so3(rvec)
    return xyz @ R.T[:, 2] + tvec[2]


def pixel_to_norm(K: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Pixel coords -> normalized image coords (inverse intrinsics, no dist)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    y = (uv[..., 1] - cy) / fy
    x = (uv[..., 0] - cx - skew * y) / fx
    return jnp.stack([x, y], axis=-1)


def distort_norm(d: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential distortion to normalized coords [...,2].

    d = (k1, k2, p1, p2, k3); pass zeros for unused terms.
    """
    k1, k2, p1, p2, k3 = d[0], d[1], d[2], d[3], d[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xt, yt], axis=-1)


def undistort_norm(d: jnp.ndarray, xy_dist: jnp.ndarray,
                   iters: int = 8) -> jnp.ndarray:
    """Invert the distortion by fixed-point iteration (cv::undistortPoints
    does the same).  Unrolled: a lax.fori_loop pays per-iteration loop
    overhead for this tiny [N,2] body; unrolling lets XLA fuse all
    iterations into one kernel (and fold them away entirely
    when d is a compile-time zero constant)."""
    k1, k2, p1, p2, k3 = d[0], d[1], d[2], d[3], d[4]
    xy = xy_dist
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x_new = (xy_dist[..., 0] - dx) / radial
        y_new = (xy_dist[..., 1] - dy) / radial
        xy = jnp.stack([x_new, y_new], axis=-1)
    return xy


def undistort_pixels(K: jnp.ndarray, d: jnp.ndarray, Kopt: jnp.ndarray,
                     uv: jnp.ndarray) -> jnp.ndarray:
    """Distorted pixel coords (under K, d) -> undistorted pixels under Kopt.

    The CFrame.cpp:169 contract: detected (distorted) points are mapped into
    the rectified pinhole model once, and everything downstream uses them.
    """
    norm = undistort_norm(d, pixel_to_norm(K, uv))
    ones = jnp.ones(norm.shape[:-1] + (1,), norm.dtype)
    cam = jnp.concatenate([norm, ones], axis=-1)
    return apply_intrinsics(Kopt, cam)


def distort_pixels(K: jnp.ndarray, d: jnp.ndarray, Kopt: jnp.ndarray,
                   uv_undist: jnp.ndarray) -> jnp.ndarray:
    """Inverse of undistort_pixels (for drawing/flow against raw images)."""
    norm = pixel_to_norm(Kopt, uv_undist)
    dist = distort_norm(d, norm)
    ones = jnp.ones(dist.shape[:-1] + (1,), dist.dtype)
    return apply_intrinsics(K, jnp.concatenate([dist, ones], axis=-1))


def optimal_new_camera_matrix(K, d, image_size, alpha: float = 0.0):
    """Host-side (numpy-friendly) analogue of cv::getOptimalNewCameraMatrix.

    alpha=0: all undistorted pixels valid (zoom in to the inner rectangle).
    Computed by undistorting the image border and fitting the new K so the
    inner (alpha=0) or outer (alpha=1) rectangle maps to the image.
    """
    import numpy as np

    h, w = image_size
    # sample border points (distorted pixel grid edges)
    n = 32
    xs = np.linspace(0, w - 1, n)
    ys = np.linspace(0, h - 1, n)
    border = np.concatenate([
        np.stack([xs, np.zeros(n)], -1),
        np.stack([xs, np.full(n, h - 1.0)], -1),
        np.stack([np.zeros(n), ys], -1),
        np.stack([np.full(n, w - 1.0), ys], -1),
    ])
    norm = np.asarray(undistort_norm(jnp.asarray(d, jnp.float32),
                                     pixel_to_norm(jnp.asarray(K, jnp.float32),
                                                   jnp.asarray(border, jnp.float32))))
    # outer rect covers every undistorted border point; inner rect is the
    # largest axis-aligned rectangle inside the undistorted border polygon
    x0o, x1o = norm[:, 0].min(), norm[:, 0].max()
    y0o, y1o = norm[:, 1].min(), norm[:, 1].max()
    # inner: max of per-edge extrema
    top = norm[0 * n:1 * n]; bot = norm[1 * n:2 * n]
    left = norm[2 * n:3 * n]; right = norm[3 * n:4 * n]
    x0i, x1i = left[:, 0].max(), right[:, 0].min()
    y0i, y1i = top[:, 1].max(), bot[:, 1].min()
    x0 = alpha * x0o + (1 - alpha) * x0i
    x1 = alpha * x1o + (1 - alpha) * x1i
    y0 = alpha * y0o + (1 - alpha) * y0i
    y1 = alpha * y1o + (1 - alpha) * y1i
    fx = (w - 1) / (x1 - x0)
    fy = (h - 1) / (y1 - y0)
    cx = -x0 * fx
    cy = -y0 * fy
    Kopt = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)
    return Kopt

"""Stage-attribution profile of make_frame (detect + describe + undistort)
on the real chip.  Each stage loops on-device via lax.scan with a
data-dependent salt so XLA cannot hoist the body."""

import os
import sys
import time

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

import __graft_entry__ as g
from sfm_tpu.config import SfMConfig
from sfm_tpu.engine.state import CameraParams
import importlib
D = importlib.import_module("sfm_tpu.features.descriptor")
Det = importlib.import_module("sfm_tpu.features.detect")
from sfm_tpu.geometry.camera import undistort_pixels
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory

REPS = 50


def timed(name, fn, *args):
    fn_j = jax.jit(fn)
    out = jax.block_until_ready(fn_j(*args))
    t0 = time.time()
    out = jax.block_until_ready(fn_j(*args))
    dt = (time.time() - t0) * 1000.0 / REPS
    print(f"{name:28s} {dt:8.3f} ms/call")
    return dt


def main():
    cfg = SfMConfig(**g.FLAGSHIP)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))
    rng = np.random.default_rng(11)
    scene = SpriteScene(rng, n_sprites=260, spread=2.4)
    rvecs, tvecs = strafe_trajectory(2, step=0.06, yaw_rate=0.001)
    img = jnp.asarray(scene.render(K, rvecs[0], tvecs[0], 480, 640))

    cdt = jnp.bfloat16 if cfg.feature_dtype == "bfloat16" else None
    levels = cfg.pyramid_levels
    lay = Det.canvas_layout(480, 640, levels)

    def loop(body):
        def fn(x):
            def b(c, _):
                out = body(x + c)
                # *0 constant-folds and the body hoists; *1e-30 is ~0 but
                # not provably 0, so the dependence chain survives
                salt = (jnp.sum(out).astype(jnp.float32) * 1e-30)
                return salt.astype(x.dtype), out.reshape(-1)[0]
            return jax.lax.scan(b, jnp.asarray(0, x.dtype), None,
                                length=REPS)[1]
        return fn

    timed("build_canvas", loop(
        lambda im: Det.build_canvas(im, levels, dtype=cdt).astype(jnp.float32)), img)

    canvas = Det.build_canvas(img, levels, dtype=cdt)
    timed("fast_score", loop(
        lambda c: Det.fast_score(c, cfg.fast_threshold).astype(jnp.float32)), canvas)

    raw = Det.fast_score(canvas, cfg.fast_threshold)
    timed("nms", loop(
        lambda r: Det.nms(r, cfg.nms_radius).astype(jnp.float32)), raw)

    s = Det.nms(raw, cfg.nms_radius) * jnp.asarray(lay.inside, raw.dtype)
    s32 = s.astype(jnp.float32)
    timed("top_k", loop(
        lambda x: jax.lax.top_k(x.reshape(-1), cfg.max_keypoints)[0]), s32)

    def full_detect(im):
        kps, cv = Det.detect(im, max_keypoints=cfg.max_keypoints,
                             levels=levels, threshold=cfg.fast_threshold,
                             nms_radius=cfg.nms_radius, compute_dtype=cdt,
                             return_canvas=True)
        return kps.xy
    timed("detect (all)", loop(full_detect), img)

    kps, canvas = Det.detect(img, max_keypoints=cfg.max_keypoints,
                             levels=levels, threshold=cfg.fast_threshold,
                             nms_radius=cfg.nms_radius, compute_dtype=cdt,
                             return_canvas=True)

    timed("smooth(canvas)", loop(
        lambda c: D.smooth(c).astype(jnp.float32)), canvas)

    canvas_s = D.smooth(canvas)
    scale = jnp.exp2(kps.level.astype(jnp.float32))
    level_xy = (kps.xy - 0.5 * (scale[:, None] - 1.0)) / scale[:, None]
    offs = jnp.asarray(np.array(lay.offsets, np.int32))
    cx = level_xy[:, 0] + offs[kps.level].astype(jnp.float32)
    cy = level_xy[:, 1]

    def patches_fn(cs):
        def one(cx_, cy_):
            x0 = jnp.floor(cx_).astype(jnp.int32) - D.PATCH_RADIUS
            y0 = jnp.floor(cy_).astype(jnp.int32) - D.PATCH_RADIUS
            rawp = jax.lax.dynamic_slice(cs, (y0, x0),
                                         (D.PATCH + 1, D.PATCH + 1))
            fx = (cx_ - jnp.floor(cx_)).astype(rawp.dtype)
            fy = (cy_ - jnp.floor(cy_)).astype(rawp.dtype)
            top = (1 - fx) * rawp[:-1, :-1] + fx * rawp[:-1, 1:]
            bot = (1 - fx) * rawp[1:, :-1] + fx * rawp[1:, 1:]
            return (1 - fy) * top + fy * bot
        return jax.vmap(one)(cx, cy).astype(jnp.float32)
    timed("extract patches", loop(patches_fn), canvas_s)

    patches = patches_fn(canvas_s)
    timed("bits_from_patches", loop(
        lambda p: D._bits_from_patches(p, cfg.desc_bits, cdt)
        .astype(jnp.float32)), patches)

    timed("describe_canvas (all)", loop(
        lambda c: D.describe_canvas(c, kps, levels, cfg.image_width,
                                    cfg.desc_bits, compute_dtype=cdt)
        .astype(jnp.float32)), canvas)

    timed("undistort_pixels", loop(
        lambda xy: undistort_pixels(cam.K, cam.d, cam.Kopt, xy)), kps.xy)


if __name__ == "__main__":
    main()

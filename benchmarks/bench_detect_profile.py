"""Stage-attribution profile of the feature detector on the real chip."""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

from sfm_tpu.features.detect import (build_pyramid, fast_score, nms, detect)
from sfm_tpu.features.descriptor import describe

REPS = 50
H, W = 480, 640
LEVELS = 4
K = 512


def loop(fn):
    def run(img):
        def body(carry, _):
            out = fn(img + carry)
            s = jnp.sum(out[0] if isinstance(out, tuple) else out)
            # data-dependent salt that is always 0 but not constant-foldable
            salt = (s.astype(jnp.int32) >> 31).astype(jnp.float32)
            return salt, s
        return jax.lax.scan(body, jnp.float32(0), None, length=REPS)[1]
    return run


def timed(name, fn, *args):
    fn_j = jax.jit(fn)
    jax.block_until_ready(fn_j(*args))
    t0 = time.time()
    jax.block_until_ready(fn_j(*args))
    dt = (time.time() - t0) * 1000.0 / REPS
    print(f"{name:28s} {dt:8.3f} ms/call")


def main():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))

    timed("build_pyramid", loop(lambda im: build_pyramid(im, LEVELS)), img)
    timed("fast_score L0 full", loop(lambda im: fast_score(im, 20.0)), img)
    timed("fast_score 4L padded",
          loop(lambda im: jnp.stack([
              fast_score(build_pyramid(im, LEVELS)[l], 20.0)
              for l in range(LEVELS)])), img)
    timed("fast_score 4L cropped",
          loop(lambda im: sum(
              jnp.sum(fast_score(build_pyramid(im, LEVELS)[l][:H >> l, :W >> l],
                                 20.0))
              for l in range(LEVELS)) + 0 * im[0, 0]), img)
    timed("nms L0", loop(lambda im: nms(im, 2)), img)
    timed("topk 307200->512",
          loop(lambda im: jax.lax.top_k(im.reshape(-1), K)[0]), img)
    timed("approx topk 307200->512",
          loop(lambda im: jax.lax.approx_max_k(im.reshape(-1), K)[0]), img)
    timed("topk4+merge",
          loop(lambda im: jax.lax.top_k(
              jnp.concatenate([jax.lax.top_k(
                  (im * (l + 1)).reshape(-1), K)[0] for l in range(LEVELS)]),
              K)[0]), img)

    def full_detect(im):
        kp = detect(im, max_keypoints=K, levels=LEVELS, threshold=20.0,
                    nms_radius=2)
        return kp.xy
    timed("detect (full)", loop(full_detect), img)

    def full_describe(im):
        kp = detect(im, max_keypoints=K, levels=LEVELS, threshold=20.0,
                    nms_radius=2)
        pyr = build_pyramid(im, LEVELS)
        return describe(pyr, kp, 512)
    timed("detect+describe", loop(full_describe), img)


if __name__ == "__main__":
    main()

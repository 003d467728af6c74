"""Device-trace attribution of the mapping pass on the real chip.

The lax.scan microbench harness proved unreliable (XLA eliminates bodies
in ways that vary run to run); this uses jax.profiler traces and sums
device-side op durations instead, attributing each HLO fusion to its
source line.  Prints the top ops of (a) one mapping pass, (b) one BA call
at mapping shapes.
"""

import collections
import glob
import gzip
import json
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
from sfm_tpu.engine.state import CameraParams, init_state
from sfm_tpu.engine.step import build_video_step
from sfm_tpu.engine.mapping import mapping_pass
from sfm_tpu.synthetic import SpriteScene, strafe_trajectory

REPS = 10


def _hlo_source_map(fn, *args):
    """fusion/op name -> 'file:line (op_name)' from the compiled HLO."""
    import re
    txt = jax.jit(fn).lower(*args).compile().as_text()
    src = {}
    for m in re.finditer(
            r"^\s*%?([\w.\-]+) = .*?metadata=\{(.*?)\}", txt, re.M):
        name, meta = m.group(1), m.group(2)
        f = re.search(r'source_file="([^"]+)"', meta)
        ln = re.search(r"source_line=(\d+)", meta)
        op = re.search(r'op_name="([^"]+)"', meta)
        if f:
            src[name] = (f"{f.group(1).split('/')[-1]}:"
                         f"{ln.group(1) if ln else '?'} "
                         f"{(op.group(1) if op else '')[-60:]}")
    return src


def trace_and_report(tag, fn, *args):
    src = _hlo_source_map(fn, *args)
    out = jax.block_until_ready(fn(*args))  # compile
    logdir = f"/tmp/mapprof_{tag}"
    with jax.profiler.trace(logdir):
        for _ in range(REPS):
            out = jax.block_until_ready(fn(*args))
    path = sorted(glob.glob(f"{logdir}/plugins/profile/*/*.trace.json.gz"))[-1]
    with gzip.open(path) as f:
        tr = json.load(f)
    ev = tr["traceEvents"]
    pids = {e["pid"]: e["args"].get("name", "") for e in ev
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    tot = collections.defaultdict(float)
    cnt = collections.defaultdict(int)
    args_of = {}
    for e in ev:
        if e.get("ph") == "X" and "dur" in e and \
                "/device:" in pids.get(e["pid"], ""):
            tot[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
            a = e.get("args") or {}
            if e["name"] not in args_of and a:
                args_of[e["name"]] = str(a)[:160]
    print(f"--- {tag}: top device ops (ms/call over {REPS} reps) ---")
    for name, d in sorted(tot.items(), key=lambda kv: -kv[1])[:25]:
        if name.startswith("jit_") or name.startswith("while"):
            continue
        print(f"{d / 1000 / REPS:9.3f} ms x{cnt[name] // REPS:4d}  "
              f"{name[:40]:40s}  {src.get(name, '')[:110]}")
    return out


def main():
    cfg = SfMConfig(**g.FLAGSHIP)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))
    chunk_step = jax.jit(build_video_step(cfg, cam))

    rng = np.random.default_rng(11)
    scene = SpriteScene(rng, n_sprites=260, spread=2.4)
    rvecs, tvecs = strafe_trajectory(64, step=0.06, yaw_rate=0.001)
    frames = np.stack([scene.render(K, rvecs[i], tvecs[i], 480, 640)
                       for i in range(64)])
    state = init_state(cfg)
    t0 = time.time()
    for i in range(0, 64, 16):
        state, m = chunk_step(state, jnp.asarray(frames[i:i + 16]))
    jax.block_until_ready(m)
    print(f"warmup scan: {time.time() - t0:.1f}s, "
          f"kfs={int(np.asarray(m.n_keyframes)[-1])}, "
          f"lms={int(np.asarray(m.n_landmarks)[-1])}", file=sys.stderr)

    new_slot = int(np.asarray(
        jnp.argmax(jnp.where(state.kfs.valid, state.kfs.frames.frame_no, -1))))
    map_fn = jax.jit(lambda st: mapping_pass(cfg, cam, st,
                                             jnp.asarray(new_slot, jnp.int32)))
    trace_and_report("mapping", map_fn, state)


if __name__ == "__main__":
    main()

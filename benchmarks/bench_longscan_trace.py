"""Device-trace one mapping pass at the longscan (512-KF / 64k-lm)
capacities on a saved mid-scan state (benchmarks/diag_longscan_map.py
writes /tmp/longscan_state.npz).

python benchmarks/bench_longscan_trace.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import jax

from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp

from bench_longscan import LARGE
from bench_mapping_profile import trace_and_report
from sfm_tpu.config import SfMConfig
from sfm_tpu.engine.state import CameraParams
from sfm_tpu.engine.mapping import mapping_pass
from sfm_tpu.io.checkpoint import load_state


def main():
    cfg = SfMConfig(**LARGE)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
    cam = CameraParams(K=jnp.asarray(K), d=jnp.zeros(5), Kopt=jnp.asarray(K))
    state = load_state("/tmp/longscan_state.npz", cfg)
    print(f"state: {int(np.asarray(state.kfs.valid).sum())} KFs, "
          f"{int(np.asarray(state.lms.valid).sum())} lms", file=sys.stderr)
    new_slot = int(np.asarray(jnp.argmax(
        jnp.where(state.kfs.valid, state.kfs.frames.frame_no, -1))))
    map_fn = jax.jit(lambda st: mapping_pass(
        cfg, cam, st, jnp.asarray(new_slot, jnp.int32)))
    trace_and_report("ls_mapping", map_fn, state)
    _grouped_report("ls_mapping")


def _grouped_report(tag):
    """Total device time grouped by source file (the top-25 op view hides
    a long tail)."""
    import collections
    import glob
    import gzip
    import json
    import re
    path = sorted(glob.glob(
        f"/tmp/mapprof_{tag}/plugins/profile/*/*.trace.json.gz"))[-1]
    with gzip.open(path) as f:
        tr = json.load(f)
    ev = tr["traceEvents"]
    pids = {e["pid"]: e["args"].get("name", "") for e in ev
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    total = 0.0
    by_name = collections.defaultdict(float)
    for e in ev:
        if e.get("ph") == "X" and "dur" in e and \
                "/device:" in pids.get(e["pid"], ""):
            n = e["name"]
            if n.startswith("jit_") or n.startswith("while") or \
                    n.startswith("cond"):
                continue   # containers double-count their children
            by_name[n] += e["dur"]
            total += e["dur"]
    print(f"--- {tag}: total leaf device time {total/1e3/10:.1f} ms/call, "
          f"{len(by_name)} distinct ops ---")


if __name__ == "__main__":
    main()

"""Verify the distributed-BA communication volume from the compiled HLO
(VERDICT round 2 item 8: measured bytes/CG-iter, not a docstring claim).

Compiles build_dist_large_ba on an 8-virtual-device CPU mesh and walks
the optimized HLO for all-reduce ops: reports each collective's payload
shape/bytes and the total all-reduced bytes per LM iteration.

XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python benchmarks/bench_dist_comm.py [C] [L] [cg_iters]
"""

import os
import re
import sys

if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp


DTYPE_BYTES = {"f32": 4, "bf16": 2, "f64": 8, "s32": 4, "u32": 4,
               "pred": 1, "f16": 2, "s8": 1, "u8": 1}


def _computation_of_line(hlo_text):
    """line index -> enclosing HLO computation name."""
    comp = None
    comps = []
    for line in hlo_text.splitlines():
        # computation headers sit at column 0: "%name (params...) -> ... {"
        # (params may contain nested tuple parens) or "ENTRY %name (...)"
        m = re.match(r"^(?:ENTRY\s+)?(%[\w.\-]+)\s*\(", line)
        if m:
            comp = m.group(1).lstrip("%")
        comps.append(comp)
    return comps


def while_body_computations(hlo_text):
    """Names of computations reachable from a while-loop body (the CG/LM
    loops) — transitively through calls/fusions/to_apply, so a collective
    inside a computation the loop body calls still counts as per-iteration."""
    lines = hlo_text.splitlines()
    comps = _computation_of_line(hlo_text)
    # call edges: computation -> referenced computations
    edges = {}
    bodies = set()
    ref_pat = re.compile(
        r"(?:body|condition|to_apply|calls)=\{?%?([\w.\-]+)")
    for i, line in enumerate(lines):
        c = comps[i]
        if c is None:
            continue
        for m in ref_pat.finditer(line):
            edges.setdefault(c, set()).add(m.group(1))
            if "body=" in m.group(0):
                bodies.add(m.group(1))
    reach = set()
    stack = list(bodies)
    while stack:
        c = stack.pop()
        if c in reach:
            continue
        reach.add(c)
        stack.extend(edges.get(c, ()))
    return reach


def collective_bytes(hlo_text):
    """(op_name, shape_str, bytes, in_loop_body) for every all-reduce in
    optimized HLO.  ``all-reduce-done`` lines are skipped (the payload is
    counted once on the start/combined op — counting both would double
    async collectives, ADVICE r3), and each op is tagged with whether its
    enclosing computation is a while-loop body, so the 24C bytes/CG-iter
    verification can anchor to ops that actually execute per iteration
    rather than loop-hoisted ones."""
    lines = hlo_text.splitlines()
    comps = _computation_of_line(hlo_text)
    bodies = while_body_computations(hlo_text)
    out = []
    for i, line in enumerate(lines):
        m = re.match(r"\s*%?([\w.-]+) = ([^=\n]*?) all-reduce"
                     r"(-start)?\(", line)
        if not m:
            continue
        shapes = re.findall(r"(f32|bf16|f64|s32|u32|pred|f16)\[([\d,]*)\]",
                            m.group(2))
        total = 0
        for dt, dims in shapes:
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * DTYPE_BYTES[dt]
        out.append((m.group(1), m.group(2).strip(), total,
                    comps[i] in bodies))
    return out


def main(C=256, L=32768, cg_iterations=25):
    from jax.sharding import Mesh
    from sfm_tpu.ba import Observations
    from sfm_tpu.parallel import partition_tables, build_dist_large_ba

    n_shards = 8
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("map",))
    rng = np.random.default_rng(0)
    kmax = 8
    home = (np.arange(L) * (C - kmax) // L).astype(np.int32)
    cam_idx = (home[:, None] + np.arange(kmax)[None, :]).reshape(-1)
    lm_idx = np.repeat(np.arange(L, dtype=np.int32), kmax)
    uv = rng.uniform(0, 640, (L * kmax, 2)).astype(np.float32)
    obs = Observations(jnp.asarray(cam_idx), jnp.asarray(lm_idx),
                       jnp.asarray(uv), jnp.ones(len(cam_idx)))
    tabs, shard_size = partition_tables(obs, C, L, n_shards,
                                        nmax=L // n_shards * kmax, kmax=kmax)
    fn = build_dist_large_ba(mesh, "map", n_cams=C, shard_size=shard_size,
                             iterations=1, cg_iterations=cg_iterations)
    K = jnp.asarray(np.array([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]],
                             np.float32))
    rvec = jnp.zeros((C, 3))
    tvec = jnp.asarray(rng.normal(0, 0.5, (C, 3)).astype(np.float32))
    xyz = jnp.asarray(np.stack([rng.uniform(-5, 5, L),
                                rng.uniform(-5, 5, L),
                                rng.uniform(5, 10, L)], 1).astype(np.float32))
    lowered = jax.jit(fn).lower(K, rvec, tvec, xyz, tabs,
                                jnp.ones(C, bool), jnp.ones(L, bool))
    hlo = lowered.compile().as_text()
    cols = collective_bytes(hlo)
    print(f"C={C}, L={L}, shards={n_shards}, cg_iterations={cg_iterations}")
    total = 0
    for name, sig, b, in_body in cols:
        tag = "loop-body" if in_body else "hoisted  "
        print(f"  all-reduce [{tag}] {name}: {b:>10d} B   {sig[:80]}")
        total += b
    # the CG-loop all-reduce executes cg_iterations times; loop-invariant
    # (hoisted) ones execute once per LM iteration.  The verification is
    # anchored to all-reduces INSIDE a while-loop body (ADVICE r3: a
    # loop-hoisted [C,6] collective must not satisfy the per-iteration
    # claim), and all-reduce-done lines are excluded from payload counting.
    cg_ops = [b for name, sig, b, in_body in cols
              if b == 24 * C and in_body]
    print(f"\nall-reduce ops in program: {len(cols)}, "
          f"total static payload {total} B")
    print(f"[C,6] f32 payload = {24*C} B inside a while-loop body -> "
          f"matches the 24C bytes/CG-iter claim: "
          f"{'YES' if cg_ops else 'NO'}")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

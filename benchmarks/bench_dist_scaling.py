"""Wall-clock distributed-BA scaling curve on the virtual CPU mesh
(VERDICT r3 task 6: an efficiency curve measured end-to-end, even if CPU
collectives are not the device's).

Strong scaling: a FIXED problem (C cameras, L landmarks, kmax obs per
landmark) solved by build_dist_large_ba on N = 1, 2, 4, 8 shards of an
--xla_force_host_platform_device_count mesh.  Efficiency(N) =
T(1) / (N * T(N)).  Virtual devices share one host's cores, so absolute
times and the curve are pessimistic bounds — the CPU "all-reduce" is a
memcpy but the shards timeshare compute.  These are CPU times, not GPU
numbers: chip_smoke.py --four-cards runs the same solver on four cards.

XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
    python benchmarks/bench_dist_scaling.py [C] [L] [cg_iters]
"""

import json
import os
import sys
import time

if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
from sfm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax.numpy as jnp


def main(C=256, L=65536, cg_iterations=15, iters=2, reps=5):
    from jax.sharding import Mesh
    from sfm_tpu.ba import Observations
    from sfm_tpu.parallel import partition_tables, build_dist_large_ba

    rng = np.random.default_rng(0)
    kmax = 6
    home = (np.arange(L) * (C - kmax) // L).astype(np.int32)
    cam_idx = (home[:, None] + np.arange(kmax)[None, :]).reshape(-1)
    lm_idx = np.repeat(np.arange(L, dtype=np.int32), kmax)
    X = np.stack([rng.uniform(-40, 40, L), rng.uniform(-8, 8, L),
                  rng.uniform(20, 50, L)], 1).astype(np.float32)
    cam_t = np.stack([np.linspace(-35, 35, C), np.zeros(C),
                      np.zeros(C)], 1).astype(np.float32)
    p = X[lm_idx] + cam_t[cam_idx]
    uv = ((p[:, :2] / p[:, 2:]) * 525.0
          + np.array([320.0, 240.0])).astype(np.float32)
    obs = Observations(jnp.asarray(cam_idx), jnp.asarray(lm_idx),
                       jnp.asarray(uv), jnp.ones(len(cam_idx)))
    K = jnp.asarray(np.array([[525.0, 0, 320], [0, 525.0, 240],
                              [0, 0, 1]], np.float32))
    rv0 = jnp.zeros((C, 3)).at[1:].add(0.002)
    tv0 = jnp.asarray(cam_t)
    X0 = jnp.asarray(X + rng.normal(0, 0.05, X.shape).astype(np.float32))
    cam_free = jnp.ones(C, bool).at[0].set(False)
    lm_free = jnp.ones(L, bool)

    # compile ALL shard counts first, then time them ROUND-ROBIN: the
    # efficiency ratio T(1)/(N*T(N)) is corrupted when the N=1 and N=N
    # measurements sample different host-load regimes minutes apart
    # (three sequential-phase runs measured N=2 at 98%, 52% and 49% on
    # the same code — scatter set entirely by what else the 2-core host
    # was doing).  Round-robin reps sample every N under the same
    # conditions; the min per N is the least-contended estimate.
    fns = {}
    args_n = {}
    for n in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:n]), ("map",))
        tabs, shard_size = partition_tables(
            obs, C, L, n, nmax=(L // n) * kmax, kmax=kmax)
        fns[n] = jax.jit(build_dist_large_ba(
            mesh, "map", n_cams=C, shard_size=shard_size,
            iterations=iters, cg_iterations=cg_iterations))
        args_n[n] = tabs
        out = fns[n](K, rv0, tv0, X0, tabs, cam_free, lm_free)
        jax.block_until_ready(out)
        stats = out[3]
        print(f"N={n}: compiled; cost {float(stats.initial_cost):.3e} -> "
              f"{float(stats.final_cost):.3e}", file=sys.stderr, flush=True)

    times = {n: np.inf for n in fns}
    costs = {}
    for _ in range(reps):
        for n in fns:
            t0 = time.time()
            out = fns[n](K, rv0, tv0, X0, args_n[n], cam_free, lm_free)
            jax.block_until_ready(out)
            times[n] = min(times[n], time.time() - t0)
            stats = out[3]
            costs[n] = (float(stats.initial_cost),
                        float(stats.final_cost))
    for n in fns:
        eff = times[1] / (n * times[n])
        print(f"N={n}: {times[n]*1e3:8.1f} ms/solve ({iters} LM x "
              f"{cg_iterations} CG), cost {costs[n][0]:.3e} -> "
              f"{costs[n][1]:.3e}, strong-scaling efficiency "
              f"{100*eff:.0f}%", file=sys.stderr, flush=True)

    # parity: the sharded solves must agree on the final cost
    ref = costs[1][1]
    for n in (2, 4, 8):
        rel = abs(costs[n][1] - ref) / max(abs(ref), 1e-12)
        assert rel < 5e-2, f"N={n} final cost diverged: {costs[n][1]} vs {ref}"

    # the evidentiary comparison (VERDICT r4 weak #2): N virtual devices
    # TIMESHARE this host's physical cores, so the hard efficiency bound
    # is min(1, cores/N).  The distributed program is exonerated iff the
    # measured curve tracks that bound — any gap below it is REAL
    # partitioning/collective overhead.
    cores = os.cpu_count()
    print(f"\nhost cores: {cores} — core-bound vs measured:",
          file=sys.stderr)
    ratios = []
    for n in (2, 4, 8):
        bound = min(1.0, cores / n)
        eff = times[1] / (n * times[n])
        ratios.append(eff / bound)
        print(f"  N={n}: bound {100*bound:5.1f}%  measured {100*eff:5.1f}%"
              f"  -> {100*eff/bound:5.1f}% of bound", file=sys.stderr)

    eff8 = times[1] / (8 * times[8])
    print(json.dumps({
        "metric": "dist_ba_cpu_mesh_efficiency_n8",
        "value": round(100 * eff8, 1),
        "unit": f"% strong-scaling efficiency at N=8 virtual CPU devices "
                f"(C={C}, L={L}, kmax={kmax}; curve: " +
                ", ".join(f"N={n}: {times[1]/(n*times[n])*100:.0f}%"
                          for n in (2, 4, 8)) +
                f"; host has {cores} cores -> core-bound min(1,{cores}/N); "
                "measured/bound: " +
                ", ".join(f"N={n}: {100*r:.0f}%"
                          for n, r in zip((2, 4, 8), ratios)) + ")",
        "vs_baseline": None,
    }))


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:] if not a.startswith("--")]
    main(*args)

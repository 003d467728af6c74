"""Proof that the SfM engine runs on one NVIDIA GPU through the entry points
its users call, at the flagship width, with its outputs checked.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # only the multi-card paths (4 cards)
    python chip_smoke.py --four-cards --only fleet,mesh2d   # some of them
    python chip_smoke.py --rehearse    # tiny shapes on any backend; never
                                       # reports ok

Phases (one process, which owns the card; nothing it starts touches JAX):
  1. device: JAX's platform/kind/count, the card's name and power limit
     (read from nvidia-smi before JAX takes the card);
  2. flagship: the deferred-mapping chunk step + mapping step of the
     flagship config, as bench.py drives them, on the seeded 80-frame
     sprite strafe: cold compile, memory analysis, peak memory, RUNNING
     share > 90%, sim(3) keyframe ATE < 2% of the extent;
  3. cli: ``sfm_tpu.cli.main(["scan", ..., "--chunk", "10"])`` on a seeded
     ray-traced .y4m (native decoder built by make): nonzero PLY, RUNNING
     share > 90%, ATE < 2%;
  4. serve: ScanServer + ScanClient in this process, uint8 RGB frames in,
     point cloud out;
  5. reference: the Hamming matcher against a NumPy brute-force matcher
     (exact), the large-BA solver against the f64 NumPy reference (final
     cost within 1%), the int8 patch-extraction path against the float
     path (bit-flip rate) and approximate against exact keypoint top-k.

``--four-cards`` runs the landmark-sharded distributed BA on a 4-way
``map`` mesh against the one-card solver (dist_ba), 8 flagship scans
sharded over 4 cards against the same 8 batched on one card (fleet: equal
statuses, each run's frame ATE per scan, and the two runs' trajectories
agreeing up to the monocular scale), the dense distributed BA on a 2x2
scan x map mesh against the one-card dense solver (mesh2d), and the
pipelined engine (tracking on card 0, mapping on card 1) against the ATE
gate (pipeline).

Every phase prints ``PHASE <name>: PASS|FAIL``.  The last line of standard
output is one JSON object; it holds ``"ok": true`` only when every phase
passed on a GPU.  Any failed phase exits non-zero."""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RUNNING_GATE = 0.90
ATE_GATE = 0.02
BA_COST_TOL = 0.01
HEADING_STEP = 0.1          # radians between the fleet scans' paths


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    """'name, power.limit' of each card, or None when nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


class Sizes:
    """Shapes of each phase: the real widths, or tiny ones to rehearse the
    control flow on a CPU."""

    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        if rehearse:
            self.hw = (240, 320)
            self.flagship_overrides = dict(
                image_height=240, image_width=320, max_keypoints=256,
                max_keyframes=16, max_landmarks=2048,
                ba_landmark_capacity=512, track_widen_capacity=512,
                mapping_reobs_capacity=512, pyramid_levels=3,
                # half the keypoints track half as many points: keep the
                # keyframe policy's floor in proportion
                keyframe_min_tracked=25)
            self.strafe_frames, self.cli_frames, self.serve_frames = 40, 30, 12
            self.matcher_shapes = [(256, 64), (64, 64)]
            self.ba_shape = (8, 200, 4)          # cams, landmarks, kmax
            self.dist_ba_shape = (40, 2000, 6)
            self.fleet = (8, 80)                 # scans, frames
        else:
            self.hw = (480, 640)
            self.flagship_overrides = {}
            self.strafe_frames, self.cli_frames, self.serve_frames = 80, 60, 20
            self.matcher_shapes = [(2048, 512), (512, 512)]
            self.ba_shape = (32, 2048, 8)
            self.dist_ba_shape = (1000, 100_000, 6)
            self.fleet = (8, 80)

    def flagship_config(self):
        import dataclasses
        import __graft_entry__ as g
        return dataclasses.replace(g.flagship_config(),
                                   **self.flagship_overrides)

    def camera(self):
        from bench import camera
        return camera(self.K())

    def K(self):
        import __graft_entry__ as g
        s = self.hw[0] / 480.0
        K = g.FLAGSHIP_K.copy()
        K[:2] *= s
        return K


# ------------------------------------------------------------------ helpers

def memory_line(name, compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return f"  {name} memory_analysis: not available on this backend"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    parts = ", ".join(f"{f.replace('_size_in_bytes', '')}="
                      f"{getattr(ma, f, 0) / 2**20:.1f} MiB" for f in fields)
    return f"  {name} memory_analysis: {parts}"


def peak_memory_line(dev):
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    if peak is None:
        return "  peak_bytes_in_use: not reported by this backend"
    return (f"  peak_bytes_in_use: {peak / 2**30:.3f} GiB "
            f"(limit {stats.get('bytes_limit', 0) / 2**30:.1f} GiB)")


def ate_fraction(state, rvecs, tvecs, n_frames):
    from bench import keyframe_ate
    ate, extent, n_kf = keyframe_ate(state, rvecs, tvecs, n_frames)
    if ate is None:
        return None, None, n_kf
    return ate / max(extent, 1e-9), extent, n_kf


def gate(ok, what):
    if not ok:
        raise AssertionError(f"gate failed: {what}")


def sprite_strafe(sz, n_frames, seed=11, rgb=False, heading=0.0):
    """(rvecs, tvecs, frames): bench.py's seeded strafe at these sizes."""
    from bench import strafe_scan
    return strafe_scan(sz.K(), n_frames, *sz.hw, seed=seed, rgb=rgb,
                       heading=heading)[1:]


# ------------------------------------------------------------------- phases

def phase_flagship(sz, dev):
    import jax
    from bench import flagship_steps, run_strafe
    from sfm_tpu.engine.state import init_state

    cfg = sz.flagship_config()
    cam = sz.camera()
    chunk = cfg.keyframe_time_lag
    rvecs, tvecs, frames = sprite_strafe(sz, sz.strafe_frames)
    chunk_step, map_step = flagship_steps(cfg, cam)
    state = init_state(cfg)
    first = jax.numpy.asarray(frames[:chunk])
    t0 = time.time()
    c_chunk = chunk_step.lower(state, first).compile()
    c_map = map_step.lower(state).compile()
    compile_s = time.time() - t0
    log(f"  cold compile (chunk step + mapping step): {compile_s:.1f} s")
    log(memory_line("chunk step", c_chunk))
    log(memory_line("mapping step", c_map))

    state, metrics, run_s = run_strafe(c_chunk, c_map, state, frames, chunk)
    status = np.concatenate([np.asarray(m.status) for m in metrics])
    running = float((status == 1).mean())
    ate, extent, n_kf = ate_fraction(state, rvecs, tvecs, len(frames))
    log(peak_memory_line(dev))
    log(f"  frames {len(status)}, RUNNING {running:.4f}, keyframes {n_kf}, "
        f"landmarks {int(np.asarray(state.lms.valid).sum())}")
    if ate is not None:
        log(f"  sim(3) keyframe ATE {100 * ate:.3f}% of {extent:.2f} m")
    log(f"  informational: {1000 * run_s / len(status):.2f} ms/frame "
        f"amortized incl. mapping ({dev.device_kind})")
    gate(running > RUNNING_GATE, f"RUNNING {running:.3f} <= {RUNNING_GATE}")
    gate(ate is not None and ate < ATE_GATE, f"ATE {ate} >= {ATE_GATE}")


def phase_cli(sz, dev):
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from concurrent.futures import ThreadPoolExecutor
    from bench_acceptance import write_y4m, DIST
    from sfm_tpu import cli
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.io import load_state, read_ply
    from sfm_tpu.io.ply import _native
    from sfm_tpu.raytrace import RayScene, orbit_arc_trajectory

    gate(_native() is not None, "native runtime (make -C sfm_tpu/native)")
    log("  native y4m/PLY runtime: built")
    n = sz.cli_frames
    h, w = sz.hw
    K = sz.K()
    flag = sz.flagship_config()
    # the CLI builds its config from these flags; the checkpoint reloads
    # with the same capacities
    cli_cfg = SfMConfig(image_height=h, image_width=w,
                        max_keypoints=flag.max_keypoints,
                        max_keyframes=flag.max_keyframes,
                        max_landmarks=flag.max_landmarks,
                        feature_dtype=flag.feature_dtype)
    scene = RayScene(seed=11, n_boxes=24)
    rvecs, tvecs = orbit_arc_trajectory(n, radius=5.5, arc=0.7 * n / 60.0)
    t0 = time.time()
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        frames = np.stack(list(ex.map(
            lambda i: scene.render(K, rvecs[i], tvecs[i], h, w, d=DIST,
                                   noise_std=2.5, frame_no=i), range(n))))
    log(f"  rendered {n} ray-traced frames in {time.time() - t0:.1f} s")
    work = tempfile.mkdtemp(prefix="sfm_smoke_")
    try:
        y4m, ply = os.path.join(work, "scan.y4m"), os.path.join(work, "c.ply")
        ckpt = os.path.join(work, "state.npz")
        metrics = os.path.join(work, "metrics.jsonl")
        write_y4m(y4m, frames)
        argv = ["scan", "--input", y4m, "--output", ply,
                "--fx", str(K[0, 0]), "--fy", str(K[1, 1]),
                "--cx", str(K[0, 2]), "--cy", str(K[1, 2]),
                "--dist"] + [str(d) for d in DIST] + [
                "--chunk", "10", "--feature-dtype", cli_cfg.feature_dtype,
                "--max-keypoints", str(cli_cfg.max_keypoints),
                "--max-keyframes", str(cli_cfg.max_keyframes),
                "--max-landmarks", str(cli_cfg.max_landmarks),
                "--checkpoint", ckpt, "--metrics", metrics]
        t0 = time.time()
        rc = cli.main(argv)
        log(f"  cli scan rc={rc} in {time.time() - t0:.1f} s (incl. compile)")
        gate(rc == 0, f"cli rc {rc}")
        with open(metrics) as f:
            status = np.array([json.loads(line)["status"] for line in f])
        running = float((status == 1).mean())
        xyz, rgb = read_ply(ply)
        state = load_state(ckpt, cli_cfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ate, extent, n_kf = ate_fraction(state, rvecs, tvecs, n)
    log(f"  PLY points {len(xyz)} (colored {rgb is not None}), frames "
        f"{len(status)}, RUNNING {running:.4f}, keyframes {n_kf}")
    if ate is not None:
        log(f"  sim(3) keyframe ATE {100 * ate:.3f}% of {extent:.2f} m")
    gate(len(xyz) > 0 and np.isfinite(xyz).all(), "PLY has points")
    gate(running > RUNNING_GATE, f"RUNNING {running:.3f} <= {RUNNING_GATE}")
    gate(ate is not None and ate < ATE_GATE, f"ATE {ate} >= {ATE_GATE}")


def phase_serve(sz, dev):
    import __graft_entry__ as g
    from sfm_tpu.serving import ScanClient, ScanServer

    _, _, frames = sprite_strafe(sz, sz.serve_frames, rgb=True)
    frames = np.clip(frames, 0, 255).astype(np.uint8)
    h, w = sz.hw
    K = sz.K()
    overrides = {**g.FLAGSHIP, **sz.flagship_overrides}
    overrides.pop("image_height")
    overrides.pop("image_width")
    with ScanServer(port=0) as srv:
        cl = ScanClient("127.0.0.1", srv.port)
        try:
            cl.init(h, w, float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                    float(K[1, 2]), config=overrides)
            t0 = time.time()
            ms = [cl.add_frame(f) for f in frames]
            log(f"  {len(ms)} uint8 RGB frames served in "
                f"{time.time() - t0:.1f} s (incl. compile)")
            xyz, rgb = cl.get_cloud()
        finally:
            cl.close()
    status = [m["status"] for m in ms]
    log(f"  statuses {status}")
    log(f"  cloud: {len(xyz)} points, colors {rgb.shape}")
    gate(status[-1] == 1, "served scan RUNNING at the end")
    gate(len(xyz) > 0 and np.isfinite(xyz).all(), "cloud has points")


def check_matcher(sz, rng):
    import jax
    from sfm_tpu.features.match import match_features
    from sfm_tpu.features.reference import brute_force_match, random_case
    kw = dict(min_radius=1.5, max_radius=40.0, max_distance=90.0, ratio=0.8)
    f = jax.jit(lambda *a: match_features(*a, **kw))
    for n_src, n_tgt in sz.matcher_shapes:
        args = random_case(rng, n_src, n_tgt)
        got = jax.device_get(f(*args))
        idx, dist, mask = brute_force_match(*args, **kw)
        same = (np.array_equal(got.mask, mask)
                and np.array_equal(got.idx, idx)
                and np.array_equal(got.dist, dist))
        log(f"  matcher {n_src}x{n_tgt}: {int(mask.sum())} matches, "
            f"{'exact' if same else 'MISMATCH'} vs NumPy brute force")
        gate(same, f"matcher {n_src}x{n_tgt} exact")


def check_large_ba(sz):
    import jax
    import jax.numpy as jnp
    from sfm_tpu.ba import Observations
    from sfm_tpu.ba.large import build_tables, run_large_ba
    from sfm_tpu.ba.reference import reference_ba
    from sfm_tpu.synthetic import banded_ba_problem

    C, L, kmax = sz.ba_shape
    pb = banded_ba_problem(C, L, kmax, seed=3, noise_px=0.5)
    n_obs = len(pb["cam_idx"])
    obs = Observations(jnp.asarray(pb["cam_idx"]), jnp.asarray(pb["lm_idx"]),
                       jnp.asarray(pb["uv"]), jnp.ones(n_obs, jnp.float32))
    nmax = int(np.bincount(pb["cam_idx"], minlength=C).max())
    tables = build_tables(obs, C, L, nmax=nmax, kmax=kmax)
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    lm_free = np.ones(L, bool)
    solve = jax.jit(lambda rv, tv, X: run_large_ba(
        jnp.asarray(pb["K"]), rv, tv, X, tables,
        cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free),
        iterations=30, cg_iterations=50, tol=1e-8))
    out = solve(jnp.asarray(pb["rvec0"]), jnp.asarray(pb["tvec0"]),
                jnp.asarray(pb["xyz0"]))
    cost = float(out[3].final_cost)
    t0 = time.time()
    _, _, _, costs = reference_ba(
        pb["K"], pb["rvec0"], pb["tvec0"], pb["xyz0"], pb["cam_idx"],
        pb["lm_idx"], pb["uv"], np.ones(n_obs), cam_free=cam_free,
        lm_free=lm_free, iterations=40, tol=1e-10)
    rel = abs(cost - costs[-1]) / costs[-1]
    log(f"  large BA {C} cams x {L} landmarks x kmax {kmax} ({n_obs} obs): "
        f"final cost {cost:.6g} (JAX, float32 matmul precision "
        f"{jax.config.jax_default_matmul_precision}) vs {costs[-1]:.6g} "
        f"(f64 NumPy reference, {time.time() - t0:.0f} s); rel diff "
        f"{rel:.2e} (tol {BA_COST_TOL})")
    gate(rel <= BA_COST_TOL, "large BA final cost within 1% of reference")


def check_feature_paths(sz, rng):
    """int8 vs float patch extraction and approximate vs exact top-k, on
    one flagship frame."""
    import jax
    import jax.numpy as jnp
    from sfm_tpu.features.bits import unpack_bits
    from sfm_tpu.features.descriptor import describe_canvas
    from sfm_tpu.features.detect import detect

    cfg = sz.flagship_config()
    _, _, frames = sprite_strafe(sz, 1)
    img = jnp.asarray(frames[0])
    bf16 = jnp.bfloat16

    def describe(img, int8):
        kps, canvas = detect(img, max_keypoints=cfg.max_keypoints,
                             levels=cfg.pyramid_levels, compute_dtype=bf16,
                             return_canvas=True)
        return kps, describe_canvas(canvas, kps, cfg.pyramid_levels,
                                    cfg.image_width, compute_dtype=bf16,
                                    patch_int8=int8)

    f_int8 = jax.jit(lambda im: describe(im, True)).lower(img).compile()
    dots = sorted({" x ".join(re.findall(r"\b([a-z]+\d+)\[", line)[:3])
                   for line in f_int8.as_text().splitlines()
                   if " dot(" in line or "gemm" in line})
    kps, d8 = f_int8(img)
    _, df = jax.jit(lambda im: describe(im, False))(img)
    valid = np.asarray(kps.valid)
    b8 = np.asarray(unpack_bits(d8))[valid]
    bf = np.asarray(unpack_bits(df))[valid]
    flip = float((b8 != bf).mean())
    log(f"  int8 patch extraction: compiled; dot/gemm types (result x "
        f"operands) in the optimized HLO: {dots}")
    log(f"  int8 descriptor bit flips vs the float path {100 * flip:.2f}% "
        f"over {int(valid.sum())} keypoints")
    gate(flip < 0.06, "int8 descriptor bit flips < 6%")

    def top(im, approx):
        return detect(im, max_keypoints=cfg.max_keypoints,
                      levels=cfg.pyramid_levels, compute_dtype=bf16,
                      approx_topk=approx)
    ka = jax.device_get(jax.jit(lambda im: top(im, True))(img))
    ke = jax.device_get(jax.jit(lambda im: top(im, False))(img))
    sa = {tuple(p) for p in np.round(ka.xy[ka.valid], 2).tolist()}
    se = {tuple(p) for p in np.round(ke.xy[ke.valid], 2).tolist()}
    log(f"  approx_max_k keypoint selection: {len(sa & se)}/{len(se)} of "
        "the exact top-k")
    log(f"  jax_default_matmul_precision: "
        f"{jax.config.jax_default_matmul_precision}")


def phase_reference(sz, dev):
    rng = np.random.default_rng(5)
    check_matcher(sz, rng)
    check_large_ba(sz)
    check_feature_paths(sz, rng)


# ------------------------------------------------------------- four cards

def device_counts(tree):
    import jax
    return sorted({len(x.sharding.device_set)
                   for x in jax.tree.leaves(tree) if hasattr(x, "sharding")})


def phase_dist_ba(sz, devs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from sfm_tpu.ba import Observations
    from sfm_tpu.ba.large import build_tables_device, run_large_ba
    from sfm_tpu.parallel import partition_tables, build_dist_large_ba
    from sfm_tpu.synthetic import banded_ba_problem

    C, L, kmax = sz.dist_ba_shape
    pb = banded_ba_problem(C, L, kmax, seed=0)
    n_obs = len(pb["cam_idx"])
    obs = Observations(jnp.asarray(pb["cam_idx"]), jnp.asarray(pb["lm_idx"]),
                       jnp.asarray(pb["uv"]), jnp.ones(n_obs, jnp.float32))
    iters, cg = 8, 25
    cam_free = jnp.ones(C, bool).at[0].set(False)
    args = (jnp.asarray(pb["K"]), jnp.asarray(pb["rvec0"]),
            jnp.asarray(pb["tvec0"]), jnp.asarray(pb["xyz0"]))

    per_shard = L // 4
    lm_shard = pb["lm_idx"] // per_shard
    nmax = int(max(np.bincount(pb["cam_idx"][lm_shard == s],
                               minlength=C).max() for s in range(4)))
    t0 = time.time()
    tabs, shard_size = partition_tables(obs, C, L, 4, nmax=nmax, kmax=kmax)
    log(f"  {C} cams x {L} landmarks, {n_obs} obs; shard tables built on "
        f"the host in {time.time() - t0:.1f} s")
    mesh = Mesh(np.array(devs[:4]), ("map",))
    tabs = jax.device_put(tabs, NamedSharding(mesh, P("map")))
    dist = build_dist_large_ba(mesh, "map", n_cams=C, shard_size=shard_size,
                               iterations=iters, cg_iterations=cg)
    t0 = time.time()
    out4 = dist(*args, tabs, cam_free, jnp.ones(L, bool))
    jax.block_until_ready(out4)
    log(f"  4-card distributed BA: {time.time() - t0:.1f} s incl. compile; "
        f"cost {float(out4[3].initial_cost):.6g} -> "
        f"{float(out4[3].final_cost):.6g}; device_set sizes: xyz "
        f"{len(out4[2].sharding.device_set)}, tables {device_counts(tabs)}")

    nmax1 = int(np.bincount(pb["cam_idx"], minlength=C).max())
    one = jax.jit(lambda K, rv, tv, X, o: run_large_ba(
        K, rv, tv, X, build_tables_device(o, C, L, nmax=nmax1,
                                          kmax=kmax)[0],
        cam_free=cam_free, lm_free=jnp.ones(L, bool), iterations=iters,
        cg_iterations=cg, tol=0.0))
    t0 = time.time()
    args1, obs1 = jax.device_put((args, obs), devs[0])
    out1 = one(*args1, obs1)
    jax.block_until_ready(out1)
    c4, c1 = float(out4[3].final_cost), float(out1[3].final_cost)
    rel = abs(c4 - c1) / c1
    log(f"  1-card run_large_ba: {time.time() - t0:.1f} s incl. compile; "
        f"final cost {c1:.6g}; 4-card vs 1-card rel diff {rel:.2e} "
        f"(tol {BA_COST_TOL}); device_set size "
        f"{len(out1[2].sharding.device_set)}")
    gate(len(out4[2].sharding.device_set) == 4, "xyz sharded over 4 cards")
    gate(rel <= BA_COST_TOL, "distributed BA cost within 1% of one card")


def run_fleet(step, states, frames, put):
    """Step a batch of scans through frames [T, B, H, W]; (states, per-frame
    metrics on the host, seconds incl. compile)."""
    import jax
    t0 = time.time()
    ms = []
    for f in frames:
        states, m = step(states, put(f))
        ms.append(m)
    jax.block_until_ready(states.status)
    return states, jax.device_get(ms), time.time() - t0


def phase_fleet(sz, devs):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from bench import centres
    from sfm_tpu.parallel import (build_batched_step, build_sharded_step,
                                  init_batched_state, shard_batched_state)

    cfg = sz.flagship_config()
    cam = sz.camera()
    B, T = sz.fleet
    # the flagship strafe's scene, one direction of travel per scan: a scan
    # whose frames or poses were swapped with another's cannot match
    headings = HEADING_STEP * (np.arange(B) - (B - 1) / 2)
    scans = [sprite_strafe(sz, T, heading=h) for h in headings]
    frames = np.stack([f for _, _, f in scans],
                      axis=1).astype(np.float32)          # [T, B, H, W]

    mesh = Mesh(np.array(devs[:4]), ("scan",))
    img_sh = NamedSharding(mesh, P("scan"))
    states4, m4, s4 = run_fleet(
        build_sharded_step(cfg, cam, mesh),
        shard_batched_state(init_batched_state(cfg, B), mesh), frames,
        lambda f: jax.device_put(f, img_sh))
    log(f"  {B} flagship scans x {T} frames over 4 cards: {s4:.1f} s incl. "
        f"compile; device_set sizes {device_counts(states4)}")
    states1, m1, s1 = run_fleet(
        jax.jit(build_batched_step(cfg, cam), donate_argnums=(0,)),
        jax.device_put(init_batched_state(cfg, B), devs[0]), frames,
        lambda f: jax.device_put(f, devs[0]))
    log(f"  same {B} scans batched on one card: {s1:.1f} s incl. compile; "
        f"device_set sizes {device_counts(states1)}")

    st4 = np.stack([m.status for m in m4])                 # [T, B]
    st1 = np.stack([m.status for m in m1])
    log(f"  statuses equal frame by frame: {np.array_equal(st4, st1)}; "
        f"RUNNING at the end {int((st4[-1] == 1).sum())}/{B} (4 cards), "
        f"{int((st1[-1] == 1).sum())}/{B} (1 card)")
    gate(all(c == 4 for c in device_counts(states4)),
         "fleet state sharded over 4 cards")
    gate(np.array_equal(st4, st1), "statuses equal")
    worst_ate = worst_gap = 0.0
    for b, (rv, tv, _) in enumerate(scans):
        run = np.nonzero(st1[:, b] == 1)[0]
        gate(len(run) > T // 2, f"scan {b} RUNNING on most frames")
        gt = centres(rv, tv)
        est = [centres([m[t].rvec[b] for t in run],
                       [m[t].tvec[b] for t in run]) for m in (m4, m1)]
        # keyframe 0 is the origin of both runs and of the ground truth:
        # they share its gauge but for the monocular scale, which the
        # bootstrap pair sets.  So the runs are compared after scaling
        # alone, which leaves each scan's direction of travel in place
        scale = [float(np.linalg.norm(e[0])
                       / np.linalg.norm(gt[run[0]] - gt[0])) for e in est]
        e4, e1 = est
        k = float((e4 * e1).sum() / (e4 * e4).sum())
        gap = float(np.sqrt(((k * e4 - e1) ** 2).sum(1).mean())
                    / np.linalg.norm(e1[-1] - e1[0]))
        turn = [float(np.arctan2(e[-1, 1], e[-1, 0])) - headings[b]
                for e in est]
        kf = [ate_fraction(jax.tree.map(lambda x: x[b], st), rv, tv, T)
              for st in (states4, states1)]
        gate(all(a is not None for a, _, _ in kf), f"scan {b}: keyframes "
             f"{[n for _, _, n in kf]}")
        worst_ate = max(worst_ate, kf[0][0], kf[1][0])
        worst_gap = max(worst_gap, gap)
        log(f"  scan {b} (heading {headings[b]:+.2f} rad), 4-card / 1-card: "
            f"bootstrap frame {run[0]}, scale {scale[0]:.6f} / "
            f"{scale[1]:.6f}; keyframes {kf[0][2]} / {kf[1][2]}, keyframe "
            f"ATE {100 * kf[0][0]:.3f}% / {100 * kf[1][0]:.3f}% of "
            f"{kf[1][1]:.2f} m; heading error {turn[0]:+.4f} / "
            f"{turn[1]:+.4f} rad; largest raw centre difference "
            f"{float(np.abs(e4 - e1).max()):.3e}; scale-aligned gap "
            f"{100 * gap:.4f}% of the 1-card extent")
    log(f"  worst keyframe ATE {100 * worst_ate:.3f}%, worst scale-aligned "
        f"gap {100 * worst_gap:.4f}% (gate {100 * ATE_GATE}% for each)")
    gate(worst_ate < ATE_GATE, "every scan's keyframe ATE in both runs")
    # headings HEADING_STEP apart: a scan swapped between the runs would
    # leave a gap of about sin(HEADING_STEP) / sqrt(3), above the gate
    gate(worst_gap < ATE_GATE, "4-card and 1-card trajectories agree")


def phase_mesh2d(sz, devs):
    """Dense distributed BA on the ``map`` axis of a 2x2 scan x map mesh
    (so replicated over ``scan``) against the one-card dense solver."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from sfm_tpu.ba import Observations, run_ba
    from sfm_tpu.parallel import (build_dist_ba, make_scan_map_mesh,
                                  partition_observations)
    from sfm_tpu.synthetic import banded_ba_problem

    mesh = make_scan_map_mesh(2)
    n_map = mesh.shape["map"]
    C, L, kmax = sz.ba_shape
    pb = banded_ba_problem(C, L, kmax, seed=3, noise_px=0.5)
    n_obs = len(pb["cam_idx"])
    obs = Observations(jnp.asarray(pb["cam_idx"]), jnp.asarray(pb["lm_idx"]),
                       jnp.asarray(pb["uv"]), jnp.ones(n_obs, jnp.float32))
    iters = 10
    cam_free = jnp.ones(C, bool).at[0].set(False)
    lm_free = jnp.ones(L, bool)
    args = (jnp.asarray(pb["K"]), jnp.asarray(pb["rvec0"]),
            jnp.asarray(pb["tvec0"]), jnp.asarray(pb["xyz0"]))
    per_shard = np.bincount(pb["lm_idx"] // (L // n_map), minlength=n_map)
    obs_sh, shard_size = partition_observations(
        obs, L, n_map, cap_per_shard=int(per_shard.max()))
    sh = NamedSharding(mesh, P("map"))
    obs_sh, xyz, lm_free_sh = jax.device_put((obs_sh, args[3], lm_free), sh)
    dist = build_dist_ba(mesh, "map", n_cams=C, shard_size=shard_size,
                         iterations=iters)
    t0 = time.time()
    out2 = dist(*args[:3], xyz, obs_sh, cam_free, lm_free_sh)
    jax.block_until_ready(out2)
    log(f"  mesh {dict(mesh.shape)}; dense distributed BA {C} cams x {L} "
        f"landmarks ({n_obs} obs): {time.time() - t0:.1f} s incl. compile; "
        f"cost {float(out2[3].initial_cost):.6g} -> "
        f"{float(out2[3].final_cost):.6g}; device_set sizes: xyz "
        f"{len(out2[2].sharding.device_set)}, observations "
        f"{device_counts(obs_sh)}")
    one = jax.jit(lambda K, rv, tv, X, o: run_ba(
        K, rv, tv, X, o, cam_free=cam_free, lm_free=lm_free,
        iterations=iters, tol=0.0))
    args1, obs1 = jax.device_put((args, obs), devs[0])
    out1 = one(*args1, obs1)
    c2, c1 = float(out2[3].final_cost), float(out1[3].final_cost)
    rel = abs(c2 - c1) / c1
    log(f"  1-card run_ba: final cost {c1:.6g}; 2x2 vs 1-card rel diff "
        f"{rel:.2e} (tol {BA_COST_TOL}); device_set size "
        f"{len(out1[2].sharding.device_set)}")
    gate(len(out2[2].sharding.device_set) == 4, "xyz on all 4 cards")
    gate(rel <= BA_COST_TOL, "2x2 dense BA cost within 1% of one card")


def phase_pipeline(sz, devs):
    import jax
    from sfm_tpu.parallel.pipeline import AsyncMappingEngine

    cfg = sz.flagship_config()
    cam = sz.camera()
    rvecs, tvecs, frames = sprite_strafe(sz, sz.strafe_frames)
    eng = AsyncMappingEngine(cfg, cam, track_device=devs[0],
                             map_device=devs[1])
    map_devs = set()
    t0 = time.time()
    status = []
    for f in frames:
        status.append(int(eng.step(f)["status"]))
        if eng._inflight is not None:
            map_devs |= {d.id for d in eng._inflight[1].lms.xyz.devices()}
    eng.flush()
    jax.block_until_ready(eng.state.status)
    running = float((np.array(status) == 1).mean())
    ate, extent, n_kf = ate_fraction(eng.state, rvecs, tvecs, len(frames))
    track_devs = sorted(d.id for d in eng.state.lms.xyz.devices())
    log(f"  pipelined engine: {time.time() - t0:.1f} s incl. compile; "
        f"tracking state on device {track_devs}, mapping results on "
        f"device {sorted(map_devs)}; RUNNING "
        f"{running:.4f}, keyframes {n_kf}")
    if ate is not None:
        log(f"  sim(3) keyframe ATE {100 * ate:.3f}% of {extent:.2f} m")
    gate(map_devs == {devs[1].id}, "mapping ran on card 1")
    gate(running > RUNNING_GATE, f"RUNNING {running:.3f}")
    gate(ate is not None and ate < ATE_GATE, f"ATE {ate}")


# --------------------------------------------------------------------- main

def run_phase(name, fn, results):
    log(f"PHASE {name}: start")
    t0 = time.time()
    try:
        fn()
    except Exception:
        traceback.print_exc(file=sys.stdout)
        results[name] = False
        log(f"PHASE {name}: FAIL ({time.time() - t0:.1f} s)")
        return
    results[name] = True
    log(f"PHASE {name}: PASS ({time.time() - t0:.1f} s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths on 4 cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes on any backend; never reports ok")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (default: all of "
                         "the selected mode)")
    args = ap.parse_args(argv)

    card = nvidia_smi()                 # before JAX takes the card
    if args.rehearse and args.four_cards:
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=4")
    sys.path.insert(0, ROOT)
    import jax
    from bench import device_info
    from sfm_tpu.utils.cache import enable_compile_cache

    devs = jax.devices()
    info = device_info()
    log(f"PHASE device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']} jax={jax.__version__}")
    log(f"card: {card if card else 'nvidia-smi not available'}")
    if info["platform"] != "gpu" and not args.rehearse:
        log("PHASE device: FAIL (JAX found no GPU; --rehearse runs tiny "
            "shapes without one)")
        print(json.dumps({"ok": False, "device": info}))
        return 1
    need = 4 if args.four_cards else 1
    if info["count"] < need:
        log(f"PHASE device: FAIL (needs {need} devices, found "
            f"{info['count']})")
        print(json.dumps({"ok": False, "device": info}))
        return 1
    log("PHASE device: PASS")
    cache = enable_compile_cache()
    log(f"compile cache: {cache}")

    sz = Sizes(args.rehearse)
    if args.four_cards:
        devs4 = devs[:4]
        phases = {"dist_ba": lambda: phase_dist_ba(sz, devs4),
                  "fleet": lambda: phase_fleet(sz, devs4),
                  "mesh2d": lambda: phase_mesh2d(sz, devs4),
                  "pipeline": lambda: phase_pipeline(sz, devs4)}
    else:
        dev = devs[0]
        phases = {"flagship": lambda: phase_flagship(sz, dev),
                  "cli": lambda: phase_cli(sz, dev),
                  "serve": lambda: phase_serve(sz, dev),
                  "reference": lambda: phase_reference(sz, dev)}
    chosen = args.only.split(",") if args.only else list(phases)
    unknown = set(chosen) - set(phases)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from "
                 f"{list(phases)}")
    results = {}
    for name in chosen:
        run_phase(name, phases[name], results)

    ok = all(results.values()) and not args.rehearse
    log(f"summary: {json.dumps(results)}")
    log(f"card: {card if card else 'nvidia-smi not available'}")
    out = {"ok": ok, "device": info}
    if args.rehearse:
        out["rehearsal"] = True
    if args.only:
        out["phases"] = chosen
    print(json.dumps(out))
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

"""CI wrappers for the end-to-end acceptance gates: the reference-shaped
video->PLY workload (benchmarks/bench_acceptance.py) and the TUM-format
dataset surface (benchmarks/bench_tum_format.py), both run as the real
CLI subprocess with exit-code gates.  Slow tests (~2-4 min each on CPU);
chip_smoke.py runs the video->PLY path at full scale on the GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, n_frames):
    env = dict(os.environ)
    pp = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = (pp + os.pathsep + ROOT) if pp else ROOT
    # the CLI subprocess must run on CPU like the suite itself
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", script),
         str(n_frames)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, \
        f"{script} gate failed:\n{proc.stderr[-3000:]}"


def test_acceptance_video_to_ply_gate():
    """y4m video -> cli scan --chunk -> colored PLY, gated on RUNNING %,
    sim(3) ATE and cloud-surface distance (main/main.cpp workload)."""
    _run("bench_acceptance.py", 48)


def test_tum_format_gate():
    """Synthesized TUM layout -> cli tum -> sim(3) ATE gate (exercises
    PNG decode, index parsing, timestamp association, gt interpolation)."""
    _run("bench_tum_format.py", 48)

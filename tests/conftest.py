"""Test configuration: run on 8 virtual CPU devices so sharding/collective
code paths are exercised without accelerator hardware (SURVEY.md §4.4).
Tests marked ``gpu`` need an NVIDIA card and skip elsewhere; run them on
the card with ``SFM_TEST_ON_GPU=1 python -m pytest tests/ -m gpu``, which
leaves JAX on the backend it picks."""

import os

_ON_CARD = os.environ.get("SFM_TEST_ON_GPU") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")

from sfm_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import json

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# fast/slow markers from recorded durations (VERDICT round 2 item 9):
#   pytest -m fast   -> unit-level suite, target < 3 min
#   pytest           -> everything (CI)
# tests/durations.json maps nodeid -> seconds (setup + call); regenerate
# with RECORD_DURATIONS=1 python -m pytest tests/ -q.  Unknown tests
# default to fast, so new tests join the quick loop until re-recorded.
# ---------------------------------------------------------------------------

_DUR_FILE = os.path.join(os.path.dirname(__file__), "durations.json")
_SLOW_SECONDS = 3.0   # fast suite: ~92 tests / ~60 s device time
                      # (round-4 re-record; target < 180 s wall)
_recorded = {}


def pytest_configure(config):
    config.addinivalue_line("markers", "fast: unit-level test (< ~5 s)")
    config.addinivalue_line("markers", "slow: heavy integration test")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (skips without one; run with "
        "SFM_TEST_ON_GPU=1 python -m pytest tests/ -m gpu)")


def pytest_collection_modifyitems(config, items):
    try:
        with open(_DUR_FILE) as f:
            durations = json.load(f)
    except OSError:
        durations = {}
    for item in items:
        if durations.get(item.nodeid, 0.0) > _SLOW_SECONDS:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)


def pytest_runtest_logreport(report):
    if report.when in ("setup", "call"):
        _recorded[report.nodeid] = _recorded.get(report.nodeid, 0.0) \
            + report.duration


def pytest_sessionfinish(session, exitstatus):
    if os.environ.get("RECORD_DURATIONS"):
        with open(_DUR_FILE, "w") as f:
            json.dump(dict(sorted(_recorded.items())), f, indent=0)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (SFM_TEST_ON_GPU=1 on a card)")
    return devs[0]

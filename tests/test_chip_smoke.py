"""The GPU bring-up surface off the card: chip_smoke.py and bench.py refuse
to report without a GPU, and the flagship configuration does not depend on
the backend.  The ``gpu``-marked test runs only on a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu(capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke
    rc = chip_smoke.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc != 0
    last = json.loads(lines[-1])
    assert last["ok"] is False and last["device"]["platform"] == "cpu"
    assert not any('"ok": true' in line for line in lines)


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script has nothing to run."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_bench_requires_gpu():
    sys.path.insert(0, ROOT)
    import bench
    with pytest.raises(SystemExit) as e:
        bench.require_gpu()
    assert e.value.code != 0


@pytest.mark.parametrize("platform", ["cpu", "gpu", "tpu"])
def test_flagship_config_is_backend_independent(monkeypatch, platform):
    import jax
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g
    from sfm_tpu.config import SfMConfig

    class FakeDevice:
        device_kind = "fake"

    FakeDevice.platform = platform
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    cfg = g.flagship_config()
    assert cfg == SfMConfig(**g.FLAGSHIP)
    assert (cfg.image_height, cfg.image_width, cfg.max_keypoints,
            cfg.max_keyframes, cfg.max_landmarks, cfg.ba_solver) == \
        (480, 640, 512, 32, 8192, "large")


@pytest.mark.gpu
def test_matcher_on_card_matches_brute_force(gpu):
    import jax
    from sfm_tpu.features.match import match_features
    from sfm_tpu.features.reference import brute_force_match, random_case
    args = random_case(np.random.default_rng(0), 2048, 512)
    kw = dict(min_radius=1.5, max_radius=40.0, max_distance=90.0, ratio=0.8)
    dev_args = jax.device_put(args, gpu)
    got = jax.device_get(jax.jit(
        lambda *a: match_features(*a, **kw))(*dev_args))
    idx, dist, mask = brute_force_match(*args, **kw)
    np.testing.assert_array_equal(got.idx, idx)
    np.testing.assert_array_equal(got.dist, dist)

"""Tests for profiling utilities, TUM loader/eval, and multi-host mesh."""

import numpy as np
import pytest

from sfm_tpu.utils import PhaseTimer, summarize_metrics
from sfm_tpu.io.tum import ate_sim3, associate, TUMSequence, TUM_INTRINSICS


class TestPhaseTimer:
    def test_accumulates(self):
        t = PhaseTimer()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        with t.phase("b"):
            pass
        s = t.summary()
        assert s["a"]["count"] == 2 and s["b"]["count"] == 1
        assert "a" in t.report()


class TestMetricsSummary:
    def test_summary(self):
        log = [dict(status=np.int32(1), n_tracked=np.int32(50),
                    n_keyframes=np.int32(3), n_landmarks=np.int32(100),
                    keyframe_added=np.bool_(i == 1),
                    mean_reproj_err=np.float32(1.5)) for i in range(4)]
        s = summarize_metrics(log)
        assert s["n_frames"] == 4 and s["n_running"] == 4
        assert s["keyframes_added"] == 1
        assert abs(s["mean_reproj_err"] - 1.5) < 1e-6


class TestATE:
    def test_zero_for_similarity_transformed(self, rng):
        gt = rng.normal(0, 1, (30, 3))
        R = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
        if np.linalg.det(R) < 0:
            R[:, 0] *= -1
        est = 2.5 * gt @ R.T + np.array([4.0, -1.0, 2.0])
        assert ate_sim3(est, gt) < 1e-6

    def test_positive_for_noise(self, rng):
        gt = rng.normal(0, 1, (30, 3))
        est = gt + rng.normal(0, 0.1, (30, 3))
        a = ate_sim3(est, gt)
        assert 0.01 < a < 0.3


class TestTUM:
    def test_sequence_layout(self, rng, tmp_path):
        from PIL import Image
        rgbdir = tmp_path / "rgb"
        rgbdir.mkdir()
        with open(tmp_path / "rgb.txt", "w") as f:
            f.write("# comment\n")
            for i in range(3):
                name = f"rgb/{i:06d}.png"
                Image.fromarray(rng.integers(0, 255, (24, 32, 3))
                                .astype(np.uint8)).save(tmp_path / name)
                f.write(f"{i * 0.033:.6f} {name}\n")
        with open(tmp_path / "groundtruth.txt", "w") as f:
            for i in range(5):
                t = i * 0.02
                f.write(f"{t:.6f} {t} 0 0 0 0 0 1\n")
        seq = TUMSequence(str(tmp_path))
        assert len(seq) == 3
        frames = list(seq.frames())
        assert frames[0][1].shape == (24, 32)
        pos = seq.gt_positions_at(np.array([0.01, 0.03]))
        np.testing.assert_allclose(pos[:, 0], [0.01, 0.03], atol=1e-6)

    def test_associate(self):
        a = np.array([0.0, 0.1, 0.2])
        b = np.array([0.005, 0.11, 0.5])
        pairs = associate(a, b, max_dt=0.02)
        assert (0, 0) in pairs and (1, 1) in pairs
        assert len(pairs) == 2

    def test_intrinsics_present(self):
        assert set(TUM_INTRINSICS) == {"fr1", "fr2", "fr3"}


class TestCompileCache:
    def test_env_var_is_honoured(self, monkeypatch, tmp_path):
        import jax
        from sfm_tpu.utils.cache import enable_compile_cache
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself: nothing is set in code
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_inside_the_checkout_and_stable(self, monkeypatch):
        import os
        import jax
        import sfm_tpu
        from sfm_tpu.utils.cache import default_cache_dir, \
            enable_compile_cache
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            sfm_tpu.__file__)))
        path = enable_compile_cache()
        assert path == os.path.join(root, ".jax_cache")
        assert path == default_cache_dir() == enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path

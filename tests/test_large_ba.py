"""Implicit-Schur PCG bundle adjustment tests: table building, parity with
the dense-coupling solver, convergence at larger scale."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sfm_tpu.ba import Observations, run_ba
from sfm_tpu.ba.large import build_tables, run_large_ba
from test_ba import make_ba_scene


class TestTables:
    def test_build_roundtrip(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=3, n_pts=20)
        t = build_tables(obs, 3, 20, nmax=32, kmax=8)
        # every live observation appears once in each layout
        assert float(t.lm_w.sum()) == float(np.asarray(obs.w).sum())
        assert float(t.cam_w.sum()) == float(np.asarray(obs.w).sum())
        # cross-consistency: cam-major row c contains exactly the landmarks
        # whose lm-major rows list camera c
        lm_cam = np.asarray(t.lm_cam); lm_w = np.asarray(t.lm_w)
        cam_lm = np.asarray(t.cam_lm); cam_w = np.asarray(t.cam_w)
        for c in range(3):
            a = sorted(cam_lm[c][cam_w[c] > 0].tolist())
            b = sorted(np.nonzero(((lm_cam == c) & (lm_w > 0)).any(1))[0]
                       .tolist())
            assert a == b

    def test_overflow_drops_consistently(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=4, n_pts=10)
        t = build_tables(obs, 4, 10, nmax=16, kmax=2)  # kmax < 4 cams
        # both tables keep the same (reduced) observation count
        assert float(t.lm_w.sum()) == float(t.cam_w.sum())
        assert float(t.lm_w.sum()) <= 10 * 2


class TestLargeBA:
    def test_parity_with_dense_solver(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=4, n_pts=60)
        rv0 = rvec.at[1:].add(0.01)
        X0 = X + 0.03
        cam_free = jnp.ones(4, bool).at[0].set(False)
        lm_free = jnp.ones(60, bool)
        rv_d, tv_d, X_d, stats_d = run_ba(
            K, rv0, tvec, X0, obs, cam_free=cam_free, lm_free=lm_free,
            iterations=15)
        tables = build_tables(obs, 4, 60, nmax=64, kmax=4)
        rv_l, tv_l, X_l, stats_l = run_large_ba(
            K, rv0, tvec, X0, tables, cam_free=cam_free, lm_free=lm_free,
            iterations=15, cg_iterations=40)
        # both reach (near-)zero cost on the noiseless scene
        assert float(stats_l.final_cost) < 1e-2
        np.testing.assert_allclose(np.asarray(rv_l), np.asarray(rv_d),
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(X_l), np.asarray(X_d),
                                   atol=5e-3)

    def test_medium_scale_convergence(self, rng):
        # 20 cameras, 800 landmarks, ~6 obs/landmark
        n_cams, n_pts = 20, 800
        from synthetic import rodrigues_np, project_np, DEFAULT_K
        K = DEFAULT_K
        X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                      rng.uniform(6, 12, n_pts)], 1).astype(np.float32)
        cam_idx, lm_idx, uvs = [], [], []
        rvs, tvs = [], []
        for c in range(n_cams):
            rv = rng.uniform(-0.03, 0.03, 3).astype(np.float32)
            tv = np.array([0.15 * c, 0, 0], np.float32)
            rvs.append(rv); tvs.append(tv)
            sel = rng.choice(n_pts, 240, replace=False)
            uv = project_np(K, rodrigues_np(rv), tv, X[sel]).astype(np.float32)
            cam_idx.append(np.full(240, c)); lm_idx.append(sel); uvs.append(uv)
        obs = Observations(
            jnp.asarray(np.concatenate(cam_idx).astype(np.int32)),
            jnp.asarray(np.concatenate(lm_idx).astype(np.int32)),
            jnp.asarray(np.concatenate(uvs)),
            jnp.ones(n_cams * 240))
        tables = build_tables(obs, n_cams, n_pts, nmax=256, kmax=16)
        rv0 = jnp.asarray(np.stack(rvs)).at[1:].add(0.01)
        tv0 = jnp.asarray(np.stack(tvs))
        X0 = jnp.asarray(X) + \
            jnp.asarray(rng.normal(0, 0.05, X.shape).astype(np.float32))
        cam_free = jnp.ones(n_cams, bool).at[0].set(False)
        rv, tv, Xf, stats = run_large_ba(
            K, rv0, tv0, X0, tables, cam_free=cam_free,
            lm_free=jnp.ones(n_pts, bool), iterations=12, cg_iterations=30)
        assert float(stats.final_cost) < 1e-3 * float(stats.initial_cost)
        np.testing.assert_allclose(np.asarray(rv), np.stack(rvs), atol=2e-3)


class TestDeviceTables:
    def test_matches_host_builder(self, rng):
        from sfm_tpu.ba.large import build_tables_device
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=3, n_pts=20)
        # knock out some observations (padding) like a real masked list
        w = np.asarray(obs.w).copy()
        w[rng.random(len(w)) < 0.2] = 0.0
        obs = obs._replace(w=jnp.asarray(w))
        th = build_tables(obs, 3, 20, nmax=32, kmax=8)
        td, n_drop = jax.jit(lambda o: build_tables_device(o, 3, 20, 32, 8))(
            obs)
        assert int(n_drop) == 0
        # no overflow here: identical observation multisets per row
        for name in ("lm", "cam"):
            ch, uh, wh = (getattr(th, f"{name}_cam" if name == "lm"
                                  else "cam_lm"),
                          getattr(th, f"{name}_uv"),
                          getattr(th, f"{name}_w"))
            cd, ud, wd = (getattr(td, f"{name}_cam" if name == "lm"
                                  else "cam_lm"),
                          getattr(td, f"{name}_uv"),
                          getattr(td, f"{name}_w"))
            ch, uh, wh = np.asarray(ch), np.asarray(uh), np.asarray(wh)
            cd, ud, wd = np.asarray(cd), np.asarray(ud), np.asarray(wd)
            assert wh.sum() == wd.sum()
            for row in range(ch.shape[0]):
                live_h = wh[row] > 0
                live_d = wd[row] > 0
                a = sorted(map(tuple, np.concatenate(
                    [ch[row][live_h, None], uh[row][live_h]], 1).tolist()))
                b = sorted(map(tuple, np.concatenate(
                    [cd[row][live_d, None], ud[row][live_d]], 1).tolist()))
                assert a == b, f"{name} row {row} differs"

    def test_overflow_consistent(self, rng):
        from sfm_tpu.ba.large import build_tables_device
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=4, n_pts=10)
        t, n_drop = build_tables_device(obs, 4, 10, nmax=16, kmax=2)
        assert float(t.lm_w.sum()) == float(t.cam_w.sum())
        assert float(t.lm_w.sum()) <= 10 * 2
        # every landmark is seen by 4 cams but kmax=2: the overflow count
        # must be surfaced, not silent (VERDICT round 2 item 7)
        assert int(n_drop) == 10 * (4 - 2)

    def test_solver_runs_on_device_tables(self, rng):
        from sfm_tpu.ba.large import build_tables_device
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=4, n_pts=60)
        tables, _ = build_tables_device(obs, 4, 60, nmax=64, kmax=4)
        rv0 = rvec.at[1:].add(0.01)
        X0 = X + 0.03
        rv, tv, Xf, stats = run_large_ba(
            K, rv0, tvec, X0, tables,
            cam_free=jnp.ones(4, bool).at[0].set(False),
            lm_free=jnp.ones(60, bool), iterations=15, cg_iterations=40)
        assert float(stats.final_cost) < 1e-2


class TestCouplingOps:
    """The two table-layout contractions of the implicit Schur complement
    against a dense [C, L, 6, 3] coupling built from the same blocks."""

    @staticmethod
    def _problem(rng):
        from sfm_tpu.ba.large import _blocks_lm_major, _blocks_cam_major
        from sfm_tpu.geometry.rotations import exp_so3
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=5, n_pts=40)
        # a sparse visibility pattern: drop ~40% of the observations
        w = jnp.asarray((rng.random(len(obs.w)) > 0.4).astype(np.float32))
        obs = obs._replace(w=w)
        t = build_tables(obs, 5, 40, nmax=40, kmax=5)
        R = exp_so3(rvec)
        ones_c, ones_l = jnp.ones(5), jnp.ones(40)
        _, A_l, B_l, _, _ = _blocks_lm_major(K, R, tvec, X, t, ones_c,
                                             ones_l, 0.0)
        _, A_c, B_c, _, _ = _blocks_cam_major(K, R, tvec, X, t, ones_c,
                                              ones_l, 0.0)
        W_l = jnp.einsum("lkia,lkib->lkab", A_l, B_l)
        W_c = jnp.einsum("cjia,cjib->cjab", A_c, B_c)
        dense = np.zeros((5, 40, 6, 3))
        lm_cam, lm_w = np.asarray(t.lm_cam), np.asarray(t.lm_w)
        for l, k in zip(*np.nonzero(lm_w > 0)):
            dense[lm_cam[l, k], l] += np.asarray(W_l[l, k])
        return t, W_l, W_c, dense

    @pytest.mark.parametrize("direction", ["wT_x", "w_z"])
    def test_matches_dense(self, rng, direction):
        from sfm_tpu.ba.large import make_coupling_ops
        t, W_l, W_c, dense = self._problem(rng)
        wT_x, w_z = make_coupling_ops(t)
        if direction == "wT_x":
            x = rng.normal(0, 1, (5, 6)).astype(np.float32)
            got = wT_x(W_l, jnp.asarray(x))
            want = np.einsum("clab,ca->lb", dense, x)
        else:
            z = rng.normal(0, 1, (40, 3)).astype(np.float32)
            got = w_z(W_c, jnp.asarray(z))
            want = np.einsum("clab,lb->ca", dense, z)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

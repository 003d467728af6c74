"""Bundle adjustment tests: analytic Jacobians vs autodiff, convergence
from perturbed ground truth in all three BA modes, gauge fixing, masking.
Parity target: the Ceres-equivalent behavior of CTracker.cpp:670-702."""

import numpy as np
import jax
import jax.numpy as jnp

from sfm_tpu.ba import (Observations, residuals_and_jacobians, run_ba,
                        BAMode, total_cost, apply_pose_update)
from sfm_tpu.geometry import exp_so3, project
from synthetic import rodrigues_np, project_np, DEFAULT_K


def make_ba_scene(rng, n_cams=4, n_pts=60, noise_px=0.0):
    K = DEFAULT_K
    X = np.stack([
        rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
        rng.uniform(5, 9, n_pts)], axis=1).astype(np.float32)
    rvecs, tvecs, uvs = [], [], []
    for c in range(n_cams):
        rv = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
        tv = np.array([0.4 * c, 0.0, 0.0], np.float32) + \
            rng.uniform(-0.05, 0.05, 3).astype(np.float32)
        uv = project_np(K, rodrigues_np(rv), tv, X).astype(np.float32)
        uv += rng.normal(0, noise_px, uv.shape).astype(np.float32)
        rvecs.append(rv); tvecs.append(tv); uvs.append(uv)
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    lm_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.concatenate(uvs).astype(np.float32)
    obs = Observations(jnp.asarray(cam_idx), jnp.asarray(lm_idx),
                       jnp.asarray(uv), jnp.ones(len(cam_idx)))
    return (jnp.asarray(K), jnp.asarray(np.stack(rvecs)),
            jnp.asarray(np.stack(tvecs)), jnp.asarray(X), obs)


class TestJacobians:
    def test_analytic_matches_autodiff(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=2, n_pts=10)

        r, A, B = residuals_and_jacobians(K, exp_so3(rvec), tvec, X, obs)

        # autodiff through the local parameterization at zero increment
        def res_fn(dw_dt_dX):
            dw = dw_dt_dX[:2 * 3].reshape(2, 3)
            dt = dw_dt_dX[6:12].reshape(2, 3)
            dX = dw_dt_dX[12:].reshape(10, 3)
            rv2, tv2 = jax.vmap(apply_pose_update)(rvec, tvec, dw, dt)
            X2 = X + dX
            r2, _, _ = residuals_and_jacobians(K, exp_so3(rv2), tv2, X2, obs)
            return r2.reshape(-1)

        J = jax.jacfwd(res_fn)(jnp.zeros(12 + 30))
        J = np.asarray(J).reshape(len(obs.cam_idx), 2, 42)
        ci = np.asarray(obs.cam_idx)
        li = np.asarray(obs.lm_idx)
        for o in range(len(ci)):
            Jw = J[o, :, ci[o] * 3:(ci[o] + 1) * 3]
            Jt = J[o, :, 6 + ci[o] * 3:6 + (ci[o] + 1) * 3]
            JX = J[o, :, 12 + li[o] * 3:12 + (li[o] + 1) * 3]
            np.testing.assert_allclose(np.asarray(A)[o, :, :3], Jw, atol=1e-2)
            np.testing.assert_allclose(np.asarray(A)[o, :, 3:], Jt, atol=1e-2)
            np.testing.assert_allclose(np.asarray(B)[o], JX, atol=1e-2)


class TestConvergence:
    def _perturb(self, rng, rvec, tvec, X, s_pose=0.02, s_pt=0.05):
        rv = np.asarray(rvec) + rng.normal(0, s_pose, rvec.shape).astype(np.float32)
        tv = np.asarray(tvec) + rng.normal(0, s_pose, tvec.shape).astype(np.float32)
        Xp = np.asarray(X) + rng.normal(0, s_pt, X.shape).astype(np.float32)
        return jnp.asarray(rv), jnp.asarray(tv), jnp.asarray(Xp)

    def test_struct_and_pose_converges(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng)
        rv0, tv0, X0 = self._perturb(rng, rvec, tvec, X)
        # gauge: fix camera 0 (the perturbation keeps cam0 noisy, so fix the
        # TRUE cam0 for comparison)
        rv0 = rv0.at[0].set(rvec[0]); tv0 = tv0.at[0].set(tvec[0])
        cam_free = jnp.ones(4, bool).at[0].set(False)
        rv, tv, Xf, stats = run_ba(K, rv0, tv0, X0, obs,
                                   cam_free=cam_free,
                                   lm_free=jnp.ones(60, bool),
                                   iterations=25)
        assert float(stats.final_cost) < 1e-2 * float(stats.initial_cost)
        cost = total_cost(K, rv, tv, Xf, obs)
        assert float(cost) / len(obs.cam_idx) < 0.05  # px^2 per obs
        # poses recovered (gauge fixed by cam0 + scale fixed by... scene):
        np.testing.assert_allclose(np.asarray(rv), np.asarray(rvec), atol=5e-3)

    def test_pose_only(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng)
        rv0, tv0, _ = self._perturb(rng, rvec, tvec, X, s_pt=0.0)
        rv, tv, Xf, stats = run_ba(K, rv0, tv0, X, obs,
                                   cam_free=jnp.ones(4, bool),
                                   lm_free=jnp.ones(60, bool),
                                   mode=BAMode.POSE_ONLY, iterations=15)
        np.testing.assert_allclose(np.asarray(Xf), np.asarray(X))  # frozen
        np.testing.assert_allclose(np.asarray(rv), np.asarray(rvec), atol=1e-3)
        np.testing.assert_allclose(np.asarray(tv), np.asarray(tvec), atol=1e-2)

    def test_struct_only(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng)
        _, _, X0 = self._perturb(rng, rvec, tvec, X)
        rv, tv, Xf, stats = run_ba(K, rvec, tvec, X0, obs,
                                   cam_free=jnp.ones(4, bool),
                                   lm_free=jnp.ones(60, bool),
                                   mode=BAMode.STRUCT_ONLY, iterations=15)
        # frozen up to the exp/log roundtrip of the zero update
        np.testing.assert_allclose(np.asarray(rv), np.asarray(rvec), atol=1e-6)
        np.testing.assert_allclose(np.asarray(Xf), np.asarray(X), atol=2e-2)

    def test_masked_padding_untouched(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=3, n_pts=40)
        # add padding: extra camera slot + landmark slots that no obs uses
        rvec_p = jnp.concatenate([rvec, jnp.zeros((1, 3))])
        tvec_p = jnp.concatenate([tvec, jnp.zeros((1, 3))])
        X_p = jnp.concatenate([X, jnp.full((8, 3), 7.7)])
        rv0 = rvec_p + 0.01
        X0 = X_p + 0.02
        cam_free = jnp.asarray([False, True, True, True])
        lm_free = jnp.concatenate([jnp.ones(40, bool), jnp.zeros(8, bool)])
        rv, tv, Xf, _ = run_ba(K, rv0, tvec_p, X0, obs,
                               cam_free=cam_free, lm_free=lm_free,
                               iterations=10)
        # frozen cam 0 and padding landmarks unchanged (up to the exp/log
        # roundtrip of the zero pose update)
        np.testing.assert_allclose(np.asarray(rv)[0], np.asarray(rv0)[0],
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(Xf)[40:], np.asarray(X0)[40:])

    def test_huber_downweights_outliers(self, rng):
        K, rvec, tvec, X, obs = make_ba_scene(rng, noise_px=0.2)
        uv = np.asarray(obs.uv).copy()
        uv[::17] += 40.0  # gross outliers
        obs = obs._replace(uv=jnp.asarray(uv))
        rv0, tv0, X0 = self._perturb(rng, rvec, tvec, X)
        rv0 = rv0.at[0].set(rvec[0]); tv0 = tv0.at[0].set(tvec[0])
        cam_free = jnp.ones(4, bool).at[0].set(False)
        rv_h, tv_h, _, _ = run_ba(K, rv0, tv0, X0, obs, cam_free=cam_free,
                                  lm_free=jnp.ones(60, bool),
                                  iterations=25, huber_delta=2.0)
        rv_n, tv_n, _, _ = run_ba(K, rv0, tv0, X0, obs, cam_free=cam_free,
                                  lm_free=jnp.ones(60, bool), iterations=25)
        err_h = np.abs(np.asarray(rv_h) - np.asarray(rvec)).max()
        err_n = np.abs(np.asarray(rv_n) - np.asarray(rvec)).max()
        assert err_h < err_n  # robust loss helps under contamination
        assert err_h < 5e-3


class TestCGSolver:
    """run_ba_cg: the implicit-Schur PCG solver used by the mapping BA
    (cfg.ba_solver="cg") must match run_ba's STRUCT_AND_POSE behavior."""

    def test_cg_converges_and_matches_dense(self, rng):
        from sfm_tpu.ba import run_ba_cg
        K, rvec, tvec, X, obs = make_ba_scene(rng)
        rv0 = np.asarray(rvec) + rng.normal(0, 0.02, rvec.shape).astype(np.float32)
        tv0 = np.asarray(tvec) + rng.normal(0, 0.02, tvec.shape).astype(np.float32)
        X0 = np.asarray(X) + rng.normal(0, 0.05, X.shape).astype(np.float32)
        rv0 = jnp.asarray(rv0).at[0].set(rvec[0])
        tv0 = jnp.asarray(tv0).at[0].set(tvec[0])
        X0 = jnp.asarray(X0)
        cam_free = jnp.ones(4, bool).at[0].set(False)
        lm_free = jnp.ones(60, bool)
        rv_d, tv_d, X_d, st_d = run_ba(K, rv0, tv0, X0, obs,
                                       cam_free=cam_free, lm_free=lm_free,
                                       iterations=25)
        rv_c, tv_c, X_c, st_c = run_ba_cg(K, rv0, tv0, X0, obs,
                                          cam_free=cam_free, lm_free=lm_free,
                                          iterations=25, cg_iterations=20)
        assert float(st_c.final_cost) < 1e-2 * float(st_c.initial_cost)
        # both reach the same optimum (exact projections -> cost ~ 0)
        assert float(st_c.final_cost) < float(st_d.final_cost) * 10 + 1e-4
        np.testing.assert_allclose(np.asarray(rv_c), np.asarray(rv_d),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(tv_c), np.asarray(tv_d),
                                   atol=1e-2)

    def test_cg_masked_padding_untouched(self, rng):
        from sfm_tpu.ba import run_ba_cg
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=3, n_pts=40)
        rvec_p = jnp.concatenate([rvec, jnp.zeros((1, 3))])
        tvec_p = jnp.concatenate([tvec, jnp.zeros((1, 3))])
        X_p = jnp.concatenate([X, jnp.full((8, 3), 7.7)])
        rv0 = rvec_p + 0.01
        X0 = X_p + 0.02
        cam_free = jnp.asarray([False, True, True, False])
        lm_free = jnp.concatenate([jnp.ones(40, bool), jnp.zeros(8, bool)])
        rv, tv, Xf, _ = run_ba_cg(K, rv0, tvec_p, X0, obs,
                                  cam_free=cam_free, lm_free=lm_free,
                                  iterations=10)
        # frozen slots keep their inputs (up to the exp/log roundtrip of
        # the zero pose update, as in run_ba)
        np.testing.assert_allclose(np.asarray(rv)[0], np.asarray(rv0)[0],
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(rv)[3], np.asarray(rv0)[3],
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(Xf)[40:], np.asarray(X0)[40:])


class TestCompaction:
    """compact_ba_problem / scatter_back_landmarks: BA over the compacted
    landmark axis must match full-axis BA exactly when capacity suffices,
    and overflow must degrade gracefully (extra landmarks stay fixed)."""

    def _scattered_scene(self, rng, L_total=96, n_pts=40):
        # live landmarks scattered through a mostly-dead slot axis
        K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=3, n_pts=n_pts)
        slots = np.sort(rng.choice(L_total, n_pts, replace=False))
        X_full = jnp.asarray(np.full((L_total, 3), 7.7, np.float32)
                             ).at[jnp.asarray(slots)].set(X)
        lm_valid = jnp.zeros(L_total, bool).at[jnp.asarray(slots)].set(True)
        remap = jnp.asarray(slots, jnp.int32)[obs.lm_idx]
        obs = obs._replace(lm_idx=remap)
        return K, rvec, tvec, X_full, lm_valid, obs, slots

    def test_compact_matches_full(self, rng):
        from sfm_tpu.ba.core import compact_ba_problem, \
            scatter_back_landmarks
        K, rvec, tvec, X_full, lm_valid, obs, slots = \
            self._scattered_scene(rng)
        X0 = X_full + 0.02 * lm_valid[:, None]
        rv0 = rvec + 0.01
        cam_free = jnp.asarray([False, True, True])

        rv_f, tv_f, X_f, st_f = run_ba(
            K, rv0, tvec, X0, obs, cam_free=cam_free, lm_free=lm_valid,
            iterations=10)

        Xc, lm_free_c, obs_c, inv = compact_ba_problem(X0, lm_valid, obs, 64)
        assert int(jnp.sum(lm_free_c)) == 40
        rv_c, tv_c, X_c, st_c = run_ba(
            K, rv0, tvec, Xc, obs_c, cam_free=cam_free, lm_free=lm_free_c,
            iterations=10)
        X_back = scatter_back_landmarks(X0, X_c, inv)

        np.testing.assert_allclose(np.asarray(rv_c), np.asarray(rv_f),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(X_back), np.asarray(X_f),
                                   atol=1e-4)
        # dead slots keep their sentinel value
        dead = ~np.asarray(lm_valid)
        np.testing.assert_allclose(np.asarray(X_back)[dead], 7.7)

    def test_overflow_keeps_extra_landmarks_fixed(self, rng):
        from sfm_tpu.ba.core import compact_ba_problem, \
            scatter_back_landmarks
        K, rvec, tvec, X_full, lm_valid, obs, slots = \
            self._scattered_scene(rng)
        X0 = X_full + 0.02 * lm_valid[:, None]
        cam_free = jnp.asarray([False, True, True])
        cap = 24  # < 40 live landmarks: the last 16 overflow
        Xc, lm_free_c, obs_c, inv = compact_ba_problem(X0, lm_valid, obs,
                                                       cap)
        assert int(jnp.sum(lm_free_c)) == cap
        # dropped observations are zero-weighted
        assert float(jnp.sum(obs_c.w)) < float(jnp.sum(obs.w))
        rv_c, tv_c, X_c, _ = run_ba(
            K, rvec + 0.01, tvec, Xc, obs_c, cam_free=cam_free,
            lm_free=lm_free_c, iterations=8)
        X_back = scatter_back_landmarks(X0, X_c, inv)
        # overflowed live slots keep their input positions
        over = np.asarray(slots)[cap:]
        np.testing.assert_allclose(np.asarray(X_back)[over],
                                   np.asarray(X0)[over])


def test_cam_major_assembly_matches_scatter(rng):
    """Scatter-free (cam-major reshape + one-hot matmul) assembly must produce
    the same LM trajectory as the scatter path."""
    K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=3, n_pts=40)
    # make_ba_scene emits the canonical cam-major repeat layout
    assert np.array_equal(np.asarray(obs.cam_idx),
                          np.repeat(np.arange(3), 40))
    rv0 = rvec + 0.01
    X0 = X + 0.02
    cam_free = jnp.asarray([False, True, True])
    lm_free = jnp.ones(40, bool)
    out_s = run_ba(K, rv0, tvec, X0, obs, cam_free=cam_free,
                   lm_free=lm_free, iterations=10, cam_major=False)
    out_m = run_ba(K, rv0, tvec, X0, obs, cam_free=cam_free,
                   lm_free=lm_free, iterations=10, cam_major=True)
    np.testing.assert_allclose(np.asarray(out_m[0]), np.asarray(out_s[0]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_m[1]), np.asarray(out_s[1]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_m[2]), np.asarray(out_s[2]),
                               atol=1e-4)
    assert int(out_m[3].accepted) == int(out_s[3].accepted)

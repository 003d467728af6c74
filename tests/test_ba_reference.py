"""Golden parity of every JAX BA solver against the independent f64 NumPy
reference solver (sfm_tpu/ba/reference.py) — the in-repo stand-in for the
"ATE vs Ceres baseline" criterion (the Ceres solve it anchors:
/root/reference/CTracker.cpp:670-702).

All scenes are NOISY so the optimum is non-trivial (a noiseless scene lets
any descent method reach cost ~0; parity there proves little)."""

import numpy as np
import jax.numpy as jnp

from sfm_tpu.ba import run_ba, run_ba_cg, BAMode, Observations
from sfm_tpu.ba.large import build_tables, run_large_ba
from sfm_tpu.ba.reference import reference_ba_obs, _exp_so3, _log_so3
from test_ba import make_ba_scene


def _perturbed_scene(rng, n_cams=4, n_pts=60, noise_px=0.5):
    K, rvec, tvec, X, obs = make_ba_scene(rng, n_cams=n_cams, n_pts=n_pts,
                                          noise_px=noise_px)
    rv0 = np.asarray(rvec) + rng.normal(0, 0.01, rvec.shape)
    tv0 = np.asarray(tvec) + rng.normal(0, 0.01, tvec.shape)
    X0 = np.asarray(X) + rng.normal(0, 0.03, X.shape)
    rv0[0], tv0[0] = np.asarray(rvec)[0], np.asarray(tvec)[0]  # gauge anchor
    cam_free = np.ones(n_cams, bool)
    cam_free[0] = False
    lm_free = np.ones(n_pts, bool)
    return (K, jnp.asarray(rv0, jnp.float32), jnp.asarray(tv0, jnp.float32),
            jnp.asarray(X0, jnp.float32), obs, cam_free, lm_free)


def _reference(K, rv0, tv0, X0, obs, cam_free, lm_free):
    return reference_ba_obs(K, rv0, tv0, X0, obs, cam_free=cam_free,
                            lm_free=lm_free, iterations=40, tol=1e-10)


class TestRotations:
    def test_exp_log_roundtrip(self, rng):
        for _ in range(20):
            w = rng.normal(0, 1.0, 3)
            np.testing.assert_allclose(_log_so3(_exp_so3(w)), w, atol=1e-9)

    def test_log_near_pi(self):
        w = np.array([0.0, 0.0, np.pi - 1e-8])
        w2 = _log_so3(_exp_so3(w))
        np.testing.assert_allclose(_exp_so3(w2), _exp_so3(w), atol=1e-6)


class TestReferenceSelfConsistency:
    def test_noiseless_to_zero(self, rng):
        K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(
            rng, noise_px=0.0)
        _, _, _, costs = _reference(K, rv0, tv0, X0, obs, cam_free, lm_free)
        assert costs[-1] < 1e-10 * costs[0]

    def test_monotone_accepted_costs(self, rng):
        K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(rng)
        _, _, _, costs = _reference(K, rv0, tv0, X0, obs, cam_free, lm_free)
        assert all(b < a for a, b in zip(costs, costs[1:]))


class TestSolverParity:
    """Each JAX solver must reach the f64 reference optimum: final cost
    within 1%, free poses within tolerance."""

    def _check(self, rv, tv, cost, ref):
        rv_ref, tv_ref, _, costs_ref = ref
        assert abs(float(cost) - costs_ref[-1]) <= 0.01 * costs_ref[-1], \
            f"final cost {float(cost):.6g} vs reference {costs_ref[-1]:.6g}"
        np.testing.assert_allclose(np.asarray(rv), rv_ref, atol=2e-3)
        np.testing.assert_allclose(np.asarray(tv), tv_ref, atol=5e-3)

    def test_run_ba_dense(self, rng):
        K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(rng)
        ref = _reference(K, rv0, tv0, X0, obs, cam_free, lm_free)
        rv, tv, Xf, stats = run_ba(
            K, rv0, tv0, X0, obs, cam_free=jnp.asarray(cam_free),
            lm_free=jnp.asarray(lm_free), mode=BAMode.STRUCT_AND_POSE,
            iterations=30, tol=1e-8)
        self._check(rv, tv, stats.final_cost, ref)

    def test_run_ba_cam_major(self, rng):
        # the scatter-free assembly path used by the mapping pass: the obs
        # list from make_ba_scene is already repeat(arange(C), n_pts)
        K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(rng)
        ref = _reference(K, rv0, tv0, X0, obs, cam_free, lm_free)
        rv, tv, Xf, stats = run_ba(
            K, rv0, tv0, X0, obs, cam_free=jnp.asarray(cam_free),
            lm_free=jnp.asarray(lm_free), iterations=30, tol=1e-8,
            cam_major=True)
        self._check(rv, tv, stats.final_cost, ref)

    def test_run_ba_cg(self, rng):
        K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(rng)
        ref = _reference(K, rv0, tv0, X0, obs, cam_free, lm_free)
        rv, tv, Xf, stats = run_ba_cg(
            K, rv0, tv0, X0, obs, cam_free=jnp.asarray(cam_free),
            lm_free=jnp.asarray(lm_free), iterations=30,
            cg_iterations=40, tol=1e-8)
        self._check(rv, tv, stats.final_cost, ref)

    def test_run_large_ba(self, rng):
        K, rv0, tv0, X0, obs, cam_free, lm_free = _perturbed_scene(rng)
        ref = _reference(K, rv0, tv0, X0, obs, cam_free, lm_free)
        tables = build_tables(obs, 4, 60, nmax=64, kmax=4)
        rv, tv, Xf, stats = run_large_ba(
            K, rv0, tv0, X0, tables, cam_free=jnp.asarray(cam_free),
            lm_free=jnp.asarray(lm_free), iterations=30,
            cg_iterations=40, tol=1e-8)
        self._check(rv, tv, stats.final_cost, ref)

    def test_medium_scale_parity(self, rng):
        # 10 cams x 300 pts with subset visibility + noise: a problem shape
        # closer to a real mapping pass
        n_cams, n_pts, per_cam = 10, 300, 120
        from synthetic import rodrigues_np, project_np, DEFAULT_K
        K = DEFAULT_K
        X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                      rng.uniform(6, 12, n_pts)], 1)
        ci, li, uvs, rvs, tvs = [], [], [], [], []
        for c in range(n_cams):
            rv = rng.uniform(-0.03, 0.03, 3)
            tv = np.array([0.2 * c, 0, 0])
            rvs.append(rv); tvs.append(tv)
            sel = rng.choice(n_pts, per_cam, replace=False)
            uv = project_np(K, rodrigues_np(rv), tv, X[sel])
            uv = uv + rng.normal(0, 0.5, uv.shape)
            ci.append(np.full(per_cam, c)); li.append(sel); uvs.append(uv)
        obs = Observations(
            jnp.asarray(np.concatenate(ci).astype(np.int32)),
            jnp.asarray(np.concatenate(li).astype(np.int32)),
            jnp.asarray(np.concatenate(uvs), jnp.float32),
            jnp.ones(n_cams * per_cam))
        rv0 = np.stack(rvs) + rng.normal(0, 0.005, (n_cams, 3))
        tv0 = np.stack(tvs) + rng.normal(0, 0.005, (n_cams, 3))
        X0 = X + rng.normal(0, 0.02, X.shape)
        rv0[0], tv0[0] = rvs[0], tvs[0]
        cam_free = np.ones(n_cams, bool); cam_free[0] = False
        lm_free = np.ones(n_pts, bool)
        ref = _reference(K, rv0, tv0, X0, obs, cam_free, lm_free)

        rv0j = jnp.asarray(rv0, jnp.float32)
        tv0j = jnp.asarray(tv0, jnp.float32)
        X0j = jnp.asarray(X0, jnp.float32)
        rv, tv, _, stats = run_ba(
            jnp.asarray(K, jnp.float32), rv0j, tv0j, X0j, obs,
            cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free),
            iterations=30, tol=1e-8)
        self._check(rv, tv, stats.final_cost, ref)

        tables = build_tables(obs, n_cams, n_pts, nmax=256, kmax=16)
        rv, tv, _, stats = run_large_ba(
            jnp.asarray(K, jnp.float32), rv0j, tv0j, X0j, tables,
            cam_free=jnp.asarray(cam_free), lm_free=jnp.asarray(lm_free),
            iterations=30, cg_iterations=50, tol=1e-8)
        self._check(rv, tv, stats.final_cost, ref)

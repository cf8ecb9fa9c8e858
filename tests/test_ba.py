"""Bundle adjustment tests: single-device and 8-way sharded (BASELINE
configs 4-5 at test scale; distributed path runs on the virtual CPU mesh per
SURVEY.md §4's multi-host test strategy)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sift_pyocl_jax.sfm.ba import BAObs, BAParams, residuals, run_ba
from sift_pyocl_jax.sfm.distributed import DistributedBA, merge_points, partition_problem
from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers
from sift_pyocl_jax.sfm.synthetic import make_problem, perturb


@pytest.fixture(scope="module")
def problem():
    K, gt, obs, meta = make_problem(n_cams=6, n_points=120, noise_px=0.4, seed=0)
    start = perturb(gt, rot_deg=2.0, trans=0.12, point_sigma=0.08, seed=1, keep_fixed=(0,))
    return K, gt, start, obs


def _rms(params, obs, K):
    r = np.asarray(residuals(
        BAParams(*map(jnp.asarray, params)), BAObs(*map(jnp.asarray, obs)), jnp.asarray(K)
    ))
    return float(np.sqrt((r**2).sum(1)).mean())


def test_ba_converges(problem):
    K, gt, start, obs = problem
    assert _rms(start, obs, K) > 5.0
    params, costs = run_ba(
        BAParams(*map(jnp.asarray, start)), BAObs(*map(jnp.asarray, obs)),
        jnp.asarray(K), fixed_cams=(0,), iters=25,
    )
    assert _rms(params, obs, K) < 0.8  # ~noise floor (0.4 px/axis)
    assert costs[-1] < 0.05 * costs[0]
    ate = ate_rmse(
        camera_centers(np.asarray(params.Rs), np.asarray(params.ts)),
        camera_centers(gt.Rs, gt.ts),
    )
    assert ate < 0.02


def test_lm_blocked_onehot_matches_default():
    """cam_blocked + pt_onehot reductions == scatter-based lm_iteration on a
    VO-layout problem (obs stored in per-camera blocks, some zero-weight
    padding and clamped point ids)."""
    from sift_pyocl_jax.sfm.ba import lm_iteration

    rng = np.random.default_rng(3)
    C, PN, OBS_F = 4, 32, 48
    P, M = C * PN, C * OBS_F
    K = jnp.asarray([[500.0, 0, 200], [0, 500.0, 150], [0, 0, 1]], jnp.float32)
    Rs = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (C, 3, 3)).copy()
    ts = jnp.asarray(rng.normal(size=(C, 3)) * 0.1, jnp.float32)
    X = jnp.asarray(rng.normal(size=(P, 3)) * 2 + [0, 0, 8], jnp.float32)
    cam = jnp.repeat(jnp.arange(C, dtype=jnp.int32), OBS_F)
    pt = jnp.asarray(rng.integers(0, P, M), jnp.int32)
    uv = jnp.asarray(rng.uniform(0, 400, (M, 2)), jnp.float32)
    w = jnp.asarray((rng.uniform(size=M) < 0.8), jnp.float32)
    params = BAParams(Rs, ts, X)
    obs = BAObs(uv=uv, cam=cam, pt=pt, w=w)
    free = jnp.arange(C) > 0
    kw = dict(huber_px=3.0, cg_iters=6, n_points=P)
    p0, lam0, cost0, acc0 = lm_iteration(
        params, obs, K, jnp.float32(1e-3), free, **kw)
    p1, lam1, cost1, acc1 = lm_iteration(
        params, obs, K, jnp.float32(1e-3), free,
        cam_blocked=True, pt_onehot=True, **kw)
    np.testing.assert_allclose(float(cost1), float(cost0), rtol=1e-6)
    assert bool(acc1) == bool(acc0)
    for a, b in zip(p1, p0):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=5e-5)
    # dense exact Schur solve == converged CG (many iterations) step
    p_cg, _, _, _ = lm_iteration(
        params, obs, K, jnp.float32(1e-3), free,
        cam_blocked=True, pt_onehot=True,
        huber_px=3.0, cg_iters=60, n_points=P)
    p_dn, _, cost_dn, acc_dn = lm_iteration(
        params, obs, K, jnp.float32(1e-3), free,
        cam_blocked=True, pt_onehot=True, dense_schur=True,
        huber_px=3.0, cg_iters=1, n_points=P)
    np.testing.assert_allclose(float(cost_dn), float(cost0), rtol=1e-6)
    for a, b in zip(p_dn, p_cg):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-4)


def test_partition_roundtrip(problem):
    K, gt, start, obs = problem
    sp = partition_problem(BAParams(*map(jnp.asarray, start)),
                           BAObs(*map(jnp.asarray, obs)), 8)
    # every original (valid) observation appears exactly once across shards
    assert int((sp.w > 0).sum()) == len(obs.cam)
    X = merge_points(sp, sp.X, start.X.shape[0])
    np.testing.assert_allclose(X, start.X, atol=0)
    # local point ids within range
    for k in range(8):
        assert sp.pt_local[k].max() < sp.pt_rng[k, 1] or sp.pt_rng[k, 1] == 0


def test_distributed_ba_matches_single(problem):
    K, gt, start, obs = problem
    dba = DistributedBA()
    assert dba.mesh.devices.size == 8  # virtual CPU mesh from conftest
    params_d, costs_d = dba.run(
        start, obs, K, fixed_cams=(0,), iters=15,
    )
    params_s, costs_s = run_ba(
        BAParams(*map(jnp.asarray, start)), BAObs(*map(jnp.asarray, obs)),
        jnp.asarray(K), fixed_cams=(0,), iters=15,
    )
    assert _rms(params_d, obs, K) < 0.8
    # sharded and single-device solvers agree (same math, reduction order aside)
    np.testing.assert_allclose(costs_d[0], costs_s[0], rtol=1e-5)
    assert abs(costs_d[-1] - costs_s[-1]) / costs_s[-1] < 0.05
    ate = ate_rmse(
        camera_centers(np.asarray(params_d.Rs), np.asarray(params_d.ts)),
        camera_centers(gt.Rs, gt.ts),
    )
    assert ate < 0.02


def test_analytic_jacobians_match_jacfwd():
    """geometry.project_jacobians == jacfwd of the retract+project residual."""
    from sift_pyocl_jax.sfm.geometry import (
        pose_retract, project, project_jacobians, so3_exp,
    )

    rng = np.random.default_rng(7)
    K = jnp.asarray([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]], jnp.float32)
    R = so3_exp(jnp.asarray(rng.normal(size=3) * 0.3, jnp.float32))
    t = jnp.asarray(rng.normal(size=3), jnp.float32)
    X = jnp.asarray(rng.normal(size=(50, 3)) * 2 + [0, 0, 6], jnp.float32)

    def res(xi, dX, Xi):
        R2, t2 = pose_retract(R, t, xi)
        p, _ = project(K, R2, t2, Xi + dX)
        return p

    Jc_ad = jax.vmap(
        lambda Xi: jax.jacfwd(res, argnums=0)(jnp.zeros(6), jnp.zeros(3), Xi)
    )(X)
    Jp_ad = jax.vmap(
        lambda Xi: jax.jacfwd(res, argnums=1)(jnp.zeros(6), jnp.zeros(3), Xi)
    )(X)
    Jc, Jp = project_jacobians(K, R, t, X)
    np.testing.assert_allclose(np.asarray(Jc), np.asarray(Jc_ad), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Jp), np.asarray(Jp_ad), rtol=2e-4, atol=1e-4)

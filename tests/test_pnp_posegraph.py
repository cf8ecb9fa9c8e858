"""PnP and pose-graph optimizer tests (synthetic ground truth)."""

import numpy as np
import jax
import jax.numpy as jnp

from sift_pyocl_jax.sfm import geometry as G
from sift_pyocl_jax.sfm.pnp import pnp_refine, ransac_pnp
from sift_pyocl_jax.sfm.posegraph import PoseGraph, optimize_pose_graph, relative_pose
from sift_pyocl_jax.sfm.synthetic import make_problem, perturb
from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers


def _pnp_scene(seed=0, n=80, noise=0.3):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3)).astype(np.float32)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    R = np.asarray(G.so3_exp(jnp.asarray([0.05, -0.2, 0.1])), np.float32)
    t = np.array([0.3, -0.1, 0.2], np.float32)
    uv = np.array(G.project(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))[0])
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    return K, R, t, X, uv.astype(np.float32)


def test_pnp_refine_converges():
    K, R_gt, t_gt, X, uv = _pnp_scene()
    xi = jnp.asarray([0.03, -0.02, 0.04, 0.1, -0.08, 0.1])
    R0, t0 = G.pose_retract(jnp.asarray(R_gt), jnp.asarray(t_gt), xi)
    R, t, rms = pnp_refine(
        jnp.asarray(K), R0, t0, jnp.asarray(X), jnp.asarray(uv),
        jnp.ones(len(X)), iters=12,
    )
    assert float(rms) < 0.5
    np.testing.assert_allclose(np.asarray(R), R_gt, atol=5e-3)
    np.testing.assert_allclose(np.asarray(t), t_gt, atol=1e-2)


def test_ransac_pnp_with_outliers():
    K, R_gt, t_gt, X, uv = _pnp_scene(seed=1, n=100)
    rng = np.random.default_rng(2)
    out = rng.choice(100, 30, replace=False)
    uv = uv.copy()
    uv[out] = rng.uniform(0, 300, (30, 2)).astype(np.float32)
    xi = jnp.asarray([0.02, 0.02, -0.03, 0.08, 0.05, -0.1])
    R0, t0 = G.pose_retract(jnp.asarray(R_gt), jnp.asarray(t_gt), xi)
    R, t, inl, n_inl = ransac_pnp(
        jax.random.key(0), jnp.asarray(K), R0, t0,
        jnp.asarray(X), jnp.asarray(uv), jnp.ones(len(X)),
    )
    gt_in = np.ones(100, bool); gt_in[out] = False
    got = np.asarray(inl)
    assert (got & gt_in).sum() >= 0.9 * gt_in.sum()
    assert (got & ~gt_in).sum() <= 2
    np.testing.assert_allclose(np.asarray(R), R_gt, atol=1e-2)
    np.testing.assert_allclose(np.asarray(t), t_gt, atol=2e-2)


def test_pose_graph_chain():
    """Noisy odometry chain + loop edges -> optimizer recovers trajectory."""
    K, gt, obs, meta = make_problem(n_cams=10, n_points=50, seed=3)
    start = perturb(gt, rot_deg=3.0, trans=0.2, point_sigma=0.0, seed=4, keep_fixed=(0,))
    # exact relative measurements from ground truth (odometry + one loop edge)
    edges_i, edges_j = [], []
    for i in range(9):
        edges_i.append(i); edges_j.append(i + 1)
    edges_i.append(0); edges_j.append(9)  # loop closure
    ZR, Zt = [], []
    for i, j in zip(edges_i, edges_j):
        R, t = relative_pose(
            jnp.asarray(gt.Rs[i]), jnp.asarray(gt.ts[i]),
            jnp.asarray(gt.Rs[j]), jnp.asarray(gt.ts[j]),
        )
        ZR.append(np.asarray(R)); Zt.append(np.asarray(t))
    graph = PoseGraph(
        i=jnp.asarray(edges_i, jnp.int32), j=jnp.asarray(edges_j, jnp.int32),
        Z_R=jnp.asarray(np.stack(ZR)), Z_t=jnp.asarray(np.stack(Zt)),
        w=jnp.ones(len(edges_i)),
    )
    free = jnp.ones(10).at[0].set(0.0)
    Rs, ts, cost = optimize_pose_graph(
        jnp.asarray(start.Rs), jnp.asarray(start.ts), graph, free, iters=25
    )
    ate = ate_rmse(
        camera_centers(np.asarray(Rs), np.asarray(ts)),
        camera_centers(gt.Rs, gt.ts), with_scale=False,
    )
    assert ate < 1e-3, ate
    assert float(cost) < 1e-6

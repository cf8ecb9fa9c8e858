"""RANSAC tests: homography + essential with outliers (BASELINE config 2)."""

import numpy as np
import jax
import jax.numpy as jnp

from sift_pyocl_jax.sfm import geometry as G
from sift_pyocl_jax.sfm.ransac import ransac_homography, ransac_essential_normalized
from sift_pyocl_jax.sfm.twoview import initialize_two_view


def _homography_scene(n=120, outlier_frac=0.35, seed=0):
    rng = np.random.default_rng(seed)
    H_gt = np.array([[1.05, 0.02, 5.0], [-0.01, 0.98, -3.0], [5e-5, -1e-4, 1.0]])
    p1 = rng.uniform(0, 300, (n, 2))
    ph = np.concatenate([p1, np.ones((n, 1))], axis=1) @ H_gt.T
    p2 = ph[:, :2] / ph[:, 2:]
    p2 += rng.normal(0, 0.3, p2.shape)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    p2[out_idx] = rng.uniform(0, 300, (n_out, 2))
    inlier_mask = np.ones(n, bool)
    inlier_mask[out_idx] = False
    return p1, p2, H_gt, inlier_mask


def test_ransac_homography_with_outliers():
    p1, p2, H_gt, gt_in = _homography_scene()
    res = ransac_homography(
        jax.random.key(0), jnp.asarray(p1), jnp.asarray(p2),
        jnp.ones(len(p1), bool), thresh_px=3.0, n_hypo=256,
    )
    got_in = np.asarray(res.inliers)
    # recover (almost) exactly the ground-truth inlier set
    assert (got_in & gt_in).sum() >= 0.97 * gt_in.sum()
    assert (got_in & ~gt_in).sum() <= 2
    H = np.asarray(res.model)
    err = np.asarray(
        G.homography_error(jnp.asarray(H), jnp.asarray(p1[gt_in]), jnp.asarray(p2[gt_in]))
    )
    assert np.median(err) < 1.0


def test_ransac_essential_with_outliers():
    rng = np.random.default_rng(1)
    X = rng.uniform([-2, -2, 4], [2, 2, 9], (150, 3))
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1.0]])
    R2 = np.asarray(G.so3_exp(jnp.asarray([0.03, -0.25, 0.02])))
    t2 = np.array([-0.8, 0.1, 0.05])
    uv1 = np.array(G.project(jnp.asarray(K), jnp.eye(3), jnp.zeros(3), jnp.asarray(X))[0])
    uv2 = np.array(G.project(jnp.asarray(K), jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(X))[0])
    uv2 += rng.normal(0, 0.3, uv2.shape)
    out_idx = rng.choice(150, 45, replace=False)
    uv2[out_idx] = rng.uniform(0, 300, (45, 2))
    gt_in = np.ones(150, bool)
    gt_in[out_idx] = False

    init = initialize_two_view(
        jax.random.key(1), jnp.asarray(K.astype(np.float32)),
        jnp.asarray(uv1.astype(np.float32)), jnp.asarray(uv2.astype(np.float32)),
        jnp.ones(150, bool), thresh_px=2.0,
    )
    got_in = np.asarray(init.inliers)
    assert (got_in & gt_in).sum() >= 0.9 * gt_in.sum()
    assert (got_in & ~gt_in).sum() <= 3
    np.testing.assert_allclose(np.asarray(init.R), R2, atol=0.01)
    t_gt = t2 / np.linalg.norm(t2)
    np.testing.assert_allclose(np.asarray(init.t), t_gt, atol=0.02)
    # triangulated structure matches ground truth up to the global scale
    s = np.linalg.norm(t2)
    Xi = np.asarray(init.points)[got_in & gt_in] * s
    np.testing.assert_allclose(Xi, X[got_in & gt_in], atol=0.25)


def test_ransac_affine_with_outliers():
    from sift_pyocl_jax.sfm.ransac import ransac_affine

    rng = np.random.default_rng(2)
    M_gt = np.array([[0.98, 0.05], [-0.04, 1.02]])
    t_gt = np.array([7.0, -3.0])
    p1 = rng.uniform(0, 300, (100, 2))
    p2 = p1 @ M_gt.T + t_gt + rng.normal(0, 0.2, (100, 2))
    out_idx = rng.choice(100, 30, replace=False)
    p2[out_idx] = rng.uniform(0, 300, (30, 2))
    gt_in = np.ones(100, bool)
    gt_in[out_idx] = False
    res = ransac_affine(
        jax.random.key(0), jnp.asarray(p1, jnp.float32),
        jnp.asarray(p2, jnp.float32), jnp.ones(100, bool),
    )
    got_in = np.asarray(res.inliers)
    assert (got_in & gt_in).sum() >= 0.97 * gt_in.sum()
    assert (got_in & ~gt_in).sum() <= 2
    model = np.asarray(res.model)
    assert np.allclose(model[:, :2], M_gt, atol=0.02)
    assert np.allclose(model[:, 2], t_gt, atol=1.0)

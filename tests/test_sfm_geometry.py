"""Geometry primitive tests (new subsystem — oracle is analytic ground truth)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_pyocl_jax.sfm import geometry as G


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(10):
        w = rng.normal(0, 1, 3)
        R = np.asarray(G.so3_exp(jnp.asarray(w)))
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(R) - 1) < 1e-5
        w2 = np.asarray(G.so3_log(jnp.asarray(R)))
        np.testing.assert_allclose(w, w2, atol=1e-4)


def test_so3_exp_small_angle():
    R = np.asarray(G.so3_exp(jnp.asarray([1e-9, 0, 0])))
    np.testing.assert_allclose(R, np.eye(3), atol=1e-7)


def test_se3_exp_zero():
    R, t = G.se3_exp(jnp.zeros(6))
    np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(np.asarray(t), np.zeros(3), atol=1e-7)


def test_pose_retract_compose_inverse():
    rng = np.random.default_rng(1)
    xi = rng.normal(0, 0.3, 6)
    R0 = np.asarray(G.so3_exp(jnp.asarray(rng.normal(0, 1, 3))))
    t0 = rng.normal(0, 1, 3)
    R1, t1 = G.pose_retract(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(xi))
    Ri, ti = G.pose_inverse(R1, t1)
    Rc, tc = G.pose_compose(Ri, ti, R1, t1)
    np.testing.assert_allclose(np.asarray(Rc), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tc), np.zeros(3), atol=1e-5)


def test_project_backproject():
    K = jnp.asarray([[500.0, 0, 320], [0, 480.0, 240], [0, 0, 1]])
    X = jnp.asarray([[0.3, -0.2, 2.0]])
    uv, z = G.project(K, jnp.eye(3), jnp.zeros(3), X)
    ray = G.backproject(K, uv)
    np.testing.assert_allclose(np.asarray(ray[0] * z[0]), np.asarray(X[0]), atol=1e-4)


@pytest.fixture(scope="module")
def two_view_scene():
    rng = np.random.default_rng(2)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (60, 3))
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    R2 = np.asarray(G.so3_exp(jnp.asarray([0.02, -0.3, 0.01])))
    t2 = np.array([-1.0, 0.05, 0.1])
    uv1, _ = G.project(jnp.asarray(K), jnp.eye(3), jnp.zeros(3), jnp.asarray(X))
    uv2, _ = G.project(jnp.asarray(K), jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(X))
    return K, R2, t2, X, np.asarray(uv1), np.asarray(uv2)


def test_triangulate(two_view_scene):
    K, R2, t2, X, uv1, uv2 = two_view_scene
    Xt, z1, z2 = G.triangulate_two_view(
        jnp.asarray(K), jnp.eye(3), jnp.zeros(3),
        jnp.asarray(K), jnp.asarray(R2), jnp.asarray(t2),
        jnp.asarray(uv1), jnp.asarray(uv2),
    )
    np.testing.assert_allclose(np.asarray(Xt), X, atol=1e-2)
    assert (np.asarray(z1) > 0).all() and (np.asarray(z2) > 0).all()


def test_essential_pipeline(two_view_scene):
    K, R2, t2, X, uv1, uv2 = two_view_scene
    Kj = jnp.asarray(K)
    xy1 = np.asarray(G.backproject(Kj, jnp.asarray(uv1)))[:, :2]
    xy2 = np.asarray(G.backproject(Kj, jnp.asarray(uv2)))[:, :2]
    w = jnp.ones(len(xy1))
    E = G.fit_fundamental_8pt(jnp.asarray(xy1), jnp.asarray(xy2), w)
    err = np.asarray(G.sampson_error_F(E, jnp.asarray(xy1), jnp.asarray(xy2)))
    assert err.max() < 1e-8
    Rs, ts = G.decompose_essential(E)
    R, t, score = G.choose_pose(Rs, ts, jnp.eye(3), jnp.eye(3),
                                jnp.asarray(xy1), jnp.asarray(xy2), w)
    assert int(score) == len(xy1)
    np.testing.assert_allclose(np.asarray(R), R2, atol=1e-3)
    t_est = np.asarray(t)
    t_gt = t2 / np.linalg.norm(t2)
    np.testing.assert_allclose(t_est, t_gt, atol=1e-3)


def test_homography_fit():
    rng = np.random.default_rng(3)
    H_gt = np.array([[1.1, 0.05, 3.0], [-0.02, 0.95, -2.0], [1e-4, -2e-4, 1.0]])
    p1 = rng.uniform(0, 200, (40, 2))
    ph = np.concatenate([p1, np.ones((40, 1))], axis=1) @ H_gt.T
    p2 = ph[:, :2] / ph[:, 2:]
    H = np.asarray(G.fit_homography(jnp.asarray(p1), jnp.asarray(p2), jnp.ones(40)))
    err = np.asarray(G.homography_error(jnp.asarray(H), jnp.asarray(p1), jnp.asarray(p2)))
    assert err.max() < 1e-4

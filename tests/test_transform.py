"""Warp op vs the oracle and scipy (reference: test/test_transform.py)."""

import numpy as np
import jax.numpy as jnp
from scipy import ndimage

from sift_pyocl_jax import oracle as O
from sift_pyocl_jax.ops.transform import affine_warp_jax


def test_warp_identity(scene128):
    out = np.asarray(
        affine_warp_jax(jnp.asarray(scene128), jnp.eye(2), jnp.zeros(2))
    )
    np.testing.assert_allclose(out, scene128, atol=1e-4)


def test_warp_vs_oracle(scene128):
    mat = np.array([[0.98, 0.05], [-0.04, 1.01]])
    off = np.array([2.5, -1.25])
    a = O.affine_warp(scene128, mat, off, fill=7.0)
    b = np.asarray(
        affine_warp_jax(jnp.asarray(scene128), jnp.asarray(mat), jnp.asarray(off), 7.0)
    )
    np.testing.assert_allclose(a, b, atol=1e-2)


def test_warp_vs_scipy(scene128):
    mat = np.array([[1.02, -0.03], [0.05, 0.97]])
    off = np.array([-3.0, 1.5])
    mine = O.affine_warp(scene128, mat, off)
    ref = ndimage.affine_transform(
        scene128.astype(np.float64), mat, offset=off, order=1, mode="constant", cval=0.0
    )
    interior = (slice(8, -8), slice(8, -8))
    np.testing.assert_allclose(mine[interior], ref[interior], atol=1e-2)

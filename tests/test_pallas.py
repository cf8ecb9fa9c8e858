"""Pallas kernel (interpret mode on the CPU) and matmul-resampling tests.

The fused best-2 matcher (ops/pallas/matchk.py, Triton route) is checked
bit for bit against the plain XLA reduction ops.match._best2_l2 at shapes
that stress its blocking; the compiled kernel is checked on the card by
tests/test_gpu.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest


def _assert_best2_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_upscale2_matmul_matches_oracle():
    from sift_pyocl_jax import oracle
    from sift_pyocl_jax.ops.pyramid import upscale2_jax

    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    got = np.asarray(upscale2_jax(jnp.asarray(img)))
    want = oracle.upscale2(img)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("n1,n2", [(1, 1), (65, 129), (130, 300), (40, 8300)])
def test_triton_best2_ragged_shapes(n1, n2):
    """Shapes that are not multiples of the kernel's blocks, including a
    set 2 wider than 8,192 columns (no resident-panel bound)."""
    from sift_pyocl_jax.ops.match import _best2_l2
    from sift_pyocl_jax.ops.pallas.matchk import best2_l2_triton

    rng = np.random.default_rng(n1 * 7 + n2)
    a = jnp.asarray(rng.integers(0, 120, (n1, 128)), jnp.uint8)
    b = jnp.asarray(rng.integers(0, 120, (n2, 128)), jnp.uint8)
    v2 = jnp.asarray(rng.uniform(size=n2) < 0.9)
    _assert_best2_equal(best2_l2_triton(a, b, v2, interpret=True),
                        _best2_l2(a, b, v2))


def test_triton_best2_all_invalid_set2():
    """No valid column: d1 = d2 = +inf and argbest 0, as in _best2_l2."""
    from sift_pyocl_jax.ops.match import _best2_l2
    from sift_pyocl_jax.ops.pallas.matchk import best2_l2_triton

    rng = np.random.default_rng(8)
    a = jnp.asarray(rng.integers(0, 255, (70, 128)), jnp.uint8)
    b = jnp.asarray(rng.integers(0, 255, (300, 128)), jnp.uint8)
    v2 = jnp.zeros(300, bool)
    got = best2_l2_triton(a, b, v2, interpret=True)
    _assert_best2_equal(got, _best2_l2(a, b, v2))
    assert np.isinf(np.asarray(got[0])).all()


def test_triton_best2_duplicate_ties_across_tiles():
    """One descriptor repeated in several column tiles: argbest is its first
    occurrence, the second best equals the best (another copy remains)."""
    from sift_pyocl_jax.ops.match import _best2_l2
    from sift_pyocl_jax.ops.pallas.matchk import BLOCK_N, best2_l2_triton

    rng = np.random.default_rng(9)
    b = rng.integers(0, 200, (3 * BLOCK_N + 5, 128)).astype(np.uint8)
    dup = (5, BLOCK_N + 1, 2 * BLOCK_N + 7, 3 * BLOCK_N + 4)
    b[list(dup)] = b[dup[0]]
    a = np.concatenate([b[[dup[0]]], rng.integers(0, 200, (20, 128))])
    v2 = np.ones(len(b), bool)
    v2[dup[0]] = False                      # first copy invalid: next one wins
    a, b, v2 = jnp.asarray(a, jnp.uint8), jnp.asarray(b), jnp.asarray(v2)
    got = best2_l2_triton(a, b, v2, interpret=True)
    _assert_best2_equal(got, _best2_l2(a, b, v2))
    assert int(got[2][0]) == dup[1] and float(got[0][0]) == float(got[1][0]) == 0.0


def test_triton_best2_rejects_f32():
    from sift_pyocl_jax.ops.pallas.matchk import best2_l2_triton

    x = jnp.zeros((4, 128), jnp.float32)
    with pytest.raises(TypeError):
        best2_l2_triton(x, x, jnp.ones(4, bool), interpret=True)

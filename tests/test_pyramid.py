"""Pyramid ops vs the NumPy oracle and scipy (reference: test/test_convol.py,
test/test_gaussian.py, test/test_preproc.py — SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import ndimage

from sift_pyocl_jax import oracle as O
from sift_pyocl_jax.ops import pyramid as P


@pytest.fixture(scope="module")
def rand64():
    return np.random.default_rng(0).uniform(0, 255, (64, 48)).astype(np.float32)


def test_gaussian_taps_normalized():
    for sig in (0.5, 1.0, 1.6, 3.2):
        taps = O.gaussian_kernel(sig)
        assert len(taps) % 2 == 1
        assert abs(taps.sum() - 1.0) < 1e-6
        # matches the analytic gaussian shape
        x = np.arange(len(taps)) - (len(taps) - 1) / 2
        ref = np.exp(-(x**2) / (2 * sig**2))
        ref /= ref.sum()
        np.testing.assert_allclose(taps, ref, atol=1e-6)


def test_blur_vs_scipy(rand64):
    for sig in (0.8, 1.6, 2.4):
        mine = O.blur(rand64, sig)
        taps = O.gaussian_kernel(sig)
        ref = ndimage.correlate1d(rand64.astype(np.float64), taps, axis=1, mode="nearest")
        ref = ndimage.correlate1d(ref, taps, axis=0, mode="nearest")
        np.testing.assert_allclose(mine, ref, atol=1e-3)


def test_blur_jax_vs_oracle(rand64):
    for sig in (0.8, 1.52, 2.01):
        a = O.blur(rand64, sig)
        b = np.asarray(P.blur_jax(jnp.asarray(rand64), sig))
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_normalize(rand64):
    a = O.normalize_image(rand64 * 0.3 + 11)
    b = np.asarray(P.normalize_image_jax(jnp.asarray(rand64 * 0.3 + 11)))
    np.testing.assert_allclose(a, b, atol=1e-3)
    assert a.min() == 0.0 and abs(a.max() - 255.0) < 1e-3


def test_normalize_rgb():
    rgb = np.random.default_rng(1).uniform(0, 255, (32, 32, 3)).astype(np.float32)
    a = O.normalize_image(rgb)
    b = np.asarray(P.normalize_image_jax(jnp.asarray(rgb)))
    np.testing.assert_allclose(a, b, atol=1e-2)


def test_upscale2(rand64):
    a = O.upscale2(rand64)
    b = np.asarray(P.upscale2_jax(jnp.asarray(rand64)))
    assert a.shape == (128, 96)
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_scale_space_parity(scene128, small_cfg):
    oo = O.build_scale_space(scene128, small_cfg)
    jo = P.build_scale_space_jax(jnp.asarray(scene128), small_cfg)
    assert len(oo) == len(jo) == small_cfg.n_octaves(scene128.shape)
    for (ob, od), (jb, jd) in zip(oo, jo):
        assert ob.shape == jb.shape and od.shape == jd.shape
        np.testing.assert_allclose(ob, np.asarray(jb), atol=2e-3)
        np.testing.assert_allclose(od, np.asarray(jd), atol=2e-3)


def test_downsample2_odd_dims_matches_slice(rand64):
    """Ceil-sized selection-matmul downsample == img[::2, ::2] (ADVICE r1:
    the Pallas and XLA octave geometries must agree at odd dims)."""
    for shape in [(64, 48), (63, 47), (135, 241)]:
        img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
        got = np.asarray(P.downsample2(jnp.asarray(img)))
        np.testing.assert_array_equal(got, img[::2, ::2])


def test_bin2_oracle_and_jax():
    """2x2 mean binning (reference: preprocess.cl::bin) — oracle vs matmuls."""
    rng = np.random.default_rng(2)
    for shape in [(64, 48), (63, 47)]:
        img = rng.uniform(0, 255, shape).astype(np.float32)
        want = O.bin2(img)
        assert want.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
        # interior blocks are exact 2x2 means
        np.testing.assert_allclose(
            want[0, 0], img[:2, :2].mean(), rtol=1e-6
        )
        got = np.asarray(P.downsample2_bin(jnp.asarray(img)))
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_scale_space_bin_mode_parity(scene128):
    """Full pyramid with downsample_mode='bin' — XLA vs oracle."""
    from sift_pyocl_jax import SiftConfig

    cfg = SiftConfig(kp_per_octave_cap=256, downsample_mode="bin")
    ref = O.build_scale_space(scene128, cfg)
    got = P.build_scale_space_jax(jnp.asarray(scene128), cfg)
    assert len(ref) == len(got)
    for (rb, rd), (gb, gd) in zip(ref, got):
        assert rb.shape == gb.shape
        np.testing.assert_allclose(np.asarray(gb), rb, atol=5e-2)
        np.testing.assert_allclose(np.asarray(gd), rd, atol=5e-2)


@pytest.mark.parametrize("shape", [(64, 96), (200, 300)])
@pytest.mark.parametrize("sigma", [1.226, 1.6, 3.09])
def test_blur_jax_matches_oracle_cases(shape, sigma):
    """XLA separable blur vs oracle.blur at the pyramid's sigma increments,
    on shapes that are not multiples of any tile."""
    img = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    got = np.asarray(P.blur_jax(jnp.asarray(img), sigma))
    np.testing.assert_allclose(got, O.blur(img, sigma), atol=2e-3)

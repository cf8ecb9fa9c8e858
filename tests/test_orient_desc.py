"""Orientation + descriptor ops vs the oracle
(reference: test/test_keypoints.py — SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from sift_pyocl_jax import oracle as O
from sift_pyocl_jax.ops.detect import compact_extrema, extrema_mask, refine_candidates
from sift_pyocl_jax.ops.orient_desc import (
    assign_orientations,
    compute_descriptors,
    gradient_planes,
    gradient_jax,
)


@pytest.fixture(scope="module")
def stage(scene128, small_cfg):
    """Mid-pipeline setup (reference: test/test_image_setup.py idiom):
    oracle scale space + jax-refined keypoints for octave 1 (octave 0 of the
    blob scene has almost no extrema; octave 1 has a dozen)."""
    octave = 1
    octs = O.build_scale_space(scene128, small_cfg)
    blurs, dogs = octs[octave]
    dj = jnp.asarray(dogs)
    cands = compact_extrema(extrema_mask(dj, small_cfg, octave), small_cfg, 256)
    kps = refine_candidates(dj, cands, small_cfg)
    return blurs, dogs, kps


def test_gradient_parity(scene128):
    m0, o0 = O.gradient(scene128)
    m1, o1 = gradient_jax(jnp.asarray(scene128))
    np.testing.assert_allclose(m0, np.asarray(m1), atol=1e-3)
    np.testing.assert_allclose(o0, np.asarray(o1), atol=1e-5)


def test_orientation_parity(stage, small_cfg):
    blurs, dogs, kps = stage
    mags, oris = gradient_planes(jnp.asarray(blurs), small_cfg)
    okps = assign_orientations(mags, oris, kps, small_cfg, 384, max_ori=2)
    # group jax angles by (approx) keypoint position
    got = {}
    for i in range(okps.angle.shape[0]):
        if bool(okps.valid[i]):
            key = (round(float(okps.fr[i]), 3), round(float(okps.fc[i]), 3))
            got.setdefault(key, []).append(float(okps.angle[i]))
    checked = 0
    for i in range(kps.fr.shape[0]):
        if not bool(kps.valid[i]):
            continue
        s = int(kps.s_int[i])
        sigma = small_cfg.init_sigma * 2.0 ** (float(kps.fs[i]) / small_cfg.scales)
        mag_np, ori_np = O.gradient(blurs[s])
        exp = O.orientation(
            mag_np, ori_np, float(kps.fr[i]), float(kps.fc[i]), sigma, small_cfg
        )[:2]
        key = (round(float(kps.fr[i]), 3), round(float(kps.fc[i]), 3))
        ja = sorted(got.get(key, []))
        assert len(ja) == len(exp), f"kp {i}: {ja} vs {exp}"
        for a, b in zip(ja, sorted(exp)):
            d = abs(a - b)
            assert min(d, 2 * np.pi - d) < 1e-3
        checked += 1
    assert checked > 3


def test_descriptor_parity(stage, small_cfg):
    blurs, dogs, kps = stage
    mags, oris = gradient_planes(jnp.asarray(blurs), small_cfg)
    okps = assign_orientations(mags, oris, kps, small_cfg, 384, max_ori=2)
    descs = np.asarray(compute_descriptors(mags, oris, okps, small_cfg))
    checked = 0
    grad_cache = {}
    for i in range(okps.angle.shape[0]):
        if not bool(okps.valid[i]):
            continue
        s = int(okps.s_int[i])
        if s not in grad_cache:
            grad_cache[s] = O.gradient(blurs[s])
        mag_np, ori_np = grad_cache[s]
        sigma = small_cfg.init_sigma * 2.0 ** (float(okps.fs[i]) / small_cfg.scales)
        exp = O.descriptor(
            mag_np, ori_np, float(okps.fr[i]), float(okps.fc[i]), sigma,
            float(okps.angle[i]), small_cfg,
        )
        l1 = np.abs(descs[i].astype(int) - exp.astype(int))
        assert l1.mean() < 0.5 and l1.max() <= 2, f"kp {i}: mean {l1.mean()}"
        checked += 1
        if checked >= 20:
            break
    assert checked > 3

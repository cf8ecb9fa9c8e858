"""LinearAlign end-to-end (reference: test/test_align.py — known-transform
round trip)."""

import numpy as np

from sift_pyocl_jax import LinearAlign
from sift_pyocl_jax.utils.testimage import transformed_pair


def test_align_recovers_translation(small_cfg):
    ref, img = transformed_pair((128, 128), seed=2, dx=6, dy=-4)
    la = LinearAlign(ref, config=small_cfg)
    out = la.align(img, return_all=True)
    assert out is not None and len(out["matches"]) >= 5
    # ref->img mapping: ~identity matrix, offset ~(-dy, -dx) in (row, col)
    np.testing.assert_allclose(out["matrix"], np.eye(2), atol=0.02)
    np.testing.assert_allclose(out["offset"], [4.0, -6.0], atol=0.3)
    # warped image should overlay the reference away from borders
    interior = (slice(16, -16), slice(16, -16))
    err = np.abs(out["result"][interior] - ref[interior])
    assert np.median(err) < 2.0


def test_align_shift_only(small_cfg):
    ref, img = transformed_pair((128, 128), seed=4, dx=3, dy=2)
    la = LinearAlign(ref, config=small_cfg)
    out = la.align(img, shift_only=True, return_all=True)
    assert out is not None
    np.testing.assert_allclose(out["offset"], [-2.0, -3.0], atol=0.3)
    interior = (slice(16, -16), slice(16, -16))
    err = np.abs(out["result"][interior] - ref[interior])
    assert np.median(err) < 2.0


def test_align_double_check_and_relative():
    """double_check = symmetric matching; relative = compose across frames
    (reference: alignment.py kwargs)."""
    import numpy as np
    from sift_pyocl_jax import LinearAlign
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    base = synthetic_scene((220, 220), n_blobs=35, seed=5)
    ref = base[10:170, 10:170]
    f1 = base[10:170, 14:174]   # +4 px in x vs ref
    f2 = base[10:170, 18:178]   # +8 px in x vs ref (+4 vs f1)

    al = LinearAlign(ref)
    out = al.align(f1, shift_only=True, double_check=True, return_all=True)
    assert out is not None
    # ref->img map: ref content sits 4 px to the LEFT in f1 => offset -4
    assert abs(out["offset"][1] + 4.0) < 0.5   # (row, col) offset

    al2 = LinearAlign(ref)
    o1 = al2.align(f1, shift_only=True, relative=True, return_all=True)
    o2 = al2.align(f2, shift_only=True, relative=True, return_all=True)
    assert abs(o1["offset"][1] + 4.0) < 0.5
    # composed ref->f2 transform accumulates to ~-8 px
    assert abs(o2["offset"][1] + 8.0) < 0.8


def test_align_orsa_robust(small_cfg):
    """orsa=True runs real RANSAC affine inlier filtering (the reference's
    orsa kwarg was a stub); same recovery as plain align plus an inlier-only
    match list."""
    ref, img = transformed_pair((128, 128), seed=7, dx=5, dy=3)
    la = LinearAlign(ref, config=small_cfg)
    out = la.align(img, orsa=True, return_all=True)
    assert out is not None and len(out["matches"]) >= 4
    np.testing.assert_allclose(out["matrix"], np.eye(2), atol=0.02)
    # small scene (few matches): inlier gating can shift the fit ~0.5 px
    np.testing.assert_allclose(out["offset"], [-3.0, -5.0], atol=0.6)
    # every surviving match must be an affine inlier of the fitted model
    p_ref = np.stack([la.ref_kp["y"][out["matches"][:, 0]],
                      la.ref_kp["x"][out["matches"][:, 0]]], axis=1)
    kp = la.sift.keypoints(img)
    p_img = np.stack([kp["y"][out["matches"][:, 1]],
                      kp["x"][out["matches"][:, 1]]], axis=1)
    resid = p_ref @ np.asarray(out["matrix"]).T + out["offset"] - p_img
    assert np.all(np.sum(resid**2, axis=1) < 9.0 + 1e-3)

"""Fixture-ingestion path (reference: test/utilstest.py download harness —
here disk-ingestion).  The real-image parity test runs only
when a user has dropped reference images into a fixtures dir."""

import numpy as np
import pytest

from sift_pyocl_jax.utils.fixtures import reference_test_image


def test_fixture_roundtrip(tmp_path, monkeypatch):
    img = np.linspace(0, 255, 32 * 48, dtype=np.float32).reshape(32, 48)
    u8 = img.astype(np.uint8)
    (tmp_path / "demo.pgm").write_bytes(b"P5\n48 32\n255\n" + u8.tobytes())
    np.save(tmp_path / "demo2.npy", img)
    monkeypatch.setenv("SIFT_PYOCL_FIXTURES", str(tmp_path))
    got = reference_test_image("demo")
    np.testing.assert_allclose(got, u8.astype(np.float32))
    got2 = reference_test_image("demo2")
    np.testing.assert_allclose(got2, img)
    assert reference_test_image("missing") is None


def test_reference_image_parity_when_available():
    """BASELINE config 1 on a REAL reference test image — runs only when the
    classic image has been ingested (no network here)."""
    img = reference_test_image("lena")
    if img is None:
        img = reference_test_image("reference512")
    if img is None:
        pytest.skip("no reference fixture image ingested "
                    "(set SIFT_PYOCL_FIXTURES)")
    from conftest import match_keypoint_sets

    from sift_pyocl_jax import SiftPlan
    from sift_pyocl_jax.oracle import sift_numpy
    from sift_pyocl_jax.config import SiftConfig

    cfg = SiftConfig()
    ref = sift_numpy(img, cfg)
    got = SiftPlan(shape=img.shape, config=cfg).keypoints(img)
    assert len(ref) > 50
    hits, desc_l1 = match_keypoint_sets(ref, got)
    assert hits >= 0.95 * len(ref)
    assert desc_l1 < 0.2

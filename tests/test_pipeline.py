"""End-to-end pipeline parity vs the oracle — the BASELINE.json config-1
criterion at test scale (keypoint set parity; reference: test/test_all.py)."""

import jax
import numpy as np
import pytest

from sift_pyocl_jax import SiftPlan
from sift_pyocl_jax.oracle import sift_numpy

from conftest import match_keypoint_sets


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """See tests/test_vo.py::_fresh_compile_state — XLA's native
    backend_compile_and_load intermittently SEGFAULTS on a big compile
    after ~100 other tests' executables accumulate in-process.  Dropping the
    accumulated caches first dodges the native-state poisoning."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def plan(scene160, small_cfg):
    return SiftPlan(shape=scene160.shape, config=small_cfg)


def test_end_to_end_parity(plan, scene160, small_cfg):
    ref = sift_numpy(scene160, small_cfg)
    got = plan.keypoints(scene160)
    assert len(ref) > 10
    hits, desc_l1 = match_keypoint_sets(ref, got)
    assert hits >= 0.95 * len(ref), f"{hits}/{len(ref)}"
    assert len(got) <= len(ref) + max(3, int(0.05 * len(ref)))
    assert desc_l1 < 0.2


def test_output_format(plan, scene160):
    kp = plan.keypoints(scene160)
    assert kp.dtype.names == ("x", "y", "scale", "angle", "desc")
    assert kp["desc"].dtype == np.uint8
    assert kp["desc"].shape[1] == 128
    h, w = scene160.shape
    assert (kp["x"] >= 0).all() and (kp["x"] <= w).all()
    assert (kp["y"] >= 0).all() and (kp["y"] <= h).all()
    assert (kp["scale"] > 0).all()
    assert (np.abs(kp["angle"]) <= np.pi).all()


def test_plan_shape_validation(plan):
    with pytest.raises(ValueError):
        plan.keypoints(np.zeros((32, 32), np.float32))


def test_constant_image(small_cfg):
    p = SiftPlan(shape=(64, 64), config=small_cfg)
    kp = p.keypoints(np.full((64, 64), 9.0, np.float32))
    assert len(kp) == 0


def test_determinism(plan, scene160):
    a = plan.keypoints(scene160)
    b = plan.keypoints(scene160)
    assert len(a) == len(b)
    np.testing.assert_array_equal(a["desc"], b["desc"])
    np.testing.assert_array_equal(a["x"], b["x"])


def test_siftplan_accepts_u8_and_rgb(scene128):
    """Input dtype parity (reference: preprocess.cl u8/u16/rgb -> float)."""
    import numpy as np
    from sift_pyocl_jax import SiftPlan

    img_f = scene128
    plan = SiftPlan(shape=img_f.shape, dtype="float32", config=None)
    kp_f = plan.keypoints(img_f)

    u8 = np.clip(img_f, 0, 255).astype(np.uint8)
    kp_u8 = SiftPlan(shape=u8.shape, dtype="uint8").keypoints(u8)
    # normalization to [0,255] makes u8 quantization a small perturbation:
    # most keypoints should survive
    assert len(kp_u8) > 0.6 * len(kp_f)

    rgb = np.stack([u8, u8, u8], axis=-1)
    kp_rgb = SiftPlan(shape=rgb.shape[:2], dtype="uint8").keypoints(rgb)
    # grayscale of an (x,x,x) RGB image equals the grayscale image
    assert len(kp_rgb) == len(kp_u8)


def test_double_im_size_end_to_end(small_cfg):
    """Full pipeline with DoubleImSize on, vs the oracle (the
    double_im_size path had no end-to-end coverage)."""
    import dataclasses

    from sift_pyocl_jax.oracle import sift_numpy
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    cfg = dataclasses.replace(small_cfg, double_im_size=True)
    scene = synthetic_scene((96, 96), n_blobs=12, seed=5)
    ref = sift_numpy(scene, cfg)
    got = SiftPlan(shape=scene.shape, config=cfg).keypoints(scene)
    assert len(ref) > 5
    hits, desc_l1 = match_keypoint_sets(ref, got)
    assert hits >= 0.9 * len(ref), f"{hits}/{len(ref)}"
    assert desc_l1 < 0.3

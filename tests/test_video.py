"""Frame-parallel video SIFT frontend on the 8-device virtual mesh
(BASELINE.json config 3; no reference counterpart — SURVEY.md §2.3 DP row)."""

import numpy as np
import jax
import jax.numpy as jnp

from sift_pyocl_jax import SiftConfig
from sift_pyocl_jax.models.sift import detect_and_describe
from sift_pyocl_jax.parallel.video import (
    VideoSiftFrontend, batched_sift, make_frames_mesh,
)
from sift_pyocl_jax.utils.testimage import synthetic_scene


def test_sharded_video_frontend_matches_single():
    cfg = SiftConfig(kp_per_octave_cap=128)
    n = len(jax.devices())
    frames = np.stack(
        [synthetic_scene((96, 96), n_blobs=12, seed=s) for s in range(n)]
    )
    fe = VideoSiftFrontend((96, 96), batch=n, cfg=cfg)
    out = fe(frames)
    assert out.valid.shape[0] == n
    # every frame's result matches the single-image pipeline
    for i in range(0, n, max(n // 2, 1)):
        single = detect_and_describe(jnp.asarray(frames[i]), cfg)
        np.testing.assert_array_equal(
            np.asarray(out.valid[i]), np.asarray(single.valid)
        )
        m = np.asarray(single.valid)
        np.testing.assert_allclose(
            np.asarray(out.x[i])[m], np.asarray(single.x)[m], atol=1e-3
        )


def test_batched_sift_single_device():
    cfg = SiftConfig(kp_per_octave_cap=128)
    frames = jnp.stack(
        [jnp.asarray(synthetic_scene((96, 96), n_blobs=10, seed=s))
         for s in range(3)]
    )
    out = batched_sift(frames, cfg)
    assert out.valid.shape[0] == 3
    assert int(out.valid.sum()) > 0


def test_frames_mesh():
    mesh = make_frames_mesh(4)
    assert mesh.devices.size == 4
    assert mesh.axis_names == ("frames",)

"""PP (octave pipelining) parity: the two-stage two-device pipeline must
reproduce the single-device frontend exactly (SURVEY §2.3 PP row)."""

import jax
import jax.numpy as jnp
import numpy as np

from sift_pyocl_jax import SiftConfig
from sift_pyocl_jax.models.sift import detect_and_describe
from sift_pyocl_jax.parallel.pipeline_octaves import TwoStagePipeline
from sift_pyocl_jax.utils.testimage import synthetic_scene


def test_two_stage_pipeline_matches_single_device():
    cfg = SiftConfig(kp_per_octave_cap=256)
    frames = [
        synthetic_scene((128, 128), n_blobs=12, seed=s) for s in range(3)
    ]
    pipe = TwoStagePipeline((128, 128), cfg, devices=jax.devices()[:2])
    got = list(pipe.process(frames))
    assert len(got) == 3
    for f, buf in zip(frames, got):
        want = detect_and_describe(jnp.asarray(f), cfg)
        np.testing.assert_array_equal(np.asarray(buf.valid),
                                      np.asarray(want.valid))
        m = np.asarray(want.valid)
        np.testing.assert_allclose(np.asarray(buf.x)[m],
                                   np.asarray(want.x)[m], atol=1e-5)
        np.testing.assert_array_equal(np.asarray(buf.desc)[m],
                                      np.asarray(want.desc)[m])
    # stage-1 outputs live on the second device
    assert list(got[0].x.devices())[0] == jax.devices()[1]

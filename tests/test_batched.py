"""Batched frontend: per-frame parity with the single-frame pipeline."""

import numpy as np
import jax.numpy as jnp

from sift_pyocl_jax import SiftConfig
from sift_pyocl_jax.models.sift import (detect_and_describe,
                                        detect_and_describe_batched)
from sift_pyocl_jax.utils.testimage import synthetic_scene


def test_batched_xla_fallback_path():
    cfg = SiftConfig()
    imgs = jnp.asarray(np.stack([
        np.asarray(synthetic_scene((128, 128), n_blobs=20, seed=s))
        for s in (1, 2)
    ]))
    bb = detect_and_describe_batched(imgs, cfg)
    b1 = detect_and_describe(imgs[1], cfg)
    assert np.array_equal(np.asarray(bb.valid[1]), np.asarray(b1.valid))
    assert np.array_equal(np.asarray(bb.desc[1]), np.asarray(b1.desc))

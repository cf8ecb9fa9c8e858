"""TP (spatial sharding) parity: the row-sharded pyramid must reproduce the
single-device scale space bit-for-tolerance (SURVEY §2.3 TP row)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sift_pyocl_jax import SiftConfig
from sift_pyocl_jax.ops.pyramid import build_scale_space_jax
from sift_pyocl_jax.parallel.spatial import sharded_scale_space
from sift_pyocl_jax.utils.testimage import synthetic_scene


def test_sharded_scale_space_matches_single_device():
    cfg = SiftConfig(kp_per_octave_cap=256)
    img = jnp.asarray(synthetic_scene((256, 192), n_blobs=25, seed=2))
    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs, ("rows",))
    got = sharded_scale_space(img, cfg, mesh)
    want = build_scale_space_jax(img, cfg)
    assert len(got) >= 2
    for o, (gb, gd) in enumerate(got):
        wb, wd = want[o]
        assert gb.shape == wb.shape, f"octave {o}"
        np.testing.assert_allclose(
            np.asarray(gb), np.asarray(wb), atol=2e-3, err_msg=f"octave {o}"
        )
        np.testing.assert_allclose(np.asarray(gd), np.asarray(wd), atol=4e-3)


def test_sharded_scale_space_is_actually_sharded():
    cfg = SiftConfig(kp_per_octave_cap=256)
    img = jnp.asarray(synthetic_scene((256, 192), n_blobs=10, seed=0))
    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
    blurs, _ = sharded_scale_space(img, cfg, mesh, n_oct=1)[0]
    assert len(blurs.sharding.device_set) == 4

"""Checkpoint round-trips + multi-host mesh helpers (virtual CPU mesh)."""

import numpy as np
import jax
import jax.numpy as jnp

from sift_pyocl_jax import SiftConfig
from sift_pyocl_jax.models.vo import VOConfig, vo_init, vo_step
from sift_pyocl_jax.parallel.multihost import (
    frames_x_ba_mesh, global_ba_mesh, initialize_multihost,
)
from sift_pyocl_jax.sfm.ba import BAParams
from sift_pyocl_jax.sfm.checkpoint import load_ba, load_vo, save_ba, save_vo
from sift_pyocl_jax.utils.testimage import synthetic_scene


def test_ba_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    params = BAParams(
        Rs=jnp.asarray(rng.normal(size=(4, 3, 3)).astype(np.float32)),
        ts=jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32)),
        X=jnp.asarray(rng.normal(size=(50, 3)).astype(np.float32)),
    )
    p = tmp_path / "ba.npz"
    save_ba(p, params, obs_uv=np.zeros((7, 2), np.float32))
    got, extra = load_ba(p)
    np.testing.assert_array_equal(got.Rs, np.asarray(params.Rs))
    np.testing.assert_array_equal(got.X, np.asarray(params.X))
    assert extra["obs_uv"].shape == (7, 2)


def test_vo_checkpoint_resume(tmp_path):
    cfg = SiftConfig(kp_per_octave_cap=256)
    vo = VOConfig(window=4, pts_per_frame=64, obs_per_frame=128,
                  pnp_n=128, pnp_iters=3, cg_iters=3)
    img = jnp.asarray(synthetic_scene((128, 128), n_blobs=20, seed=0))
    K = jnp.asarray([[200.0, 0, 64], [0, 200.0, 64], [0, 0, 1]], jnp.float32)
    st = vo_init(img, K, cfg, vo)
    p = tmp_path / "vo.npz"
    save_vo(p, st)
    st2 = load_vo(p)
    for a, b in zip(st, st2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the restored state steps identically to the original
    _, out_a = vo_step(st, img, K, cfg, vo)
    _, out_b = vo_step(st2, img, K, cfg, vo)
    np.testing.assert_array_equal(np.asarray(out_a.t), np.asarray(out_b.t))


def test_multihost_helpers_single_process():
    idx, cnt = initialize_multihost()
    assert idx == 0 and cnt == 1
    mesh = global_ba_mesh()
    assert mesh.devices.size == len(jax.devices())
    mesh2 = frames_x_ba_mesh(2)
    assert mesh2.devices.shape == (2, len(jax.devices()) // 2)
    assert mesh2.axis_names == ("frames", "ba")


def test_pipeline_deterministic():
    """Determinism test (SURVEY.md §5: replaces the reference's atomic-order
    nondeterminism tolerance — the functional pipeline must be bit-stable)."""
    from sift_pyocl_jax.models.sift import detect_and_describe

    cfg = SiftConfig(kp_per_octave_cap=256)
    img = jnp.asarray(synthetic_scene((160, 128), n_blobs=25, seed=7))
    a = detect_and_describe(img, cfg)
    b = detect_and_describe(img + 0.0, cfg)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

"""Checks that need a CUDA GPU (the `gpu` marker).  Each skips, decided
inside the test, where JAX's default backend is not the GPU; on the card:
`python -m pytest -m gpu tests/test_gpu.py` (chip_smoke.py runs the same
functions in-process)."""

import jax
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.gpu


def _need_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a CUDA GPU; JAX backend is {jax.default_backend()}")


@pytest.mark.parametrize("n1,n2", [(8320, 2048), (8320, 8320), (130, 300)])
def test_compiled_best2_kernel_matches_xla(n1, n2):
    _need_gpu()
    from sift_pyocl_jax.utils.gpucheck import check_best2_kernel

    r = check_best2_kernel(n1, n2, n=2, reps=1)
    assert r["kernel_ms"] > 0 and r["xla_ms"] > 0


def test_sift_outputs_on_gpu():
    _need_gpu()
    from sift_pyocl_jax import SiftPlan
    from sift_pyocl_jax.utils.gpucheck import assert_on_gpu
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    img = synthetic_scene((128, 160), n_blobs=20, seed=0)
    assert_on_gpu(SiftPlan(img.shape).keypoints_raw(jnp.asarray(img)))

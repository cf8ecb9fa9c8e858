#!/usr/bin/env python
"""Per-layer times of the 1080p SIFT frontend on one GPU.

Times, each warm and closed by `block_until_ready` (utils/benchtool.time_ms):
one Gaussian blur (sigma 1.226), the whole scale-space pyramid, the
extrema stencil and the `jnp.nonzero` compaction of octave 0, then
`SiftPlan.log_profile()` (cumulative stage times).  One JSON line each.
Fails when JAX finds no GPU.

    python tools/probe_layers.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main() -> int:
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    from sift_pyocl_jax import SiftConfig, SiftPlan
    from sift_pyocl_jax.ops.detect import compact_extrema, extrema_mask
    from sift_pyocl_jax.ops.pyramid import blur_jax, build_scale_space_jax
    from sift_pyocl_jax.utils.benchtool import (enable_compile_cache,
                                                gpu_card, time_ms)
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    enable_compile_cache()
    print(gpu_card(), flush=True)
    shape = (1080, 1920)
    cfg = SiftConfig()
    img = jnp.asarray(synthetic_scene(shape, n_blobs=200, seed=0))
    pyramid = jax.jit(lambda x: build_scale_space_jax(x, cfg))
    dogs = pyramid(img)[0][1]
    mask = jax.jit(lambda d: extrema_mask(d, cfg, 0))
    compact = jax.jit(lambda m: compact_extrema(m, cfg, cfg.kp_per_octave_cap))
    m = mask(dogs)
    print(json.dumps({
        "shape": shape,
        "blur_ms": time_ms(jax.jit(lambda x: blur_jax(x, 1.226)), img, n=50),
        "pyramid_ms": time_ms(pyramid, img, n=20),
        "mask_oct0_ms": time_ms(mask, dogs, n=20),
        "compact_oct0_ms": time_ms(compact, m, n=20),
        "extrema_oct0": int(m.sum()),
    }), flush=True)
    print(json.dumps({"log_profile_ms": SiftPlan(shape).log_profile()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Demo: bundle adjustment on a synthetic multi-camera problem, single-host
and mesh-sharded (BASELINE.json configs 4-5).

Run on a virtual multi-device mesh with:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/demo_sfm.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
import jax.numpy as jnp

from sift_pyocl_jax.sfm.ba import BAParams, run_ba
from sift_pyocl_jax.sfm.distributed import DistributedBA
from sift_pyocl_jax.sfm.synthetic import make_problem


def main():
    K, gt, obs, meta = make_problem(n_cams=12, n_points=400, noise_px=0.5, seed=0)
    rng = np.random.default_rng(1)
    noisy = BAParams(
        Rs=jnp.asarray(gt.Rs),
        ts=jnp.asarray(gt.ts + 0.02 * rng.normal(size=gt.ts.shape)),
        X=jnp.asarray(gt.X + 0.10 * rng.normal(size=gt.X.shape)),
    )

    params, costs = run_ba(noisy, obs, K, iters=10)
    print(f"single-host BA: cost {costs[0]:.2f} -> {costs[-1]:.2f}")

    n_dev = len(jax.devices())
    if n_dev > 1:
        dba = DistributedBA()
        dparams, dcosts = dba.run(noisy, obs, K, iters=10)
        print(f"sharded BA ({n_dev} devices): cost {dcosts[0]:.2f} -> {dcosts[-1]:.2f}")
    else:
        print("one device visible; set XLA_FLAGS=--xla_force_host_platform_"
              "device_count=8 JAX_PLATFORMS=cpu for the sharded path")


if __name__ == "__main__":
    main()

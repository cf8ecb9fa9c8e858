#!/usr/bin/env python
"""Distributed-BA scaling benchmark (BASELINE.json config 5).

Times LM iterations of the sharded bundle adjuster on a 1-device mesh and on
a mesh over every local GPU (keyframes replicated, map blocks + observations
sharded, camera system psum-reduced over the mesh axis), on a synthetic
problem made from a seed.  Run on a machine with the GPUs:

    python bench_distributed.py --cams 64 --points 8192

Prints one JSON line: scaling efficiency N-dev vs 1-dev; the detail line
names the devices.  Fails when JAX finds no GPU.
"""

import argparse
import json
import sys
import time

import numpy as np


def _time_iters(dba, params, obs, K, iters):
    # warm-up/compile; run() fetches every iteration's cost to the host, so
    # the clock below stops only after the device finished
    dba.run(params, obs, K, iters=1)
    t0 = time.perf_counter()
    _, costs = dba.run(params, obs, K, iters=iters)
    dt = time.perf_counter() - t0
    return dt / iters, costs[-1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sift_pyocl_jax.sfm.ba import BAParams
    from sift_pyocl_jax.sfm.distributed import DistributedBA
    from sift_pyocl_jax.sfm.synthetic import make_problem

    K, gt, obs, meta = make_problem(
        n_cams=args.cams, n_points=args.points, noise_px=0.5, seed=0,
        arc_deg=150.0,
    )
    rng = np.random.default_rng(1)
    noisy = BAParams(
        Rs=jnp.asarray(gt.Rs),
        ts=jnp.asarray(gt.ts + 0.02 * rng.normal(size=gt.ts.shape)),
        X=jnp.asarray(gt.X + 0.10 * rng.normal(size=gt.X.shape)),
    )
    devs = jax.devices()
    n = len(devs)
    mesh1 = Mesh(np.array(devs[:1]), ("ba",))
    meshN = Mesh(np.array(devs), ("ba",))

    t1, c1 = _time_iters(DistributedBA(mesh1), noisy, obs, K, args.iters)
    tN, cN = _time_iters(DistributedBA(meshN), noisy, obs, K, args.iters)
    eff = (t1 / tN) / n

    print(
        json.dumps(
            {
                "metric": f"distributed_ba_scaling_efficiency_{n}dev",
                "value": round(eff, 4),
                "unit": "fraction",
                "vs_baseline": round(eff / 0.8, 4),
            }
        )
    )
    print(
        json.dumps(
            {
                "detail": {
                    "platform": jax.default_backend(),
                    "device_kind": devs[0].device_kind,
                    "devices": n,
                    "obs": int(np.asarray(obs.uv).shape[0]),
                    "it_ms_1dev": round(t1 * 1e3, 2),
                    "it_ms_Ndev": round(tN * 1e3, 2),
                    "final_cost_1dev": round(float(c1), 3),
                    "final_cost_Ndev": round(float(cN), 3),
                }
            }
        ),
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Demo: detect SIFT keypoints on a synthetic scene (reference: demo_sift.py).

Usage: python examples/demo_sift.py [--shape H W]
"""

import argparse

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from sift_pyocl_jax import SiftPlan
from sift_pyocl_jax.utils.testimage import synthetic_scene


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=2, default=[512, 512])
    args = ap.parse_args()
    shape = tuple(args.shape)

    img = synthetic_scene(shape, n_blobs=80, seed=0)
    plan = SiftPlan(shape=shape, dtype="float32")
    kp = plan.keypoints(img)
    print(f"{len(kp)} keypoints on a {shape[0]}x{shape[1]} scene")
    order = np.argsort(-kp["scale"])[:10]
    print("strongest 10 by scale:")
    for i in order:
        print(
            f"  x={kp['x'][i]:7.2f} y={kp['y'][i]:7.2f} "
            f"sigma={kp['scale'][i]:5.2f} angle={kp['angle'][i]:+.2f}"
        )


if __name__ == "__main__":
    main()

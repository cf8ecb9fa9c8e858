#!/usr/bin/env python
"""Demo: the fused visual-odometry loop (SIFT + matching + PnP + windowed BA
in one compiled step per frame — the BASELINE.json north-star composition).

Renders a rigid 3-D blob cloud from a camera translating along +x and
compares the recovered trajectory against ground truth; with init_depth
matching the cloud's mean depth the trajectory is metric.

Usage: python examples/demo_vo.py [--frames N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from sift_pyocl_jax import SiftConfig
from sift_pyocl_jax.models.vo import VOConfig, vo_init, vo_step
from sift_pyocl_jax.utils.testimage import blob_cloud, render_point_cloud


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--step", type=float, default=0.15,
                    help="camera x-translation per frame (world units)")
    args = ap.parse_args()

    H, W = 256, 256
    K = [[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]]
    pts, radii, amps = blob_cloud(n=140, seed=3, depth=(3.5, 8.0), span=4.5)
    I = np.eye(3, dtype=np.float32)

    def frame_at(i):
        c = np.array([args.step * i, 0.0, 0.0], np.float32)
        return jnp.asarray(render_point_cloud(pts, radii, amps, K, I, -c, (H, W)))

    cfg = SiftConfig(kp_per_octave_cap=512)
    vo = VOConfig(window=6, pts_per_frame=128, obs_per_frame=256,
                  pnp_n=256, pnp_iters=6, cg_iters=6)
    Kj = jnp.asarray(K, jnp.float32)
    state = vo_init(frame_at(0), Kj, cfg, vo)
    print("frame | keypoints matches  rms(px)   t (world)            true t_x   err")
    for i in range(1, args.frames):
        state, out = vo_step(state, frame_at(i), Kj, cfg, vo)
        t = np.asarray(out.t)
        true_tx = -args.step * i
        print(
            f"{i:5d} | {int(out.n_kp):9d} {int(out.n_matches):7d} "
            f"{float(out.rms_px):8.3f}   [{t[0]:+.3f} {t[1]:+.3f} {t[2]:+.3f}]"
            f"   {true_tx:+.3f}   {abs(t[0] - true_tx):.3f}"
        )


if __name__ == "__main__":
    main()

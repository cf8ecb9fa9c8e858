"""VO long-run fence probe: the 200-frame orbit of
tests/test_vo_longrun.py as a parameterized CLI so VOConfig knobs
(ba_iters, metric_weight, window...) can be A/B'd against ATE/path_ratio
without editing the test.

Run (CPU): python tools/diag_longrun.py --ba-iters 2
Results recorded in PARITY.md.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--ba-iters", type=int, default=1)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--metric-weight", type=float, default=3.0)
    ap.add_argument("--cg-iters", type=int, default=6)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from sift_pyocl_jax import SiftConfig
    from sift_pyocl_jax.models.vo import VOConfig, vo_init, vo_step
    from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers
    from sift_pyocl_jax.utils.testimage import blob_cloud, render_point_cloud

    H, W = 224, 224
    K = [[280.0, 0, W / 2], [0, 280.0, H / 2], [0, 0, 1.0]]
    pts, radii, amps = blob_cloud(n=150, seed=args.seed, depth=(3.5, 8.5),
                                  span=4.5)
    I3 = np.eye(3, dtype=np.float32)

    def center_at(i):
        return np.array([0.45 * np.sin(2 * np.pi * i / 80.0),
                         0.30 * np.sin(2 * np.pi * i / 50.0),
                         0.25 * np.sin(2 * np.pi * i / 120.0)], np.float32)

    def frame_at(i):
        return jnp.asarray(render_point_cloud(
            pts, radii, amps, K, I3, -center_at(i), (H, W)))

    cfg = SiftConfig(kp_per_octave_cap=512)
    vo = VOConfig(window=args.window, pts_per_frame=128, obs_per_frame=256,
                  pnp_n=256, pnp_iters=6, cg_iters=args.cg_iters,
                  ba_iters=args.ba_iters, metric_weight=args.metric_weight)
    Kj = jnp.asarray(K, jnp.float32)
    t0 = time.perf_counter()
    st = vo_init(frame_at(0), Kj, cfg, vo)
    Rs, ts, tracked = [I3], [np.zeros(3, np.float32)], []
    for i in range(1, args.frames):
        st, out = vo_step(st, frame_at(i), Kj, cfg, vo)
        Rs.append(np.asarray(out.R))
        ts.append(np.asarray(out.t))
        tracked.append(bool(out.tracked))
    est = camera_centers(np.stack(Rs), np.stack(ts))
    gt = np.stack([center_at(i) for i in range(args.frames)])
    ate = ate_rmse(est, gt, with_scale=True)
    path_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    path_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    print(json.dumps({
        "frames": args.frames, "ba_iters": args.ba_iters,
        "window": args.window, "metric_weight": args.metric_weight,
        "seed": args.seed,
        "tracked": round(float(np.mean(tracked)), 3),
        "ate_sim3": round(float(ate), 4),
        "path_ratio": round(float(path_est / path_gt), 3),
        "wall_s": round(time.perf_counter() - t0, 1),
    }))


if __name__ == "__main__":
    main()

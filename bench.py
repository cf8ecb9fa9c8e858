#!/usr/bin/env python
"""Benchmark: the fused 1080p VO step (SIFT + matching + PnP + windowed BA,
models/vo.py) on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit"} with the VO
frame rate; the detail line on stderr carries the SIFT-frontend-only rate,
the keypoint count, the device and the card's name and power limit.

Traffic: SIFT alone runs on the synthetic 200-blob scene; the VO step is
initialised on frame 0 of a rendered 1080p trajectory and timed on frame 1
(real camera motion, as in chip_smoke.py phase 4).

Timing: each program is compiled and warmed off the clock, then timed over
N back-to-back calls closed by `block_until_ready` (utils/benchtool.time_ms);
the median over --reps windows is reported.  Fails when JAX finds no GPU.

    python bench.py [--shape 1080 1920] [--steps 10] [--reps 3]
"""

import argparse
import json
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=2, default=[1080, 1920])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")

    from functools import partial

    from sift_pyocl_jax import SiftConfig
    from sift_pyocl_jax.models.sift import _jitted_detector
    from sift_pyocl_jax.models.vo import VOConfig, vo_init, vo_step
    from sift_pyocl_jax.utils.benchtool import (enable_compile_cache,
                                                gpu_card, time_ms)
    from sift_pyocl_jax.utils.render3d import render_sequence
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    cache_dir = enable_compile_cache()
    cfg, vo = SiftConfig(), VOConfig()
    shape = tuple(args.shape)
    img = jnp.asarray(synthetic_scene(shape, n_blobs=200, seed=0))
    K, frames, _, _ = render_sequence(n_frames=11, image_size=shape[::-1],
                                      f=1800.0, seed=0, arc_deg=40.0)
    K = jnp.asarray(K, jnp.float32)
    f0, f1 = jnp.asarray(frames[0]), jnp.asarray(frames[1])
    wall0 = time.perf_counter()

    detect = _jitted_detector(cfg)
    sift_ms = time_ms(detect, img, n=args.steps, reps=args.reps)
    n_kp = int(detect(img).valid.sum())

    st = jax.jit(partial(vo_init, cfg=cfg, vo=vo))(f0, K)
    step = jax.jit(lambda s, x: vo_step(s, x, K, cfg, vo))
    tracked = bool(step(st, f1)[1].tracked)
    if not tracked:
        raise SystemExit("VO step lost track on frame 1")
    vo_ms = time_ms(step, st, f1, n=args.steps, reps=args.reps)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"vo_sift_match_ba_fps_{shape[0]}x{shape[1]}",
        "value": 1000.0 / vo_ms,
        "unit": "frames/s",
    }))
    print(json.dumps({"detail": {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": gpu_card(),
        "vo_ms_per_frame": vo_ms,
        "sift_only_ms_per_frame": sift_ms,
        "sift_only_fps": 1000.0 / sift_ms,
        "keypoints": n_kp,
        "vo": dict(vo._asdict()),
        "method": f"warm-up, then {args.steps} calls per window closed by "
                  f"block_until_ready, median of {args.reps} windows",
        "compile_cache": cache_dir,
        "bench_wall_s": time.perf_counter() - wall0,
    }}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

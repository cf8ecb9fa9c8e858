#!/usr/bin/env python
"""A/B of the L2 best-2 matcher end to end, on one GPU.

Two workloads, each timed with two matchers swapped into
ops.match._best2_l2_auto:
  * vo    the fused 1080p vo_step (default VOConfig) over a rendered
          trajectory: median ms per step over the sequence;
  * pair  1080p translated pair, match + RANSAC homography in one jitted
          program (chip_smoke.py phase 3): median ms per call.
Matchers: "kernel" is the shipped path (the Triton kernel on uint8
descriptors), "xla" the plain `_best2_l2` reduction.  Every program is
compiled first; then each round times both matchers, the order
alternating.  Fails when JAX finds no GPU.

    python tools/ab_matcher.py --rounds 12
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sift_pyocl_jax import SiftConfig  # noqa: E402
from sift_pyocl_jax.ops import match as M  # noqa: E402
from sift_pyocl_jax.utils.benchtool import time_ms  # noqa: E402

RATIO_SQ = 0.73 ** 2
SHIPPED = M._best2_l2_auto
MATCHERS = {"kernel": SHIPPED, "xla": M._best2_l2}


def _compile(build):
    """{matcher: executable}, each traced with that matcher swapped in."""
    out = {}
    try:
        for name, fn in MATCHERS.items():
            M._best2_l2_auto = fn
            jax.clear_caches()
            t0 = time.perf_counter()
            out[name] = build()
            print(json.dumps({"matcher": name,
                              "compile_s": time.perf_counter() - t0}),
                  flush=True)
    finally:
        M._best2_l2_auto = SHIPPED
    return out


def vo_runner(frames, K, cfg, vo):
    """{matcher: run()} where run() steps the sequence and returns
    (median ms per step, frames tracked)."""
    from sift_pyocl_jax.models.vo import vo_init, vo_step

    Kd = jnp.asarray(np.asarray(K, np.float32))
    fd = [jnp.asarray(f) for f in frames]
    st0 = jax.jit(partial(vo_init, cfg=cfg, vo=vo))(fd[0], Kd)
    exe = _compile(lambda: vo_step.lower(st0, fd[1], Kd, cfg, vo).compile())

    def make(name):
        def run():
            st, ms, tracked = st0, [], 0
            for f in fd[1:]:
                t0 = time.perf_counter()
                st, out = exe[name](st, f, Kd)
                jax.block_until_ready((st, out))
                ms.append((time.perf_counter() - t0) * 1e3)
                tracked += int(out.tracked)
            return float(np.median(ms)), tracked
        return run
    return {name: make(name) for name in exe}


def pair_runner(ba, bb, n: int = 20):
    """{matcher: run()} where run() returns (median ms per match+RANSAC
    call, matches kept)."""
    from sift_pyocl_jax.sfm.ransac import ransac_homography

    key = jax.random.PRNGKey(0)

    def match_ransac(ba, bb):
        keep, mid, _, _ = M.match_descriptors_dense(
            ba.desc, ba.valid, bb.desc, bb.valid, metric="L2",
            ratio_sq=RATIO_SQ)
        uv1 = jnp.stack([ba.x, ba.y], -1)
        uv2 = jnp.stack([bb.x, bb.y], -1)[mid]
        return keep, ransac_homography(key, uv1, uv2, keep)

    exe = _compile(lambda: jax.jit(match_ransac).lower(ba, bb).compile())

    def make(name):
        def run():
            keep, _ = exe[name](ba, bb)
            return time_ms(exe[name], ba, bb, n=n), int(keep.sum())
        return run
    return {name: make(name) for name in exe}


def ab(workload: str, runners: dict, rounds: int) -> dict:
    """Round-robin timing; per-matcher runs, median, range, and per-round
    wins and median gap of each matcher pair."""
    for run in runners.values():
        run()                                   # warm
    names = list(runners)
    orders = list(itertools.permutations(names))
    runs = {n: [] for n in names}
    for r in range(rounds):
        for name in orders[r % len(orders)]:
            ms, extra = runners[name]()
            runs[name].append(ms)
            print(json.dumps({"workload": workload, "round": r,
                              "matcher": name, "ms": ms, "check": extra}),
                  flush=True)
    out = {"workload": workload, "rounds": rounds}
    for n in names:
        v = np.asarray(runs[n])
        out[n] = {"median_ms": float(np.median(v)), "min_ms": float(v.min()),
                  "max_ms": float(v.max()), "runs": v.tolist()}
    for a, b in itertools.combinations(names, 2):
        diff = np.asarray(runs[b]) - np.asarray(runs[a])
        out[f"{a}_vs_{b}"] = {"wins": int((diff > 0).sum()), "of": rounds,
                              "median_gap_ms": float(np.median(diff))}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12,
                    help="rounds; each times every matcher once")
    ap.add_argument("--frames", type=int, default=11)
    ap.add_argument("--workloads", default="vo,pair")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")

    from sift_pyocl_jax.models.sift import _jitted_detector
    from sift_pyocl_jax.models.vo import VOConfig
    from sift_pyocl_jax.utils.benchtool import enable_compile_cache, gpu_card
    from sift_pyocl_jax.utils.render3d import render_sequence
    from sift_pyocl_jax.utils.testimage import transformed_pair

    enable_compile_cache()
    print(gpu_card(), flush=True)
    cfg = SiftConfig()
    detect = _jitted_detector(cfg)
    want = args.workloads.split(",")
    if "vo" in want:
        K, frames, _, _ = render_sequence(n_frames=args.frames,
                                          image_size=(1920, 1080), f=1800.0,
                                          seed=0, arc_deg=40.0)
        ab("vo", vo_runner(frames, K, cfg, VOConfig()), args.rounds)
    if "pair" in want:
        a, b = transformed_pair((1080, 1920), seed=1, dx=7, dy=-4)
        ba, bb = detect(jnp.asarray(a)), detect(jnp.asarray(b))
        ab("pair", pair_runner(ba, bb), args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Timings for BASELINE.json measurement configs 2 and 4 on a GPU.

Run on the card:  python tools/bench_configs.py --configs 2,2seq,4
Fails when JAX finds no GPU.

Config 2 — pairwise 1080p matching, three protocols:
  * `pair`  — detect BOTH frames + ratio-test match + RANSAC homography in
    ONE jitted program (the historical per-pair protocol; charges two
    detections to every pair).
  * `seq`   — per-frame amortized: detect each frame ONCE and match+RANSAC
    against the PREVIOUS frame's carried detection (the realistic sequence
    protocol).
  * `stages` — isolated per-stage timings at full 1080p capacities:
    detect / match / RANSAC-H, so the non-detect cost is explained instead
    of inferred by subtraction.

Config 4 — 50-frame small SfM (two-view init + sequential PnP +
triangulation + periodic/final BA + loop closure): WALL time per frame,
plus the final ATE.  `--host-loop` times the legacy
host-driven registration (~100 dispatches/frame) instead of the fused
one-dispatch-per-frame path (sfm/pipeline.py::register_frame_fused) for the
architecture A/B.

Configs 1/3/5 are covered elsewhere: 1 = keypoint parity tests (512²),
3 = bench.py sift/vo headline + parallel/video DP, 5 = bench_distributed.py.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


RATIO_SQ = 0.5329 ** 2


def config2_pairwise(shape, n_hi, reps):
    from sift_pyocl_jax import SiftConfig
    from sift_pyocl_jax.models.sift import detect_and_describe
    from sift_pyocl_jax.ops.match import match_descriptors_dense
    from sift_pyocl_jax.sfm.ransac import ransac_homography
    from sift_pyocl_jax.utils.benchtool import chained_ms
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    cfg = SiftConfig()
    img = jnp.asarray(synthetic_scene(shape, n_blobs=200, seed=0))
    key = jax.random.PRNGKey(0)

    def step(c):
        b1 = detect_and_describe(c, cfg)
        b2 = detect_and_describe(c[::-1], cfg)   # distinct second frame
        keep, mid, d, _ = match_descriptors_dense(
            b1.desc, b1.valid, b2.desc, b2.valid, metric="L2",
            ratio_sq=RATIO_SQ,
        )
        uv1 = jnp.stack([b1.x, b1.y], -1)
        uv2 = jnp.stack([b2.x, b2.y], -1)[mid]
        res = ransac_homography(key, uv1, uv2, keep)
        return [res.n_inliers, res.model.sum(), keep.sum()]

    ms = chained_ms(step, img, n_hi=n_hi, reps=reps)
    return {"config2_pair_ms": round(ms, 3),
            "config2_pairs_per_s": round(1000.0 / ms, 1)}


def config2_sequence(shape, n_hi, reps):
    """Per-frame amortized protocol: each chain iteration detects ONE frame
    and matches+RANSACs against the previous iteration's carried detection
    (desc/valid/uv ride the fori_loop carry, so detection is charged once
    per frame like a real sequence matcher)."""
    from sift_pyocl_jax import SiftConfig
    from sift_pyocl_jax.models.sift import detect_and_describe
    from sift_pyocl_jax.ops.match import match_descriptors_dense
    from sift_pyocl_jax.sfm.ransac import ransac_homography
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    cfg = SiftConfig()
    img = jnp.asarray(synthetic_scene(shape, n_blobs=200, seed=0))
    key = jax.random.PRNGKey(0)

    @jax.jit
    def chain(x, n):
        b0 = detect_and_describe(x[::-1], cfg)
        uv0 = jnp.stack([b0.x, b0.y], -1)

        def body(i, carry):
            x, pd, pv, puv = carry
            b = detect_and_describe(x, cfg)
            keep, mid, d, _ = match_descriptors_dense(
                b.desc, b.valid, pd, pv, metric="L2", ratio_sq=RATIO_SQ)
            uv1 = jnp.stack([b.x, b.y], -1)
            res = ransac_homography(key, uv1, puv[mid], keep)
            s = (res.n_inliers.astype(jnp.float32)
                 + res.model.sum() + d.sum())
            x2 = x * 0.9999 + 0.0001 * jnp.tanh(s * 1e-9)
            return (x2, b.desc, b.valid, uv1)

        return lax.fori_loop(0, n, body, (x, b0.desc, b0.valid, uv0))

    x = img
    n = jnp.int32(n_hi)
    jax.block_until_ready(chain(x, n))          # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x, n))
        times.append((time.perf_counter() - t0) / n_hi)
    ms = float(np.median(times)) * 1e3
    return {"config2_seq_ms": round(ms, 3),
            "config2_seq_frames_per_s": round(1000.0 / ms, 1)}


def config2_stages(shape, n_hi, reps):
    """Isolated stage breakdown at full-capacity 1080p shapes:
    detect / ratio-match / RANSAC homography (n_hypo default 256 and a 64
    probe so the hypothesis count's cost share is measured, not guessed)."""
    from sift_pyocl_jax import SiftConfig
    from sift_pyocl_jax.models.sift import detect_and_describe
    from sift_pyocl_jax.ops.match import match_descriptors_dense
    from sift_pyocl_jax.sfm.ransac import ransac_homography
    from sift_pyocl_jax.utils.benchtool import chained_ms
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    cfg = SiftConfig()
    img = jnp.asarray(synthetic_scene(shape, n_blobs=200, seed=0))
    key = jax.random.PRNGKey(0)
    # real full-capacity buffers for the matcher/RANSAC stages
    b1 = jax.jit(lambda c: detect_and_describe(c, cfg))(img)
    b2 = jax.jit(lambda c: detect_and_describe(c, cfg))(img[::-1])
    keep0, mid0, _, _ = jax.jit(
        lambda: match_descriptors_dense(
            b1.desc, b1.valid, b2.desc, b2.valid, metric="L2",
            ratio_sq=RATIO_SQ)
    )()
    uv1 = jnp.stack([b1.x, b1.y], -1)
    uv2m = jnp.stack([b2.x, b2.y], -1)[mid0]
    out = {"n_slots": int(b1.desc.shape[0]),
           "n_matches": int(jnp.sum(keep0))}

    def step_detect(c):
        b = detect_and_describe(c, cfg)
        return [b.x.sum(), b.desc.astype(jnp.float32).sum(), b.valid.sum()]

    def step_match(c):
        d1 = b1.desc + c[0, 0].astype(jnp.uint8)    # fresh data per iter
        keep, mid, d, d2 = match_descriptors_dense(
            d1, b1.valid, b2.desc, b2.valid, metric="L2", ratio_sq=RATIO_SQ)
        return [keep.sum(), mid.sum(), d.sum()]

    def make_step_ransac(n_hypo):
        def step(c):
            uv = uv1 + c[0, :2]                      # fresh data per iter
            res = ransac_homography(key, uv, uv2m, keep0, n_hypo=n_hypo)
            return [res.n_inliers, res.model.sum()]
        return step

    out["stage_detect_ms"] = round(
        chained_ms(step_detect, img, n_hi=n_hi, reps=reps), 3)
    carry = jnp.zeros((8, 128), jnp.float32)
    out["stage_match_ms"] = round(
        chained_ms(step_match, carry, n_hi=n_hi, reps=reps), 3)
    out["stage_ransacH256_ms"] = round(
        chained_ms(make_step_ransac(256), carry, n_hi=n_hi, reps=reps), 3)
    out["stage_ransacH64_ms"] = round(
        chained_ms(make_step_ransac(64), carry, n_hi=n_hi, reps=reps), 3)
    return out


def config4_sfm(n_frames, host_loop=False):
    from sift_pyocl_jax import SiftConfig
    from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers
    from sift_pyocl_jax.sfm.pipeline import IncrementalSfM
    from sift_pyocl_jax.utils.render3d import render_sequence

    K, frames, gtR, gtT = render_sequence(
        n_frames=n_frames, n_points=120, image_size=(320, 240), seed=0,
        arc_deg=40.0,
    )
    kw = dict(cfg=SiftConfig(kp_per_octave_cap=256), ba_every=8,
              fused=not host_loop)
    sfm = IncrementalSfM(K, frames[0].shape, **kw)
    t0 = time.perf_counter()
    sfm.run(frames)
    wall_cold = time.perf_counter() - t0
    # Steady-state protocol (plan idiom): the warm pass above traces and
    # compiles every shape variant the sequence visits (map buckets, BA
    # camera counts, loop-closure buckets) IN THIS PROCESS; the reference's
    # plan architecture amortizes exactly this way (compile once, run
    # many).  wall_cold above still reports the tracing-inclusive number.
    sfm2 = IncrementalSfM(K, frames[0].shape, **kw)
    t0 = time.perf_counter()
    res = sfm2.run(frames)
    wall = time.perf_counter() - t0
    out = {"config4_frames": n_frames,
           "config4_arch": "host_loop" if host_loop else "fused",
           "config4_wall_s": round(wall, 2),
           "config4_fps": round(n_frames / wall, 2),
           "config4_wall_cold_s": round(wall_cold, 2)}
    if res is not None:
        reg = res.frames_registered
        ate = ate_rmse(camera_centers(res.Rs, res.ts),
                       camera_centers(gtR[reg], gtT[reg]))
        out["config4_ate"] = round(float(ate), 4)
        out["config4_registered"] = len(reg)
        out["config4_points"] = int(len(res.points))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=2, default=[1080, 1920])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--n-hi", type=int, default=9)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--configs", type=str, default="2,2seq,4",
                    help="comma list: 2, 2seq, 2stages, 4")
    ap.add_argument("--host-loop", action="store_true",
                    help="config 4 with the legacy host-driven registration")
    args = ap.parse_args()
    from sift_pyocl_jax.utils.benchtool import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    enable_compile_cache()
    want = set(args.configs.split(","))
    out = {}
    shape = tuple(args.shape)
    if "2" in want:
        out.update(config2_pairwise(shape, args.n_hi, args.reps))
        print(json.dumps(out), flush=True)
    if "2seq" in want:
        out.update(config2_sequence(shape, args.n_hi, args.reps))
        print(json.dumps(out), flush=True)
    if "2stages" in want:
        out.update(config2_stages(shape, args.n_hi, args.reps))
        print(json.dumps(out), flush=True)
    if "4" in want:
        out.update(config4_sfm(args.frames, host_loop=args.host_loop))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

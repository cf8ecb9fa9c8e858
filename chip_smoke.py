#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, through the public entry
points, at the sizes users run (BASELINE.json configs 1-5).

    python chip_smoke.py          # phases 1-6 on one GPU
    python chip_smoke.py --four   # phase 7 only: the 4-GPU paths

Phases (each raises on failure; nothing is caught):
  1. device      JAX's default backend is the GPU; JAX version, card, limit
  2. sift        SiftPlan at 1080p vs the same program on the host CPU, and
                 512^2 parity with oracle.py
  3. pair        1080p translated pair: matching + RANSAC homography
  4. vo          10 fused vo_steps at 1080p (default VOConfig) against ground
                 truth, and GPU-vs-CPU agreement of the quick VO config
  5. sfm         IncrementalSfM on the config-4 sequence
  6. best2       the Triton best-2 kernel vs ops.match._best2_l2 at the VO
                 map (N x 2048) and frame-to-frame (N x N) shapes
  7. four GPUs   DistributedBA on 4 cards vs 1, frame-parallel SIFT on 4
                 cards vs per-frame SIFT on one

Every phase runs in this one process (a second JAX process could not get
the card's memory); the CPU references run here on JAX's CPU backend.
Precision: the package sets jax_default_matmul_precision="highest", so f32
products and convolutions run without TF32 on the GPU; sums still run in
another order than on the CPU, so keypoints at a threshold can flip and the
GPU-vs-CPU tolerances below allow for it.  The last stdout line is
{"ok": true, "device": {"platform", "kind", "count"}}; with no GPU the
script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

# the CPU backend hosts the references: keep it next to a GPU-only setting
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sift_pyocl_jax import SiftConfig, SiftPlan  # noqa: E402
from sift_pyocl_jax.models.sift import (_jitted_detector,  # noqa: E402
                                        buffer_to_records)
from sift_pyocl_jax.oracle import match_keypoint_sets, sift_numpy  # noqa: E402
from sift_pyocl_jax.utils.benchtool import (enable_compile_cache,  # noqa: E402
                                            gpu_card, time_ms)
from sift_pyocl_jax.utils.gpucheck import (assert_on_gpu,  # noqa: E402
                                           check_best2_kernel)

RATIO_SQ = 0.73 ** 2      # Lowe ratio of SiftConfig.match_ratio, squared


def log(msg: str) -> None:
    print(msg, flush=True)


def cpu_device():
    return jax.devices("cpu")[0]


def phase_device() -> dict:
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    devs = jax.devices()
    log(f"[device] jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_sift(shape=(1080, 1920), oracle_shape=(512, 512), n=10) -> SiftPlan:
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    img = synthetic_scene(shape, n_blobs=200, seed=0)
    plan = SiftPlan(shape)
    t0 = time.perf_counter()
    buf = plan.keypoints_raw(img)
    jax.block_until_ready(buf)
    compile_s = time.perf_counter() - t0
    assert_on_gpu(buf, "sift")
    ms = time_ms(plan.keypoints_raw, jnp.asarray(img), n=n)
    got = buffer_to_records(buf)
    ref = buffer_to_records(_jitted_detector(plan.cfg)(
        jax.device_put(img, cpu_device())))
    hits, l1 = match_keypoint_sets(ref, got)
    log(f"[sift] {shape}: {len(got)} keypoints (cpu {len(ref)}), "
        f"{hits}/{len(ref)} cpu keypoints matched, desc L1 {l1:.4f}; "
        f"{ms:.3f} ms/frame warm ({1000 / ms:.1f} frames/s), first call "
        f"{compile_s:.1f} s")
    # tolerance: >= 99% of CPU keypoints matched (xy 0.1 px, scale 0.05,
    # angle 0.05 rad), counts within 1%, mean desc L1 <= 1 on the u8 scale
    assert hits >= 0.99 * len(ref) and len(ref) > 50, (hits, len(ref))
    assert abs(len(got) - len(ref)) <= 0.01 * len(ref), (len(got), len(ref))
    assert l1 <= 1.0, l1

    img5 = synthetic_scene(oracle_shape, n_blobs=60, seed=0)
    got5 = SiftPlan(oracle_shape).keypoints(img5)
    ref5 = sift_numpy(img5, SiftConfig())
    hits5, l15 = match_keypoint_sets(ref5, got5)
    log(f"[sift] oracle parity {oracle_shape}: {hits5}/{len(ref5)} matched, "
        f"{len(got5)} found, desc L1 {l15:.4f} (tolerance: >= 95% matched, "
        f"<= 5% extra, L1 < 0.2, as tests/test_pipeline.py)")
    assert len(ref5) > 10 and hits5 >= 0.95 * len(ref5), (hits5, len(ref5))
    assert len(got5) <= len(ref5) + max(3, int(0.05 * len(ref5)))
    assert l15 < 0.2, l15
    return plan


def phase_pair(plan: SiftPlan, dx=7, dy=-4, n=10) -> None:
    from sift_pyocl_jax.ops.match import match_descriptors_dense
    from sift_pyocl_jax.sfm.ransac import ransac_homography
    from sift_pyocl_jax.utils.testimage import transformed_pair

    a, b = transformed_pair(plan.shape, seed=1, dx=dx, dy=dy)
    ba, bb = plan.keypoints_raw(a), plan.keypoints_raw(b)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def match_ransac(ba, bb):
        keep, mid, _, _ = match_descriptors_dense(
            ba.desc, ba.valid, bb.desc, bb.valid, metric="L2",
            ratio_sq=RATIO_SQ)
        uv1 = jnp.stack([ba.x, ba.y], -1)
        uv2 = jnp.stack([bb.x, bb.y], -1)[mid]
        return keep, uv1, uv2, ransac_homography(key, uv1, uv2, keep)

    out = match_ransac(ba, bb)
    assert_on_gpu(out, "pair")
    keep, uv1, uv2, res = jax.device_get(out)
    ms = time_ms(match_ransac, ba, bb, n=n)
    n_match = int(keep.sum())
    inl = res.inliers & keep
    d = np.median(uv2[inl] - uv1[inl], axis=0)
    frac = int(inl.sum()) / max(n_match, 1)
    log(f"[pair] {plan.shape}, {ba.desc.shape[0]} slots: {n_match} matches, "
        f"inlier fraction {frac:.3f}, median displacement ({d[0]:.3f}, "
        f"{d[1]:.3f}) vs ({-dx}, {-dy}); match+RANSAC {ms:.3f} ms")
    assert n_match > 20 and frac > 0.9, (n_match, frac)
    assert abs(d[0] + dx) < 0.5 and abs(d[1] + dy) < 0.5, d


def _vo_run(frames, K, cfg, vo, device=None):
    from sift_pyocl_jax.models.vo import vo_init, vo_step

    put = (lambda x: jax.device_put(x, device)) if device else jnp.asarray
    Kd = put(np.asarray(K, np.float32))
    st = jax.jit(partial(vo_init, cfg=cfg, vo=vo))(put(frames[0]), Kd)
    outs, step_ms = [], []
    for f in frames[1:]:
        fd = put(f)
        jax.block_until_ready(fd)
        t0 = time.perf_counter()
        st, out = vo_step(st, fd, Kd, cfg, vo)
        jax.block_until_ready(out)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return outs, step_ms


def _vo_quick_inputs():
    """tests/test_vo.py::test_vo_step_quick's scene and capacities."""
    from sift_pyocl_jax.models.vo import VOConfig
    from sift_pyocl_jax.utils.testimage import blob_cloud, render_point_cloud

    H, W = 96, 96
    K = np.array([[140.0, 0, W / 2], [0, 140.0, H / 2], [0, 0, 1.0]],
                 np.float32)
    pts, radii, amps = blob_cloud(n=70, seed=2, depth=(3.5, 8.0), span=3.5)
    frames = [render_point_cloud(pts, radii, amps, K, np.eye(3, dtype=np.float32),
                                 -np.array([0.12 * i, 0, 0], np.float32), (H, W))
              for i in range(4)]
    vo = VOConfig(window=3, pts_per_frame=32, obs_per_frame=64, pnp_n=32,
                  pnp_iters=3, cg_iters=3, min_track_matches=8)
    return frames, K, SiftConfig(kp_per_octave_cap=128), vo


def phase_vo(image_size=(1920, 1080), n_frames=11, f=1800.0) -> None:
    from sift_pyocl_jax.models.vo import VOConfig
    from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers
    from sift_pyocl_jax.utils.render3d import render_sequence

    K, frames, gtR, gtT = render_sequence(
        n_frames=n_frames, image_size=image_size, f=f, seed=0, arc_deg=40.0)
    outs, step_ms = _vo_run(frames, K, SiftConfig(), VOConfig())
    assert_on_gpu(outs, "vo")
    outs = jax.device_get(outs)
    tracked = [bool(o.tracked) for o in outs]
    Rs = np.stack([np.eye(3, dtype=np.float32)] + [o.R for o in outs])
    ts = np.stack([np.zeros(3, np.float32)] + [o.t for o in outs])
    ate = ate_rmse(camera_centers(Rs, ts), camera_centers(gtR, gtT),
                   with_scale=True)
    warm = float(np.median(step_ms[1:]))
    log(f"[vo] {image_size[1]}x{image_size[0]}, default VOConfig, "
        f"{len(outs)} steps: tracked {sum(tracked)}/{len(tracked)}, "
        f"matches {[int(o.n_matches) for o in outs]}, sim3 ATE {ate:.4f} "
        f"(bound 0.35, tests/test_vo_longrun.py); {warm:.3f} ms/step warm "
        f"median ({1000 / warm:.1f} frames/s), first step {step_ms[0] / 1e3:.1f} s")
    assert all(tracked), tracked
    assert ate < 0.35, ate

    frames, K, cfg, vo = _vo_quick_inputs()
    g = jax.device_get(_vo_run(frames, K, cfg, vo)[0])
    c = jax.device_get(_vo_run(frames, K, cfg, vo, device=cpu_device())[0])
    dt = max(float(np.abs(a.t - b.t).max()) for a, b in zip(g, c))
    dR = max(float(np.abs(a.R - b.R).max()) for a, b in zip(g, c))
    log(f"[vo] quick config GPU vs CPU over {len(g)} steps: tracked "
        f"{[bool(o.tracked) for o in g]} / {[bool(o.tracked) for o in c]}, "
        f"max |dt| {dt:.5f} (tolerance 0.02; 0.12 per step of motion), "
        f"max |dR| {dR:.5f} (tolerance 0.01)")
    assert [bool(o.tracked) for o in g] == [bool(o.tracked) for o in c]
    # GPU runs are not bit-reproducible (autotuned reductions), and a flipped
    # RANSAC/top-k pick moves the pose: two H100 runs gave 0.0119 and 0.0139
    assert dt < 0.02 and dR < 0.01, (dt, dR)


def phase_sfm(n_frames=12) -> None:
    from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers
    from sift_pyocl_jax.sfm.pipeline import IncrementalSfM
    from sift_pyocl_jax.utils.render3d import render_sequence

    K, frames, gtR, gtT = render_sequence(
        n_frames=n_frames, n_points=120, image_size=(320, 240), seed=0,
        arc_deg=40.0)
    walls = []
    for _ in range(2):                       # cold (compiles), then warm
        sfm = IncrementalSfM(K, frames[0].shape,
                             cfg=SiftConfig(kp_per_octave_cap=256), ba_every=8)
        t0 = time.perf_counter()
        res = sfm.run(frames)
        walls.append(time.perf_counter() - t0)
    assert res is not None, "bootstrap failed"
    reg = res.frames_registered
    ate = ate_rmse(camera_centers(res.Rs, res.ts),
                   camera_centers(gtR[reg], gtT[reg]))
    log(f"[sfm] config 4, 320x240, {n_frames} frames: {len(reg)} registered, "
        f"{len(res.points)} points, ATE {ate:.4f} (bound 0.15, "
        f"tests/test_sfm_pipeline.py); wall {walls[0]:.2f} s cold, "
        f"{walls[1]:.2f} s warm ({walls[1] / n_frames:.3f} s/frame)")
    assert len(reg) == n_frames, reg
    assert ate < 0.15, ate


def phase_best2(n_kp=8320, n_map=2048) -> None:
    for n2 in (n_map, n_kp):
        r = check_best2_kernel(n_kp, n2)
        log(f"[best2] {n_kp}x{n2} u8: bit-identical to _best2_l2; kernel "
            f"{r['kernel_ms']:.4f} ms, XLA {r['xla_ms']:.4f} ms")


def phase_four(n_frames=8, shape=(1080, 1920), cams=64, points=8192,
               iters=10) -> dict:
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sift_pyocl_jax.parallel.video import make_frames_mesh, sharded_sift_fn
    from sift_pyocl_jax.sfm.ba import BAParams
    from sift_pyocl_jax.sfm.distributed import DistributedBA
    from sift_pyocl_jax.sfm.synthetic import make_problem
    from sift_pyocl_jax.utils.testimage import synthetic_scene

    devs = jax.devices()
    if len(devs) != 4 or jax.default_backend() != "gpu":
        raise SystemExit(f"--four needs 4 GPUs, JAX sees {devs}")

    # sharded BA: same problem on a 1-card and a 4-card mesh
    K, gt, obs, _ = make_problem(n_cams=cams, n_points=points, noise_px=0.5,
                                 seed=0, arc_deg=150.0)
    rng = np.random.default_rng(1)
    start = BAParams(
        Rs=jnp.asarray(gt.Rs),
        ts=jnp.asarray(gt.ts + 0.02 * rng.normal(size=gt.ts.shape)),
        X=jnp.asarray(gt.X + 0.10 * rng.normal(size=gt.X.shape)))
    res = {}
    for n in (1, 4):
        dba = DistributedBA(Mesh(np.array(devs[:n]), ("ba",)))
        dba.run(start, obs, K, iters=1)                      # compile
        t0 = time.perf_counter()
        _, costs = dba.run(start, obs, K, iters=iters)       # fetches costs
        res[n] = ((time.perf_counter() - t0) / iters * 1e3, costs)
    rel = abs(res[4][1][-1] - res[1][1][-1]) / res[1][1][-1]
    log(f"[four] DistributedBA {cams} cams / {points} points / "
        f"{int(np.asarray(obs.uv).shape[0])} obs, {iters} LM iterations: "
        f"{res[1][0]:.3f} ms/it on 1 card, {res[4][0]:.3f} ms/it on 4; "
        f"final cost {res[1][1][-1]:.6g} vs {res[4][1][-1]:.6g} (rel diff "
        f"{rel:.2e}, tolerance 1e-3), first cost rel diff "
        f"{abs(res[4][1][0] - res[1][1][0]) / res[1][1][0]:.2e}")
    assert rel < 1e-3, rel

    # frame-parallel SIFT: 4-card shard_map vs per-frame SIFT on one card
    cfg = SiftConfig()
    frames = np.stack([synthetic_scene(shape, n_blobs=200, seed=s)
                       for s in range(n_frames)])
    mesh = make_frames_mesh(4)
    fn = sharded_sift_fn(mesh, cfg)
    x = jax.device_put(jnp.asarray(frames), NamedSharding(mesh, P("frames")))
    out = fn(x)
    jax.block_until_ready(out)
    assert_on_gpu(out, "frame-parallel sift")
    shard_devs = {s.device for s in out.x.addressable_shards}
    assert len(shard_devs) == 4, shard_devs       # one frame block per card
    ms4 = time_ms(fn, x, n=3) / n_frames
    one = _jitted_detector(cfg)
    singles = [one(jax.device_put(f, devs[0])) for f in frames]
    ms1 = time_ms(one, jax.device_put(frames[0], devs[0]), n=5)
    out = jax.device_get(out)
    diffs = {f: 0.0 for f in ("x", "y", "scale", "angle", "desc")}
    n_desc_off = n_kp = 0
    for i, s in enumerate(jax.device_get(singles)):
        np.testing.assert_array_equal(out.valid[i], s.valid)
        m = s.valid
        n_kp += int(m.sum())
        for f in diffs:
            d = np.abs(getattr(out, f)[i][m].astype(np.float64)
                       - getattr(s, f)[m].astype(np.float64))
            diffs[f] = max(diffs[f], float(d.max(initial=0)))
            if f == "desc":
                n_desc_off += int((d > 0).sum())
    log(f"[four] frame-parallel SIFT, {n_frames} frames {shape} over "
        f"{len(shard_devs)} cards: {ms4:.3f} ms/frame vs {ms1:.3f} ms/frame "
        f"on one card ({ms1 / ms4:.2f}x); {n_kp} keypoints, valid slots "
        f"identical on every frame, max |diff| {diffs}, {n_desc_off} of "
        f"{n_kp * 128} descriptor bytes differ (tolerance: identical keypoint "
        f"slots, x/y/scale/angle within 1e-3, descriptor bytes within 1)")
    assert max(diffs[f] for f in ("x", "y", "scale", "angle")) <= 1e-3, diffs
    assert diffs["desc"] <= 1, diffs
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU phase (needs 4 cards)")
    args = ap.parse_args()
    device = phase_device()
    log(f"[device] cache {enable_compile_cache()}")
    log(gpu_card())
    t0 = time.perf_counter()

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        log(f"[{name}] phase wall {time.perf_counter() - t:.1f} s")
        return out

    if args.four:
        device = timed("four", phase_four)
    else:
        plan = timed("sift", phase_sift)
        timed("pair", phase_pair, plan)
        timed("vo", phase_vo)
        timed("sfm", phase_sfm)
        timed("best2", phase_best2)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

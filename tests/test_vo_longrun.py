"""VO long-run stability: 200-frame synthetic trajectory.

Catches the failure classes the short (<=60 frame) tests cannot: slow pose
drift, NaN/Inf creep through the LM damping or triangulation paths,
tracking-fraction decay as the map ages, per-frame recompiles (shape or
weak-type wobble in the carried VOState), and host-memory growth.

The camera orbits gently inside a fixed 3-D blob cloud (known ground-truth
centers) so the scene stays feature-rich for the whole run; ATE is scored
with the same sim(3)-aligned RMSE the evaluate CLI reports.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sift_pyocl_jax import SiftConfig


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """See tests/test_vo.py::_fresh_compile_state — dodge the accumulated-
    executable native compile segfault before this module's big jit."""
    jax.clear_caches()
    yield
from sift_pyocl_jax.models.vo import VOConfig, vo_init, vo_step
from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers
from sift_pyocl_jax.utils.testimage import blob_cloud, render_point_cloud

N_FRAMES = 200


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return float(line.split()[1]) / 1024.0
    return 0.0


@pytest.mark.slow
def test_vo_200_frame_stability():
    H, W = 224, 224
    K = [[280.0, 0, W / 2], [0, 280.0, H / 2], [0, 0, 1.0]]
    pts, radii, amps = blob_cloud(n=150, seed=5, depth=(3.5, 8.5), span=4.5)
    I3 = np.eye(3, dtype=np.float32)

    # gentle lissajous drift: keeps the cloud in frame for all 200 frames
    def center_at(i):
        return np.array([0.45 * np.sin(2 * np.pi * i / 80.0),
                         0.30 * np.sin(2 * np.pi * i / 50.0),
                         0.25 * np.sin(2 * np.pi * i / 120.0)], np.float32)

    def frame_at(i):
        return jnp.asarray(render_point_cloud(
            pts, radii, amps, K, I3, -center_at(i), (H, W)))

    cfg = SiftConfig(kp_per_octave_cap=512)
    vo = VOConfig(window=6, pts_per_frame=128, obs_per_frame=256,
                  pnp_n=256, pnp_iters=6, cg_iters=6)
    Kj = jnp.asarray(K, jnp.float32)
    st = vo_init(frame_at(0), Kj, cfg, vo)

    Rs = [I3]
    ts = [np.zeros(3, np.float32)]
    tracked = []
    compiles_after_warmup = None
    rss_after_warmup = None
    for i in range(1, N_FRAMES):
        st, out = vo_step(st, frame_at(i), Kj, cfg, vo)
        if i == 2:
            compiles_after_warmup = vo_step._cache_size()
            rss_after_warmup = _rss_mb()
        Rs.append(np.asarray(out.R))
        ts.append(np.asarray(out.t))
        tracked.append(bool(out.tracked))
        # NaN/Inf creep: check the full carried state every 25 frames
        if i % 25 == 0:
            assert np.isfinite(np.asarray(out.t)).all(), f"t blew up at {i}"
            assert np.isfinite(float(st.lam)), f"lam blew up at {i}"
            assert np.isfinite(np.asarray(st.X)).all(), f"map NaN at {i}"

    # 1. tracking holds for the whole run
    frac = float(np.mean(tracked))
    assert frac >= 0.95, f"tracked only {frac:.2f} of {N_FRAMES} frames"

    # 2. bounded, sane trajectory: sim(3)-aligned ATE against ground truth
    # plus a total-path-length ratio.  Calibration (r4): the scale-collapse
    # failure class this test exists to catch (map depth draining through
    # biased low-parallax spawns; fixed by keyframe triangulation, deferred
    # depth refresh and carry-over recycling in models/vo.py) measured
    # path_ratio 0.1-0.2 and ATE 0.39-0.41.  Re-calibrated r5 after the
    # spawn-slot/dedup/parallax-store fixes with a knob sweep
    # (tools/diag_longrun.py, 200 frames each): defaults seed 5/6 give
    # ATE 0.288/0.257, path_ratio 0.69/0.50; ba_iters=2 -> 0.327/0.74;
    # window=8 -> 0.260/0.64; metric_weight=5 -> 0.254/0.53.  Every knob
    # lands inside the cross-seed noise band, so ATE ~0.25-0.33 is this
    # monocular orbit's observability level, not a tunable deficiency;
    # bounds are frozen just outside the measured band.  The path-ratio
    # band is the sharp discriminator for collapse; the ATE bound catches
    # gross drift.
    est = camera_centers(np.stack(Rs), np.stack(ts))
    gt = np.stack([center_at(i) for i in range(N_FRAMES)])
    assert np.isfinite(est).all()
    ate = ate_rmse(est, gt, with_scale=True)
    path_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    path_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    path_ratio = path_est / path_gt
    print(f"[vo-longrun] tracked {frac:.3f}, ATE {ate:.4f}, "
          f"path_ratio {path_ratio:.2f} over {N_FRAMES} frames")
    assert 0.45 < path_ratio < 2.5, (
        f"path ratio {path_ratio:.2f}: trajectory scale collapsed/exploded"
    )
    assert ate < 0.35, f"long-run ATE {ate:.3f} (drift)"

    # 3. no per-frame recompiles: the jitted vo_step executable count must
    # not grow after warmup (VOState dtypes/shapes stay fixed)
    assert vo_step._cache_size() == compiles_after_warmup, (
        f"vo_step recompiled mid-run: {compiles_after_warmup} -> "
        f"{vo_step._cache_size()} executables")

    # 4. stable host memory: generous bound, catches per-frame leak classes
    # (constant re-capture, growing python-side buffers), not noise
    growth = _rss_mb() - rss_after_warmup
    assert growth < 500.0, f"RSS grew {growth:.0f} MB over the run"

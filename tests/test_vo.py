"""Fused VO step: tracking on a translating synthetic scene (CPU backend).

The VO model is the BASELINE.json north-star composition (SIFT + matching +
PnP + windowed BA in one jit); no reference counterpart (SURVEY.md §2.3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sift_pyocl_jax import SiftConfig
from sift_pyocl_jax.models.vo import VOConfig, VOState, vo_init, vo_step
from sift_pyocl_jax.utils.testimage import synthetic_scene


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """Full-suite segfault workaround (r4, observed 3x): XLA's native
    backend_compile_and_load crashes compiling the big fused vo_step AFTER
    ~55 other tests' executables have accumulated in-process (the same
    compile succeeds standalone; 128 GB free, 64 MB stack — neither is the
    trigger).  Dropping the accumulated executables/tracing caches before
    this module's heavy compiles dodges the native-state poisoning at the
    cost of some recompiles."""
    jax.clear_caches()
    yield


def test_vo_tracks_translation():
    cfg = SiftConfig(kp_per_octave_cap=256)
    vo = VOConfig(window=4, pts_per_frame=64, obs_per_frame=128,
                  pnp_n=128, pnp_iters=6, cg_iters=5)
    H, W = 160, 160
    base = synthetic_scene((H + 48, W + 48), n_blobs=40, seed=0)

    def frame_at(dx):
        return jnp.asarray(base[24 : 24 + H, 24 + dx : 24 + dx + W])

    K = jnp.asarray(
        [[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]], jnp.float32
    )
    st = vo_init(frame_at(0), K, cfg, vo)
    assert isinstance(st, VOState)
    ts = []
    for i in range(1, 4):
        st, out = vo_step(st, frame_at(2 * i), K, cfg, vo)
        assert int(out.n_matches) > 10
        assert float(out.rms_px) < 2.0
        assert np.isfinite(float(out.ba_cost))
        ts.append(np.asarray(out.t))
    # motion is detected (a planar scene at a nominal depth is degenerate
    # for windowed BA, so only "some motion recovered, poses stay sane" is
    # asserted here; metric accuracy is covered by the SfM pipeline tests)
    assert any(np.linalg.norm(t) > 1e-3 for t in ts)
    assert all(np.linalg.norm(t) < 1.0 for t in ts)
    # state invariants
    assert st.X.shape == (4, 64, 3)
    assert int(st.frame) == 4


def test_vo_step_quick():
    """Quick-lane vo_step e2e: the flagship fused step at
    tiny capacities (3-frame window, 32 pts/frame, 128-cap SIFT, 96^2
    frames) so the compile fits the <=5-min quick lane's budget while still
    exercising every vo_step stage end-to-end — detect, map match, PnP,
    window roll, spawn, deferred depth refresh, windowed BA."""
    from sift_pyocl_jax.utils.testimage import blob_cloud, render_point_cloud

    H, W = 96, 96
    K = [[140.0, 0, W / 2], [0, 140.0, H / 2], [0, 0, 1.0]]
    pts, radii, amps = blob_cloud(n=70, seed=2, depth=(3.5, 8.0), span=3.5)
    I3 = np.eye(3, dtype=np.float32)

    def frame_at(i):
        c = np.array([0.12 * i, 0.0, 0.0], np.float32)
        return jnp.asarray(
            render_point_cloud(pts, radii, amps, K, I3, -c, (H, W)))

    cfg = SiftConfig(kp_per_octave_cap=128)
    vo = VOConfig(window=3, pts_per_frame=32, obs_per_frame=64,
                  pnp_n=32, pnp_iters=3, cg_iters=3, min_track_matches=8)
    Kj = jnp.asarray(K, jnp.float32)
    st = vo_init(frame_at(0), Kj, cfg, vo)
    for i in range(1, 4):
        st, out = vo_step(st, frame_at(i), Kj, cfg, vo)
        assert bool(out.tracked), f"lost tracking at tiny frame {i}"
        assert np.isfinite(float(out.rms_px))
        assert np.isfinite(np.asarray(out.t)).all()
    assert st.X.shape == (3, 32, 3)
    assert int(st.frame) == 4
    assert np.isfinite(np.asarray(st.X)).all()
    # some motion along +x must be recovered (sign/scale are prior-limited)
    assert abs(float(st.ts[-1][0])) > 1e-3


def test_match_xy_radius_gating():
    from sift_pyocl_jax.ops.match import match_descriptors_jax

    rng = np.random.default_rng(0)
    d = rng.integers(0, 255, (32, 128)).astype(np.uint8)
    xy1 = rng.uniform(0, 100, (32, 2)).astype(np.float32)
    # set2 = same descriptors (perfect matches) at shifted positions
    xy2 = xy1 + np.array([5.0, 0.0], np.float32)
    v = jnp.ones(32, bool)
    loose = match_descriptors_jax(
        jnp.asarray(d), v, jnp.asarray(d), v, metric="L1", ratio_sq=0.9,
        xy1=jnp.asarray(xy1), xy2=jnp.asarray(xy2), xy_radius=(10.0, 10.0),
    )
    tight = match_descriptors_jax(
        jnp.asarray(d), v, jnp.asarray(d), v, metric="L1", ratio_sq=0.9,
        xy1=jnp.asarray(xy1), xy2=jnp.asarray(xy2), xy_radius=(2.0, 10.0),
    )
    assert int(loose.count) > 0
    assert int(tight.count) == 0  # every true pair is 5 px apart in x


def test_matchplan_roi():
    from sift_pyocl_jax import MatchPlan
    from sift_pyocl_jax.oracle import KP_DTYPE

    rng = np.random.default_rng(1)
    n = 24
    kp = np.zeros(n, dtype=KP_DTYPE)
    kp["x"] = rng.uniform(0, 100, n)
    kp["y"] = rng.uniform(0, 100, n)
    kp["desc"] = rng.integers(0, 255, (n, 128))
    mp = MatchPlan(ratio_th=0.95)
    full = mp.match_index(kp, kp)
    roi = np.zeros((101, 101), dtype=np.uint8)
    roi[:, :50] = 1  # keep only left-half keypoints of set 1
    mp.set_roi(roi)
    part = mp.match_index(kp, kp)
    left = (kp["x"] < 50).sum()
    assert len(full) == n
    assert len(part) == left
    mp.unset_roi()
    assert len(mp.match_index(kp, kp)) == n


def test_vo_3d_cloud_metric_scale_and_triangulated_spawns():
    """VO over a true 3-D blob cloud (pinhole renders, known camera path).

    Checks the two-view triangulated map-point spawning (models/vo.py
    vo_step 4c): spawned points must carry real depth spread (not the flat
    median-depth fallback), and with init_depth matching the cloud's mean
    depth the recovered trajectory must be metric — t_x ≈ -0.15·frame.
    """
    from sift_pyocl_jax.models.sift import detect_and_describe
    from sift_pyocl_jax.utils.testimage import blob_cloud, render_point_cloud

    H, W = 256, 256
    K = [[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1.0]]
    pts, radii, amps = blob_cloud(n=140, seed=3, depth=(3.5, 8.0), span=4.5)
    I = np.eye(3, dtype=np.float32)

    def frame_at(i):
        c = np.array([0.15 * i, 0.0, 0.0], np.float32)
        return jnp.asarray(render_point_cloud(pts, radii, amps, K, I, -c, (H, W)))

    cfg = SiftConfig(kp_per_octave_cap=512)
    vo = VOConfig(window=6, pts_per_frame=128, obs_per_frame=256,
                  pnp_n=256, pnp_iters=6, cg_iters=6)
    Kj = jnp.asarray(K, jnp.float32)
    st = vo_init(frame_at(0), Kj, cfg, vo)
    uniq_depths = []
    Rs_all = [np.asarray(I)]
    ts_all = [np.zeros(3, np.float32)]
    for i in range(1, 7):
        frame = frame_at(i)
        st, out = vo_step(st, frame, Kj, cfg, vo)
        assert int(out.n_matches) > 20
        assert float(out.rms_px) < 3.0
        Rs_all.append(np.asarray(out.R))
        ts_all.append(np.asarray(out.t))
        ok = np.asarray(st.Xvalid[-1]) > 0
        zc = (np.asarray(st.X[-1]) @ np.asarray(st.Rs[-1]).T
              + np.asarray(st.ts[-1]))[:, 2]
        uniq_depths.append(len(np.unique(zc[ok].round(4))))
    # triangulation fired: spawned depths are spread, not one flat value
    assert max(uniq_depths[1:]) > 5
    # Trajectory quality (recalibrated round 4): the absolute metric scale
    # of this scenario is set by the init_depth=5.0 prior against whatever
    # blob depths SIFT happens to land on — measured across cloud seeds it
    # swings 0.5x-1.6x in BOTH the pre- and post-rotation-fix code, so the
    # old absolute |t_x + 0.9| < 0.3 bound was luck, not a guarantee.  The
    # real guarantees are trajectory SHAPE (sim(3)-aligned ATE; measured
    # 0.07-0.14 over the 0.9-unit path for cloud seeds 3/4/5) and a sane
    # prior-limited scale band.
    from sift_pyocl_jax.sfm.evaluate import ate_rmse, camera_centers
    est = camera_centers(np.stack(Rs_all), np.stack(ts_all))
    gt = np.stack([[0.15 * i, 0.0, 0.0] for i in range(7)]).astype(np.float32)
    ate = ate_rmse(est, gt, with_scale=True)
    assert ate < 0.25, f"aligned ATE {ate:.3f} over a 0.9-unit path"
    x_scale = abs(est[-1, 0] - est[0, 0]) / 0.9
    assert 0.35 < x_scale < 1.9, f"x-scale {x_scale:.2f} outside prior band"
    # prev-frame keypoint threading matches a fresh detect on the last frame
    buf = detect_and_describe(frame, cfg)
    np.testing.assert_array_equal(np.asarray(st.prev_valid), np.asarray(buf.valid))
    np.testing.assert_array_equal(np.asarray(st.prev_desc), np.asarray(buf.desc))


def test_vo_survives_blank_frame():
    """tracking-loss detection + keyframe retention — a blank
    frame must not corrupt the pose or flush the window map, and tracking
    must re-converge on the next good frame."""
    cfg = SiftConfig(kp_per_octave_cap=256)
    vo = VOConfig(window=4, pts_per_frame=64, obs_per_frame=128,
                  pnp_n=128, pnp_iters=6, cg_iters=5)
    H, W = 160, 160
    base = synthetic_scene((H + 48, W + 48), n_blobs=40, seed=0)

    def frame_at(dx):
        return jnp.asarray(base[24 : 24 + H, 24 + dx : 24 + dx + W])

    K = jnp.asarray(
        [[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]], jnp.float32
    )
    st = vo_init(frame_at(0), K, cfg, vo)
    st, out1 = vo_step(st, frame_at(2), K, cfg, vo)
    assert bool(out1.tracked)
    map_valid_before = np.asarray(st.Xvalid).copy()
    t_before = np.asarray(out1.t)

    # blank frame: no keypoints -> tracking loss
    st, out_blank = vo_step(st, jnp.zeros((H, W), jnp.float32), K, cfg, vo)
    assert not bool(out_blank.tracked)
    np.testing.assert_allclose(np.asarray(out_blank.t), t_before, atol=1e-6)
    # keyframe retention: the window map was NOT rolled/flushed
    np.testing.assert_array_equal(np.asarray(st.Xvalid), map_valid_before)

    # next good frame: re-localizes against the retained map
    st, out2 = vo_step(st, frame_at(4), K, cfg, vo)
    assert bool(out2.tracked)
    assert int(out2.n_matches) > 10
    assert float(out2.rms_px) < 3.0
    assert int(st.frame) == 4

"""Fused visual-odometry step: SIFT + matching + PnP + windowed BA, one jit.

This is the framework's flagship end-to-end model (BASELINE.json's north
star: end-to-end SIFT+matching+BA per 1080p frame).  The reference has no
VO/SfM loop (SURVEY.md §2.3 — `LinearAlign` is its closest analog,
reference: sift-src/alignment.py).  Design:

  * ONE compiled program per frame — detection, descriptor matching, robust
    pose estimation and a windowed bundle-adjustment iteration all run on
    device with static shapes; no host round-trips inside the loop.
  * All sliding-window state is laid out in per-frame BLOCKS that roll along
    the window axis (concatenate + static writes), never scattered: map
    points, their descriptors and observations each live in (W, ...) arrays
    whose slot index doubles as the BA camera id.  When the window rolls,
    stored point ids just shift by -PN (vectorized arithmetic), and ids that
    fall off the window get weight 0.
  * Selection (which matches feed PnP/BA, which keypoints spawn map points)
    uses top_k over dense masks — the scatter-free idiom of this codebase.

Per step:
  1. detect_and_describe(frame)                     [XLA SIFT frontend]
  2. ratio-test match vs the window map descriptors [fused best-2 matcher]
  3. robust pose-only refinement from 2D-3D matches [Huber IRLS Gauss-Newton]
  4. roll window; new obs block; spawn PN new map points by back-projection
     at the matched median depth (refined by BA in subsequent frames)
  5. one damped Schur/CG BA iteration over the window [sfm.ba.lm_iteration]
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import SiftConfig
from ..ops.match import match_descriptors_dense
from ..sfm.ba import BAObs, BAParams, lm_iteration
from ..sfm.geometry import triangulate_two_view
from ..sfm.pnp import pnp_refine
from .sift import KeypointBuffer, detect_and_describe


class VOConfig(NamedTuple):
    window: int = 8          # sliding window size W (cameras in BA)
    pts_per_frame: int = 256  # PN: new map points spawned per frame
    obs_per_frame: int = 512  # OBS_F: observations kept per frame
    pnp_n: int = 512          # matches fed to pose refinement
    pnp_iters: int = 8
    cg_iters: int = 8
    huber_px: float = 3.0
    ratio_sq: float = 0.7     # looser than Lowe 0.5329: VO re-sees its map
    match_metric: str = "L2"
    # --- robustness (tracking-loss handling) ---
    min_track_matches: int = 12   # below this the frame counts as LOST
    reloc_ratio_sq: float = 0.85  # looser re-localization gate when lost
    max_rms_px: float = 12.0      # PnP residual gate on pose acceptance
    ba_pt_onehot: bool = True     # point reductions in BA as one-hot matmuls
                                  # instead of serialized scatters
    ba_solver: str = "dense"      # "dense" = exact (6W,6W) Schur solve (the
                                  # window is tiny; beats CG in cost AND step
                                  # quality) | "cg" = matrix-free CG
    ba_iters: int = 1             # LM iterations per frame (dense solves are
                                  # cheap enough that 2 is affordable when
                                  # drift matters more than throughput)
    min_parallax_px: float = 6.0  # rotation-compensated parallax below which
                                  # two-view spawn triangulation is noise-
                                  # dominated (depth biased low -> long-run
                                  # scale collapse); such spawns fall back to
                                  # median-depth backprojection
    kf_promote_px: float = 12.0   # promote the current frame to spawn
                                  # keyframe once the expected disparity
                                  # f*|baseline|/med_depth exceeds this
    kf_max_age: int = 40          # ... or the keyframe is this many frames
                                  # old (keeps descriptor overlap fresh)
    depth_refresh: bool = True    # deferred two-view triangulation: refresh
                                  # a spawned point's depth from its stored
                                  # spawn ray once a re-observation carries
                                  # enough baseline (see vo_step 4d)
    metric_weight: float = 3.0    # PnP/BA weight of metrically triangulated
                                  # points relative to flat-depth placeholders
                                  # (the flat shell should not drag the pose
                                  # as hard as real geometry)


class VOState(NamedTuple):
    Rs: jnp.ndarray       # (W,3,3) world->cam per window slot (slot = cam id)
    ts: jnp.ndarray       # (W,3)
    X: jnp.ndarray        # (W,PN,3) map points, blocked by source frame
    Xvalid: jnp.ndarray   # (W,PN) f32 0/1
    Xdesc: jnp.ndarray    # (W,PN,128) uint8
    obs_uv: jnp.ndarray   # (W,OBS_F,2)
    obs_pt: jnp.ndarray   # (W,OBS_F) int32 flat map id (slot*PN+local), -1 pad
    obs_w: jnp.ndarray    # (W,OBS_F) f32
    prev_desc: jnp.ndarray   # (N,128) uint8 previous frame's keypoint buffer
    prev_uv: jnp.ndarray     # (N,2) f32
    prev_valid: jnp.ndarray  # (N,) bool
    # spawn keyframe: new map points triangulate against this frame, NOT the
    # previous one — consecutive-frame baselines give ~1-2 px true disparity
    # (noise-dominated, depth biased low), while a promoted keyframe holds
    # 10-15 px of real parallax (relative depth bias ~(sigma/d)^2 < 1%).
    key_desc: jnp.ndarray    # (N,128) uint8
    key_uv: jnp.ndarray      # (N,2) f32
    key_valid: jnp.ndarray   # (N,) bool
    key_R: jnp.ndarray       # (3,3) keyframe pose (map scale at promotion)
    key_t: jnp.ndarray       # (3,)
    key_frame: jnp.ndarray   # () int32 frame id at promotion
    tri_par: jnp.ndarray     # (W,PN) f32 sin^2 of the ray angle at the last
                             # metric triangulation (0 = still flat-depth);
                             # deferred refreshes re-fire when the pose-
                             # predicted parallax grows 1.5x past this
    lam: jnp.ndarray      # () f32 LM damping carried across frames
    frame: jnp.ndarray    # () int32


class VOOut(NamedTuple):
    R: jnp.ndarray        # (3,3) latest pose
    t: jnp.ndarray        # (3,)
    n_kp: jnp.ndarray     # () int32
    n_matches: jnp.ndarray
    rms_px: jnp.ndarray   # () f32 PnP inlier RMS
    ba_cost: jnp.ndarray  # () f32 robust BA cost after the iteration
    tracked: jnp.ndarray  # () bool False = frame rejected (tracking loss);
                          # pose held, window retained for re-localization
    n_spawn_tri: jnp.ndarray  # () int32 spawns that passed the keyframe
                              # parallax gate (rest backproject at med depth)


def _kp_xy(buf: KeypointBuffer) -> jnp.ndarray:
    return jnp.stack([buf.x, buf.y], axis=-1)


def _backproject(K, R, t, uv, depth):
    """World point for pixel uv at camera depth `depth`."""
    d = jnp.stack(
        [(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1],
         jnp.ones_like(uv[..., 0])], axis=-1,
    )
    Xc = d * depth[..., None]
    return (Xc - t) @ R  # R^T (Xc - t)


logger = logging.getLogger(__name__)


def vo_init(frame0: jnp.ndarray, K: jnp.ndarray, cfg: SiftConfig,
            vo: VOConfig, init_depth: float = 5.0) -> VOState:
    """Bootstrap: frame 0 at identity; its strongest keypoints seed the map
    at a nominal depth (BA shapes the cloud as the window fills)."""
    logger.info("vo_init: frame %s, window %d, %d pts/frame, metric %s", frame0.shape, vo.window, vo.pts_per_frame, vo.match_metric)
    W, PN, OBS_F = vo.window, vo.pts_per_frame, vo.obs_per_frame
    assert OBS_F >= PN, "obs_per_frame must cover the spawned points"
    buf = detect_and_describe(frame0, cfg)
    score = jnp.where(buf.valid, buf.scale, -jnp.inf)
    _, sel = lax.top_k(score, PN)
    ok = buf.valid[sel].astype(jnp.float32)
    uv = _kp_xy(buf)[sel]
    R0 = jnp.eye(3, dtype=jnp.float32)
    t0 = jnp.zeros(3, dtype=jnp.float32)
    X0 = _backproject(K, R0, t0, uv, jnp.full((PN,), init_depth))
    st = VOState(
        Rs=jnp.broadcast_to(R0, (W, 3, 3)).copy(),
        ts=jnp.zeros((W, 3), jnp.float32),
        X=jnp.zeros((W, PN, 3), jnp.float32).at[W - 1].set(X0),
        Xvalid=jnp.zeros((W, PN), jnp.float32).at[W - 1].set(ok),
        Xdesc=jnp.zeros((W, PN, 128), jnp.uint8).at[W - 1].set(buf.desc[sel]),
        # seed self-observations live in the TAIL block [OBS_F-PN:] — the
        # same slots vo_step 4c writes spawn self-obs into and 4d's deferred
        # depth refresh reads spawn pixels back from (ADVICE r4: writing them
        # at the head left the refresh reading zeros for the seed block,
        # "refreshing" seeds against a (0,0) corner ray during bootstrap)
        obs_uv=jnp.zeros((W, OBS_F, 2), jnp.float32)
        .at[W - 1, OBS_F - PN:].set(uv),
        obs_pt=jnp.full((W, OBS_F), -1, jnp.int32)
        .at[W - 1, OBS_F - PN:]
        .set((W - 1) * PN + jnp.arange(PN, dtype=jnp.int32)),
        obs_w=jnp.zeros((W, OBS_F), jnp.float32)
        .at[W - 1, OBS_F - PN:].set(ok),
        prev_desc=buf.desc,
        prev_uv=_kp_xy(buf),
        prev_valid=buf.valid,
        key_desc=buf.desc,
        key_uv=_kp_xy(buf),
        key_valid=buf.valid,
        key_R=R0,
        key_t=t0,
        key_frame=jnp.int32(0),
        tri_par=jnp.zeros((W, PN), jnp.float32),  # seeds are flat-depth:
        # eligible for deferred refresh as soon as baseline accumulates
        lam=jnp.float32(1e-3),
        frame=jnp.int32(1),
    )
    return st


@partial(jax.jit, static_argnames=("cfg", "vo"))
def vo_step(state: VOState, frame: jnp.ndarray, K: jnp.ndarray,
            cfg: SiftConfig, vo: VOConfig) -> Tuple[VOState, VOOut]:
    """One fused VO frame: detect -> match -> PnP -> roll -> BA iteration."""
    W, PN, OBS_F = vo.window, vo.pts_per_frame, vo.obs_per_frame
    P = W * PN

    # 1. SIFT frontend
    buf = detect_and_describe(frame, cfg)
    kp_uv = _kp_xy(buf)
    n_kp = jnp.sum(buf.valid.astype(jnp.int32))

    # 2. match new descriptors against the window map
    map_desc = state.Xdesc.reshape(P, 128)
    map_valid = state.Xvalid.reshape(P) > 0
    keep, map_id, dist, dist2 = match_descriptors_dense(
        buf.desc, buf.valid, map_desc, map_valid,
        metric=vo.match_metric, ratio_sq=vo.ratio_sq,
    )
    n_matches = jnp.sum(keep.astype(jnp.int32))

    # 2b. tracking-loss handling: when the strict ratio-test match count
    # collapses, re-gate the SAME distances with the looser re-localization
    # ratio (free — d2 is already computed) and feed that to PnP instead
    finite = dist2 < jnp.float32(np.float32(2**31 - 1))
    keep_loose = buf.valid & finite & (dist2 > 0) & (
        dist < vo.reloc_ratio_sq * dist2
    )
    strict_ok = n_matches >= vo.min_track_matches
    use_loose = (~strict_ok) & (
        jnp.sum(keep_loose.astype(jnp.int32)) >= vo.min_track_matches
    )
    keep_pnp = jnp.where(use_loose, keep_loose, keep)

    # 3. robust pose refinement on the best pnp_n matches (approx_max_k:
    # any `pnp_n` good matches serve equally well, so exact top_k over the
    # ~6K slots is not needed)
    score = jnp.where(keep_pnp, -dist, -jnp.inf)
    _, sel = lax.approx_max_k(score, vo.pnp_n)
    w_sel = keep_pnp[sel].astype(jnp.float32)
    # metric-confidence weighting: points with a real triangulation behind
    # them count metric_weight x as much as flat-depth placeholders
    met_sel = (state.tri_par.reshape(P)[map_id[sel]] > 0).astype(jnp.float32)
    w_sel = w_sel * (1.0 + (vo.metric_weight - 1.0) * met_sel)
    uv_sel = kp_uv[sel]
    X_sel = state.X.reshape(P, 3)[map_id[sel]]
    R_prev = state.Rs[W - 1]
    t_prev = state.ts[W - 1]
    R_fit, t_fit, rms = pnp_refine(
        K, R_prev, t_prev, X_sel, uv_sel, w_sel,
        iters=vo.pnp_iters, huber_px=vo.huber_px,
    )
    # pose acceptance gate: enough matches fed in AND sane residual;
    # otherwise hold the previous pose (constant-position fallback) and mark
    # the frame untracked — the window is NOT rolled below, so the map
    # survives blank/occluded frames for re-localization
    tracked = (jnp.sum((w_sel > 0).astype(jnp.float32))
               >= vo.min_track_matches) & (rms < vo.max_rms_px)
    R_new = jnp.where(tracked, R_fit, R_prev)
    t_new = jnp.where(tracked, t_fit, t_prev)

    # 4a. roll the window; stored ids shift one frame down
    Rs = jnp.concatenate([state.Rs[1:], R_new[None]], axis=0)
    ts = jnp.concatenate([state.ts[1:], t_new[None]], axis=0)
    obs_pt_shift = state.obs_pt - PN          # ids < 0 fell off the window
    obs_w_old = state.obs_w * (obs_pt_shift >= 0)
    obs_pt_old = jnp.maximum(obs_pt_shift, 0)

    # 4b. new observation block: best OBS_F matched keypoints of this frame
    # (keep_pnp, not strict keep: on a loose re-localization frame the
    # accepted matches must feed BA too, else the frame contributes ~zero
    # observations exactly when tracking is most fragile)
    _, osel = lax.approx_max_k(score, OBS_F)
    ow = keep_pnp[osel].astype(jnp.float32)
    met_o = (state.tri_par.reshape(P)[map_id[osel]] > 0).astype(jnp.float32)
    ow = ow * (1.0 + (vo.metric_weight - 1.0) * met_o)
    ouv = kp_uv[osel]
    opt = jnp.maximum(map_id[osel] - PN, 0)
    ow = ow * (map_id[osel] - PN >= 0)
    obs_uv = jnp.concatenate([state.obs_uv[1:], ouv[None]], axis=0)
    obs_pt = jnp.concatenate([obs_pt_old[1:], opt[None]], axis=0)
    obs_w = jnp.concatenate([obs_w_old[1:], ow[None]], axis=0)

    # 4c. spawn the new PN-point block: carry-over of still-tracked points
    #     from the dying block, keyframe-triangulated new landmarks when the
    #     parallax gate passes, median-depth backprojections otherwise
    #     (deferred refresh in 4d upgrades those once baseline accumulates)
    Xc_sel = X_sel @ R_new.T + t_new
    depths = jnp.where(w_sel > 0, Xc_sel[:, 2], jnp.nan)
    med_depth = jnp.nan_to_num(jnp.nanmedian(depths), nan=5.0)
    med_depth = jnp.clip(med_depth, 0.5, 100.0)
    # spawn candidates, two kinds (r4):
    #   * CARRY-OVER: current keypoints matched to the DYING block
    #     (map_id < PN).  Without this, map-point lifetime is hard-coupled
    #     to the BA window — metric structure rolls off every W frames and
    #     whole low-parallax stretches leave the map a flat shell (measured:
    #     metric fraction oscillating 0.5 -> 0.02 and the trajectory scale
    #     collapsing in the troughs).  A carried point re-spawns into the
    #     new block with its BA-refined position and metric status, so
    #     tracked points live indefinitely.  Its current-frame observation
    #     was dropped in 4b anyway (the dying id is invalid after the roll),
    #     so no observation is double-counted.
    #   * NEW: keypoints unmatched under keep_pnp (loose-gate matches on a
    #     re-localization frame are map RE-observations, not new landmarks).
    carried_raw = keep_pnp & (map_id < PN)
    # dedup carries per dying map id (ADVICE r4): matching is per-query, so
    # several keypoints can claim the same dying point and each would carry
    # it (+1e4 boost), duplicating the landmark and displacing fresh spawns.
    # Keep only the best-distance claimant: argmin over the masked (N, PN)
    # distance matrix picks one winner per dying id, scatter-free.
    colmat = jnp.where(
        carried_raw[:, None]
        & (map_id[:, None] == jnp.arange(PN, dtype=jnp.int32)[None, :]),
        dist[:, None], jnp.inf,
    )
    winner = jnp.argmin(colmat, axis=0).astype(jnp.int32)     # (PN,)
    carried = carried_raw & (
        winner[jnp.minimum(map_id, PN - 1)]
        == jnp.arange(map_id.shape[0], dtype=jnp.int32)
    )
    spawn_ok = (buf.valid & ~keep_pnp) | carried
    new_score = jnp.where(
        spawn_ok, buf.scale + jnp.where(carried, 1e4, 0.0), -jnp.inf
    )
    _, nsel = lax.approx_max_k(new_score, PN)
    nok = spawn_ok[nsel].astype(jnp.float32)
    car = carried[nsel]
    nuv = kp_uv[nsel]
    Xbp = _backproject(K, R_new, t_new, nuv, jnp.full((PN,), med_depth))
    # Triangulate against the spawn KEYFRAME, not the previous frame (r4,
    # from the long-run scale collapse): consecutive-frame baselines give
    # ~1-2 px true disparity — comparable to keypoint noise — and noise-
    # dominated disparity is inflated in magnitude, so depth = f*B/disparity
    # comes out systematically LOW; spawning those points drained the map's
    # median depth ~3%/frame (measured) into exponential scale collapse.
    # A promoted keyframe holds >= kf_promote_px of real parallax, cutting
    # the relative depth bias to ~(noise/disparity)^2 < 1% per spawn.
    pk, pidx, _pd, _pd2 = match_descriptors_dense(
        buf.desc[nsel], nok > 0, state.key_desc, state.key_valid,
        metric=vo.match_metric, ratio_sq=vo.ratio_sq,
    )
    uv_key = state.key_uv[pidx]
    Xtri, z_key, z_new = triangulate_two_view(
        K, state.key_R, state.key_t, K, R_new, t_new, uv_key, nuv
    )
    # rotation-compensated parallax: what the keyframe pixel would be under
    # pure rotation; the residual displacement is real baseline signal
    ray = jnp.stack(
        [(uv_key[:, 0] - K[0, 2]) / K[0, 0],
         (uv_key[:, 1] - K[1, 2]) / K[1, 1],
         jnp.ones_like(uv_key[:, 0])], axis=-1,
    )
    ray_new = ray @ (R_new @ state.key_R.T).T      # rotate rays, no baseline
    uv_rot = jnp.stack(
        [K[0, 0] * ray_new[:, 0] / ray_new[:, 2] + K[0, 2],
         K[1, 1] * ray_new[:, 1] / ray_new[:, 2] + K[1, 2]], axis=-1,
    )
    parallax = jnp.linalg.norm(nuv - uv_rot, axis=-1)
    tri_ok = (
        pk & ~car
        & (parallax > vo.min_parallax_px)
        & (z_key > 0.2 * med_depth) & (z_new > 0.2 * med_depth)
        & (z_key < 10.0 * med_depth) & (z_new < 10.0 * med_depth)
    )
    X_car = state.X.reshape(P, 3)[map_id[nsel]]
    par_car = state.tri_par.reshape(P)[map_id[nsel]]
    Xnew = jnp.where(car[:, None], X_car,
                     jnp.where(tri_ok[:, None], Xtri, Xbp))
    X = jnp.concatenate([state.X[1:], Xnew[None]], axis=0)
    Xvalid = jnp.concatenate([state.Xvalid[1:], nok[None]], axis=0)
    Xdesc = jnp.concatenate([state.Xdesc[1:], buf.desc[nsel][None]], axis=0)
    # the spawning frame observes its new points too
    self_uv = nuv
    self_pt = (W - 1) * PN + jnp.arange(PN, dtype=jnp.int32)
    # append into the tail of the new obs block (OBS_F >= PN slots assumed
    # to leave room: overwrite the weakest half if needed)
    obs_uv = obs_uv.at[W - 1, OBS_F - PN :].set(self_uv)
    obs_pt = obs_pt.at[W - 1, OBS_F - PN :].set(self_pt)
    spawn_metric = tri_ok | (car & (par_car > 0))
    obs_w = obs_w.at[W - 1, OBS_F - PN :].set(
        nok * (1.0 + (vo.metric_weight - 1.0)
               * spawn_metric.astype(jnp.float32))
    )

    # 4d. deferred two-view triangulation ("depth refresh", r4): most spawns
    # start at the flat median matched depth — the spawn-time keyframe
    # triangulation only fires for ~2% of spawns (measured: map-unmatched
    # keypoints are anti-selected for keyframe matchability), so without a
    # second chance the map is a near-flat shell and the trajectory scale
    # wobbles +-35% over 200 frames.  But each spawned point's spawn pixel
    # is already stored in the spawning frame's self-observation block, and
    # its spawn camera IS that window slot — so every later re-observation
    # carries an exact correspondence to the spawn ray for free: once real
    # baseline accumulates, re-triangulate the point from spawn ray x
    # current ray (one-hot matmul update, scatter-free).
    #
    # Two bias traps, both measured before this form landed:
    #   * gating on MEASURED parallax first-crossing selects exactly the
    #     observations whose pixel noise inflated the disparity -> refreshed
    #     depths systematically shallow -> scale down-drifts -0.7%/frame.
    #     The gate below is therefore POSE-PREDICTED parallax (baseline_perp
    #     over the point's current depth estimate) — independent of the
    #     measured pixels, so no selection bias enters the geometry.
    #   * one-shot refresh freezes the first (smallest-parallax, noisiest)
    #     fix; instead re-refresh whenever predicted parallax grows 1.5x
    #     past the last one (tri_par), so the final, least-noisy geometry
    #     wins without per-frame churn against BA.
    tri_par_new = jnp.where(
        car, par_car,
        tri_ok.astype(jnp.float32) * (parallax / K[0, 0]) ** 2,
    )
    tri_par = jnp.concatenate(
        [state.tri_par[1:], tri_par_new[None]], axis=0
    )
    if vo.depth_refresh:
        w_src = opt // PN
        j_loc = opt % PN
        sp_idx = w_src * OBS_F + (OBS_F - PN) + j_loc
        sp_uv = obs_uv.reshape(W * OBS_F, 2)[sp_idx]
        # a zero spawn-slot weight means no spawn pixel was ever recorded
        # for this row (e.g. an untracked-frame hold); never refresh those
        sp_w = obs_w.reshape(W * OBS_F)[sp_idx]
        R_src = Rs[w_src]                          # (OBS_F,3,3)
        t_src = ts[w_src]
        c_src = -jnp.einsum("nji,nj->ni", R_src, t_src)
        ray_s = jnp.stack(
            [(sp_uv[:, 0] - K[0, 2]) / K[0, 0],
             (sp_uv[:, 1] - K[1, 2]) / K[1, 1],
             jnp.ones_like(sp_uv[:, 0])], axis=-1,
        )
        d_src = jnp.einsum("nji,nj->ni", R_src, ray_s)
        d_src = d_src / jnp.linalg.norm(d_src, axis=-1, keepdims=True)
        c_cur = -R_new.T @ t_new
        ray_c = jnp.stack(
            [(ouv[:, 0] - K[0, 2]) / K[0, 0],
             (ouv[:, 1] - K[1, 2]) / K[1, 1],
             jnp.ones_like(ouv[:, 0])], axis=-1,
        )
        d_cur = ray_c @ R_new                      # R^T ray, rows
        d_cur = d_cur / jnp.linalg.norm(d_cur, axis=-1, keepdims=True)
        b = c_cur[None, :] - c_src
        m = jnp.sum(d_src * d_cur, axis=-1)
        denom = jnp.maximum(1.0 - m * m, 1e-12)    # sin^2(measured angle)
        bd1 = jnp.sum(b * d_src, axis=-1)
        bd2 = jnp.sum(b * d_cur, axis=-1)
        s_len = (bd1 - m * bd2) / denom
        t_len = s_len * m - bd2
        X_mid = 0.5 * (c_src + s_len[:, None] * d_src
                       + c_cur[None, :] + t_len[:, None] * d_cur)
        z_cur = (X_mid @ R_new.T + t_new)[:, 2]
        # pose-predicted parallax: |baseline perp to the viewing ray| over
        # the point's CURRENT depth estimate (pre-refresh) — noise-free
        Xflat = X.reshape(P, 3)
        z_est = (Xflat[opt] @ R_new.T + t_new)[:, 2]
        bperp2 = jnp.maximum(
            jnp.sum(b * b, axis=-1) - bd2 * bd2, 0.0
        )
        exp_sin2 = bperp2 / jnp.maximum(z_est * z_est, 1e-12)
        min_sin2 = (vo.min_parallax_px / K[0, 0]) ** 2
        last_par = tri_par.reshape(P)[opt]
        # anti-spiral escape: the predicted gate uses ESTIMATED baselines, so
        # if the trajectory scale ever collapses the system believes it has
        # no parallax and stops refreshing — which is exactly what deepens
        # the collapse.  Measured parallax well past the noise band (4x the
        # gate in sin^2, i.e. 2x in px) re-opens the gate: first-crossing
        # selection bias only matters in the marginal band.
        gate = (exp_sin2 > min_sin2) | (denom > 4.0 * min_sin2)
        upd = (
            (ow > 0) & (sp_w > 0)
            & gate & (jnp.maximum(exp_sin2, denom) > 2.25 * last_par)
            & (denom > 0.25 * min_sin2)            # degenerate-ray guard
            & (s_len > 0) & (t_len > 0)
            & (z_cur > 0.2 * med_depth) & (z_cur < 10.0 * med_depth)
        )
        U = ((opt[:, None] == jnp.arange(P, dtype=jnp.int32)[None, :])
             & upd[:, None]).astype(jnp.float32)   # (OBS_F, P) one-hot
        num = U.T @ X_mid                          # (P,3)
        den = jnp.sum(U, axis=0)                   # (P,)
        Xflat = jnp.where(den[:, None] > 0,
                          num / jnp.maximum(den, 1.0)[:, None], Xflat)
        X = Xflat.reshape(W, PN, 3)
        # store the parallax actually ACHIEVED at refresh (ADVICE r4): when
        # the measured-angle escape branch fires, exp_sin2 can sit far below
        # the achieved angle and the 2.25x growth gate would re-pass every
        # frame — exactly the churn the design avoids
        par_num = U.T @ jnp.maximum(exp_sin2, denom)   # (P,)
        tp = tri_par.reshape(P)
        tri_par = jnp.where(den > 0, par_num / jnp.maximum(den, 1.0),
                            tp).reshape(W, PN)

    # 5. one windowed BA iteration (oldest camera gauge-fixed)
    params = BAParams(Rs, ts, X.reshape(P, 3))
    cam_ids = jnp.repeat(
        jnp.arange(W, dtype=jnp.int32)[:, None], OBS_F, axis=1
    ).reshape(-1)
    obs = BAObs(
        uv=obs_uv.reshape(-1, 2),
        cam=cam_ids,
        pt=obs_pt.reshape(-1),
        w=obs_w.reshape(-1) * Xvalid.reshape(P)[obs_pt.reshape(-1)],
    )
    # Gauge: anchor the TWO oldest cameras (fixed-lag smoothing with anchor
    # frames).  Fixing one camera pins translation+rotation but NOT scale —
    # scaling the scene about the fixed camera's center leaves every
    # reprojection invariant, so with `> 0` the window BA has an
    # unconstrained scale direction that random-walks over long runs (caught
    # by tests/test_vo_longrun.py: est/gt displacement ratio collapsed
    # 0.99 -> 0.05 by frame 75).  The cam0->cam1 baseline pins the scale.
    free = jnp.arange(W) > 1
    # the window layout stores obs in per-frame blocks -> cam_blocked always
    # holds here; both flags turn serialized scatter-adds into
    # reshape-sums / matmuls
    dense = vo.ba_solver == "dense"
    params2, lam2 = params, state.lam
    for _ in range(vo.ba_iters):
        params2, lam2, cost, _ = lm_iteration(
            params2, obs, K, lam2, free,
            huber_px=vo.huber_px, cg_iters=vo.cg_iters, n_points=P,
            cam_blocked=True, pt_onehot=vo.ba_pt_onehot or dense,
            dense_schur=dense,
        )

    # keyframe promotion: once the expected disparity of the CURRENT frame
    # vs the keyframe (f * |baseline| / median scene depth, plus any aging
    # cap) clears kf_promote_px, this frame becomes the new spawn keyframe —
    # spawns computed above still used the old one, so a promotion frame
    # keeps its full parallax
    c_new = -R_new.T @ t_new
    c_key = -state.key_R.T @ state.key_t
    base_px = K[0, 0] * jnp.linalg.norm(c_new - c_key) / med_depth
    promote = (base_px > vo.kf_promote_px) | (
        state.frame - state.key_frame >= vo.kf_max_age
    )
    rolled = VOState(
        Rs=params2.Rs,
        ts=params2.ts,
        X=params2.X.reshape(W, PN, 3),
        Xvalid=Xvalid,
        Xdesc=Xdesc,
        obs_uv=obs_uv,
        obs_pt=obs_pt,
        obs_w=obs_w,
        prev_desc=buf.desc,
        prev_uv=kp_uv,
        prev_valid=buf.valid,
        key_desc=jnp.where(promote, buf.desc, state.key_desc),
        key_uv=jnp.where(promote, kp_uv, state.key_uv),
        key_valid=jnp.where(promote, buf.valid, state.key_valid),
        key_R=jnp.where(promote, params2.Rs[W - 1], state.key_R),
        key_t=jnp.where(promote, params2.ts[W - 1], state.key_t),
        key_frame=jnp.where(promote, state.frame, state.key_frame),
        tri_par=tri_par,
        lam=lam2,
        frame=state.frame + 1,
    )
    # keyframe retention on tracking loss: hold the whole window (map,
    # observations, poses) so blank/occluded frames cannot flush good state;
    # only the previous-frame buffers and the counter advance
    hold = state._replace(
        prev_desc=buf.desc,
        prev_uv=kp_uv,
        prev_valid=buf.valid,
        frame=state.frame + 1,
    )
    new_state = jax.tree_util.tree_map(
        lambda a, b: jnp.where(
            jnp.reshape(tracked, (1,) * a.ndim) if a.ndim else tracked, a, b
        ),
        rolled, hold,
    )
    out = VOOut(
        R=new_state.Rs[W - 1], t=new_state.ts[W - 1],
        n_kp=n_kp, n_matches=n_matches, rms_px=rms, ba_cost=cost,
        tracked=tracked,
        n_spawn_tri=jnp.sum((tri_ok & (nok > 0)).astype(jnp.int32)),
    )
    return new_state, out

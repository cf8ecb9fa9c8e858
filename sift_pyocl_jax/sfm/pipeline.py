"""Incremental SfM over an image sequence (BASELINE.json config 4:
two-view init + sequential registration + pose graph + bundle adjustment).

Two registration architectures share the host-side map bookkeeping:

  * FUSED (default, round 5): one jitted program per frame does the entire
    registration — detect_and_describe -> map matching -> RANSAC-PnP ->
    new-point triangulation + reprojection gating — and returns packed
    results in three arrays, so a frame costs ~1 dispatch + 3 fetches
    instead of ~100 dispatches — the architecture of
    `models/vo.py::vo_step`.
  * HOST (legacy, kept for A/B): host-orchestrated over individually jitted
    kernels, padding device inputs per call.

In both, the host keeps the growing map (points, descriptors, observation
table) in NumPy and pads device inputs to power-of-two buckets so jit
recompiles O(log) times as the map grows.

New subsystem — no reference counterpart (SURVEY.md §2.3; the reference's
mid-pipeline host-return in sift-src/alignment.py::LinearAlign.align is the
anti-pattern the fused path eliminates).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import SiftConfig
from ..models.sift import SiftPlan, detect_and_describe
from ..ops.match import match_descriptors_dense, match_descriptors_jax
from .geometry import pose_compose, project, triangulate_two_view
from .pnp import ransac_pnp
from .twoview import initialize_two_view

logger = logging.getLogger(__name__)


def _say(verbose: bool, msg: str, *args):
    """Runtime observability (reference parity: per-module logging)."""
    logger.info(msg, *args)
    if verbose:
        print(msg % args if args else msg)


def _pow2_pad(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


@partial(jax.jit, static_argnames=("cfg", "new_cap", "ratio_sq",
                                   "reproj_px", "metric"))
def register_frame_fused(
    frame: jnp.ndarray,        # (H, W) f32
    key: jax.Array,
    map_desc: jnp.ndarray,     # (P, 128) u8 — padded map bucket
    map_valid: jnp.ndarray,    # (P,) bool   (host-side match window applied)
    map_X: jnp.ndarray,        # (P, 3) f32
    prev_desc: jnp.ndarray,    # (N, 128) u8 — previous REGISTERED frame's buf
    prev_uv: jnp.ndarray,      # (N, 2) f32
    prev_valid: jnp.ndarray,   # (N,) bool
    R_prev_cam: jnp.ndarray,   # (3,3) that frame's current camera pose
    t_prev_cam: jnp.ndarray,   # (3,)
    R0: jnp.ndarray,           # (3,3) PnP init (last registered pose)
    t0: jnp.ndarray,           # (3,)
    K: jnp.ndarray,
    cfg: SiftConfig,
    new_cap: int = 256,
    ratio_sq: float = 0.7,
    reproj_px: float = 3.0,
    metric: str = "L2",
):
    """One fused SfM registration: detect -> map match -> RANSAC-PnP ->
    triangulate new landmarks, all on device.

    Output packing keeps the host round-trips to ONE fetch: a
    (1 + P + new_cap, 136) f32 array — row 0 is the
    header [R(9), t(3), n_inl, n_match]; rows 1..P are map rows
    [keep, inl, u, v, pad(4) | matched-kp desc(128), for host-side
    descriptor refresh of inliers]; the rest are new-point rows
    [ok, X(3), uv_prev(2), uv_cur(2) | desc(128)].  Also returns
    desc/uv/valid of this frame's detection, left ON DEVICE for the next
    frame's triangulation and end-of-run loop closure.
    """
    P = map_desc.shape[0]
    buf = detect_and_describe(frame, cfg)
    kp_uv = jnp.stack([buf.x, buf.y], axis=-1)
    N = buf.desc.shape[0]

    # 1. map -> keypoint matching (map points are the queries — the same
    # direction the host pipeline used, so ratio-test semantics carry over)
    keep, mid, _d, _d2 = match_descriptors_dense(
        map_desc, map_valid, buf.desc, buf.valid,
        metric=metric, ratio_sq=ratio_sq,
    )
    n_match = jnp.sum(keep.astype(jnp.int32))

    # 2. robust pose from the 2D-3D matches
    uv_m = kp_uv[mid]
    R, t, inl, n_inl = ransac_pnp(
        key, K, R0, t0, map_X, uv_m, keep.astype(jnp.float32),
        thresh_px=reproj_px,
    )

    # 3. new-landmark candidates: previous registered frame's keypoints
    # matched to CURRENT keypoints that no map match claimed
    pk, pidx, _pd, _pd2 = match_descriptors_dense(
        prev_desc, prev_valid, buf.desc, buf.valid,
        metric=metric, ratio_sq=ratio_sq,
    )
    used_kp = jnp.zeros((N,), jnp.bool_).at[mid].max(keep)
    cur_uv = kp_uv[pidx]
    Xn, z1, z2 = triangulate_two_view(
        K, R_prev_cam, t_prev_cam, K, R, t, prev_uv, cur_uv
    )
    pa, _ = project(K, R_prev_cam, t_prev_cam, Xn)
    pb, _ = project(K, R, t, Xn)
    ea2 = jnp.sum((pa - prev_uv) ** 2, axis=-1)
    eb2 = jnp.sum((pb - cur_uv) ** 2, axis=-1)
    thr2 = jnp.float32(reproj_px) ** 2
    tri_ok = (
        pk & ~used_kp[pidx]
        & (z1 > 1e-3) & (z2 > 1e-3) & (ea2 < thr2) & (eb2 < thr2)
    )
    score = jnp.where(tri_ok, buf.scale[pidx], -jnp.inf)
    new_cap = min(new_cap, score.shape[0])   # static clamp for tiny frames
    _, nsel = lax.top_k(score, new_cap)
    nok = tri_ok[nsel].astype(jnp.float32)

    # ONE packed f32 output array: the per-frame results ride home in a
    # single device->host fetch.  Row 0 = header [R(9), t(3), n_inl, n_match];
    # rows 1..P = map rows [keep, inl, u, v | desc(128)]; rows P+1.. =
    # new-point rows [ok, X(3), uv_prev(2), uv_cur(2) | desc(128)].
    # u8 descriptors are exact in f32 (0..255).
    head = jnp.concatenate([
        R.reshape(-1), t,
        jnp.stack([n_inl.astype(jnp.float32), n_match.astype(jnp.float32)]),
    ])
    rows_map = jnp.concatenate([
        keep.astype(jnp.float32)[:, None], inl.astype(jnp.float32)[:, None],
        uv_m, jnp.zeros((P, 4), jnp.float32),
    ], axis=-1)
    rows_new = jnp.concatenate([
        nok[:, None], Xn[nsel], prev_uv[nsel], cur_uv[nsel],
    ], axis=-1)
    rows = jnp.concatenate([rows_map, rows_new], axis=0)
    descs = jnp.concatenate([buf.desc[mid], buf.desc[pidx][nsel]], axis=0)
    packed = jnp.concatenate([
        jnp.pad(head, (0, 136 - head.shape[0]))[None, :],
        jnp.concatenate([rows, descs.astype(jnp.float32)], axis=1),
    ], axis=0)                                    # (1 + P + new_cap, 136)
    return packed, (buf.desc, kp_uv, buf.valid)


@partial(jax.jit, static_argnames=("iters", "huber_px", "cg_iters"))
def _ba_rounds_packed(Rs, ts, X, obs_pack, K, free, iters: int,
                      huber_px: float, cg_iters: int):
    """`iters` LM iterations in ONE dispatch with packed I/O.

    The pipeline's periodic BA — otherwise 12 lm_iteration dispatches +
    per-iteration cost fetches — is folded into a single fori_loop program taking one packed obs array
    [u, v, cam, pt, w] and returning one packed (P, 15) result
    [Rs(9) | ts(3) rows 0..C | X(3)].  cam/pt ride in f32 exactly
    (< 2^24).  Same math as sfm.ba.run_ba (lam0=1e-3, accept/reject LM).
    """
    from .ba import BAObs, BAParams, lm_iteration

    obs = BAObs(uv=obs_pack[:, :2], cam=obs_pack[:, 2].astype(jnp.int32),
                pt=obs_pack[:, 3].astype(jnp.int32), w=obs_pack[:, 4])
    nP = X.shape[0]

    def body(i, carry):
        params, lam = carry
        params, lam, _cost, _acc = lm_iteration(
            params, obs, K, lam, free,
            huber_px=huber_px, cg_iters=cg_iters, n_points=nP,
        )
        return (params, lam)

    params, _lam = lax.fori_loop(
        0, iters, body, (BAParams(Rs, ts, X), jnp.float32(1e-3)))
    C = Rs.shape[0]
    out = jnp.zeros((nP, 15), jnp.float32)
    out = out.at[:C, :9].set(params.Rs.reshape(C, 9))
    out = out.at[:C, 9:12].set(params.ts)
    out = out.at[:, 12:15].set(params.X)
    return out


@partial(jax.jit, static_argnames=("ratio_sq",))
def _match_pairs_packed(d1, v1, d2, v2, ratio_sq: float):
    """match_descriptors_jax with the result packed into ONE (cap, 3)
    int32 array [idx1, idx2, valid] — one fetch instead of three."""
    res = match_descriptors_jax(d1, v1, d2, v2, ratio_sq=ratio_sq)
    return jnp.stack(
        [res.idx1, res.idx2, res.valid.astype(jnp.int32)], axis=1)


@partial(jax.jit, static_argnames=("ratio_sq",))
def _boot_probe_batched(d0, v0, uv0, descs, valids, uvs, ratio_sq: float):
    """Bootstrap candidate probe for a CHUNK of frames in one dispatch:
    per candidate, the ratio-match count against frame 0 and the median
    matched displacement (the flow gate) — the two quantities the
    bootstrap scan gates on before it spends host round trips on full
    match materialization and two-view init.  L1 metric and slot-masked
    queries give counts/flows identical to the host `_match` path."""

    def one(desc_b, valid_b, uv_b):
        keep, mid, _d, _d2 = match_descriptors_dense(
            d0, v0, desc_b, valid_b, metric="L1", ratio_sq=ratio_sq)
        disp = jnp.linalg.norm(uv_b[mid] - uv0, axis=-1)
        flow = jnp.nanmedian(jnp.where(keep, disp, jnp.nan))
        return jnp.stack([jnp.sum(keep.astype(jnp.float32)), flow])

    return jax.vmap(one)(descs, valids, uvs)


@partial(jax.jit, static_argnames=("ratio_sq", "metric", "thresh_px"))
def _loop_probe_batched(keys, old_desc, old_valid, old_X,
                        descs, valids, uvs, R0s, t0s, K,
                        ratio_sq: float, metric: str, thresh_px: float):
    """Loop-closure probe for ALL candidate frames in ONE dispatch: each
    frame's slot buffers are matched against the (tiny, bootstrap-anchored)
    old-map block and RANSAC-PnP'd; returns (F, 14) rows
    [n_match, n_inl, R(9), t(3)], instead of one host round trip per
    frame."""

    def one(key, desc_f, valid_f, uv_f, R0, t0):
        keep, mid, _d, _d2 = match_descriptors_dense(
            old_desc, old_valid, desc_f, valid_f,
            metric=metric, ratio_sq=ratio_sq)
        uv_m = uv_f[mid]
        R, t, _inl, n_inl = ransac_pnp(
            key, K, R0, t0, old_X, uv_m, keep.astype(jnp.float32),
            thresh_px=thresh_px)
        return jnp.concatenate([
            jnp.stack([jnp.sum(keep.astype(jnp.float32)),
                       n_inl.astype(jnp.float32)]),
            R.reshape(-1), t])

    return jax.vmap(one)(keys, descs, valids, uvs, R0s, t0s)


@jax.jit
def _relative_poses_batched(Rs, ts):
    """Consecutive-pair odometry edges Z_c = T_c * T_{c-1}^-1 in ONE
    dispatch (instead of ~2 host round trips per camera)."""
    from .posegraph import relative_pose

    return jax.vmap(relative_pose)(Rs[:-1], ts[:-1], Rs[1:], ts[1:])


@dataclass
class SfMResult:
    Rs: np.ndarray                 # (F,3,3) world-to-camera
    ts: np.ndarray                 # (F,3)
    points: np.ndarray             # (P,3)
    n_obs: int
    frames_registered: List[int] = field(default_factory=list)


class IncrementalSfM:
    """Sequential SfM: bootstrap pair -> PnP registration -> triangulate new
    points -> periodic + final BA."""

    def __init__(
        self,
        K: np.ndarray,
        frame_shape,
        cfg: Optional[SiftConfig] = None,
        min_boot_flow_px: float = 8.0,
        min_matches: int = 30,
        reproj_px: float = 3.0,
        ba_every: int = 8,
        ratio_sq: float = 0.7,
        seed: int = 0,
        loop_closure: bool = True,
        loop_min_inliers: int = 15,
        map_match_window: Optional[int] = None,
        reloc_fallback: bool = True,
        fused: bool = True,
        new_cap: int = 256,
        match_metric: str = "L1",
    ):
        self.K = np.asarray(K, np.float32)
        self.cfg = cfg or SiftConfig()
        self.sift = SiftPlan(shape=frame_shape, config=self.cfg)
        self.min_boot_flow = min_boot_flow_px
        self.min_matches = min_matches
        self.reproj_px = reproj_px
        self.ba_every = ba_every
        # looser ratio than the pairwise default 0.5329: SfM matching is
        # outlier-gated downstream by RANSAC-PnP / reprojection checks
        self.ratio_sq = ratio_sq
        self.key = jax.random.key(seed)
        # loop closure (BASELINE config 4 "pose graph"): after sequential
        # registration, re-match late frames against the oldest map points
        # (bootstrap-anchored, hence drift-free up to gauge), turn accepted
        # PnP poses into pose-graph edges, optimize, and re-anchor the map.
        self.loop_closure = loop_closure
        self.loop_min_inliers = loop_min_inliers
        # when set, sequential PnP matches only points first observed in the
        # last W cameras (local-map tracking as real-time systems do); global
        # anchoring then comes from loop closure alone
        self.map_match_window = map_match_window
        # full-map retry when the windowed match starves (revisits)
        self.reloc_fallback = reloc_fallback
        # fused per-frame registration (round 5): one jitted program per
        # frame instead of ~100 host-driven dispatches; `False` keeps the
        # legacy host loop for A/B
        self.fused = fused
        self.new_cap = new_cap
        # "L1" = the reference parity metric the host loop's
        # match_descriptors_jax default uses (match sets carry over exactly);
        # "L2" ranks by squared euclidean via one matmul (near-identical sets,
        # rare near-tie flips)
        self.match_metric = match_metric
        self.n_loop_edges = 0

    def _next_key(self):
        self.key, k = jax.random.split(self.key)
        return k

    def _match(self, d1, d2):
        """Padded-bucket descriptor matching; returns (M,2) int indices."""
        n1, n2 = len(d1), len(d2)
        if n1 == 0 or n2 == 0:
            return np.zeros((0, 2), np.int32)
        p1, p2 = _pow2_pad(n1), _pow2_pad(n2)
        d1p = np.zeros((p1, 128), np.uint8)
        d1p[:n1] = d1
        d2p = np.zeros((p2, 128), np.uint8)
        d2p[:n2] = d2
        v1 = np.arange(p1) < n1
        v2 = np.arange(p2) < n2
        out = np.asarray(_match_pairs_packed(
            jnp.asarray(d1p), jnp.asarray(v1), jnp.asarray(d2p),
            jnp.asarray(v2), ratio_sq=self.ratio_sq,
        ))
        return out[out[:, 2] > 0][:, :2].astype(np.int32)

    def run(self, frames, verbose: bool = False) -> Optional[SfMResult]:
        if self.fused:
            return self._run_fused(frames, verbose)
        return self._run_host(frames, verbose)

    def _bootstrap(self, kps, F):
        """Bootstrap pair selection: frame 0 against the best-baseline frame.

        Prefers the first frame meeting both gates (enough inliers AND
        enough parallax); if none does, falls back to the candidate
        maximizing inliers * flow (baseline-vs-coverage tradeoff).
        `kps` is anything indexable by frame id yielding dicts/recarrays
        with "x"/"y"/"desc" (eager list in the host path, lazy detector in
        the fused path)."""
        run_init = self._run_two_view_init
        boot = None
        fallback = None
        fallback_score = 0.0
        low_flow = []   # candidates failing only the flow gate (fallback pool)
        for b in range(1, F):
            m = self._match(kps[0]["desc"], kps[b]["desc"])
            if len(m) < max(self.min_matches // 2, 10):
                continue
            uv0 = np.stack([kps[0]["x"][m[:, 0]], kps[0]["y"][m[:, 0]]], 1)
            uvb = np.stack([kps[b]["x"][m[:, 1]], kps[b]["y"][m[:, 1]]], 1)
            flow = float(np.median(np.linalg.norm(uvb - uv0, axis=1)))
            # flow gate FIRST (r5): flow needs only the match, so a
            # candidate that cannot possibly boot (flow too small) skips
            # the two-view init entirely — on slow-motion sequences the
            # first ~15 candidates fail only this gate, and each skipped
            # init saves a device round-trip.  Skipped candidates join the
            # fallback pool evaluated below only if nothing boots.
            if flow < self.min_boot_flow:
                low_flow.append((b, m, uv0, uvb, flow))
                continue
            init = run_init(m, uv0, uvb)
            n_inl = int(init.n_inliers)
            if n_inl >= self.min_matches:
                boot = (b, m, uv0, uvb, init)
                break
            score = n_inl * flow
            if n_inl >= max(self.min_matches // 2, 10) and score > fallback_score:
                fallback = (b, m, uv0, uvb, init)
                fallback_score = score
        if boot is None:
            # no candidate passed both gates: score the low-flow pool too
            # (same inliers*flow criterion as before the reorder)
            for b, m, uv0, uvb, flow in low_flow:
                init = run_init(m, uv0, uvb)
                n_inl = int(init.n_inliers)
                score = n_inl * flow
                if (n_inl >= max(self.min_matches // 2, 10)
                        and score > fallback_score):
                    fallback = (b, m, uv0, uvb, init)
                    fallback_score = score
            boot = fallback
        return boot

    def _run_two_view_init(self, m, uv0, uvb):
        """Pow2-padded essential-RANSAC two-view init on matched pairs."""
        n = _pow2_pad(len(m))
        uv0p = np.zeros((n, 2), np.float32)
        uv0p[: len(m)] = uv0
        uvbp = np.zeros((n, 2), np.float32)
        uvbp[: len(m)] = uvb
        vp = np.arange(n) < len(m)
        return initialize_two_view(
            self._next_key(), jnp.asarray(self.K), jnp.asarray(uv0p),
            jnp.asarray(uvbp), jnp.asarray(vp), thresh_px=self.reproj_px,
        )

    def _init_map_state(self, kps, boot):
        """Host-side map/obs state from the accepted bootstrap pair."""
        b, m, uv0, uvb, init = boot
        inl = np.asarray(init.inliers)[: len(m)]
        map_X = np.asarray(init.points)[: len(m)][inl].astype(np.float32)
        map_desc = kps[0]["desc"][m[inl, 0]]
        obs_cam, obs_pt, obs_uv = [], [], []
        for pi, (i0, ib) in enumerate(m[inl]):
            obs_cam += [0, 1]
            obs_pt += [pi, pi]
            obs_uv += [
                [kps[0]["x"][i0], kps[0]["y"][i0]],
                [kps[b]["x"][ib], kps[b]["y"][ib]],
            ]
        cam_of_frame = {0: 0, b: 1}
        Rs = [np.eye(3, dtype=np.float32), np.asarray(init.R, np.float32)]
        ts = [np.zeros(3, np.float32), np.asarray(init.t, np.float32)]
        frames_reg = [0, b]
        pt_first_cam = np.zeros(len(map_X), np.int32)  # all bootstrap points
        return (map_X, map_desc, obs_cam, obs_pt, obs_uv, cam_of_frame,
                Rs, ts, frames_reg, pt_first_cam)

    def _run_host(self, frames, verbose: bool = False) -> Optional[SfMResult]:
        """Legacy host-orchestrated registration loop (kept for A/B against
        the fused path; ~100 device dispatches per frame)."""
        F = len(frames)
        kps = [self.sift.keypoints(np.asarray(f)) for f in frames]
        K = jnp.asarray(self.K)
        boot = self._bootstrap(kps, F)
        if boot is None:
            return None
        b, m, uv0, uvb, init = boot
        _say(verbose, "bootstrap: frames (0, %d), %d inliers",
             b, int(init.n_inliers))
        (map_X, map_desc, obs_cam, obs_pt, obs_uv, cam_of_frame,
         Rs, ts, frames_reg, pt_first_cam) = self._init_map_state(kps, boot)

        # --- sequential registration of the remaining frames ---
        order = [f for f in range(1, F) if f != b]
        order = [f for f in order if f > b] + [f for f in order if f < b]
        for f in sorted(set(order)):
            if self.map_match_window is not None:
                lo = max(0, len(Rs) - self.map_match_window)
                sel = np.nonzero(pt_first_cam >= lo)[0]
                mm = self._match(map_desc[sel], kps[f]["desc"])
                if len(mm):
                    mm = np.stack([sel[mm[:, 0]], mm[:, 1]], 1)
                # relocalization fallback (r4): when windowed matching
                # starves — typically a revisit whose overlap is with OLD
                # map points outside the window (out-and-back sequences) —
                # retry against the full map rather than dropping the frame.
                # One starved frame otherwise cascades: the next frame's
                # window shifts onto the same stale points and the rest of
                # the sequence never registers (measured: a single marginal
                # triangulation flip cost 3 of 12 registrations).
                if len(mm) < 12 and self.reloc_fallback:
                    mm_full = self._match(map_desc, kps[f]["desc"])
                    if len(mm_full) > len(mm):
                        _say(verbose,
                             "frame %d: windowed match starved (%d), "
                             "relocalizing vs full map (%d)",
                             f, len(mm), len(mm_full))
                        mm = mm_full
            else:
                mm = self._match(map_desc, kps[f]["desc"])
            if len(mm) < 12:
                _say(verbose, "frame %d: only %d map matches, skipped",
                     f, len(mm))
                continue
            n = _pow2_pad(len(mm))
            Xp = np.zeros((n, 3), np.float32)
            Xp[: len(mm)] = map_X[mm[:, 0]]
            uvp = np.zeros((n, 2), np.float32)
            uvp[: len(mm)] = np.stack(
                [kps[f]["x"][mm[:, 1]], kps[f]["y"][mm[:, 1]]], 1
            )
            wp = (np.arange(n) < len(mm)).astype(np.float32)
            R0, t0 = Rs[-1], ts[-1]  # previous registered pose as init
            R, t, inl_f, n_inl = ransac_pnp(
                self._next_key(), K, jnp.asarray(R0), jnp.asarray(t0),
                jnp.asarray(Xp), jnp.asarray(uvp), jnp.asarray(wp),
                thresh_px=self.reproj_px,
            )
            if int(n_inl) < 10:
                _say(verbose, "frame %d: PnP failed (%d inliers)",
                     f, int(n_inl))
                continue
            cam_id = len(Rs)
            cam_of_frame[f] = cam_id
            Rs.append(np.asarray(R, np.float32))
            ts.append(np.asarray(t, np.float32))
            frames_reg.append(f)
            inl_np = np.asarray(inl_f)[: len(mm)]
            for k_, (pi, ki) in enumerate(mm):
                if inl_np[k_]:
                    obs_cam.append(cam_id)
                    obs_pt.append(int(pi))
                    obs_uv.append([kps[f]["x"][ki], kps[f]["y"][ki]])
                    # refresh the map point's descriptor to the newest view so
                    # sequential matching tracks appearance drift
                    map_desc[pi] = kps[f]["desc"][ki]

            # triangulate new points vs the previous registered frame
            prev_f = frames_reg[-2]
            self._triangulate_new(
                kps, f, prev_f, cam_of_frame, Rs, ts, mm,
                map_X, map_desc, obs_cam, obs_pt, obs_uv,
            )
            map_X, map_desc, n_new = self._map_arrays
            if n_new:
                pt_first_cam = np.concatenate(
                    [pt_first_cam,
                     np.full(n_new, cam_of_frame[prev_f], np.int32)]
                )

            # periodic BA
            if len(Rs) % self.ba_every == 0:
                Rs, ts, map_X = self._run_ba(Rs, ts, map_X, obs_cam, obs_pt, obs_uv)
                self._map_arrays = (map_X, map_desc, 0)
            _say(verbose, "frame %d: cam %d, %d PnP inliers, map %d",
                 f, cam_id, int(n_inl), len(map_X))

        # --- loop closure + pose graph (BASELINE config 4) ---
        if self.loop_closure and len(Rs) > 3:
            Rs, ts, map_X = self._pose_graph_close(
                kps, frames_reg, cam_of_frame, Rs, ts,
                map_X, map_desc, pt_first_cam, verbose,
            )

        # --- final global BA ---
        Rs, ts, map_X = self._run_ba(Rs, ts, map_X, obs_cam, obs_pt, obs_uv, iters=25)
        return SfMResult(
            Rs=np.stack(Rs), ts=np.stack(ts), points=map_X,
            n_obs=len(obs_cam), frames_registered=frames_reg,
        )

    # -- fused registration (round 5) ----------------------------------------

    def _kp_np(self, f):
        """Compacted host-side keypoints of frame f from its device buffer
        (detect-on-demand; dict with the recarray field names the bootstrap
        helper indexes)."""
        if f not in self._kps_cache:
            desc, uv, valid = self._buf(f)
            m = np.asarray(valid)
            uvh = np.asarray(uv)[m]
            self._kps_cache[f] = {
                "x": uvh[:, 0], "y": uvh[:, 1],
                "desc": np.asarray(desc)[m],
            }
        return self._kps_cache[f]

    def _buf(self, f):
        """Device-resident (desc, uv, valid) slot buffers of frame f."""
        if f not in self._bufs:
            b = self.sift.keypoints_raw(np.asarray(self._frames[f]))
            self._bufs[f] = (b.desc, jnp.stack([b.x, b.y], -1), b.valid)
        return self._bufs[f]

    class _LazyKps:
        def __init__(self, sfm):
            self.sfm = sfm

        def __getitem__(self, f):
            return self.sfm._kp_np(f)

    def _bootstrap_fast(self, kps, F):
        """Fused-path bootstrap: chunks of candidates are probed ON DEVICE
        (`_boot_probe_batched`: match count + median flow per candidate in
        one dispatch) so the two host-side gates run before any per-frame
        match materialization or two-view init round trips.  Candidate
        order, gates, fallback scoring and the returned tuple are identical
        to `_bootstrap`."""
        gate = max(self.min_matches // 2, 10)
        d0, uv0v, v0 = self._buf(0)
        fallback = None
        fallback_score = 0.0
        low_flow = []   # (b, flow) failing only the flow gate
        cands = list(range(1, F))
        CH = 8

        def materialize(b):
            m = self._match(kps[0]["desc"], kps[b]["desc"])
            uv0 = np.stack([kps[0]["x"][m[:, 0]], kps[0]["y"][m[:, 0]]], 1)
            uvb = np.stack([kps[b]["x"][m[:, 1]], kps[b]["y"][m[:, 1]]], 1)
            return m, uv0, uvb

        for ci in range(0, len(cands), CH):
            chunk = cands[ci:ci + CH]
            out = np.asarray(_boot_probe_batched(
                d0, v0, uv0v,
                jnp.stack([self._buf(b)[0] for b in chunk]),
                jnp.stack([self._buf(b)[2] for b in chunk]),
                jnp.stack([self._buf(b)[1] for b in chunk]),
                ratio_sq=self.ratio_sq))
            for b, row in zip(chunk, out):
                n_m, flow = int(row[0]), float(row[1])
                if n_m < gate:
                    continue
                if not np.isfinite(flow) or flow < self.min_boot_flow:
                    low_flow.append((b, flow))
                    continue
                m, uv0, uvb = materialize(b)
                init = self._run_two_view_init(m, uv0, uvb)
                n_inl = int(init.n_inliers)
                if n_inl >= self.min_matches:
                    return (b, m, uv0, uvb, init)
                score = n_inl * flow
                if n_inl >= gate and score > fallback_score:
                    fallback = (b, m, uv0, uvb, init)
                    fallback_score = score
        for b, flow in low_flow:
            m, uv0, uvb = materialize(b)
            init = self._run_two_view_init(m, uv0, uvb)
            n_inl = int(init.n_inliers)
            score = n_inl * flow
            if n_inl >= gate and score > fallback_score:
                fallback = (b, m, uv0, uvb, init)
                fallback_score = score
        return fallback

    def _run_fused(self, frames, verbose: bool = False) -> Optional[SfMResult]:
        import time as _time

        F = len(frames)
        self._frames = frames
        self._bufs = {}
        self._kps_cache = {}
        # wall-time breakdown (reference parity: plan.py::log_profile's
        # per-stage report) — read self.phase_times after run()
        pt = self.phase_times = {"bootstrap": 0.0, "register": 0.0,
                                 "periodic_ba": 0.0, "loop_closure": 0.0,
                                 "final_ba": 0.0}
        t0 = _time.perf_counter()
        kps = self._LazyKps(self)
        K = jnp.asarray(self.K)
        boot = self._bootstrap_fast(kps, F)
        pt["bootstrap"] = _time.perf_counter() - t0
        if boot is None:
            return None
        b, m, uv0, uvb, init = boot
        _say(verbose, "bootstrap: frames (0, %d), %d inliers",
             b, int(init.n_inliers))
        (map_X, map_desc, obs_cam, obs_pt, obs_uv, cam_of_frame,
         Rs, ts, frames_reg, pt_first_cam) = self._init_map_state(kps, boot)

        def fused_call(f, valid_rows):
            """One fused registration dispatch; valid_rows masks the map
            bucket (the host-side match window)."""
            t0 = _time.perf_counter()
            P = _pow2_pad(len(map_X))
            md = np.zeros((P, 128), np.uint8)
            md[: len(map_X)] = map_desc
            mv = np.zeros(P, bool)
            mv[: len(map_X)] = valid_rows
            mX = np.zeros((P, 3), np.float32)
            mX[: len(map_X)] = map_X
            prev_f = frames_reg[-1]
            pdesc, puv, pvalid = self._buf(prev_f)
            ca = cam_of_frame[prev_f]
            packed, bufs = register_frame_fused(
                jnp.asarray(np.asarray(frames[f], np.float32)),
                self._next_key(),
                jnp.asarray(md), jnp.asarray(mv), jnp.asarray(mX),
                pdesc, puv, pvalid,
                jnp.asarray(Rs[ca]), jnp.asarray(ts[ca]),
                jnp.asarray(Rs[-1]), jnp.asarray(ts[-1]), K,
                cfg=self.cfg, new_cap=self.new_cap,
                ratio_sq=self.ratio_sq, reproj_px=self.reproj_px,
                metric=self.match_metric,
            )
            pk = np.asarray(packed)               # the ONE per-frame fetch
            pt["register"] += _time.perf_counter() - t0
            return (pk[0, :14], pk[1:, :8],
                    pk[1:, 8:].astype(np.uint8), bufs, P, ca)

        for f in sorted(f for f in range(1, F) if f != b):
            if self.map_match_window is not None:
                lo = max(0, len(Rs) - self.map_match_window)
                vrows = pt_first_cam >= lo
            else:
                vrows = np.ones(len(map_X), bool)
            head, rows, descs, bufs, P, ca = fused_call(f, vrows)
            n_match = int(head[13])
            # relocalization fallback (r4): when windowed matching starves —
            # typically a revisit overlapping OLD map points outside the
            # window — retry against the full map rather than dropping the
            # frame (one starved frame otherwise cascades)
            if (n_match < 12 and self.map_match_window is not None
                    and self.reloc_fallback and not vrows.all()):
                head2, rows2, descs2, bufs2, P2, ca2 = fused_call(
                    f, np.ones(len(map_X), bool))
                if int(head2[13]) > n_match:
                    _say(verbose,
                         "frame %d: windowed match starved (%d), "
                         "relocalizing vs full map (%d)",
                         f, n_match, int(head2[13]))
                    head, rows, descs, bufs, P, ca = (
                        head2, rows2, descs2, bufs2, P2, ca2)
                    n_match = int(head[13])
            if n_match < 12:
                _say(verbose, "frame %d: only %d map matches, skipped",
                     f, n_match)
                continue
            n_inl = int(head[12])
            if n_inl < 10:
                _say(verbose, "frame %d: PnP failed (%d inliers)", f, n_inl)
                continue
            R = head[:9].reshape(3, 3).astype(np.float32)
            t = head[9:12].astype(np.float32)
            cam_id = len(Rs)
            cam_of_frame[f] = cam_id
            Rs.append(R)
            ts.append(t)
            frames_reg.append(f)
            self._bufs[f] = bufs
            # observations + descriptor refresh from the map-row pack
            rmap = rows[: len(map_X)]
            for pi in np.nonzero(rmap[:, 1] > 0)[0]:
                obs_cam.append(cam_id)
                obs_pt.append(int(pi))
                obs_uv.append([float(rmap[pi, 2]), float(rmap[pi, 3])])
                # refresh the map point's descriptor to the newest view so
                # sequential matching tracks appearance drift
                map_desc[pi] = descs[pi]
            # new landmarks from the new-point pack (triangulated vs the
            # previously registered frame = camera `ca`)
            rnew = rows[P:]
            dnew = descs[P:]
            ok = rnew[:, 0] > 0
            n_new = int(ok.sum())
            if n_new:
                base = len(map_X)
                map_X = np.concatenate(
                    [map_X, rnew[ok, 1:4].astype(np.float32)])
                map_desc = np.concatenate([map_desc, dnew[ok]])
                for k_, r_ in enumerate(rnew[ok]):
                    obs_cam += [ca, cam_id]
                    obs_pt += [base + k_, base + k_]
                    obs_uv += [[float(r_[4]), float(r_[5])],
                               [float(r_[6]), float(r_[7])]]
                pt_first_cam = np.concatenate(
                    [pt_first_cam, np.full(n_new, ca, np.int32)])
            # periodic BA
            if len(Rs) % self.ba_every == 0:
                t0 = _time.perf_counter()
                Rs, ts, map_X = self._run_ba(
                    Rs, ts, map_X, obs_cam, obs_pt, obs_uv)
                pt["periodic_ba"] += _time.perf_counter() - t0
            _say(verbose, "frame %d: cam %d, %d PnP inliers, map %d",
                 f, cam_id, n_inl, len(map_X))

        # --- loop closure + pose graph (BASELINE config 4) ---
        if self.loop_closure and len(Rs) > 3:
            t0 = _time.perf_counter()
            Rs, ts, map_X = self._pose_graph_close(
                kps, frames_reg, cam_of_frame, Rs, ts,
                map_X, map_desc, pt_first_cam, verbose,
            )
            pt["loop_closure"] = _time.perf_counter() - t0

        # --- final global BA ---
        t0 = _time.perf_counter()
        Rs, ts, map_X = self._run_ba(
            Rs, ts, map_X, obs_cam, obs_pt, obs_uv, iters=25)
        pt["final_ba"] = _time.perf_counter() - t0
        return SfMResult(
            Rs=np.stack(Rs), ts=np.stack(ts), points=map_X,
            n_obs=len(obs_cam), frames_registered=frames_reg,
        )

    # -- helpers -------------------------------------------------------------

    def _triangulate_new(self, kps, f, prev_f, cam_of_frame, Rs, ts, mm,
                         map_X, map_desc, obs_cam, obs_pt, obs_uv):
        """Add map points from f<->prev_f matches not already in the map."""
        from .geometry import triangulate_two_view

        m = self._match(kps[prev_f]["desc"], kps[f]["desc"])
        used_f = set(mm[:, 1].tolist())
        fresh = [(i, j) for i, j in m if j not in used_f]
        if len(fresh) < 5:
            self._map_arrays = (map_X, map_desc, 0)
            return
        fresh = np.array(fresh, np.int32)
        ca, cb = cam_of_frame[prev_f], cam_of_frame[f]
        uva = np.stack([kps[prev_f]["x"][fresh[:, 0]], kps[prev_f]["y"][fresh[:, 0]]], 1)
        uvb = np.stack([kps[f]["x"][fresh[:, 1]], kps[f]["y"][fresh[:, 1]]], 1)
        K = jnp.asarray(self.K)
        X, z1, z2 = triangulate_two_view(
            K, jnp.asarray(Rs[ca]), jnp.asarray(ts[ca]),
            K, jnp.asarray(Rs[cb]), jnp.asarray(ts[cb]),
            jnp.asarray(uva.astype(np.float32)), jnp.asarray(uvb.astype(np.float32)),
        )
        from .geometry import project

        pa, _ = project(K, jnp.asarray(Rs[ca]), jnp.asarray(ts[ca]), X)
        pb, _ = project(K, jnp.asarray(Rs[cb]), jnp.asarray(ts[cb]), X)
        ea = np.linalg.norm(np.asarray(pa) - uva, axis=1)
        eb = np.linalg.norm(np.asarray(pb) - uvb, axis=1)
        ok = (np.asarray(z1) > 1e-3) & (np.asarray(z2) > 1e-3)
        ok &= (ea < self.reproj_px) & (eb < self.reproj_px)
        Xn = np.asarray(X)[ok]
        base = len(map_X)
        if len(Xn):
            map_X = np.concatenate([map_X, Xn.astype(np.float32)])
            map_desc = np.concatenate([map_desc, kps[f]["desc"][fresh[ok, 1]]])
            for k_, (i, j) in enumerate(fresh[ok]):
                obs_cam += [ca, cb]
                obs_pt += [base + k_, base + k_]
                obs_uv += [
                    [kps[prev_f]["x"][i], kps[prev_f]["y"][i]],
                    [kps[f]["x"][j], kps[f]["y"][j]],
                ]
        self._map_arrays = (map_X, map_desc, len(Xn))

    def _pose_graph_close(self, kps, frames_reg, cam_of_frame, Rs, ts,
                          map_X, map_desc, pt_first_cam, verbose=False):
        """Detect loop closures and optimize the pose graph.

        Loop detection: match each late frame's descriptors against the
        OLDEST map points (first observed by the bootstrap cameras — those
        are in the gauge-fixed world frame, so a PnP pose against them is a
        drift-free absolute measurement).  Accepted PnP results become
        strong 0->c pose-graph edges alongside unit-weight odometry edges;
        after sfm.posegraph.optimize_pose_graph, every map point is
        re-anchored through its first-observing camera's correction.
        """
        from .posegraph import PoseGraph, optimize_pose_graph
        from .pnp import ransac_pnp

        C = len(Rs)
        old_mask = pt_first_cam <= 1
        if old_mask.sum() < 20:
            return Rs, ts, map_X
        old_idx = np.nonzero(old_mask)[0]
        ZRs, Zts = _relative_poses_batched(
            jnp.asarray(np.stack(Rs)), jnp.asarray(np.stack(ts)))
        ZRs = np.asarray(ZRs)
        Zts = np.asarray(Zts)
        ei = list(range(C - 1))
        ej = list(range(1, C))
        eZR = [ZRs[c] for c in range(C - 1)]
        eZt = [Zts[c] for c in range(C - 1)]
        ew = [1.0] * (C - 1)
        K = jnp.asarray(self.K)
        n_lc = 0
        # Batched probe (fused path): all candidate frames' slot buffers are
        # still on device — ONE dispatch + ONE fetch replaces ~2 round
        # trips per frame.  Same correspondences and gates as the per-frame
        # loop below (which remains for the host path / missing buffers).
        cand = [f for f in frames_reg
                if cam_of_frame[f] > 1 and f in getattr(self, "_bufs", {})]
        if cand and len(cand) == sum(
                1 for f in frames_reg if cam_of_frame[f] > 1):
            Q = _pow2_pad(len(old_idx), floor=64)
            od = np.zeros((Q, 128), np.uint8)
            od[: len(old_idx)] = map_desc[old_idx]
            ov = np.arange(Q) < len(old_idx)
            oX = np.zeros((Q, 3), np.float32)
            oX[: len(old_idx)] = map_X[old_idx]
            out = np.asarray(_loop_probe_batched(
                jax.random.split(self._next_key(), len(cand)),
                jnp.asarray(od), jnp.asarray(ov), jnp.asarray(oX),
                jnp.stack([self._bufs[f][0] for f in cand]),
                jnp.stack([self._bufs[f][2] for f in cand]),
                jnp.stack([self._bufs[f][1] for f in cand]),
                jnp.asarray(np.stack([Rs[cam_of_frame[f]] for f in cand])),
                jnp.asarray(np.stack([ts[cam_of_frame[f]] for f in cand])),
                K, ratio_sq=self.ratio_sq, metric=self.match_metric,
                thresh_px=self.reproj_px))
            for row, f in zip(out, cand):
                if (int(row[0]) < self.loop_min_inliers
                        or int(row[1]) < self.loop_min_inliers):
                    continue
                ei.append(0)
                ej.append(cam_of_frame[f])
                eZR.append(row[2:11].reshape(3, 3).astype(np.float32))
                eZt.append(row[11:14].astype(np.float32))
                ew.append(3.0)
                n_lc += 1
            frames_probe = []
        else:
            frames_probe = frames_reg
        for f in frames_probe:
            c = cam_of_frame[f]
            if c <= 1:
                continue
            mm = self._match(map_desc[old_idx], kps[f]["desc"])
            if len(mm) < self.loop_min_inliers:
                continue
            n = _pow2_pad(len(mm))
            Xp = np.zeros((n, 3), np.float32)
            Xp[: len(mm)] = map_X[old_idx[mm[:, 0]]]
            uvp = np.zeros((n, 2), np.float32)
            uvp[: len(mm)] = np.stack(
                [kps[f]["x"][mm[:, 1]], kps[f]["y"][mm[:, 1]]], 1
            )
            wp = (np.arange(n) < len(mm)).astype(np.float32)
            R, t, _inl, n_inl = ransac_pnp(
                self._next_key(), K, jnp.asarray(Rs[c]), jnp.asarray(ts[c]),
                jnp.asarray(Xp), jnp.asarray(uvp), jnp.asarray(wp),
                thresh_px=self.reproj_px,
            )
            if int(n_inl) < self.loop_min_inliers:
                continue
            # T_0 = I, so the absolute PnP pose IS the 0->c edge transform
            ei.append(0)
            ej.append(c)
            eZR.append(np.asarray(R, np.float32))
            eZt.append(np.asarray(t, np.float32))
            ew.append(3.0)
            n_lc += 1
        self.n_loop_edges = n_lc
        if n_lc == 0:
            return Rs, ts, map_X
        graph = PoseGraph(
            i=jnp.asarray(np.asarray(ei, np.int32)),
            j=jnp.asarray(np.asarray(ej, np.int32)),
            Z_R=jnp.asarray(np.stack(eZR)),
            Z_t=jnp.asarray(np.stack(eZt)),
            w=jnp.asarray(np.asarray(ew, np.float32)),
        )
        free = jnp.asarray((np.arange(C) > 0).astype(np.float32))
        R_old = np.stack(Rs)
        t_old = np.stack(ts)
        Rn, tn, cost = optimize_pose_graph(
            jnp.asarray(R_old), jnp.asarray(t_old), graph, free,
            iters=20, huber=10.0,
        )
        Rn = np.asarray(Rn, np.float32)
        tn = np.asarray(tn, np.float32)
        self._pgo_debug = (R_old, t_old, Rn, tn,
                           [np.stack(eZR[C - 1:]), np.stack(eZt[C - 1:]),
                            ej[C - 1:]] if n_lc else None)
        _say(verbose, "pose graph: %d loop edges, cost %.4f",
             n_lc, float(cost))
        # re-anchor map points through their first-observing camera:
        # X' = R_new_a^T (R_old_a X + t_old_a - t_new_a)
        a = np.clip(pt_first_cam, 0, C - 1)
        Xc = np.einsum("pij,pj->pi", R_old[a], map_X) + t_old[a]
        map_X = np.einsum("pji,pj->pi", Rn[a], Xc - tn[a]).astype(np.float32)
        return [Rn[i] for i in range(C)], [tn[i] for i in range(C)], map_X

    def _run_ba(self, Rs, ts, map_X, obs_cam, obs_pt, obs_uv, iters: int = 12):
        """All `iters` LM iterations in one dispatch, packed I/O (see
        _ba_rounds_packed — per-dispatch cost dominates at these sizes)."""
        C = len(Rs)
        P = len(map_X)
        M = len(obs_cam)
        Mp = _pow2_pad(M)
        Pp = _pow2_pad(P)
        pack = np.zeros((Mp, 5), np.float32)
        pack[:M, :2] = np.asarray(obs_uv, np.float32)
        pack[:M, 2] = obs_cam
        pack[:M, 3] = obs_pt
        pack[:M, 4] = 1.0
        Xp = np.zeros((Pp, 3), np.float32)
        Xp[:P] = map_X
        free = np.ones(C, np.float32)
        free[0] = 0.0
        if not hasattr(self, "_Kdev"):
            self._Kdev = jnp.asarray(self.K)
        out = np.asarray(_ba_rounds_packed(
            jnp.asarray(np.stack(Rs)), jnp.asarray(np.stack(ts)),
            jnp.asarray(Xp), jnp.asarray(pack), self._Kdev,
            jnp.asarray(free), iters=iters, huber_px=self.reproj_px,
            cg_iters=30))
        Rs = [out[i, :9].reshape(3, 3).astype(np.float32) for i in range(C)]
        ts = [out[i, 9:12].astype(np.float32) for i in range(C)]
        return Rs, ts, out[:P, 12:15].astype(np.float32)

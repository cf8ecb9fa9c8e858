"""Orientation assignment and 128-d descriptor as batched XLA ops.

JAX replacement for the reference's per-keypoint histogram kernels
(reference: openCL/orientation_cpu.cl / orientation_gpu.cl and the three
keypoints_{cpu,gpu1,gpu2}.cl::descriptor variants — SURVEY.md §2.2).  The
reference picks one of several workgroup-size variants at runtime; here there
is a single formulation:

  * Per keypoint, a static-size window of the octave's gradient field is
    gathered with `dynamic_slice` (zero-padded magnitude outside the image,
    which reproduces the reference's out-of-image skip).
  * The orientation histogram is a masked weighted one-hot reduction (36 bins).
  * The descriptor's trilinear scatter is re-expressed as three separable
    per-dimension weight matrices wr (P,4), wc (P,4), wo (P,8) and contracted
    as one matmul:  desc[rc, o] = (wr ⊗ wc)^T @ (gauss·mag · wo)  — an exact
    rewrite of trilinear scatter-add because relu(1-|bin-i|) equals the
    interpolation weight of each adjacent bin and 0 elsewhere.
  * Keypoints are processed in chunks (`lax.map(..., batch_size=...)`) to
    bound the materialized window memory.

Secondary orientation peaks spawn duplicate keypoints; the static-shape idiom
is an (cap, max_ori) angle matrix with validity, re-compacted before the
descriptor stage (replaces the reference's atomic append of new keypoints).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import SiftConfig
from ..oracle import DESC_GRID, DESC_ORI, MAG_FACTOR, N_ORI_BINS
from .detect import RefinedKeypoints


class OrientedKeypoints(NamedTuple):
    """Compacted keypoints with assigned orientations (octave-local coords)."""

    s_int: jnp.ndarray   # (dcap,) int32 integer scale index (gradient plane)
    fs: jnp.ndarray      # (dcap,) f32
    fr: jnp.ndarray      # (dcap,) f32
    fc: jnp.ndarray      # (dcap,) f32
    angle: jnp.ndarray   # (dcap,) f32 in (-pi, pi]
    valid: jnp.ndarray   # (dcap,) bool
    count: jnp.ndarray   # () int32 true number of oriented keypoints


def gradient_jax(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Central-difference gradient mag/ori with clamped edges (oracle.gradient)."""
    p = jnp.pad(img, 1, mode="edge")
    dx = p[1:-1, 2:] - p[1:-1, :-2]
    dy = p[2:, 1:-1] - p[:-2, 1:-1]
    mag = 0.5 * jnp.sqrt(dx * dx + dy * dy)
    ori = jnp.arctan2(dy, dx)
    return mag, ori


def gradient_planes(blurs: jnp.ndarray, cfg: SiftConfig):
    """Gradient mag/ori for the scale planes used by detection (s = 1..scales).

    Returns (scales, H, W) mag and ori stacks; plane index = s_int - 1.
    """
    mags, oris = [], []
    for s in range(1, cfg.scales + 1):
        m, o = gradient_jax(blurs[s])
        mags.append(m)
        oris.append(o)
    return jnp.stack(mags), jnp.stack(oris)


def _ori_window_size(cfg: SiftConfig) -> int:
    """Static orientation window: covers radius floor(4.5*sigma_max)."""
    sigma_max = cfg.init_sigma * 2.0 ** ((cfg.scales + 1.5) / cfg.scales)
    need = 2 * int(4.5 * sigma_max) + 3
    return max(cfg.ori_window, (need + 7) // 8 * 8)


def _desc_window_size(cfg: SiftConfig) -> int:
    """Static descriptor window: covers radius ~ 10.61*sigma_max."""
    sigma_max = cfg.init_sigma * 2.0 ** ((cfg.scales + 1.5) / cfg.scales)
    rad = math.sqrt(2.0) * MAG_FACTOR * sigma_max * (DESC_GRID + 1) / 2.0
    need = 2 * int(rad + 0.5) + 3
    return max(cfg.desc_window, (need + 7) // 8 * 8)


def _gather_window(plane_stack, s_idx, r0, c0, win, pad_value):
    """Gather a (win, win) window centered at integer (r0, c0) from plane s_idx.

    plane_stack: (S, H, W); out-of-image samples take pad_value.
    """
    S, H, W = plane_stack.shape
    half = win // 2
    padded = jnp.pad(
        plane_stack,
        ((0, 0), (half, half), (half, half)),
        mode="constant",
        constant_values=pad_value,
    )
    start_r = r0  # padded coords: r0 - half + half
    start_c = c0
    plane = lax.dynamic_index_in_dim(padded, s_idx, axis=0, keepdims=False)
    return lax.dynamic_slice(plane, (start_r, start_c), (win, win))


def assign_orientations(
    mags: jnp.ndarray,
    oris: jnp.ndarray,
    kps: RefinedKeypoints,
    cfg: SiftConfig,
    dcap: int,
    max_ori: int = 2,
    chunk: int = 128,
) -> OrientedKeypoints:
    """36-bin orientation histogram per keypoint (orientation_*.cl).

    Numerics follow oracle.orientation exactly: integer radius floor(4.5*s),
    inclusion d2 < radius^2 + 0.5, Gaussian weight sigma_w = 1.5*s, 6 rounds
    of circular 3-tap smoothing, peaks >= 0.8*max that are local maxima,
    parabolic refinement.  Up to `max_ori` strongest peaks per keypoint
    (dominant first) are kept, then compacted to capacity `dcap`.
    """
    win = _ori_window_size(cfg)
    half = win // 2
    sigma_oct = cfg.init_sigma * 2.0 ** (kps.fs / cfg.scales)

    def one_kp(s_int, fr, fc, sig, valid):
        r0 = jnp.round(fr).astype(jnp.int32)
        c0 = jnp.round(fc).astype(jnp.int32)
        magw = _gather_window(mags, s_int - 1, r0, c0, win, 0.0)
        oriw = _gather_window(oris, s_int - 1, r0, c0, win, 0.0)
        rr = (jnp.arange(win, dtype=jnp.float32) - half)[:, None] + (
            r0.astype(jnp.float32) - fr
        )
        cc = (jnp.arange(win, dtype=jnp.float32) - half)[None, :] + (
            c0.astype(jnp.float32) - fc
        )
        d2 = rr * rr + cc * cc
        sig_w = 1.5 * sig
        radius = jnp.floor(3.0 * sig_w)
        inside = d2 < radius * radius + 0.5
        w = jnp.exp(-d2 / (2.0 * sig_w * sig_w)) * magw * inside
        b = jnp.floor(N_ORI_BINS * (oriw + np.pi) / (2 * np.pi)).astype(jnp.int32)
        b = jnp.clip(b, 0, N_ORI_BINS - 1)
        onehot = jax.nn.one_hot(b.reshape(-1), N_ORI_BINS, dtype=jnp.float32)
        hist = onehot.T @ w.reshape(-1)
        for _ in range(6):
            hist = (jnp.roll(hist, 1) + hist + jnp.roll(hist, -1)) / 3.0
        hmax = jnp.max(hist)
        left = jnp.roll(hist, 1)
        right = jnp.roll(hist, -1)
        is_peak = (hist >= 0.8 * hmax) & (hist > left) & (hist > right) & (hmax > 0)
        scores = jnp.where(is_peak, hist, -jnp.inf)
        top_vals, top_bins = lax.top_k(scores, max_ori)
        ok = jnp.isfinite(top_vals) & valid
        l = left[top_bins]
        rgt = right[top_bins]
        h = hist[top_bins]
        denom = l - 2.0 * h + rgt
        off = jnp.where(denom != 0, 0.5 * (l - rgt) / jnp.where(denom != 0, denom, 1.0), 0.0)
        ang = 2 * np.pi * (top_bins.astype(jnp.float32) + 0.5 + off) / N_ORI_BINS - np.pi
        ang = jnp.where(ang > np.pi, ang - 2 * np.pi, ang)
        ang = jnp.where(ang <= -np.pi, ang + 2 * np.pi, ang)
        return ang, ok

    angs, oks = lax.map(
        lambda t: one_kp(*t),
        (kps.s_int, kps.fr, kps.fc, sigma_oct, kps.valid),
        batch_size=chunk,
    )
    # expand each keypoint into max_ori slots and re-compact to dcap
    cap = kps.fr.shape[0]
    flat_ok = oks.reshape(-1)
    count = jnp.sum(flat_ok.astype(jnp.int32))
    (sel,) = jnp.nonzero(flat_ok, size=dcap, fill_value=-1)
    valid = sel >= 0
    sel = jnp.maximum(sel, 0)
    kp_idx = sel // max_ori
    return OrientedKeypoints(
        s_int=kps.s_int[kp_idx],
        fs=kps.fs[kp_idx],
        fr=kps.fr[kp_idx],
        fc=kps.fc[kp_idx],
        angle=angs.reshape(-1)[sel],
        valid=valid,
        count=count,
    )


def compute_descriptors(
    mags: jnp.ndarray,
    oris: jnp.ndarray,
    okps: OrientedKeypoints,
    cfg: SiftConfig,
    chunk: int = 64,
) -> jnp.ndarray:
    """128-d descriptors for oriented keypoints (keypoints_*.cl::descriptor).

    Returns (dcap, 128) uint8.  Numerics follow oracle.descriptor: spacing
    3*sigma, Gaussian window sigma = 2 (half of DESC_GRID), trilinear weights,
    normalize -> clip 0.2 -> renormalize -> u8 = min(255, 512*v).
    """
    win = _desc_window_size(cfg)
    half = win // 2
    P = win * win
    sigma_oct = cfg.init_sigma * 2.0 ** (okps.fs / cfg.scales)

    rgrid = jnp.arange(DESC_GRID, dtype=jnp.float32)
    ogrid = jnp.arange(DESC_ORI, dtype=jnp.float32)

    def one_kp(s_int, fr, fc, sig, angle):
        r0 = jnp.round(fr).astype(jnp.int32)
        c0 = jnp.round(fc).astype(jnp.int32)
        magw = _gather_window(mags, s_int - 1, r0, c0, win, 0.0).reshape(P)
        oriw = _gather_window(oris, s_int - 1, r0, c0, win, 0.0).reshape(P)
        dr = ((jnp.arange(win, dtype=jnp.float32) - half)[:, None] + (r0.astype(jnp.float32) - fr))
        dc = ((jnp.arange(win, dtype=jnp.float32) - half)[None, :] + (c0.astype(jnp.float32) - fc))
        dr = jnp.broadcast_to(dr, (win, win)).reshape(P)
        dc = jnp.broadcast_to(dc, (win, win)).reshape(P)
        spacing = MAG_FACTOR * sig
        cos_t = jnp.cos(angle)
        sin_t = jnp.sin(angle)
        # canonical frame u = R(+angle) @ d — see oracle.descriptor for the
        # convention derivation (R(-angle) doubles rotation, r4 fix)
        rrot = (cos_t * dr - sin_t * dc) / spacing
        crot = (sin_t * dr + cos_t * dc) / spacing
        rbin = rrot + DESC_GRID / 2.0 - 0.5
        cbin = crot + DESC_GRID / 2.0 - 0.5
        inside = (rbin > -1.0) & (rbin < DESC_GRID) & (cbin > -1.0) & (cbin < DESC_GRID)
        gw = jnp.exp(-(rrot * rrot + crot * crot) / (2.0 * (0.5 * DESC_GRID) ** 2))
        m = gw * magw * inside  # (P,)
        obin = (oriw - angle) * (DESC_ORI / (2 * np.pi))
        obin = jnp.mod(obin, DESC_ORI)
        # separable trilinear weights: relu(1-|bin - i|), circular for ori
        wr = jnp.maximum(0.0, 1.0 - jnp.abs(rbin[:, None] - rgrid[None, :]))  # (P,4)
        wc = jnp.maximum(0.0, 1.0 - jnp.abs(cbin[:, None] - rgrid[None, :]))  # (P,4)
        do = jnp.abs(obin[:, None] - ogrid[None, :])
        do = jnp.minimum(do, DESC_ORI - do)
        wo = jnp.maximum(0.0, 1.0 - do)                                       # (P,8)
        A = (wr[:, :, None] * wc[:, None, :]).reshape(P, DESC_GRID * DESC_GRID)
        B = m[:, None] * wo
        hist = A.T @ B  # (16, 8)
        v = hist.reshape(-1)
        n = jnp.sqrt(jnp.sum(v * v))
        v = jnp.where(n > 0, v / jnp.where(n > 0, n, 1.0), v)
        v = jnp.minimum(v, 0.2)
        n = jnp.sqrt(jnp.sum(v * v))
        v = jnp.where(n > 0, v / jnp.where(n > 0, n, 1.0), v)
        return jnp.minimum(512.0 * v, 255.0).astype(jnp.uint8)

    desc = lax.map(
        lambda t: one_kp(*t),
        (okps.s_int, okps.fr, okps.fc, sigma_oct, okps.angle),
        batch_size=chunk,
    )
    return desc

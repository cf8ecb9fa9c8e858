"""DoG extrema detection, compaction and subpixel refinement as XLA ops.

JAX replacement for the reference's detection kernels
(reference: openCL/image.cl::{local_maxmin, compact, interp_keypoint},
SURVEY.md §2.2).  The reference appends candidates with atomic counters and
reads the counter back to the host per scale (the hot-loop sync noted in
SURVEY.md §3.2); here the whole DoG stack is scanned with one vectorized
26-neighbor comparison, and candidates are compacted into a *static-capacity*
buffer with `jnp.nonzero(size=...)` — no atomics, no host sync, fully jittable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SiftConfig


class Candidates(NamedTuple):
    """Static-capacity candidate buffer for one octave."""

    s: jnp.ndarray       # (cap,) int32 scale index in [1, scales]
    r: jnp.ndarray       # (cap,) int32 row
    c: jnp.ndarray       # (cap,) int32 col
    valid: jnp.ndarray   # (cap,) bool
    count: jnp.ndarray   # () int32 true number of extrema (may exceed cap)


class RefinedKeypoints(NamedTuple):
    """Refined keypoints for one octave (octave-local coordinates)."""

    s_int: jnp.ndarray   # (cap,) int32 original integer scale index
    fs: jnp.ndarray      # (cap,) f32 refined scale coordinate
    fr: jnp.ndarray      # (cap,) f32 refined row
    fc: jnp.ndarray      # (cap,) f32 refined col
    peak: jnp.ndarray    # (cap,) f32 interpolated DoG value
    valid: jnp.ndarray   # (cap,) bool


def extrema_mask(dogs: jnp.ndarray, cfg: SiftConfig, octave: int) -> jnp.ndarray:
    """Boolean mask (scales, H-2bd, W-2bd) of accepted extrema candidates.

    Conditions as in oracle.local_maxmin: strict 26-neighbor max/min,
    |v| > 0.8*peak_thresh, spatial-Hessian edge rejection, border margin.
    The 26 shifted compares fuse into one XLA stencil loop with no
    intermediates.
    """
    S, H, W = dogs.shape
    bd = cfg.border_dist
    # octsize<=1 rule (see oracle.local_maxmin): edge_thresh1 for octave 0,
    # and for octave 1 too when double_im_size (octsize ladder starts at 0.5)
    octsize = 2.0 ** (octave - 1) if cfg.double_im_size else 2.0 ** octave
    eth = cfg.edge_thresh1 if octsize <= 1.0 else cfg.edge_thresh

    v = dogs[1 : S - 1, bd : H - bd, bd : W - bd]
    strong = jnp.abs(v) > 0.8 * cfg.peak_thresh

    is_max = jnp.ones_like(strong)
    is_min = jnp.ones_like(strong)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if ds == 0 and dr == 0 and dc == 0:
                    continue
                nb = dogs[
                    1 + ds : S - 1 + ds,
                    bd + dr : H - bd + dr,
                    bd + dc : W - bd + dc,
                ]
                is_max = is_max & (v > nb)
                is_min = is_min & (v < nb)
    cand = strong & (is_max | is_min)

    # edge rejection on the 2x2 spatial Hessian of each DoG slice
    d = dogs[1 : S - 1]
    ctr = d[:, bd : H - bd, bd : W - bd]
    hxx = d[:, bd : H - bd, bd - 1 : W - bd - 1] + d[:, bd : H - bd, bd + 1 : W - bd + 1] - 2 * ctr
    hyy = d[:, bd - 1 : H - bd - 1, bd : W - bd] + d[:, bd + 1 : H - bd + 1, bd : W - bd] - 2 * ctr
    hxy = 0.25 * (
        d[:, bd + 1 : H - bd + 1, bd + 1 : W - bd + 1]
        - d[:, bd + 1 : H - bd + 1, bd - 1 : W - bd - 1]
        - d[:, bd - 1 : H - bd - 1, bd + 1 : W - bd + 1]
        + d[:, bd - 1 : H - bd - 1, bd - 1 : W - bd - 1]
    )
    det = hxx * hyy - hxy * hxy
    tr = hxx + hyy
    not_edge = (det > 0) & (det >= eth * tr * tr)
    return cand & not_edge


def compact_extrema(mask: jnp.ndarray, cfg: SiftConfig, cap: int) -> Candidates:
    """Stream-compact the extrema mask into a static-capacity index buffer.

    Replaces the reference's atomic-append + counter-readback + compact kernel
    (image.cl::compact) with `nonzero(size=cap)`.
    """
    Sm, Hm, Wm = mask.shape  # margins already removed
    bd = cfg.border_dist
    flat = mask.reshape(-1)
    count = jnp.sum(flat.astype(jnp.int32))
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=-1)
    valid = idx >= 0
    idx = jnp.maximum(idx, 0)
    s = idx // (Hm * Wm) + 1
    rem = idx % (Hm * Wm)
    r = rem // Wm + bd
    c = rem % Wm + bd
    return Candidates(
        s.astype(jnp.int32), r.astype(jnp.int32), c.astype(jnp.int32), valid, count
    )


def _grad_hess_3x3x3(cube: jnp.ndarray):
    """3-D gradient and Hessian from a 3x3x3 DoG neighborhood (center 1,1,1)."""
    d = cube
    g = jnp.stack(
        [
            0.5 * (d[2, 1, 1] - d[0, 1, 1]),
            0.5 * (d[1, 2, 1] - d[1, 0, 1]),
            0.5 * (d[1, 1, 2] - d[1, 1, 0]),
        ]
    )
    ctr = d[1, 1, 1]
    hss = d[2, 1, 1] + d[0, 1, 1] - 2 * ctr
    hrr = d[1, 2, 1] + d[1, 0, 1] - 2 * ctr
    hcc = d[1, 1, 2] + d[1, 1, 0] - 2 * ctr
    hsr = 0.25 * (d[2, 2, 1] - d[2, 0, 1] - d[0, 2, 1] + d[0, 0, 1])
    hsc = 0.25 * (d[2, 1, 2] - d[2, 1, 0] - d[0, 1, 2] + d[0, 1, 0])
    hrc = 0.25 * (d[1, 2, 2] - d[1, 2, 0] - d[1, 0, 2] + d[1, 0, 0])
    H = jnp.array(
        [[hss, hsr, hsc], [hsr, hrr, hrc], [hsc, hrc, hcc]], dtype=cube.dtype
    )
    return g, H


def _solve3(H: jnp.ndarray, b: jnp.ndarray):
    """Solve H x = b for 3x3 symmetric H via the adjugate (vmap friendly).

    Returns (x, ok) where ok=False for (near-)singular systems — the analog of
    the oracle's LinAlgError rejection.
    """
    a, bb, cc = H[0, 0], H[0, 1], H[0, 2]
    d, e = H[1, 1], H[1, 2]
    f = H[2, 2]
    det = a * (d * f - e * e) - bb * (bb * f - e * cc) + cc * (bb * e - d * cc)
    adj = jnp.array(
        [
            [d * f - e * e, cc * e - bb * f, bb * e - cc * d],
            [e * cc - bb * f, a * f - cc * cc, bb * cc - a * e],
            [bb * e - d * cc, cc * bb - a * e, a * d - bb * bb],
        ],
        dtype=H.dtype,
    )
    ok = jnp.abs(det) > 1e-30
    safe_det = jnp.where(ok, det, 1.0)
    return (adj @ b) / safe_det, ok


def refine_candidates(
    dogs: jnp.ndarray, cands: Candidates, cfg: SiftConfig
) -> RefinedKeypoints:
    """Batched iterative 3-D quadratic refinement (image.cl::interp_keypoint).

    Mirrors oracle.interp_keypoint: up to cfg.max_interp_moves re-centering
    steps (move a pixel when |offset| > 0.6 and the move stays inside the
    border), then a final solve; accept iff |peak| > peak_thresh and all
    offset components are within 1.5.
    """
    S, H, W = dogs.shape
    bd = cfg.border_dist

    def one(s, r, c):
        def gather_solve(r_, c_):
            cube = lax.dynamic_slice(dogs, (s - 1, r_ - 1, c_ - 1), (3, 3, 3))
            g, Hm = _grad_hess_3x3x3(cube)
            off, ok = _solve3(Hm, -g)
            return cube, g, off, ok

        def body(_, state):
            r_, c_ = state
            _, _, off, _ = gather_solve(r_, c_)
            converged = (jnp.abs(off[1]) <= 0.6) & (jnp.abs(off[2]) <= 0.6)
            dr = jnp.where(off[1] > 0.6, 1, jnp.where(off[1] < -0.6, -1, 0))
            dc = jnp.where(off[2] > 0.6, 1, jnp.where(off[2] < -0.6, -1, 0))
            # clamp moves inside the border (oracle move rule)
            dr = jnp.where((dr > 0) & (r_ + 1 >= H - bd), 0, dr)
            dr = jnp.where((dr < 0) & (r_ - 1 < bd), 0, dr)
            dc = jnp.where((dc > 0) & (c_ + 1 >= W - bd), 0, dc)
            dc = jnp.where((dc < 0) & (c_ - 1 < bd), 0, dc)
            r_ = jnp.where(converged, r_, r_ + dr)
            c_ = jnp.where(converged, c_, c_ + dc)
            return (r_, c_)

        r_f, c_f = lax.fori_loop(0, cfg.max_interp_moves, body, (r, c))
        cube, g, off, ok = gather_solve(r_f, c_f)
        peak = cube[1, 1, 1] + 0.5 * jnp.dot(g, off)
        accept = (
            ok
            & (jnp.abs(peak) > cfg.peak_thresh)
            & jnp.all(jnp.abs(off) <= 1.5)
        )
        return (
            s,
            s.astype(jnp.float32) + off[0],
            r_f.astype(jnp.float32) + off[1],
            c_f.astype(jnp.float32) + off[2],
            peak,
            accept,
        )

    s_i, fs, fr, fc, peak, acc = jax.vmap(one)(cands.s, cands.r, cands.c)
    return RefinedKeypoints(s_i, fs, fr, fc, peak, acc & cands.valid)


def detect_octave(
    dogs: jnp.ndarray, cfg: SiftConfig, octave: int, cap: int
) -> RefinedKeypoints:
    """Full detection for one octave: extrema -> compact -> refine."""
    mask = extrema_mask(dogs, cfg, octave)
    cands = compact_extrema(mask, cfg, cap)
    return refine_candidates(dogs, cands, cfg)

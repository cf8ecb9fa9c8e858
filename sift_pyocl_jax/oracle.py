"""Pure-NumPy golden implementation of the full SIFT pipeline.

This module plays the role of the reference's numerical oracle
(reference: ``test/test_image_functions.py`` — the pure-NumPy re-implementation
of every OpenCL kernel that every GPU kernel test compares against, SURVEY.md
§4).  Everything in the JAX pipeline (``sift_pyocl_jax.ops``) is tested
against these functions; they define the numerics of the framework.

Stage → reference kernel correspondence (SURVEY.md §2.2):
  normalize_image        openCL/preprocess.cl::*_to_float + reductions.cl
  gaussian_kernel        openCL/gaussian.cl::gaussian
  blur                   openCL/convolution.cl::{horizontal,vertical}_convolution
  build_scale_space      sift-src/plan.py::_one_octave blur ladder + algebra.cl::combine
  local_maxmin           openCL/image.cl::local_maxmin
  interp_keypoint        openCL/image.cl::interp_keypoint
  gradient               (per-octave gradient precompute used by orientation/descriptor)
  orientation            openCL/orientation_*.cl
  descriptor             openCL/keypoints_*.cl::descriptor
  match_descriptors      openCL/matching_*.cl::matching
  affine_warp            openCL/transform.cl::transform

PROVENANCE: the reference mount was empty this session (SURVEY.md header); the
numerics here are a from-scratch implementation of classic Lowe-2004 SIFT in
the parameterization the reference uses (ASIFT/IPOL sift.cpp family).  Where a
detail could not be verified against reference code it is chosen once HERE and
the JAX pipeline matches THIS file.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .config import SiftConfig

# Structured keypoint record, same layout as the reference's output recarray
# (reference: sift-src/__init__.py keypoint dtype).
KP_DTYPE = np.dtype(
    [("x", "f4"), ("y", "f4"), ("scale", "f4"), ("angle", "f4"), ("desc", "u1", (128,))]
)


# ----------------------------------------------------------------------------
# Preprocessing (reference: preprocess.cl + reductions.cl)
# ----------------------------------------------------------------------------

def normalize_image(img: np.ndarray) -> np.ndarray:
    """Convert any dtype image to float32 grayscale normalized to [0, 255]."""
    img = np.asarray(img)
    if img.ndim == 3:  # RGB -> luminance (reference: preprocess.cl::rgb_to_float)
        img = img[..., :3].astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    img = img.astype(np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi == lo:
        return np.zeros_like(img, dtype=np.float32)
    return (img - lo) * (255.0 / (hi - lo))


def gaussian_kernel(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps; support = 8*sigma+1 rounded up to odd."""
    size = int(math.ceil(8.0 * sigma + 1.0))
    if size % 2 == 0:
        size += 1
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _conv1d_clamp(img: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """1-D correlation along `axis` with clamp-to-edge borders (f32 accum)."""
    half = (len(taps) - 1) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (half, half)
    padded = np.pad(img, pad, mode="edge").astype(np.float32)
    out = np.zeros_like(img, dtype=np.float32)
    for i, t in enumerate(taps):
        sl = [slice(None), slice(None)]
        sl[axis] = slice(i, i + img.shape[axis])
        out += np.float32(t) * padded[tuple(sl)]
    return out


def blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur, clamped borders (reference: convolution.cl)."""
    taps = gaussian_kernel(sigma)
    return _conv1d_clamp(_conv1d_clamp(img, taps, axis=1), taps, axis=0)


def upscale2(img: np.ndarray) -> np.ndarray:
    """Bilinear 2x upscale used by DoubleImSize (output pixel o maps to o/2)."""
    h, w = img.shape
    out = np.zeros((2 * h, 2 * w), dtype=np.float32)
    ys = np.arange(2 * h) / 2.0
    xs = np.arange(2 * w) / 2.0
    y0 = np.minimum(ys.astype(int), h - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.minimum(xs.astype(int), w - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None].astype(np.float32)
    fx = (xs - x0)[None, :].astype(np.float32)
    out = (
        img[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + img[np.ix_(y1, x0)] * fy * (1 - fx)
        + img[np.ix_(y0, x1)] * (1 - fy) * fx
        + img[np.ix_(y1, x1)] * fy * fx
    )
    return out.astype(np.float32)


def shrink2(img: np.ndarray) -> np.ndarray:
    """Octave downsample: take every other pixel (reference: preprocess.cl::shrink)."""
    return np.ascontiguousarray(img[::2, ::2])


def bin2(img: np.ndarray) -> np.ndarray:
    """Octave downsample: 2x2 mean binning (reference: preprocess.cl::bin).

    Output is ceil-sized like shrink2 so both modes share one octave
    geometry; at odd edges the block mean covers the available pixels
    (edge-replicated — provenance: sizes chosen HERE, reference unavailable).
    """
    h, w = img.shape
    p = np.pad(img, ((0, h % 2), (0, w % 2)), mode="edge").astype(np.float32)
    return 0.25 * (
        p[0::2, 0::2] + p[1::2, 0::2] + p[0::2, 1::2] + p[1::2, 1::2]
    )


def downsample(img: np.ndarray, cfg: SiftConfig) -> np.ndarray:
    """Octave downsample dispatch: cfg.downsample_mode in {shrink, bin}."""
    return bin2(img) if cfg.downsample_mode == "bin" else shrink2(img)


# ----------------------------------------------------------------------------
# Scale space (reference: plan.py::_one_octave blur ladder + algebra.cl::combine)
# ----------------------------------------------------------------------------

def prepare_input(img: np.ndarray, cfg: SiftConfig) -> np.ndarray:
    """Normalize, optionally double, and pre-blur the input to init_sigma."""
    data = normalize_image(img)
    cur_sigma = cfg.orig_sigma
    if cfg.double_im_size:
        data = upscale2(data)
        cur_sigma *= 2.0
    if cfg.init_sigma > cur_sigma:
        data = blur(data, math.sqrt(cfg.init_sigma**2 - cur_sigma**2))
    return data


def build_octave(base: np.ndarray, cfg: SiftConfig) -> Tuple[np.ndarray, np.ndarray]:
    """One octave's blur stack (S+3,H,W) and DoG stack (S+2,H,W).

    `base` must already be blurred to init_sigma in this octave's coordinates.
    """
    blurs = [base.astype(np.float32)]
    for inc in cfg.sigma_increments():
        blurs.append(blur(blurs[-1], inc))
    blurs = np.stack(blurs)
    dogs = blurs[1:] - blurs[:-1]
    return blurs, dogs


def build_scale_space(
    img: np.ndarray, cfg: SiftConfig
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """All octaves: list of (blur_stack, dog_stack), halving resolution each."""
    base = prepare_input(img, cfg)
    octaves = []
    for _ in range(cfg.n_octaves(img.shape[:2])):
        blurs, dogs = build_octave(base, cfg)
        octaves.append((blurs, dogs))
        # blur[scales] has sigma = 2*init_sigma = next octave's init_sigma
        base = downsample(blurs[cfg.scales], cfg)
    return octaves


# ----------------------------------------------------------------------------
# Detection (reference: image.cl::local_maxmin / interp_keypoint)
# ----------------------------------------------------------------------------

def local_maxmin(dogs: np.ndarray, cfg: SiftConfig, octave: int) -> np.ndarray:
    """Find 26-neighbor extrema candidates in a DoG stack.

    Returns int array (N, 3) of (s, r, c) with s in [1, scales], passing:
      * strict max or strict min among the 26 neighbors in (s-1,s,s+1)
      * |v| > 0.8 * peak_thresh  (pre-interpolation contrast gate)
      * 2x2 spatial-Hessian edge test at the pixel:
          det > 0 and det/tr^2 >= edge_thresh (edge_thresh1 on octave 0)
      * r, c within [border_dist, dim - border_dist)
    """
    S, H, W = dogs.shape
    bd = cfg.border_dist
    # Reference rule (plan.py octsize<=1, SURVEY §2.2 image.cl row): the
    # stricter edge_thresh1 applies while octsize <= 1 — octave 0 always,
    # AND octave 1 when the image was doubled (octsize ladder starts at 0.5).
    octsize = 2.0 ** (octave - 1) if cfg.double_im_size else 2.0 ** octave
    eth = cfg.edge_thresh1 if octsize <= 1.0 else cfg.edge_thresh
    out = []
    for s in range(1, S - 1):
        v = dogs[s, bd : H - bd, bd : W - bd]
        strong = np.abs(v) > 0.8 * cfg.peak_thresh
        is_max = np.ones_like(strong)
        is_min = np.ones_like(strong)
        for ds in (-1, 0, 1):
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    if ds == 0 and dr == 0 and dc == 0:
                        continue
                    nb = dogs[s + ds, bd + dr : H - bd + dr, bd + dc : W - bd + dc]
                    is_max &= v > nb
                    is_min &= v < nb
        cand = strong & (is_max | is_min)
        # edge rejection on the 2x2 spatial Hessian of DoG[s]
        d = dogs[s]
        ctr = d[bd : H - bd, bd : W - bd]
        hxx = d[bd : H - bd, bd - 1 : W - bd - 1] + d[bd : H - bd, bd + 1 : W - bd + 1] - 2 * ctr
        hyy = d[bd - 1 : H - bd - 1, bd : W - bd] + d[bd + 1 : H - bd + 1, bd : W - bd] - 2 * ctr
        hxy = 0.25 * (
            d[bd + 1 : H - bd + 1, bd + 1 : W - bd + 1]
            - d[bd + 1 : H - bd + 1, bd - 1 : W - bd - 1]
            - d[bd - 1 : H - bd - 1, bd + 1 : W - bd + 1]
            + d[bd - 1 : H - bd - 1, bd - 1 : W - bd - 1]
        )
        det = hxx * hyy - hxy * hxy
        tr = hxx + hyy
        not_edge = (det > 0) & (det >= eth * tr * tr)
        cand &= not_edge
        rs, cs = np.nonzero(cand)
        for r, c in zip(rs, cs):
            out.append((s, r + bd, c + bd))
    return np.array(out, dtype=np.int32).reshape(-1, 3)


def _dog_grad_hessian(dogs: np.ndarray, s: int, r: int, c: int):
    """3-D gradient and Hessian of the DoG stack at integer (s, r, c)."""
    d = dogs
    g = np.array(
        [
            0.5 * (d[s + 1, r, c] - d[s - 1, r, c]),
            0.5 * (d[s, r + 1, c] - d[s, r - 1, c]),
            0.5 * (d[s, r, c + 1] - d[s, r, c - 1]),
        ],
        dtype=np.float64,
    )
    hss = d[s + 1, r, c] + d[s - 1, r, c] - 2 * d[s, r, c]
    hrr = d[s, r + 1, c] + d[s, r - 1, c] - 2 * d[s, r, c]
    hcc = d[s, r, c + 1] + d[s, r, c - 1] - 2 * d[s, r, c]
    hsr = 0.25 * (d[s + 1, r + 1, c] - d[s + 1, r - 1, c] - d[s - 1, r + 1, c] + d[s - 1, r - 1, c])
    hsc = 0.25 * (d[s + 1, r, c + 1] - d[s + 1, r, c - 1] - d[s - 1, r, c + 1] + d[s - 1, r, c - 1])
    hrc = 0.25 * (d[s, r + 1, c + 1] - d[s, r + 1, c - 1] - d[s, r - 1, c + 1] + d[s, r - 1, c - 1])
    H = np.array([[hss, hsr, hsc], [hsr, hrr, hrc], [hsc, hrc, hcc]], dtype=np.float64)
    return g, H


def interp_keypoint(
    dogs: np.ndarray, s: int, r: int, c: int, cfg: SiftConfig
) -> Tuple[float, float, float, float] | None:
    """Iterative 3-D quadratic subpixel refinement (image.cl::interp_keypoint).

    Returns (peak_val, s + ds, r + dr, c + dc) or None if rejected.
    Movement rule: if |dr| or |dc| > 0.6, re-center to the neighboring pixel
    (clamped inside the border) and re-solve, at most cfg.max_interp_moves
    times.  Final acceptance: |peak| > peak_thresh and offsets within 1.5.
    """
    S, H, W = dogs.shape
    bd = cfg.border_dist
    for _ in range(cfg.max_interp_moves):
        g, Hm = _dog_grad_hessian(dogs, s, r, c)
        try:
            off = np.linalg.solve(Hm, -g)
        except np.linalg.LinAlgError:
            return None
        if abs(off[1]) <= 0.6 and abs(off[2]) <= 0.6:
            break
        if off[1] > 0.6 and r + 1 < H - bd:
            r += 1
        elif off[1] < -0.6 and r - 1 >= bd:
            r -= 1
        if off[2] > 0.6 and c + 1 < W - bd:
            c += 1
        elif off[2] < -0.6 and c - 1 >= bd:
            c -= 1
    else:
        g, Hm = _dog_grad_hessian(dogs, s, r, c)
        try:
            off = np.linalg.solve(Hm, -g)
        except np.linalg.LinAlgError:
            return None
    peak = dogs[s, r, c] + 0.5 * float(g @ off)
    if abs(peak) < cfg.peak_thresh:
        return None
    if abs(off[0]) > 1.5 or abs(off[1]) > 1.5 or abs(off[2]) > 1.5:
        return None
    return float(peak), s + float(off[0]), r + float(off[1]), c + float(off[2])


# ----------------------------------------------------------------------------
# Gradient, orientation, descriptor
# (reference: orientation_*.cl, keypoints_*.cl)
# ----------------------------------------------------------------------------

def gradient(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Central-difference gradient magnitude and orientation, clamped edges.

    mag = 0.5*sqrt(dx^2+dy^2); ori = atan2(dy, dx) in (-pi, pi].
    dx = I[r, c+1] - I[r, c-1]; dy = I[r+1, c] - I[r-1, c].
    """
    p = np.pad(img, 1, mode="edge").astype(np.float32)
    dx = p[1:-1, 2:] - p[1:-1, :-2]
    dy = p[2:, 1:-1] - p[:-2, 1:-1]
    mag = 0.5 * np.sqrt(dx * dx + dy * dy)
    ori = np.arctan2(dy, dx)
    return mag.astype(np.float32), ori.astype(np.float32)


N_ORI_BINS = 36


def orientation(
    mag: np.ndarray, ori: np.ndarray, r: float, c: float, sigma_oct: float,
    cfg: SiftConfig,
) -> List[float]:
    """Dominant orientation(s) for a keypoint (orientation_*.cl).

    36-bin histogram of gradient orientation, Gaussian-weighted
    (sigma_w = 1.5*sigma_oct) within radius 3*sigma_w; smoothed 6 times with a
    circular 3-tap box; peaks >= 0.8*max that are local maxima produce one
    angle each, refined by parabolic interpolation.  Returns angles in
    (-pi, pi]; dominant peak first.
    """
    H, W = mag.shape
    sig_w = 1.5 * sigma_oct
    radius = int(3.0 * sig_w)
    hist = np.zeros(N_ORI_BINS, dtype=np.float64)
    r0, c0 = int(round(r)), int(round(c))
    for rr in range(max(r0 - radius, 0), min(r0 + radius + 1, H)):
        for cc in range(max(c0 - radius, 0), min(c0 + radius + 1, W)):
            dr, dc = rr - r, cc - c
            d2 = dr * dr + dc * dc
            if d2 >= radius * radius + 0.5:
                continue
            w = math.exp(-d2 / (2.0 * sig_w * sig_w))
            b = int(N_ORI_BINS * (ori[rr, cc] + math.pi) / (2 * math.pi))
            b = min(b, N_ORI_BINS - 1)
            hist[b] += w * mag[rr, cc]
    for _ in range(6):  # circular 3-tap smoothing, applied 6 times
        hist = (np.roll(hist, 1) + hist + np.roll(hist, -1)) / 3.0
    peaks: List[float] = []
    hmax = hist.max()
    if hmax <= 0:
        return peaks
    order = [int(np.argmax(hist))] + [
        b for b in range(N_ORI_BINS) if b != int(np.argmax(hist))
    ]
    for b in order:
        l, rgt = hist[(b - 1) % N_ORI_BINS], hist[(b + 1) % N_ORI_BINS]
        if hist[b] >= 0.8 * hmax and hist[b] > l and hist[b] > rgt:
            denom = l - 2.0 * hist[b] + rgt
            off = 0.5 * (l - rgt) / denom if denom != 0 else 0.0
            ang = 2 * math.pi * (b + 0.5 + off) / N_ORI_BINS - math.pi
            if ang > math.pi:
                ang -= 2 * math.pi
            if ang <= -math.pi:
                ang += 2 * math.pi
            peaks.append(ang)
    return peaks


DESC_GRID = 4          # 4x4 spatial bins
DESC_ORI = 8           # 8 orientation bins
MAG_FACTOR = 3.0       # descriptor sample spacing = 3*sigma


def descriptor(
    mag: np.ndarray, ori: np.ndarray, r: float, c: float, sigma_oct: float,
    angle: float, cfg: SiftConfig,
) -> np.ndarray:
    """128-d SIFT descriptor (keypoints_*.cl::descriptor).

    Rotated 4x4 spatial grid x 8 orientation bins, trilinear interpolation,
    Gaussian window (sigma = half the descriptor width), normalize -> clip 0.2
    -> renormalize -> u8 = min(255, 512*v).
    """
    H, W = mag.shape
    spacing = MAG_FACTOR * sigma_oct
    radius = int(math.sqrt(2.0) * spacing * (DESC_GRID + 1) / 2.0 + 0.5)
    hist = np.zeros((DESC_GRID, DESC_GRID, DESC_ORI), dtype=np.float64)
    cos_t, sin_t = math.cos(angle), math.sin(angle)
    r0, c0 = int(round(r)), int(round(c))
    for rr in range(max(r0 - radius, 0), min(r0 + radius + 1, H)):
        for cc in range(max(c0 - radius, 0), min(c0 + radius + 1, W)):
            dr, dc = rr - r, cc - c
            # rotate into keypoint frame, in units of descriptor spacing.
            # Angle convention: gradient ori = atan2(d_row, d_col), so a +t
            # image rotation in (row, col) shifts every angle by -t; the
            # canonical frame is u = R(+angle) @ d (then u' = R(a-t)R(t)d =
            # u, invariant).  The round-1..3 code used R(-angle), which
            # DOUBLES the rotation instead of cancelling it — caught by the
            # round-4 invariance battery (tests/test_invariance.py: zero
            # ratio-test matches under rotation while repeatability was 0.9).
            rrot = (cos_t * dr - sin_t * dc) / spacing
            crot = (sin_t * dr + cos_t * dc) / spacing
            rbin = rrot + DESC_GRID / 2.0 - 0.5
            cbin = crot + DESC_GRID / 2.0 - 0.5
            if rbin <= -1.0 or rbin >= DESC_GRID or cbin <= -1.0 or cbin >= DESC_GRID:
                continue
            w = math.exp(-(rrot * rrot + crot * crot) / (2.0 * (0.5 * DESC_GRID) ** 2))
            m = w * mag[rr, cc]
            obin = (ori[rr, cc] - angle) * DESC_ORI / (2 * math.pi)
            obin %= DESC_ORI
            rb0, cb0, ob0 = math.floor(rbin), math.floor(cbin), math.floor(obin)
            fr, fc, fo = rbin - rb0, cbin - cb0, obin - ob0
            for ir, wr in ((rb0, 1 - fr), (rb0 + 1, fr)):
                if ir < 0 or ir >= DESC_GRID:
                    continue
                for ic, wc in ((cb0, 1 - fc), (cb0 + 1, fc)):
                    if ic < 0 or ic >= DESC_GRID:
                        continue
                    for io, wo in ((ob0 % DESC_ORI, 1 - fo), ((ob0 + 1) % DESC_ORI, fo)):
                        hist[ir, ic, io] += m * wr * wc * wo
    v = hist.reshape(-1)
    n = np.linalg.norm(v)
    if n > 0:
        v = v / n
    v = np.minimum(v, 0.2)
    n = np.linalg.norm(v)
    if n > 0:
        v = v / n
    return np.minimum(512.0 * v, 255.0).astype(np.uint8)


# ----------------------------------------------------------------------------
# Full pipeline (reference: SiftPlan.keypoints)
# ----------------------------------------------------------------------------

def sift_numpy(img: np.ndarray, cfg: SiftConfig | None = None) -> np.ndarray:
    """End-to-end SIFT: returns a structured array of KP_DTYPE records.

    x = column, y = row, in input-image pixel coordinates; scale = absolute
    sigma in input-image coordinates; angle in (-pi, pi].
    """
    cfg = cfg or SiftConfig()
    octaves = build_scale_space(img, cfg)
    records = []
    octsize = 0.5 if cfg.double_im_size else 1.0
    for o, (blurs, dogs) in enumerate(octaves):
        cands = local_maxmin(dogs, cfg, o)
        grads = {}
        for s, r, c in cands:
            ref = interp_keypoint(dogs, int(s), int(r), int(c), cfg)
            if ref is None:
                continue
            _, fs, fr, fc = ref
            sigma_oct = cfg.init_sigma * (2.0 ** (fs / cfg.scales))
            if s not in grads:
                grads[s] = gradient(blurs[s])
            mag, orim = grads[s]
            for ang in orientation(mag, orim, fr, fc, sigma_oct, cfg):
                desc = descriptor(mag, orim, fr, fc, sigma_oct, ang, cfg)
                rec = np.zeros((), dtype=KP_DTYPE)
                rec["x"] = fc * octsize
                rec["y"] = fr * octsize
                rec["scale"] = sigma_oct * octsize
                rec["angle"] = ang
                rec["desc"] = desc
                records.append(rec)
        octsize *= 2.0
    if not records:
        return np.zeros((0,), dtype=KP_DTYPE)
    return np.stack(records).view(KP_DTYPE).reshape(-1)


def match_keypoint_sets(a, b, tol_xy=0.1, tol_s=0.05, tol_a=0.05):
    """Set-based keypoint comparison (reference test strategy, SURVEY.md §4:
    sorted/greedy matching because ordering is nondeterministic upstream).

    Greedy nearest-(x, y) pairing of each record of `a` with an unused
    record of `b`; a pair counts when x+y distance < tol_xy, |dscale| <
    tol_s and the circular angle difference < tol_a.  Returns (n_matched,
    mean_desc_l1) for reference records a vs candidate b, the L1 being the
    per-byte mean on the uint8 scale.
    """
    used = np.zeros(len(b), bool)
    hits = 0
    desc_l1 = []
    for i in range(len(a)):
        d = np.abs(b["x"] - a["x"][i]) + np.abs(b["y"] - a["y"][i])
        d = np.where(used, np.inf, d)
        if len(d) == 0:
            break
        j = int(np.argmin(d))
        da = abs(b["angle"][j] - a["angle"][i])
        da = min(da, 2 * np.pi - da)
        if (
            d[j] < tol_xy
            and abs(b["scale"][j] - a["scale"][i]) < tol_s
            and da < tol_a
        ):
            used[j] = True
            hits += 1
            desc_l1.append(
                np.abs(
                    b["desc"][j].astype(int) - a["desc"][i].astype(int)
                ).mean()
            )
    return hits, (float(np.mean(desc_l1)) if desc_l1 else 0.0)


# ----------------------------------------------------------------------------
# Matching (reference: matching_*.cl::matching, match.py::MatchPlan)
# ----------------------------------------------------------------------------

def match_descriptors(
    desc1: np.ndarray, desc2: np.ndarray, ratio_sq: float = 0.5329
) -> np.ndarray:
    """Brute-force L1 matching with Lowe ratio test on distance quotient.

    desc1 (N1,128) u8, desc2 (N2,128) u8.  For each row of desc1, find the two
    smallest L1 distances d1<=d2 in desc2; keep the pair if d1 < ratio_sq*d2.
    Returns int32 (M,2) of (i1, i2).  ratio_sq default 0.5329 = 0.73^2
    (reference: match.py ratio threshold).
    """
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros((0, 2), dtype=np.int32)
    a = desc1.astype(np.int32)
    b = desc2.astype(np.int32)
    out = []
    for i in range(a.shape[0]):
        d = np.abs(a[i][None, :] - b).sum(axis=1)
        if d.shape[0] < 2:
            continue
        j = int(np.argmin(d))
        d1 = d[j]
        d[j] = np.iinfo(np.int32).max
        d2 = d.min()
        if d2 > 0 and d1 < ratio_sq * d2:
            out.append((i, j))
    return np.array(out, dtype=np.int32).reshape(-1, 2)


# ----------------------------------------------------------------------------
# Affine warp (reference: transform.cl::transform)
# ----------------------------------------------------------------------------

def affine_warp(
    img: np.ndarray, matrix: np.ndarray, offset: np.ndarray, fill: float = 0.0
) -> np.ndarray:
    """Bilinear inverse-warp: out[r,c] = img[M@(r,c)+offset], fill outside."""
    H, W = img.shape
    rr, cc = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # f32 coordinate math, matching ops/transform.py exactly
    src = np.tensordot(
        matrix.astype(np.float32), np.stack([rr, cc]).astype(np.float32), axes=(1, 0)
    )
    sr = (src[0] + np.float32(offset[0])).astype(np.float32)
    sc = (src[1] + np.float32(offset[1])).astype(np.float32)
    r0 = np.floor(sr).astype(int)
    c0 = np.floor(sc).astype(int)
    fr = (sr - r0).astype(np.float32)
    fc = (sc - c0).astype(np.float32)
    valid = (sr >= 0) & (sr <= H - 1) & (sc >= 0) & (sc <= W - 1)
    r0c = np.clip(r0, 0, H - 1)
    r1c = np.clip(r0 + 1, 0, H - 1)
    c0c = np.clip(c0, 0, W - 1)
    c1c = np.clip(c0 + 1, 0, W - 1)
    out = (
        img[r0c, c0c] * (1 - fr) * (1 - fc)
        + img[r1c, c0c] * fr * (1 - fc)
        + img[r0c, c1c] * (1 - fr) * fc
        + img[r1c, c1c] * fr * fc
    )
    return np.where(valid, out, fill).astype(np.float32)

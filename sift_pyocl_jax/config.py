"""Configuration for the SIFT pipeline.

This is the JAX replacement for the reference's mutable module-level
parameter dict (reference: ``sift-src/param.py::par``).  Field names and
defaults mirror the reference exactly so that parity tests and user code can
translate 1:1; the dataclass is frozen because everything downstream is traced
into jitted XLA programs keyed on these values (compile-once semantics, the
plan idiom of ``sift-src/plan.py::SiftPlan`` re-expressed as static trace-time
configuration).

NOTE ON PROVENANCE: the reference mount was empty this session (see
SURVEY.md header); defaults follow SURVEY.md §2.1 which reconstructs
``sift-src/param.py`` from the public sift_pyocl / silx.opencl.sift sources
and the IPOL ASIFT ``sift.cpp`` they follow.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """Static SIFT pipeline parameters (reference: sift-src/param.py::par)."""

    # --- reference `par` fields (same names modulo snake_case, same defaults) ---
    double_im_size: bool = False        # par.DoubleImSize
    init_sigma: float = 1.6             # par.InitSigma
    border_dist: int = 5                # par.BorderDist
    scales: int = 3                     # par.Scales (S intervals per octave)
    peak_thresh: float = 255.0 * 0.04 / 3.0   # par.PeakThresh (on [0,255] data)
    edge_thresh: float = 0.06           # par.EdgeThresh   (octaves > 0)
    edge_thresh1: float = 0.08          # par.EdgeThresh1  (first octave, octsize<=1)
    match_ratio: float = 0.73           # par.MatchRatio (Lowe ratio)
    orig_sigma: float = 0.5             # assumed blur of the raw input image

    # --- plan-level knobs (reference: SiftPlan ctor kwargs) ---
    pix_per_kp: int = 10                # PIX_PER_KP: capacity heuristic npix/PIX_PER_KP
    downsample_mode: str = "shrink"     # octave downsample: "shrink" (every
                                        # other pixel, preprocess.cl::shrink)
                                        # | "bin" (2x2 mean, preprocess.cl::bin)

    # --- static-shape capacities (no reference analog:
    #     they replace the reference's atomic counters + device->host readbacks,
    #     SURVEY.md §3.2 hot-loop note) ---
    kp_per_octave_cap: int = 2048       # static keypoint capacity per octave
    ori_window: int = 40                # static orientation gather window (px)
    desc_window: int = 80               # static descriptor gather window (px)
    max_interp_moves: int = 5           # iterative subpixel refinement moves
    max_ori: int = 2                    # orientation peaks kept per keypoint
                                        # (reference spawns every >=0.8*max
                                        # peak; >2 is rare — raise if needed)
    min_octave_size: int = 2 * 5 + 3    # stop octaves when min dim <= this

    # --- derived helpers (pure functions of config + image shape) ---

    @property
    def n_scale_imgs(self) -> int:
        """Blur images per octave: s = 0 .. scales+2  (reference: _calc_scales)."""
        return self.scales + 3

    @property
    def n_dogs(self) -> int:
        """DoG images per octave."""
        return self.scales + 2

    def sigma_ladder(self) -> Tuple[float, ...]:
        """Absolute blur of each scale image in octave coordinates."""
        return tuple(
            self.init_sigma * (2.0 ** (s / self.scales))
            for s in range(self.n_scale_imgs)
        )

    def sigma_increments(self) -> Tuple[float, ...]:
        """Incremental blur applied between scale s-1 and s (len = scales+2)."""
        lad = self.sigma_ladder()
        return tuple(
            math.sqrt(lad[s] ** 2 - lad[s - 1] ** 2)
            for s in range(1, self.n_scale_imgs)
        )

    def n_octaves(self, shape: Tuple[int, int]) -> int:
        """Octave count for an image shape (after optional doubling).

        Reference (SiftPlan._calc_scales): halve until the min dimension is too
        small relative to BorderDist; we keep an octave while its min dim
        exceeds 2*border_dist + 3 so a 26-neighborhood inside the border fits.
        """
        h, w = shape
        if self.double_im_size:
            h, w = 2 * h, 2 * w
        n = 0
        while min(h, w) > self.min_octave_size:
            n += 1
            h, w = h // 2, w // 2
        return max(n, 1)

    def kp_capacity(self, shape: Tuple[int, int]) -> int:
        """Total keypoint capacity for an image (reference: npix // PIX_PER_KP)."""
        h, w = shape
        if self.double_im_size:
            h, w = 2 * h, 2 * w
        return max(h * w // self.pix_per_kp, self.kp_per_octave_cap)


# Legacy-style view for API parity with `from sift import par`.
DEFAULT_CONFIG = SiftConfig()

par = {
    "DoubleImSize": DEFAULT_CONFIG.double_im_size,
    "InitSigma": DEFAULT_CONFIG.init_sigma,
    "BorderDist": DEFAULT_CONFIG.border_dist,
    "Scales": DEFAULT_CONFIG.scales,
    "PeakThresh": DEFAULT_CONFIG.peak_thresh,
    "EdgeThresh": DEFAULT_CONFIG.edge_thresh,
    "EdgeThresh1": DEFAULT_CONFIG.edge_thresh1,
    "MatchRatio": DEFAULT_CONFIG.match_ratio,
    "OrigSigma": DEFAULT_CONFIG.orig_sigma,
}


def config_from_par(p=None, **overrides) -> SiftConfig:
    """Build a SiftConfig from a reference-style `par` dict (API bridge)."""
    p = dict(par if p is None else p)
    mapping = {
        "DoubleImSize": "double_im_size",
        "InitSigma": "init_sigma",
        "BorderDist": "border_dist",
        "Scales": "scales",
        "PeakThresh": "peak_thresh",
        "EdgeThresh": "edge_thresh",
        "EdgeThresh1": "edge_thresh1",
        "MatchRatio": "match_ratio",
        "OrigSigma": "orig_sigma",
    }
    kwargs = {mapping[k]: v for k, v in p.items() if k in mapping}
    kwargs["double_im_size"] = bool(kwargs.get("double_im_size", False))
    kwargs.update(overrides)
    return SiftConfig(**kwargs)

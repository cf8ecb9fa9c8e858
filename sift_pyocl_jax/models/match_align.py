"""MatchPlan and LinearAlign public APIs.

API parity with the reference's matcher and aligner
(reference: sift-src/match.py::MatchPlan, sift-src/alignment.py::LinearAlign —
SURVEY.md §2.1/§3.3/§3.4).  `LinearAlign` is also the seed of the SfM
front-end: keypoints -> matches -> robust model fit -> warp.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import SiftConfig
from ..oracle import KP_DTYPE
from ..ops.match import match_descriptors_jax
from ..ops.transform import affine_warp_jax
from .sift import SiftPlan


class MatchPlan:
    """Brute-force descriptor matcher (reference: match.py::MatchPlan).

    The reference pre-allocates buffers of `size` keypoints and compiles its
    kernels once; the same compile-once semantics hold here: inputs are
    zero-padded (with a validity mask) to the ctor `size`, so every call at
    or below `size` reuses ONE compiled XLA program.  Larger inputs bucket
    to the next power of two (one extra compile per bucket, not per size).
    `match` returns an (M, 2) structured array of matched keypoint record
    pairs, like the reference.
    """

    def __init__(self, size: int = 16384, devicetype: str = "GPU",
                 ratio_th: float = 0.5329, metric: str = "L1",
                 match_xradius: Optional[float] = None,
                 match_yradius: Optional[float] = None, **_ignored):
        self.size = size
        self.ratio_th = float(ratio_th)
        self.metric = metric
        # reference: par.MatchXradius / par.MatchYradius spatial gating
        self.match_xradius = match_xradius
        self.match_yradius = match_yradius
        self.roi = None

    def set_roi(self, roi: np.ndarray):
        """Restrict set-1 keypoints to a region of interest
        (reference: match.py::MatchPlan.set_roi — nonzero mask image)."""
        self.roi = None if roi is None else np.asarray(roi) != 0

    def unset_roi(self):
        self.roi = None

    def _roi_mask(self, kp: np.ndarray) -> np.ndarray:
        if self.roi is None:
            return np.ones(len(kp), dtype=bool)
        r = np.clip(kp["y"].astype(int), 0, self.roi.shape[0] - 1)
        c = np.clip(kp["x"].astype(int), 0, self.roi.shape[1] - 1)
        return self.roi[r, c]

    def _padded(self, kp: np.ndarray, mask: np.ndarray):
        """Zero-pad records to a stable compile footprint: power-of-two
        buckets (>=128) capped at the ctor `size`, so all calls at or below
        `size` share at most log2(size) compiled programs — the functional
        analog of the reference's compile-once preallocated buffers."""
        n = len(kp)
        bucket = 1 << max(7, (n - 1).bit_length())
        cap = min(bucket, self.size) if self.size >= n else bucket
        desc = np.zeros((cap, 128), np.uint8)
        desc[:n] = kp["desc"]
        m = np.zeros(cap, bool)
        m[:n] = mask
        xy = np.zeros((cap, 2), np.float32)
        xy[:n, 0] = kp["x"]
        xy[:n, 1] = kp["y"]
        return desc, m, xy

    def match_index(self, kp1: np.ndarray, kp2: np.ndarray) -> np.ndarray:
        """(M, 2) int32 indices of matches between two KP_DTYPE arrays."""
        if len(kp1) == 0 or len(kp2) == 0:
            return np.zeros((0, 2), dtype=np.int32)
        d1, m1, xy1 = self._padded(kp1, self._roi_mask(kp1))
        d2, m2, xy2 = self._padded(kp2, np.ones(len(kp2), dtype=bool))
        kwargs = {}
        if self.match_xradius is not None or self.match_yradius is not None:
            kwargs = dict(
                xy1=jnp.asarray(xy1),
                xy2=jnp.asarray(xy2),
                xy_radius=(
                    float(self.match_xradius or np.inf),
                    float(self.match_yradius or np.inf),
                ),
            )
        res = match_descriptors_jax(
            jnp.asarray(d1),
            jnp.asarray(m1),
            jnp.asarray(d2),
            jnp.asarray(m2),
            metric=self.metric,
            ratio_sq=self.ratio_th,
            **kwargs,
        )
        m = np.asarray(res.valid)
        return np.stack(
            [np.asarray(res.idx1)[m], np.asarray(res.idx2)[m]], axis=1
        ).astype(np.int32)

    def match(self, kp1: np.ndarray, kp2: np.ndarray) -> np.ndarray:
        idx = self.match_index(kp1, kp2)
        out = np.zeros((len(idx), 2), dtype=KP_DTYPE)
        if len(idx):
            out[:, 0] = kp1[idx[:, 0]]
            out[:, 1] = kp2[idx[:, 1]]
        return out

    __call__ = match


def fit_affine(dst: np.ndarray, src: np.ndarray):
    """Least-squares affine fit: dst ≈ matrix @ src + offset.

    (reference: alignment.py CPU lstsq step, SURVEY.md §3.4.)
    dst/src are (N, 2) arrays of (row, col).
    """
    n = len(dst)
    A = np.zeros((2 * n, 6), dtype=np.float64)
    b = np.zeros(2 * n, dtype=np.float64)
    A[0::2, 0] = src[:, 0]
    A[0::2, 1] = src[:, 1]
    A[0::2, 4] = 1.0
    A[1::2, 2] = src[:, 0]
    A[1::2, 3] = src[:, 1]
    A[1::2, 5] = 1.0
    b[0::2] = dst[:, 0]
    b[1::2] = dst[:, 1]
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    matrix = np.array([[sol[0], sol[1]], [sol[2], sol[3]]])
    offset = np.array([sol[4], sol[5]])
    return matrix, offset


class LinearAlign:
    """Align images to a reference image (reference: alignment.py::LinearAlign).

    Pipeline: SIFT keypoints on the reference at init; per `align(img)` call:
    keypoints -> ratio-test matches -> (shift-only mean or affine lstsq) ->
    bilinear warp on device.
    """

    def __init__(self, image: np.ndarray, config: Optional[SiftConfig] = None,
                 devicetype: str = "GPU", **_ignored):
        self.ref_image = np.asarray(image)
        self.shape = self.ref_image.shape[:2]
        self.cfg = config or SiftConfig()
        self.sift = SiftPlan(shape=self.shape, config=self.cfg)
        self.match_plan = MatchPlan()
        self.ref_kp = self.sift.keypoints(self.ref_image)
        # accumulated transform for relative mode (reference: alignment.py
        # `relative` kwarg — align each frame against the PREVIOUS one and
        # compose, for drifting video)
        self._rel_matrix = np.eye(2)
        self._rel_offset = np.zeros(2)

    def align(
        self,
        img: np.ndarray,
        shift_only: bool = False,
        return_all: bool = False,
        relative: bool = False,
        double_check: bool = False,
        orsa: bool = False,
        seed: int = 0,
    ):
        """Warp `img` onto the reference frame.  Returns the warped image, or
        a dict with (result, matrix, offset, matches) when return_all.

        double_check: symmetric matching — keep only pairs that also win the
        reverse-direction ratio test (reference kwarg).
        relative: fit against the previous frame's keypoints and compose the
        transform (video stabilization mode; reference kwarg).
        orsa: robust outlier rejection.  The reference accepted this kwarg
        but never implemented it (SURVEY.md §2.3 *(verify)*); here it runs a
        real RANSAC affine fit (sfm.ransac.ransac_affine) and keeps only the
        inlier matches before the final fit — a strict improvement with the
        same signature.
        seed: RANSAC sampling seed for orsa (deterministic per value; vary
        it if a draw is unlucky for a given scene).
        """
        base_kp = self.ref_kp
        kp = self.sift.keypoints(np.asarray(img))
        idx = self.match_plan.match_index(base_kp, kp)
        if double_check and len(idx):
            rev = self.match_plan.match_index(kp, base_kp)
            fwd = {(int(a), int(b)) for a, b in idx}
            idx = np.array(
                [[b, a] for a, b in rev if (int(b), int(a)) in fwd],
                dtype=np.int32,
            ).reshape(-1, 2)
        if len(idx) < (1 if shift_only else 3):
            return None
        p_ref = np.stack(
            [base_kp["y"][idx[:, 0]], base_kp["x"][idx[:, 0]]], axis=1
        )
        p_img = np.stack([kp["y"][idx[:, 1]], kp["x"][idx[:, 1]]], axis=1)
        if orsa and len(idx) >= 4:
            import jax

            from ..sfm.ransac import ransac_affine

            res = ransac_affine(
                jax.random.PRNGKey(seed),
                jnp.asarray(p_ref, jnp.float32),
                jnp.asarray(p_img, jnp.float32),
                jnp.ones(len(idx), bool),
            )
            inl = np.asarray(res.inliers)
            # require a real consensus set even in shift_only mode: a median
            # over all matches beats a "median" of 1-2 RANSAC stragglers
            if inl.sum() >= 3:
                idx, p_ref, p_img = idx[inl], p_ref[inl], p_img[inl]
        # the warp samples img at M @ (ref coords) + offset, so fit the
        # ref -> img mapping: p_img ≈ M @ p_ref + offset
        if shift_only:
            matrix = np.eye(2)
            # median, not mean: a single bad ratio-test match otherwise drags
            # the shift (deliberate robustness improvement over the reference)
            offset = np.median(p_img - p_ref, axis=0)
        else:
            matrix, offset = fit_affine(p_img, p_ref)
        if relative:
            # the fit maps previous-frame coords -> img; compose with the
            # accumulated ref -> previous transform, and make this frame the
            # next anchor:  p_img = A (A_acc p_ref + b_acc) + b
            matrix, offset = (
                np.asarray(matrix) @ self._rel_matrix,
                np.asarray(matrix) @ self._rel_offset + np.asarray(offset),
            )
            self._rel_matrix = np.asarray(matrix)
            self._rel_offset = np.asarray(offset)
            self.ref_kp = kp
        warped = np.asarray(
            affine_warp_jax(
                jnp.asarray(img, dtype=jnp.float32),
                jnp.asarray(matrix),
                jnp.asarray(offset),
            )
        )
        if return_all:
            return {
                "result": warped,
                "matrix": matrix,
                "offset": offset,
                "matches": idx,
            }
        return warped

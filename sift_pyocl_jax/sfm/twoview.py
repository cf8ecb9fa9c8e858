"""Two-view initialization: relative pose + initial structure.

New subsystem per BASELINE.json ("two-view geometry ... essential"), seeded
from the SIFT matcher the same way LinearAlign chains keypoints -> matches ->
model fit (SURVEY.md §3.4), but with a metric pose instead of an affine warp.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .geometry import (
    backproject,
    choose_pose,
    decompose_essential,
    sampson_error_F,
    triangulate_two_view,
)
from .ransac import ransac_essential_normalized


class TwoViewInit(NamedTuple):
    R: jnp.ndarray          # (3,3) pose of cam2 (cam1 = identity)
    t: jnp.ndarray          # (3,) unit-norm translation (scale is free)
    points: jnp.ndarray     # (N,3) triangulated points (world = cam1 frame)
    inliers: jnp.ndarray    # (N,) bool: essential inliers with positive depths
    n_inliers: jnp.ndarray  # () int32


@partial(jax.jit, static_argnames=("thresh_px", "n_hypo", "min_parallax_deg"))
def initialize_two_view(
    key: jax.Array,
    K: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    thresh_px: float = 1.5,
    n_hypo: int = 256,
    min_parallax_deg: float = 0.0,
) -> TwoViewInit:
    """Essential RANSAC -> cheirality-tested pose -> triangulated structure.

    All static shapes: outputs are (N,3)/(N,) with validity masks.  Jitted
    as ONE program: called eagerly this chains ~25 individual device
    dispatches per bootstrap candidate.
    """
    f = 0.5 * (K[0, 0] + K[1, 1])
    xy1 = backproject(K, uv1)[:, :2]
    xy2 = backproject(K, uv2)[:, :2]
    res = ransac_essential_normalized(
        key, xy1, xy2, valid, thresh=(thresh_px / f) ** 2, n_hypo=n_hypo
    )
    E = res.model  # already rank-2, ~unit norm on normalized coords
    Rs, ts = decompose_essential(E)
    Kn = jnp.eye(3)
    R, t, _ = choose_pose(
        Rs, ts, Kn, Kn, xy1, xy2, res.inliers.astype(jnp.float32)
    )
    I = jnp.eye(3)
    z3 = jnp.zeros(3)
    X, z1, z2 = triangulate_two_view(Kn, I, z3, Kn, R, t, xy1, xy2)
    good = res.inliers & (z1 > 1e-6) & (z2 > 1e-6)
    # reproject-check in pixels with the real K
    err = sampson_error_F(E, xy1, xy2) * f * f
    good = good & (err < thresh_px**2)
    return TwoViewInit(R, t, X, good, jnp.sum(good))

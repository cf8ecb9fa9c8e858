"""Static-shape batched RANSAC in JAX.

New subsystem (no reference counterpart — the reference's `orsa` kwarg is a
stub, SURVEY.md §2.3).  Design: all hypotheses are generated and
scored in one batched program — `n_hypo` minimal samples drawn with masked
Gumbel top-k (valid-only, without replacement), models fit with vmapped
weighted DLT, errors scored as one (n_hypo, N) matrix, winner refit on its
inlier set.  No data-dependent shapes anywhere.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: jnp.ndarray      # fitted model (refit on inliers)
    inliers: jnp.ndarray    # (N,) bool
    n_inliers: jnp.ndarray  # () int32
    best_score: jnp.ndarray # () int32 inlier count of the winning hypothesis


def _sample_weights(key, valid: jnp.ndarray, n_hypo: int, k: int) -> jnp.ndarray:
    """(n_hypo, N) 0/1 weight rows, each selecting k distinct valid indices.

    Masked Gumbel top-k: iid gumbel noise per entry, invalid entries at -inf;
    the k largest are a uniform without-replacement sample of the valid set.
    """
    n = valid.shape[0]
    g = jax.random.gumbel(key, (n_hypo, n))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, k)  # (n_hypo, k)
    w = jax.nn.one_hot(idx, n, dtype=jnp.float32).sum(axis=1)
    return w


def ransac(
    key: jax.Array,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    fit_fn: Callable,      # (uv1, uv2, w) -> model
    error_fn: Callable,    # (model, uv1, uv2) -> (N,) squared error
    min_samples: int,
    thresh: float,
    n_hypo: int = 256,
) -> RansacResult:
    """Generic batched RANSAC over (N,2)x(N,2) correspondences."""
    w = _sample_weights(key, valid, n_hypo, min_samples)
    models = jax.vmap(lambda wi: fit_fn(uv1, uv2, wi))(w)
    errs = jax.vmap(lambda m: error_fn(m, uv1, uv2))(models)  # (n_hypo, N)
    inl = (errs < thresh) & valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    best_in = inl[best]
    # refit on the winning inlier set (guard: need >= min_samples)
    enough = scores[best] >= min_samples
    refit_w = jnp.where(enough, best_in.astype(jnp.float32), w[best])
    model = fit_fn(uv1, uv2, refit_w)
    final_err = error_fn(model, uv1, uv2)
    final_in = (final_err < thresh) & valid
    # keep the better of refit vs raw winner (refit can rarely degrade)
    use_refit = jnp.sum(final_in) >= scores[best]
    model = jax.tree.map(
        lambda a, b: jnp.where(use_refit, a, b), model, jax.tree.map(lambda m: m[best], models)
    )
    inliers = jnp.where(use_refit, final_in, best_in)
    return RansacResult(model, inliers, jnp.sum(inliers), scores[best])


def ransac_homography(key, uv1, uv2, valid, thresh_px: float = 3.0, n_hypo: int = 256):
    """RANSAC homography (BASELINE.json config 2)."""
    from .geometry import fit_homography, homography_error

    return ransac(
        key, uv1, uv2, valid,
        fit_homography, homography_error,
        min_samples=4, thresh=thresh_px**2, n_hypo=n_hypo,
    )


def _fit_affine_weighted(uv1, uv2, w):
    """Weighted lstsq affine uv2 ≈ M @ uv1 + t, returned as a (2, 3) [M | t].

    Normal-equation solve so it vmaps over RANSAC hypothesis weight rows.
    Points are Hartley-normalized first (matching fit_homography) so the
    normal equations stay well-conditioned at any pixel scale, and the 1e-6
    ridge — now against O(1) entries — genuinely keeps degenerate
    (collinear) samples finite; they then simply score few inliers.
    """
    from .geometry import _normalize_points

    p1, T1 = _normalize_points(uv1, w)
    p2, T2 = _normalize_points(uv2, w)
    x = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)  # (N, 3)
    xw = x * w[:, None]
    ata = x.T @ xw + 1e-6 * jnp.eye(3, dtype=uv1.dtype)
    atb = xw.T @ p2  # (3, 2)
    sol = jnp.linalg.solve(ata, atb)  # (3, 2): rows [M.T ; t] in norm coords
    an = jnp.concatenate(
        [sol.T, jnp.array([[0.0, 0.0, 1.0]], dtype=uv1.dtype)], axis=0
    )  # (3, 3) homogeneous affine, normalized frame
    # denormalize: [uv2;1] = T2^-1 @ An @ T1 @ [uv1;1]
    full = jnp.linalg.solve(T2.astype(uv1.dtype), an @ T1.astype(uv1.dtype))
    return full[:2]  # (2, 3)


def _affine_error(model, uv1, uv2):
    pred = uv1 @ model[:, :2].T + model[:, 2]
    return jnp.sum((pred - uv2) ** 2, axis=1)


def ransac_affine(key, uv1, uv2, valid, thresh_px: float = 3.0,
                  n_hypo: int = 256):
    """RANSAC 2-D affine fit uv2 ≈ M @ uv1 + t (model: (2, 3) [M | t]).

    Backs `LinearAlign(orsa=True)`: the reference's `orsa` kwarg was a stub
    (SURVEY.md §2.3 *(verify)*); here it performs real robust outlier
    rejection before the final fit.
    """
    return ransac(
        key, uv1, uv2, valid,
        _fit_affine_weighted, _affine_error,
        min_samples=3, thresh=thresh_px**2, n_hypo=n_hypo,
    )


def ransac_essential_normalized(key, xy1, xy2, valid, thresh: float = 1e-4,
                                n_hypo: int = 256):
    """RANSAC essential matrix on K-normalized image coordinates.

    xy* are backprojected rays' (x, y) at z=1; `thresh` is squared Sampson
    error in normalized units ((px_err/f)^2 scale).
    """
    from .geometry import fit_fundamental_8pt, sampson_error_F

    return ransac(
        key, xy1, xy2, valid,
        fit_fundamental_8pt, sampson_error_F,
        min_samples=8, thresh=thresh, n_hypo=n_hypo,
    )

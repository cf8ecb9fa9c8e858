"""Brute-force descriptor matching as tiled on-device reductions.

JAX replacement for the reference's matching kernels
(reference: openCL/matching_cpu.cl / matching_gpu.cl::matching and
sift-src/match.py::MatchPlan — SURVEY.md §2.2/§3.3).  The reference scans
set2 once per set1 keypoint inside a workgroup, appending passing pairs with
atomics; here the all-pairs distance matrix is computed in static tiles with a
`lax.scan` keeping a running (best, second-best) per query row — no atomics,
one fused jit program.

Two distance modes:
  * "L1"  — parity mode, the reference metric: sum |a-b| on uint8 descriptors,
    computed in int32 tiles.
  * "L2"  — fast mode: squared euclidean via ||a||^2+||b||^2-2ab, the 2ab term
    a single (N1,128)x(128,N2) matmul.  Ranking differs from L1 only in rare
    near-tie cases.  On a CUDA GPU, uint8 descriptors go through the fused
    best-2 kernel (ops/pallas/matchk.py); elsewhere, and for f32
    descriptors, through the plain XLA reduction `_best2_l2`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .pallas.matchk import best2_l2_triton

INT_MAX = np.int32(2**31 - 1)


class MatchResult(NamedTuple):
    idx1: jnp.ndarray    # (cap,) int32 indices into set 1
    idx2: jnp.ndarray    # (cap,) int32 indices into set 2
    dist: jnp.ndarray    # (cap,) f32 best distance
    valid: jnp.ndarray   # (cap,) bool
    count: jnp.ndarray   # () int32 true number of matches


def _best2_l1(desc1: jnp.ndarray, desc2: jnp.ndarray, valid2: jnp.ndarray,
              tile: int = 512):
    """Running (best, second-best, argbest) of L1 distances per row of desc1."""
    n1 = desc1.shape[0]
    n2 = desc2.shape[0]
    pad2 = (-n2) % tile
    d2p = jnp.pad(desc2, ((0, pad2), (0, 0)))
    v2p = jnp.pad(valid2, (0, pad2))
    n_tiles = d2p.shape[0] // tile
    a = desc1.astype(jnp.int32)

    def step(carry, t):
        d1, d2, i1 = carry
        b = lax.dynamic_slice(d2p, (t * tile, 0), (tile, 128)).astype(jnp.int32)
        vb = lax.dynamic_slice(v2p, (t * tile,), (tile,))
        dist = jnp.sum(jnp.abs(a[:, None, :] - b[None, :, :]), axis=-1)  # (n1, tile)
        dist = jnp.where(vb[None, :], dist, INT_MAX)
        m1 = jnp.min(dist, axis=1)
        am1 = jnp.argmin(dist, axis=1).astype(jnp.int32)
        dist2 = jnp.where(
            jax.nn.one_hot(am1, tile, dtype=jnp.bool_), INT_MAX, dist
        )
        m2 = jnp.min(dist2, axis=1)
        gi = t * tile + am1
        better = m1 < d1
        nd2 = jnp.where(better, jnp.minimum(d1, m2), jnp.minimum(d2, m1))
        nd1 = jnp.where(better, m1, d1)
        ni1 = jnp.where(better, gi, i1)
        return (nd1, nd2, ni1), None

    init = (
        jnp.full((n1,), INT_MAX, jnp.int32),
        jnp.full((n1,), INT_MAX, jnp.int32),
        jnp.zeros((n1,), jnp.int32),
    )
    (d1, d2, i1), _ = lax.scan(step, init, jnp.arange(n_tiles))
    return d1.astype(jnp.float32), d2.astype(jnp.float32), i1


def _best2_l2(desc1: jnp.ndarray, desc2: jnp.ndarray, valid2: jnp.ndarray):
    """(best, second-best, argbest) of squared-L2 distances via one matmul.

    The plain reference of the fused kernel: materializes the (N1, N2)
    distance matrix, then min / argmin (first occurrence) / min excluding
    the argmin column.  Runs in f32 at the package's "highest" matmul
    precision, so uint8 descriptors give exact integer distances.
    """
    a = desc1.astype(jnp.float32)
    b = desc2.astype(jnp.float32)
    ab = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    na = jnp.sum(a * a, axis=1)
    nb = jnp.sum(b * b, axis=1)
    dist = na[:, None] + nb[None, :] - 2.0 * ab
    dist = jnp.where(valid2[None, :], jnp.maximum(dist, 0.0), jnp.inf)
    d1 = jnp.min(dist, axis=1)
    a1 = jnp.argmin(dist, axis=1).astype(jnp.int32)
    col = lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    d2 = jnp.min(jnp.where(col == a1[:, None], jnp.inf, dist), axis=1)
    return d1, d2, a1


def _best2_l2_auto(desc1, desc2, valid2):
    """L2 best-2: the fused Triton kernel where the program is lowered for a
    CUDA GPU and both descriptor sets are uint8, `_best2_l2` otherwise.

    The choice is made per lowering platform (`lax.platform_dependent`), so
    one traced function serves a GPU and a CPU compile alike.
    """
    if desc1.dtype != jnp.uint8 or desc2.dtype != jnp.uint8:
        return _best2_l2(desc1, desc2, valid2)
    return lax.platform_dependent(desc1, desc2, valid2,
                                  cuda=best2_l2_triton, default=_best2_l2)


@partial(jax.jit, static_argnames=("metric", "ratio_sq"))
def match_descriptors_dense(
    desc1: jnp.ndarray,
    valid1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid2: jnp.ndarray,
    metric: str = "L2",
    ratio_sq: float = 0.5329,
):
    """Per-slot (uncompacted) ratio-test matching.

    Returns (keep (N1,) bool, idx2 (N1,) int32, dist (N1,) f32, dist2 (N1,)
    f32) aligned with desc1's slots — the scatter-free form used by the
    fused VO step, where downstream selection happens with top_k instead of
    nonzero.  dist2 (second-best distance) lets callers re-gate with a
    looser ratio for free (VO re-localization).
    """
    if metric == "L1":
        d1, d2, i1 = _best2_l1(desc1, desc2, valid2)
    elif metric == "L2":
        d1, d2, i1 = _best2_l2_auto(desc1, desc2, valid2)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    finite = d2 < jnp.float32(INT_MAX)
    keep = valid1 & finite & (d2 > 0) & (d1 < ratio_sq * d2)
    return keep, i1, d1, d2


@partial(jax.jit, static_argnames=("metric", "ratio_sq", "xy_radius"))
def match_descriptors_jax(
    desc1: jnp.ndarray,
    valid1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid2: jnp.ndarray,
    metric: str = "L1",
    ratio_sq: float = 0.5329,
    xy1: jnp.ndarray = None,
    xy2: jnp.ndarray = None,
    xy_radius: Tuple[float, float] = None,
) -> MatchResult:
    """Ratio-test matching into a static-capacity pair buffer.

    Semantics follow oracle.match_descriptors: for each valid row of desc1,
    the two smallest distances d1<=d2 among valid rows of desc2; keep if
    d2 > 0 and d1 < ratio_sq * d2.  Capacity = len(desc1) (each query yields
    at most one match, so this never overflows).

    xy_radius=(xr, yr) with xy1/xy2 (N,2) enables the reference's spatial
    gating (reference: matching*.cl MatchXradius/MatchYradius): a pair only
    counts if |x1-x2| < xr and |y1-y2| < yr, applied to the BEST match like
    the reference (candidate ranking itself is by descriptor distance).
    """
    if metric == "L1":
        d1, d2, i1 = _best2_l1(desc1, desc2, valid2)
    elif metric == "L2":
        d1, d2, i1 = _best2_l2_auto(desc1, desc2, valid2)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    finite = d2 < jnp.float32(INT_MAX)  # at least two valid candidates
    keep = valid1 & finite & (d2 > 0) & (d1 < ratio_sq * d2)
    if xy_radius is not None:
        dxy = jnp.abs(xy1 - xy2[i1])
        keep = keep & (dxy[:, 0] < xy_radius[0]) & (dxy[:, 1] < xy_radius[1])
    cap = desc1.shape[0]
    count = jnp.sum(keep.astype(jnp.int32))
    (sel,) = jnp.nonzero(keep, size=cap, fill_value=-1)
    valid = sel >= 0
    sel = jnp.maximum(sel, 0)
    return MatchResult(
        idx1=sel.astype(jnp.int32),
        idx2=i1[sel],
        dist=d1[sel],
        valid=valid,
        count=count,
    )

"""Fused best-2 descriptor matching: a Pallas kernel on the Triton route.

GPU replacement for the reference's brute-force matching kernel
(reference: openCL/matching_gpu.cl::matching — SURVEY.md §2.2), fast L2
mode.  The plain form (ops/match.py::_best2_l2) writes the whole (N1, N2)
f32 distance matrix to device memory and reads it back three times (min,
argmin, masked second min): 277 MB per pass at 8,320 x 8,320 slots.  Here
each program owns BLOCK_M query rows, walks set 2 in BLOCK_N-column tiles,
and keeps a running (best, second, argbest) per row in registers, so the
distance matrix never leaves the SM.

Exactness.  Descriptors are uint8, which bf16 holds exactly; the tensor
cores multiply bf16 pairs exactly and accumulate in f32, and every partial
sum is an integer below 2^24, so ||a||^2 + ||b||^2 - 2ab is the same f32
integer as in _best2_l2 whatever the summation order.  Tiles merge exactly
like ops/match.py::_best2_l1: argbest is the first occurrence of the
minimum, and the second best excludes only the argbest column.  Invalid
set-2 columns (and padding) carry +inf in ||b||^2, so their distance is
+inf by arithmetic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

BLOCK_M = 64     # query rows per program
BLOCK_N = 128    # set-2 columns per inner-loop tile
NUM_WARPS = 4
NUM_STAGES = 2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _kernel(a_ref, b_ref, nb_ref, d1_ref, d2_ref, i1_ref, *, n_tiles: int):
    a = a_ref[...]                                   # (BM, 128) bf16
    a32 = a.astype(jnp.float32)
    na = jnp.sum(a32 * a32, axis=1)                  # (BM,)
    bm = a.shape[0]
    big = jnp.int32(2**30)
    col = lax.broadcasted_iota(jnp.int32, (bm, BLOCK_N), 1)

    def tile(j, carry):
        d1, d2, i1 = carry
        b = b_ref[pl.ds(j * BLOCK_N, BLOCK_N), :]    # (BN, 128) bf16
        nb = nb_ref[pl.ds(j * BLOCK_N, BLOCK_N)]     # (BN,) f32, +inf = invalid
        ab = pl.dot(a, b, trans_b=True)              # (BM, BN) f32
        dist = jnp.maximum(na[:, None] + nb[None, :] - 2.0 * ab, 0.0)
        m1 = jnp.min(dist, axis=1)
        am1 = jnp.min(jnp.where(dist == m1[:, None], col, big), axis=1)
        m2 = jnp.min(jnp.where(col == am1[:, None], jnp.inf, dist), axis=1)
        better = m1 < d1
        nd2 = jnp.where(better, jnp.minimum(d1, m2), jnp.minimum(d2, m1))
        return (jnp.where(better, m1, d1), nd2,
                jnp.where(better, j * BLOCK_N + am1, i1))

    init = (jnp.full((bm,), jnp.inf, jnp.float32),
            jnp.full((bm,), jnp.inf, jnp.float32),
            jnp.zeros((bm,), jnp.int32))
    d1, d2, i1 = lax.fori_loop(0, n_tiles, tile, init)
    d1_ref[...] = d1
    d2_ref[...] = d2
    i1_ref[...] = i1


@functools.partial(jax.jit, static_argnames=("interpret",))
def best2_l2_triton(desc1: jnp.ndarray, desc2: jnp.ndarray,
                    valid2: jnp.ndarray, *, interpret: bool = False):
    """(best, second-best, argbest) of squared-L2 distances per desc1 row.

    desc1 (N1,128) uint8, desc2 (N2,128) uint8, valid2 (N2,) bool.  Returns
    (d1 (N1,) f32, d2 (N1,) f32, i1 (N1,) int32), bit-identical to
    ops.match._best2_l2.
    `interpret=True` runs the Pallas interpreter (CPU tests only).
    """
    if desc1.dtype != jnp.uint8 or desc2.dtype != jnp.uint8:
        raise TypeError("best2_l2_triton takes uint8 descriptors; f32 "
                        "descriptors use ops.match._best2_l2")
    n1, d = desc1.shape
    n2 = desc2.shape[0]
    if d != 128 or desc2.shape[1] != 128:
        raise ValueError(f"descriptors must be 128-d, got {d}, {desc2.shape[1]}")
    n1p = _round_up(max(n1, 1), BLOCK_M)
    n2p = _round_up(max(n2, 1), BLOCK_N)
    a = jnp.pad(desc1, ((0, n1p - n1), (0, 0))).astype(jnp.bfloat16)
    b = jnp.pad(desc2, ((0, n2p - n2), (0, 0))).astype(jnp.bfloat16)
    b32 = desc2.astype(jnp.float32)
    nb = jnp.pad(jnp.where(valid2, jnp.sum(b32 * b32, axis=1), jnp.inf),
                 (0, n2p - n2), constant_values=jnp.inf)
    row = pl.BlockSpec((BLOCK_M,), lambda i: (i,))
    d1, d2, i1 = pl.pallas_call(
        functools.partial(_kernel, n_tiles=n2p // BLOCK_N),
        grid=(n1p // BLOCK_M,),
        in_specs=[
            pl.BlockSpec((BLOCK_M, 128), lambda i: (i, 0)),
            pl.BlockSpec((n2p, 128), lambda i: (0, 0)),
            pl.BlockSpec((n2p,), lambda i: (0,)),
        ],
        out_specs=[row, row, row],
        out_shape=[
            jax.ShapeDtypeStruct((n1p,), jnp.float32),
            jax.ShapeDtypeStruct((n1p,), jnp.float32),
            jax.ShapeDtypeStruct((n1p,), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        interpret=interpret,
        name="best2_l2",
    )(a, b, nb)
    return d1[:n1], d2[:n1], i1[:n1]

"""Tensor/intra-op parallelism: one frame's scale-space sharded across chips.

SURVEY.md §2.3 TP row ("spatial sharding of large images across cores") —
absent in the single-device reference; built here the JAX way: the image is
row-sharded over a 1-D mesh axis with `shard_map`, each Gaussian level
exchanges `half`-row halos with its neighbors over NVLink via `lax.ppermute`
(clamp-to-edge replication at the global boundary shards), and the
normalization min/max ride `lax.pmin`/`lax.pmax`.  DoG is local arithmetic;
stride-2 octave downsampling stays aligned because every shard keeps an even
row count.

Use when a single frame must go faster than one chip's frontend (the blur
ladder is the FLOPs king, SURVEY §7.2) — e.g. very large stills.  For video
throughput, frame-parallel DP (parallel/video.py) dominates and needs no
halos; this module exists to cover the intra-frame axis.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SiftConfig
from ..oracle import gaussian_kernel


def _conv_rows_valid(x: jnp.ndarray, taps) -> jnp.ndarray:
    """VALID correlation over axis 0 (rows already include the halo)."""
    k = jnp.asarray(taps, jnp.float32).reshape(1, 1, -1, 1)
    y = lax.conv_general_dilated(
        x[None, None], k, (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return y[0, 0]


def _conv_cols_clamp(x: jnp.ndarray, taps) -> jnp.ndarray:
    """Correlation over axis 1 with local clamp-to-edge (full width local)."""
    half = (len(taps) - 1) // 2
    xp = jnp.pad(x, ((0, 0), (half, half)), mode="edge")
    k = jnp.asarray(taps, jnp.float32).reshape(1, 1, 1, -1)
    y = lax.conv_general_dilated(
        xp[None, None], k, (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return y[0, 0]


def _halo_exchange(x: jnp.ndarray, half: int, axis: str) -> jnp.ndarray:
    """Return x extended with `half` rows of halo on each side.

    Interior halos come from the row-neighbors over NVLink (`ppermute`);
    boundary shards replicate their own edge row — which reproduces the
    global clamp-to-edge border of oracle.blur exactly."""
    n = lax.psum(1, axis)
    idx = lax.axis_index(axis)
    top = x[:half]
    bot = x[-half:]
    from_prev = lax.ppermute(bot, axis, [(i, i + 1) for i in range(n - 1)])
    from_next = lax.ppermute(top, axis, [(i + 1, i) for i in range(n - 1)])
    edge_top = jnp.broadcast_to(x[0:1], (half, x.shape[1]))
    edge_bot = jnp.broadcast_to(x[-1:], (half, x.shape[1]))
    top_halo = jnp.where(idx == 0, edge_top, from_prev)
    bot_halo = jnp.where(idx == n - 1, edge_bot, from_next)
    return jnp.concatenate([top_halo, x, bot_halo], axis=0)


def _blur_sharded(x: jnp.ndarray, sigma: float, axis: str) -> jnp.ndarray:
    taps = gaussian_kernel(sigma)
    half = (len(taps) - 1) // 2
    y = _conv_cols_clamp(x, taps)
    return _conv_rows_valid(_halo_exchange(y, half, axis), taps)


def _normalize_sharded(img: jnp.ndarray, axis: str) -> jnp.ndarray:
    img = img.astype(jnp.float32)
    lo = lax.pmin(jnp.min(img), axis)
    hi = lax.pmax(jnp.max(img), axis)
    scale = jnp.where(hi > lo, 255.0 / (hi - lo), 0.0)
    return (img - lo) * scale


def _pyramid_local(img, cfg: SiftConfig, n_oct: int, axis: str):
    """Per-shard pyramid body (runs under shard_map)."""
    data = _normalize_sharded(img, axis)
    if cfg.init_sigma > cfg.orig_sigma:
        data = _blur_sharded(
            data, float(np.sqrt(cfg.init_sigma**2 - cfg.orig_sigma**2)), axis
        )
    outs = []
    base = data
    for _o in range(n_oct):
        blurs = [base]
        for inc in cfg.sigma_increments():
            blurs.append(_blur_sharded(blurs[-1], inc, axis))
        stack = jnp.stack(blurs)
        outs.append((stack, stack[1:] - stack[:-1]))
        base = blurs[cfg.scales][::2, ::2]   # local stride-2 stays aligned
    return tuple(outs)


def sharded_scale_space(
    img: jnp.ndarray, cfg: SiftConfig, mesh: Mesh, axis: str = "rows",
    n_oct: int = None,
) -> List[Tuple[jnp.ndarray, jnp.ndarray]]:
    """Row-sharded Gaussian scale space of ONE frame.

    Returns [(blurs (S+3,H,W), dogs (S+2,H,W)), ...] as globally-sharded
    arrays (row axis split over `mesh`).  Requires H divisible by
    n_devices * 2**n_oct so every shard keeps even rows per octave;
    double_im_size must be applied by the caller beforehand.
    """
    assert not cfg.double_im_size, "apply upscale2 before sharding"
    h, w = img.shape
    n = mesh.shape[axis]
    if n_oct is None:
        n_oct = cfg.n_octaves((h, w))
        while n_oct > 1 and (h % (n * 2 ** (n_oct - 1)) or
                             (h // n) // 2 ** (n_oct - 1) < 16):
            n_oct -= 1
    assert h % (n * 2 ** max(n_oct - 1, 0)) == 0, (
        f"H={h} not shardable over {n} devices x {n_oct} octaves"
    )
    specs = tuple(
        (P(None, axis, None), P(None, axis, None)) for _ in range(n_oct)
    )
    fn = shard_map(
        functools.partial(_pyramid_local, cfg=cfg, n_oct=n_oct, axis=axis),
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=specs,
    )
    arr = jax.device_put(img, NamedSharding(mesh, P(axis, None)))
    return list(fn(arr))

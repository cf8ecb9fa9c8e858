"""Gaussian scale-space pyramid as XLA ops.

JAX replacement for the reference's separable-convolution kernels and
octave loop (reference: openCL/convolution.cl::{horizontal,vertical}_convolution,
openCL/gaussian.cl, openCL/preprocess.cl::shrink, algebra.cl::combine, and the
blur ladder in sift-src/plan.py::_one_octave — see SURVEY.md §2.2/§3.2).

Design notes:
  * Gaussian taps are computed at trace time with NumPy (sigmas are static
    config), so XLA sees constant filter weights — the reference's on-device
    tap generation kernel is unnecessary.
  * Convolution is expressed as two 1-D `lax.conv_general_dilated` calls with
    clamp-to-edge padding; XLA fuses the elementwise DoG subtraction.
  * All shapes are static; octave downsampling is an exact 0/1 selection
    product (see downsample2).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import SiftConfig
from ..oracle import gaussian_kernel


def normalize_image_jax(img: jnp.ndarray) -> jnp.ndarray:
    """f32 grayscale normalized to [0,255] (oracle.normalize_image)."""
    if img.ndim == 3:
        img = (
            img[..., :3].astype(jnp.float32)
            @ jnp.array([0.299, 0.587, 0.114], dtype=jnp.float32)
        )
    img = img.astype(jnp.float32)
    lo = jnp.min(img)
    hi = jnp.max(img)
    scale = jnp.where(hi > lo, 255.0 / (hi - lo), 0.0)
    return (img - lo) * scale


def conv1d_clamp_jax(img: jnp.ndarray, taps: np.ndarray, axis: int) -> jnp.ndarray:
    """1-D correlation along `axis` with clamp-to-edge borders (f32)."""
    half = (len(taps) - 1) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (half, half)
    padded = jnp.pad(img, pad, mode="edge")
    k = jnp.asarray(taps, dtype=jnp.float32)
    if axis == 1:
        kern = k.reshape(1, 1, 1, -1)  # OIHW
    else:
        kern = k.reshape(1, 1, -1, 1)
    out = lax.conv_general_dilated(
        padded[None, None, :, :],
        kern,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # full f32 (no TF32/bf16 passes): ~0.5% error from reduced-precision
        # passes is far above the DoG peak threshold scale and breaks oracle
        # parity
        precision=lax.Precision.HIGHEST,
    )
    return out[0, 0]


def blur_jax(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with clamped borders (oracle.blur), XLA conv."""
    taps = gaussian_kernel(sigma)
    return conv1d_clamp_jax(conv1d_clamp_jax(img, taps, axis=1), taps, axis=0)


def _upsample_matrix(n: int) -> np.ndarray:
    """(2n, n) bilinear interpolation matrix: row 2i -> x[i],
    row 2i+1 -> (x[i] + x[i+1])/2 (clamped)."""
    U = np.zeros((2 * n, n), dtype=np.float32)
    idx = np.arange(n)
    U[2 * idx, idx] = 1.0
    nxt = np.minimum(idx + 1, n - 1)
    U[2 * idx + 1, idx] += 0.5
    U[2 * idx + 1, nxt] += 0.5
    return U


def upscale2_jax(img: jnp.ndarray) -> jnp.ndarray:
    """Bilinear 2x upscale (oracle.upscale2), used by DoubleImSize.

    Expressed as two interpolation matmuls (U_r @ img @ U_c^T) rather than
    gathers.
    """
    h, w = img.shape
    Ur = jnp.asarray(_upsample_matrix(h))
    Uc = jnp.asarray(_upsample_matrix(w))
    up = jax.lax.dot_general(
        Ur, img, (((1,), (0,)), ((), ())), precision=lax.Precision.HIGHEST
    )
    return jax.lax.dot_general(
        up, Uc, (((1,), (1,)), ((), ())), precision=lax.Precision.HIGHEST
    ).astype(jnp.float32)


def prepare_input_jax(img: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """Normalize, optionally double, pre-blur to init_sigma (oracle.prepare_input)."""
    data = normalize_image_jax(img)
    cur_sigma = cfg.orig_sigma
    if cfg.double_im_size:
        data = upscale2_jax(data)
        cur_sigma *= 2.0
    if cfg.init_sigma > cur_sigma:
        data = blur_jax(data, float(np.sqrt(cfg.init_sigma**2 - cur_sigma**2)))
    return data


def build_octave_jax(
    base: jnp.ndarray, cfg: SiftConfig
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One octave: blur stack (S+3,H,W) and DoG stack (S+2,H,W)."""
    blurs = [base]
    for inc in cfg.sigma_increments():
        blurs.append(blur_jax(blurs[-1], inc))
    stack = jnp.stack(blurs)
    dogs = stack[1:] - stack[:-1]
    return stack, dogs


def downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Exact stride-2 downsample as 0/1 selection matmuls.

    Bit-identical to img[::2, ::2] (HIGHEST precision keeps f32 operands
    exact through the single-nonzero-term products).
    """
    h, w = img.shape
    # ceil-sized output ((h+1)//2 rows), matching img[::2, ::2] and the
    # oracle's shrink2 for odd dims (1080p octave 4 has 68 rows, not 67).
    ER = jnp.asarray(
        (np.arange(h)[None, :] == 2 * np.arange((h + 1) // 2)[:, None]).astype(np.float32)
    )
    EC = jnp.asarray(
        (np.arange(w)[None, :] == 2 * np.arange((w + 1) // 2)[:, None]).astype(np.float32)
    )
    y = lax.dot_general(ER, img, (((1,), (0,)), ((), ())),
                        precision=lax.Precision.HIGHEST)
    return lax.dot_general(y, EC, (((1,), (1,)), ((), ())),
                           precision=lax.Precision.HIGHEST)


def _bin_matrix(n: int) -> np.ndarray:
    """((n+1)//2, n) averaging matrix: row i = 0.5 at 2i and 2i+1 (weight
    1.0 at 2i when 2i+1 falls off an odd edge) — oracle.bin2 numerics."""
    m = np.zeros(((n + 1) // 2, n), np.float32)
    i = np.arange((n + 1) // 2)
    has2 = 2 * i + 1 < n
    m[i, 2 * i] = np.where(has2, 0.5, 1.0)
    m[i[has2], 2 * i[has2] + 1] = 0.5
    return m


def downsample2_bin(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 mean binning (oracle.bin2 / reference preprocess.cl::bin) as
    matmuls, ceil-sized like downsample2."""
    h, w = img.shape
    BR = jnp.asarray(_bin_matrix(h))
    BC = jnp.asarray(_bin_matrix(w))
    y = lax.dot_general(BR, img, (((1,), (0,)), ((), ())),
                        precision=lax.Precision.HIGHEST)
    return lax.dot_general(y, BC, (((1,), (1,)), ((), ())),
                           precision=lax.Precision.HIGHEST)


def downsample_octave(img: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """Octave downsample dispatch (cfg.downsample_mode: shrink | bin)."""
    return downsample2_bin(img) if cfg.downsample_mode == "bin" else downsample2(img)


def build_scale_space_jax(
    img: jnp.ndarray, cfg: SiftConfig
) -> List[Tuple[jnp.ndarray, jnp.ndarray]]:
    """All octaves as a Python-unrolled (trace-time) list of static shapes:
    [(blurs (S+3,H,W), dogs (S+2,H,W)), ...], each octave seeded by
    downsampling the previous octave's blur at index `scales`."""
    base = prepare_input_jax(img, cfg)
    octaves = [build_octave_jax(base, cfg)]
    for _ in range(1, cfg.n_octaves(img.shape[:2])):
        octaves.append(
            build_octave_jax(downsample_octave(octaves[-1][0][cfg.scales], cfg),
                             cfg))
    return octaves

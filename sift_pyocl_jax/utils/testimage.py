"""Synthetic test images.

The reference downloads its classic test image over HTTP
(reference: test/utilstest.py); this environment has no network, so parity
tests run on reproducible synthetic scenes with rich multi-scale structure
(Gaussian blobs over smoothed noise) that produce stable SIFT keypoints.
"""

from __future__ import annotations

import numpy as np


def synthetic_scene(shape=(512, 512), n_blobs: int = 60, seed: int = 0) -> np.ndarray:
    """Smoothed-noise background + Gaussian blobs at a range of scales."""
    rng = np.random.default_rng(seed)
    h, w = shape
    # low-frequency background: upsampled coarse noise
    coarse = rng.normal(size=(h // 16 + 2, w // 16 + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    bg = (
        coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
        + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
        + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
    )
    img = 30.0 * bg
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
        sig = rng.uniform(2.0, 14.0)
        amp = rng.uniform(60.0, 160.0) * rng.choice([-1.0, 1.0])
        img = img + amp * np.exp(-((rr - cy) ** 2 + (cc - cx) ** 2) / (2 * sig**2))
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-9)
    return img.astype(np.float32)


def _bilinear_upsample(coarse: np.ndarray, shape) -> np.ndarray:
    h, w = shape
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    return (
        coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
        + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
        + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
    )


def textured_scene(shape=(256, 256), seed: int = 0) -> np.ndarray:
    """Multi-frequency textured scene (break the Gaussian-
    blob monoculture): fractal noise octaves + hard-edged high-contrast
    patches + a multiplicative illumination gradient.  Statistics are much
    closer to photographs than `synthetic_scene`'s smooth isotropic blobs:
    real spectral content at every SIFT octave, step edges that exercise the
    Hessian edge-rejection path, local contrast swings that exercise the
    descriptor clipping (0.2) and low-contrast discard paths.
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.zeros((h, w))
    # fractal noise: octave spectrum with ~1/f amplitude decay
    for cell, amp in [(64, 55.0), (32, 38.0), (16, 26.0), (8, 16.0),
                      (4, 9.0)]:
        coarse = rng.normal(size=(h // cell + 2, w // cell + 2))
        img += amp * _bilinear_upsample(coarse, shape)
    # hard-edged patches (axis-aligned and rotated bars): step edges with
    # corners — the structures blob scenes never present to the detector
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for _ in range(14):
        cy, cx = rng.uniform(0.08, 0.92) * h, rng.uniform(0.08, 0.92) * w
        hh = rng.uniform(6.0, 40.0)
        ww = rng.uniform(6.0, 40.0)
        th = rng.uniform(0.0, np.pi)
        u = (rr - cy) * np.cos(th) + (cc - cx) * np.sin(th)
        v = -(rr - cy) * np.sin(th) + (cc - cx) * np.cos(th)
        patch = (np.abs(u) < hh / 2) & (np.abs(v) < ww / 2)
        img[patch] += rng.uniform(50.0, 120.0) * rng.choice([-1.0, 1.0])
    # smooth multiplicative illumination gradient (diagonal, 0.55x-1.45x)
    g = 0.55 + 0.9 * (rr / max(h - 1, 1) + cc / max(w - 1, 1)) / 2.0
    img = (img - img.mean()) * g
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-9)
    return img.astype(np.float32)


def blob_cloud(n: int = 120, seed: int = 0, depth=(3.5, 8.0), span: float = 4.0):
    """Random 3-D blob cloud in front of the origin (camera looks down +z).

    Returns (points (n,3) f32, radii (n,) f32, amps (n,) f32): world-space
    blob centres, physical radii, and signed intensity amplitudes — feed to
    ``render_point_cloud`` to image the same rigid scene from many poses.
    """
    rng = np.random.default_rng(seed)
    z = rng.uniform(depth[0], depth[1], n)
    x = rng.uniform(-span / 2, span / 2, n)
    y = rng.uniform(-span / 2, span / 2, n)
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    radii = rng.uniform(0.04, 0.22, n).astype(np.float32)
    amps = (rng.uniform(60.0, 160.0, n) * rng.choice([-1.0, 1.0], n)).astype(
        np.float32
    )
    return pts, radii, amps


def render_point_cloud(points, radii, amps, K, R, t, shape=(256, 256),
                       seed: int = 0) -> np.ndarray:
    """Pinhole render of a 3-D blob cloud: each point becomes a Gaussian blob
    whose on-screen sigma is ``f * radius / depth``, so the same physical blob
    is re-detected by SIFT at a consistent scale from every viewpoint. Adds
    the ``synthetic_scene`` smoothed-noise background (static per ``seed``,
    i.e. attached to the image plane, not the world — keep its keypoints out
    of geometric assertions by using enough cloud blobs).
    """
    points = np.asarray(points, np.float64)
    h, w = shape
    Xc = points @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    z = Xc[:, 2]
    fx, fy = float(K[0][0]), float(K[1][1])
    cx, cy = float(K[0][2]), float(K[1][2])
    vis = z > 1e-3
    u = np.where(vis, fx * Xc[:, 0] / np.where(vis, z, 1.0) + cx, -1e9)
    v = np.where(vis, fy * Xc[:, 1] / np.where(vis, z, 1.0) + cy, -1e9)
    sig = np.where(vis, fx * np.asarray(radii, np.float64) / np.where(vis, z, 1.0), 1.0)
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(h // 16 + 2, w // 16 + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fyw = (ys - y0)[:, None]
    fxw = (xs - x0)[None, :]
    img = 30.0 * (
        coarse[np.ix_(y0, x0)] * (1 - fyw) * (1 - fxw)
        + coarse[np.ix_(y0 + 1, x0)] * fyw * (1 - fxw)
        + coarse[np.ix_(y0, x0 + 1)] * (1 - fyw) * fxw
        + coarse[np.ix_(y0 + 1, x0 + 1)] * fyw * fxw
    )
    rr = np.arange(h)[:, None]
    cc = np.arange(w)[None, :]
    for i in np.nonzero(vis & (u > -4 * sig) & (u < w + 4 * sig)
                        & (v > -4 * sig) & (v < h + 4 * sig))[0]:
        img += amps[i] * np.exp(
            -((rr - v[i]) ** 2 + (cc - u[i]) ** 2) / (2 * sig[i] ** 2)
        )
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-9)
    return img.astype(np.float32)


def transformed_pair(shape=(256, 256), seed: int = 1, dx: float = 7.0, dy: float = -4.0):
    """A scene and its translated copy (for matching / alignment tests)."""
    h, w = shape
    big = synthetic_scene((h + 64, w + 64), seed=seed)
    y0, x0 = 32, 32
    a = big[y0 : y0 + h, x0 : x0 + w]
    b = big[int(y0 + dy) : int(y0 + dy) + h, int(x0 + dx) : int(x0 + dx) + w]
    return a.copy(), b.copy()

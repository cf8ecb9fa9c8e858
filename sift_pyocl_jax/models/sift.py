"""End-to-end SIFT pipeline and the `SiftPlan` public API.

JAX re-architecture of the reference's plan engine
(reference: sift-src/plan.py::SiftPlan — SURVEY.md §2.1/§3.1-3.2).  The
reference pre-allocates device buffers and pre-compiles OpenCL kernels per
image shape, then runs `keypoints(img)` repeatedly at low overhead; here the
same compile-once idiom is `jax.jit` of one fused program per (shape, dtype,
config): pyramid -> detection -> orientation -> descriptor, all octaves
unrolled at trace time with static shapes and static-capacity keypoint
buffers (no atomics, no per-scale host syncs).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from functools import lru_cache, partial
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

from ..config import SiftConfig
from ..oracle import KP_DTYPE
from ..ops.detect import detect_octave
from ..ops.orient_desc import assign_orientations, compute_descriptors, gradient_planes
from ..ops.pyramid import build_scale_space_jax


class KeypointBuffer(NamedTuple):
    """Fixed-capacity keypoint output (the functional analog of the
    reference's keypoint recarray, with a validity mask instead of a count)."""

    x: jnp.ndarray        # (cap,) f32 column in input-image coords
    y: jnp.ndarray        # (cap,) f32 row in input-image coords
    scale: jnp.ndarray    # (cap,) f32 absolute sigma in input-image coords
    angle: jnp.ndarray    # (cap,) f32 in (-pi, pi]
    desc: jnp.ndarray     # (cap, 128) uint8
    valid: jnp.ndarray    # (cap,) bool
    counts: jnp.ndarray   # (n_octaves, 2) int32 true (extrema, oriented) counts


def octave_capacities(shape: Tuple[int, int], cfg: SiftConfig) -> List[Tuple[int, int]]:
    """(candidate_cap, descriptor_cap) per octave, shrinking with resolution.

    kp_per_octave_cap bounds octave 0 and halves per octave (floor 128):
    keypoint density drops ~4x per octave, and unused capacity is not free —
    every slot is gathered, histogrammed and matched like a valid one.
    """
    h, w = shape
    if cfg.double_im_size:
        h, w = 2 * h, 2 * w
    caps = []
    cap_bound = cfg.kp_per_octave_cap
    for _ in range(cfg.n_octaves(shape)):
        cap = int(min(cap_bound, max(h * w // cfg.pix_per_kp, 64)))
        cap = (cap + 63) // 64 * 64
        dcap = cap + cap // 2
        caps.append((cap, dcap))
        h, w = h // 2, w // 2
        cap_bound = max(cap_bound // 2, 128)
    return caps


def detect_and_describe(img: jnp.ndarray, cfg: SiftConfig) -> KeypointBuffer:
    """The full forward pass (reference: SiftPlan.keypoints, SURVEY.md §3.2),
    in plain jax.numpy/lax: one XLA program per (shape, config)."""
    octaves = build_scale_space_jax(img, cfg)
    return describe_octaves(octaves, img.shape[:2], cfg)


def describe_octaves(octaves, shape: Tuple[int, int],
                     cfg: SiftConfig) -> KeypointBuffer:
    """Detection + orientation + descriptors over a prebuilt scale space.

    Split out of `detect_and_describe` so the pyramid stage and this stage
    can run on DIFFERENT devices (parallel/pipeline_octaves.py — PP)."""
    caps = octave_capacities(shape, cfg)
    xs, ys, scales_, angles, descs, valids, counts = [], [], [], [], [], [], []
    octsize = 0.5 if cfg.double_im_size else 1.0
    for o, (blurs, dogs) in enumerate(octaves):
        cap, dcap = caps[o]
        mags, oris = gradient_planes(blurs, cfg)
        kps = detect_octave(dogs, cfg, o, cap)
        extrema_count = jnp.sum(kps.valid.astype(jnp.int32))
        okps = assign_orientations(mags, oris, kps, cfg, dcap,
                                   max_ori=cfg.max_ori)
        desc = compute_descriptors(mags, oris, okps, cfg)
        sigma_oct = cfg.init_sigma * 2.0 ** (okps.fs / cfg.scales)
        xs.append(okps.fc * octsize)
        ys.append(okps.fr * octsize)
        scales_.append(sigma_oct * octsize)
        angles.append(okps.angle)
        descs.append(desc)
        valids.append(okps.valid)
        counts.append(jnp.stack([extrema_count, okps.count]))
        octsize *= 2.0
    return KeypointBuffer(
        x=jnp.concatenate(xs),
        y=jnp.concatenate(ys),
        scale=jnp.concatenate(scales_),
        angle=jnp.concatenate(angles),
        desc=jnp.concatenate(descs),
        valid=jnp.concatenate(valids),
        counts=jnp.stack(counts),
    )


def detect_and_describe_batched(imgs: jnp.ndarray,
                                cfg: SiftConfig) -> KeypointBuffer:
    """Batched frontend: B frames, each through the single-frame pipeline.

    imgs: (B, H, W).  Returns a KeypointBuffer whose arrays carry a leading
    batch axis: x/y/scale/angle/valid (B, N), desc (B, N, 128),
    counts (B, n_octaves, 2).  Per-frame results are identical to
    detect_and_describe.
    """
    bufs = [detect_and_describe(imgs[f], cfg) for f in range(imgs.shape[0])]
    return KeypointBuffer(*[
        jnp.stack([getattr(b, fld) for b in bufs])
        for fld in KeypointBuffer._fields
    ])


@lru_cache(maxsize=32)
def _jitted_detector(cfg: SiftConfig):
    """Process-wide jitted detector per config.

    One jax.jit wrapper per SiftConfig (frozen dataclass, hashable) so
    every SiftPlan with the same config shares one trace cache and one set
    of compiled executables; IncrementalSfM constructs a fresh SiftPlan per
    run, and a per-instance wrapper would re-trace the whole graph each time.
    """
    return jax.jit(partial(detect_and_describe, cfg=cfg))


def buffer_to_records(buf: KeypointBuffer) -> np.ndarray:
    """Valid slots of a (device) KeypointBuffer as a host KP_DTYPE array."""
    buf = jax.device_get(buf)
    m = buf.valid
    out = np.zeros(int(m.sum()), dtype=KP_DTYPE)
    for f in ("x", "y", "scale", "angle", "desc"):
        out[f] = getattr(buf, f)[m]
    return out


def device_memory_limit(device=None) -> int:
    """Bytes the backend lets this process allocate on `device` (default:
    the first device): `memory_stats()["bytes_limit"]` on an accelerator,
    physical host RAM on the CPU backend.  Raises when neither is known —
    a plan is never checked against an assumed device size."""
    dev = device or jax.devices()[0]
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    limit = (dev.memory_stats() or {}).get("bytes_limit", 0)
    if not limit:
        raise RuntimeError(f"{dev.device_kind}: memory_stats() reports no "
                           "bytes_limit, so plan memory cannot be checked")
    return int(limit)


class SiftPlan:
    """Compile-once SIFT plan (API parity with sift-src/plan.py::SiftPlan).

    >>> plan = SiftPlan(shape=(512, 512), dtype="float32")
    >>> kp = plan.keypoints(img)     # structured array, KP_DTYPE records

    `devicetype` is accepted for signature parity but ignored: JAX owns device
    placement (SURVEY.md §2.1, opencl.py row).
    """

    def __init__(
        self,
        shape: Optional[Tuple[int, int]] = None,
        dtype="float32",
        template: Optional[np.ndarray] = None,
        config: Optional[SiftConfig] = None,
        devicetype: str = "GPU",
        PIX_PER_KP: Optional[int] = None,
        init_sigma: Optional[float] = None,
        **_ignored,
    ):
        if template is not None:
            shape = template.shape[:2]
            dtype = template.dtype
        if shape is None:
            raise ValueError("provide shape=(h, w) or template=image")
        cfg = config or SiftConfig()
        overrides = {}
        if PIX_PER_KP is not None:
            overrides["pix_per_kp"] = PIX_PER_KP
        if init_sigma is not None:
            overrides["init_sigma"] = init_sigma
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.cfg = cfg
        self._check_memory()
        self._fn = _jitted_detector(cfg)
        # verbose memory/geometry report (reference: plan.py::_calc_memory
        # logs a device-memory breakdown at plan construction)
        logger.info(
            "SiftPlan %s %s: %d octaves, caps %s, est. device memory %.1f MiB",
            self.shape, self.dtype, cfg.n_octaves(self.shape),
            octave_capacities(self.shape, cfg), self.calc_memory() / 2**20,
        )

    def calc_memory(self) -> int:
        """Estimated peak device bytes for this plan's arrays (reference:
        plan.py::_calc_memory — the reference raises before allocating an
        image that cannot fit; we pre-check the same way instead of failing
        deep inside the compiler).  Counts the blur/DoG stacks, gradient
        planes and the keypoint buffers, all f32."""
        cfg = self.cfg
        h, w = self.shape
        if cfg.double_im_size:
            h, w = 2 * h, 2 * w
        total = h * w * 4 * 2  # input + normalized/doubled base
        caps = octave_capacities(self.shape, cfg)
        for cap, dcap in caps:
            blur_dog = (cfg.n_scale_imgs + cfg.n_dogs) * h * w * 4
            grads = 2 * cfg.scales * h * w * 4
            kp_bufs = (cap * 8 + dcap * (8 + 128)) * 4
            total += blur_dog + grads + kp_bufs
            h, w = (h + 1) // 2, (w + 1) // 2
        return total

    def _check_memory(self, limit_bytes: Optional[int] = None):
        need = self.calc_memory()
        if limit_bytes is None:
            limit_bytes = device_memory_limit()
        if need > limit_bytes:
            raise MemoryError(
                f"SiftPlan{self.shape}: estimated {need / 2**30:.2f} GiB of "
                f"device arrays exceeds the {limit_bytes / 2**30:.2f} GiB "
                "limit (reference parity: plan.py::_calc_memory pre-check)"
            )

    def compile(self) -> "SiftPlan":
        """Force ahead-of-time compilation (the reference does this in __init__)."""
        dummy = jnp.zeros(self.shape, dtype=jnp.float32)
        self._fn.lower(dummy).compile()
        return self

    def keypoints_raw(self, image) -> KeypointBuffer:
        """Device-resident fixed-capacity result (for fused downstream use)."""
        img = jnp.asarray(image)
        if img.shape[:2] != self.shape:
            raise ValueError(f"image shape {img.shape[:2]} != plan shape {self.shape}")
        return self._fn(img)

    def keypoints(self, image) -> np.ndarray:
        """Host-side structured keypoint array (reference output format)."""
        return buffer_to_records(self.keypoints_raw(image))

    __call__ = keypoints

    def log_profile(self):
        """Parity shim for the reference's event-profiling report
        (reference: plan.py::log_profile).  Under XLA there is one fused
        program; use utils.profiling.stage_times for a per-stage breakdown."""
        from ..utils.profiling import stage_times

        return stage_times(self)

"""Frame-parallel (data-parallel) SIFT frontend over a device mesh.

The reference is strictly single-device/single-image (SURVEY.md §2.3: all
parallelism rows "Absent"); this is the data-parallel extension: batch the
pipeline over a `frames` mesh axis with `shard_map`, one fused program per
device processing its local shard of the frame stream (BASELINE.json
config 3, the video frontend).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import SiftConfig
from ..models.sift import KeypointBuffer, detect_and_describe


def make_frames_mesh(n_devices: Optional[int] = None, axis: str = "frames") -> Mesh:
    """1-D mesh over all (or the first n) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def batched_sift(frames: jnp.ndarray, cfg: SiftConfig) -> KeypointBuffer:
    """detect+describe over a (B, H, W) frame batch on one device.

    Sequential `lax.map` rather than vmap: a video stream is processed
    frame-serially per device (throughput comes from the mesh's frame axis,
    not intra-device batching), and the per-frame program's memory stays
    that of one frame.
    """
    return jax.lax.map(lambda f: detect_and_describe(f, cfg), frames)


def sharded_sift_fn(mesh: Mesh, cfg: SiftConfig, axis: str = "frames"):
    """Build a jitted frame-sharded SIFT: (B, H, W) -> KeypointBuffer batch.

    B must be divisible by the mesh axis size; each device runs the fused
    single-image program on its local frames — zero collectives (SIFT is
    embarrassingly frame-parallel; the collectives live in the SfM backend).
    """
    fn = shard_map(
        partial(batched_sift, cfg=cfg),
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn)


class VideoSiftFrontend:
    """Streaming video SIFT: compile once for (batch, shape), then feed frames.

    The analog of calling SiftPlan.keypoints in a loop, but
    frame-parallel across the mesh (BASELINE.json config 3).
    """

    def __init__(
        self,
        frame_shape: Tuple[int, int],
        batch: int,
        cfg: Optional[SiftConfig] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.cfg = cfg or SiftConfig()
        self.mesh = mesh or make_frames_mesh()
        axis = self.mesh.axis_names[0]
        if batch % self.mesh.devices.size:
            raise ValueError(
                f"batch {batch} not divisible by mesh size {self.mesh.devices.size}"
            )
        self.batch = batch
        self.frame_shape = tuple(frame_shape)
        self._sharding = NamedSharding(self.mesh, P(axis))
        self._fn = sharded_sift_fn(self.mesh, self.cfg, axis)

    def __call__(self, frames) -> KeypointBuffer:
        frames = jnp.asarray(frames, dtype=jnp.float32)
        if frames.shape != (self.batch,) + self.frame_shape:
            raise ValueError(f"expected {(self.batch,) + self.frame_shape}")
        frames = jax.device_put(frames, self._sharding)
        return self._fn(frames)

"""Pipeline parallelism: pyramid and detect/describe stages on two chips.

SURVEY.md §2.3 PP row ("pyramid-octave pipelining across devices") — absent
in the reference; built the JAX way: two jitted stage programs pinned to two
devices by input placement, with the scale-space stacks crossing the device link (NVLink) via
`jax.device_put`.  JAX's async dispatch provides the pipelining: the host
enqueues stage 0 of frame i while stage 1 of frame i-1 is still executing,
so both chips stay busy and steady-state throughput approaches
1 / max(stage_time) instead of 1 / sum(stage_time).

Stage split: pyramid construction (build_scale_space_jax — the FLOPs-dense
blur ladder) vs detection + orientation + descriptors (describe_octaves —
the keypoint-bound half).  Frame-parallel DP (parallel/video.py) is the
first choice for throughput; this axis composes with it when a frame group
needs lower latency than one chip's full frontend.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from ..models.sift import KeypointBuffer, describe_octaves
from ..ops.pyramid import build_scale_space_jax


class TwoStagePipeline:
    """Pipelined SIFT frontend over a frame stream.

    >>> pipe = TwoStagePipeline((1080, 1920), cfg)
    >>> for buf in pipe.process(frames):
    ...     ...                     # KeypointBuffer per frame, in order
    """

    def __init__(self, shape: Tuple[int, int], cfg: SiftConfig,
                 devices: Optional[Sequence] = None):
        devs = list(devices) if devices is not None else jax.devices()[:2]
        if len(devs) < 2:
            devs = devs * 2   # degrade gracefully on one device
        self.d0, self.d1 = devs[0], devs[1]
        self.shape = tuple(shape)
        self.cfg = cfg
        self._stage0 = jax.jit(partial(build_scale_space_jax, cfg=cfg))
        self._stage1 = jax.jit(
            partial(describe_octaves, shape=self.shape, cfg=cfg)
        )

    def process(self, frames: Iterable) -> Iterator[KeypointBuffer]:
        """Yield per-frame keypoint buffers; stage 0 of frame i overlaps
        stage 1 of frame i-1 (async dispatch — no host sync in the loop)."""
        pending = None
        for f in frames:
            img = jax.device_put(jnp.asarray(f), self.d0)
            octaves = self._stage0(img)
            octaves = jax.device_put(octaves, self.d1)   # device-to-device hop
            if pending is not None:
                yield pending
            pending = self._stage1(octaves)
        if pending is not None:
            yield pending

"""Multi-host bootstrap and mesh construction.

The reference is single-process/single-device (SURVEY.md §3.5); this is the
multi-host entry point for the distributed BA backend
(sfm/distributed.py) and the frame-parallel video frontend (parallel/video.py).

Collective layout (SURVEY.md §2.3): the BA mesh axis shards map blocks and
observations; camera blocks are replicated and reduced with `psum`, which XLA
hands to NCCL (NVLink within a host, the network across hosts).  Failure semantics follow
standard JAX multi-host practice — a lost process fails the job, the
controller restarts it, and state reloads from sfm/checkpoint.py snapshots.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """`jax.distributed.initialize` with env-based defaults; no-op when the
    job is provably single-process.  Returns (process_index, process_count).

    Explicit args win; otherwise, when a coordinator address or a known
    cluster environment is present (JAX coordinator env vars, SLURM /
    OpenMPI), `jax.distributed.initialize()` runs with auto-detection so a
    job configured purely via environment is NOT silently left
    un-initialized.
    """
    import os

    import jax

    if num_processes is not None and num_processes > 1:
        logger.info("jax.distributed.initialize: %d processes, coordinator %s",
                    num_processes, coordinator_address)
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif num_processes is None:
        # Only treat the env as multi-process when it provably names MORE
        # than one worker.
        def _gt1(v):
            return bool(v) and v.isdigit() and int(v) > 1

        env_configured = (
            coordinator_address is not None
            or any(
                os.environ.get(k)
                for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
            )
            or _gt1(os.environ.get("SLURM_JOB_NUM_NODES", ""))
            or _gt1(os.environ.get("OMPI_COMM_WORLD_SIZE", ""))
        )
        if env_configured:
            # CRITICAL ordering: do NOT touch jax.process_count()/devices()
            # before initialize — they would initialize the XLA backend and
            # initialize() then always raises (jax 0.9 backends_are_
            # initialized check).  If another component already initialized
            # distributed mode, initialize raises RuntimeError — treat that
            # as "already done" and continue.
            logger.info("multi-process environment detected; running "
                        "jax.distributed.initialize() auto-detection")
            try:
                jax.distributed.initialize(
                    coordinator_address=coordinator_address
                )
            except RuntimeError as e:
                if "already" in str(e) or "must be called before" in str(e):
                    logger.warning(
                        "jax.distributed.initialize skipped: %s", e
                    )
                else:
                    raise
    return jax.process_index(), jax.process_count()


def global_ba_mesh(axis: str = "ba"):
    """1-D mesh over ALL global devices (every host's chips) for the
    sharded BA — `psum` over this axis crosses NVLink within a host and
    the network across hosts."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def frames_x_ba_mesh(n_frames_axis: int, axes=("frames", "ba")):
    """2-D mesh: frame-parallel SIFT frontend on one axis, sharded BA on the
    other (video SfM across hosts: each frame group feeds keyframes into the
    BA shard that owns its map blocks)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    n = devs.size
    if n % n_frames_axis:
        raise ValueError(f"{n} devices not divisible by {n_frames_axis}")
    return Mesh(devs.reshape(n_frames_axis, n // n_frames_axis), axes)

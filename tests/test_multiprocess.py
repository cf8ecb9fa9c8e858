"""2-process jax.distributed smoke test over localhost DCN.

Spawns two CPU-backend subprocesses that call the real
`initialize_multihost(num_processes=2, ...)` path and run a cross-process
reduction over the global BA mesh — the multi-host bootstrap that single-
process tests cannot reach.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers(mode: str = "sum", timeout: int = 300):
    repo = Path(__file__).resolve().parent.parent
    worker = Path(__file__).resolve().parent / "_mp_worker.py"
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(i), "2", mode],
            cwd=str(repo), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"worker hung; out={out[-500:]} err={err[-2000:]}")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nout={out}\nerr={err[-3000:]}"
        assert "OK process" in out
    return outs


@pytest.mark.slow
def test_two_process_distributed_init():
    _spawn_workers("sum")


@pytest.mark.slow
def test_two_process_distributed_ba():
    """DistributedBA's psum'd camera reduction across a REAL
    process boundary (2 processes x 2 CPU devices over localhost DCN), with
    the final cost checked against a single-process run of the SAME 4-shard
    partition — multi-host correctness of the BA collective pattern, not
    just a smoke psum."""
    import re

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from sift_pyocl_jax.sfm.distributed import DistributedBA
    from sift_pyocl_jax.sfm.synthetic import make_problem, perturb

    # reference: single-process, 4 local devices -> identical partition to
    # the workers' 2x2-device global mesh (partition_problem is a pure
    # function of (problem, n_shards))
    K, gt, obs, _ = make_problem(n_cams=6, n_points=96, noise_px=0.3, seed=0)
    noisy = perturb(gt, rot_deg=2.0, trans=0.05, point_sigma=0.05, seed=1)
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("ba",))
    _, costs_ref = DistributedBA(mesh4).run(noisy, obs, K, iters=6)

    outs = _spawn_workers("ba", timeout=600)
    pat = re.compile(r"BA_COST0 ([0-9.e+-]+) BA_COSTN ([0-9.e+-]+)")
    vals = []
    for rc, out, err in outs:
        mt = pat.search(out)
        assert mt, f"worker printed no BA costs:\n{out}\n{err[-1000:]}"
        vals.append((float(mt.group(1)), float(mt.group(2))))
    # both processes see the same replicated cost
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-6)
    # first cost is a pure function evaluation: must match single-process
    # exactly up to float reduction order; final cost within LM-path noise
    np.testing.assert_allclose(vals[0][0], costs_ref[0], rtol=1e-4)
    assert abs(vals[0][1] - costs_ref[-1]) / costs_ref[-1] < 0.05, (
        vals[0][1], costs_ref[-1])

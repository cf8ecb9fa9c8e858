"""Worker for the 2-process jax.distributed test (run as a subprocess).

Exercises the REAL `jax.distributed.initialize` branch of
parallel.multihost.initialize_multihost (that branch had
never run) plus a cross-process psum over the global BA mesh.
"""

import sys


def main():
    coord, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, ".")
    from sift_pyocl_jax.parallel.multihost import (
        global_ba_mesh,
        initialize_multihost,
    )

    idx, cnt = initialize_multihost(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert idx == pid and cnt == nproc, (idx, cnt)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_ba_mesh()
    n_dev = mesh.devices.size
    assert n_dev == nproc * jax.local_device_count()

    # cross-process collective: global sum of a sharded array
    sharding = NamedSharding(mesh, P("ba"))
    local = jnp.arange(n_dev, dtype=jnp.float32)
    arr = jax.make_array_from_callback(
        (n_dev,), sharding, lambda i: np.arange(n_dev, dtype=np.float32)[i]
    )
    total = jax.jit(lambda x: jnp.sum(x), out_shardings=None)(arr)
    expect = float(np.arange(n_dev).sum())
    assert float(total) == expect, (float(total), expect)

    # optional second leg: the REAL DistributedBA camera-
    # system psum across the process boundary, not just a global sum
    mode = sys.argv[4] if len(sys.argv) > 4 else "sum"
    if mode == "ba":
        from sift_pyocl_jax.sfm.distributed import DistributedBA
        from sift_pyocl_jax.sfm.synthetic import make_problem, perturb

        K, gt, obs, _ = make_problem(
            n_cams=6, n_points=96, noise_px=0.3, seed=0)
        noisy = perturb(gt, rot_deg=2.0, trans=0.05, point_sigma=0.05,
                        seed=1)
        dba = DistributedBA(mesh)
        params, costs = dba.run(noisy, obs, K, iters=6)
        assert np.isfinite(costs).all(), costs
        assert np.isfinite(params.X).all()
        print(f"BA_COST0 {costs[0]:.8e} BA_COSTN {costs[-1]:.8e}")

    print(f"OK process {idx}/{cnt} devices {n_dev} sum {float(total)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-device sharded bundle adjustment.

BASELINE.json config 5: keyframes (cameras) replicated, map blocks (points +
their observations) sharded across the mesh; the reduced camera system is
accumulated with `psum` over the mesh axis (NVLink in-host, network across
hosts) —
the collective pattern SURVEY.md §2.3/§5 calls for.  The per-shard math is
exactly `sfm.ba.lm_iteration` with `axis_name` set: the only cross-device
traffic is (C,6,6)+(C,6) camera blocks per build and one (C,6) vector per CG
matvec — tiny next to the sharded point/observation state.

Partitioning invariant: ALL observations of a point live on that point's
shard, so V blocks and point updates are shard-local and never communicated.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .ba import BAObs, BAParams, lm_iteration


class ShardedProblem(NamedTuple):
    """Host-built sharded layout (leading axis = shard)."""

    uv: np.ndarray        # (S, Ms, 2)
    cam: np.ndarray       # (S, Ms)
    pt_local: np.ndarray  # (S, Ms) local point index within the shard
    w: np.ndarray         # (S, Ms)
    X: np.ndarray         # (S, Ps, 3) padded point blocks
    pt_rng: np.ndarray    # (S, 2) [start, count) of each shard's points
    p_shard: int          # Ps


def partition_problem(params: BAParams, obs: BAObs, n_shards: int) -> ShardedProblem:
    """Split points into contiguous ranges with ~balanced observation counts;
    route each observation to its point's shard."""
    pt = np.asarray(obs.pt)
    X = np.asarray(params.X)
    n_pts = X.shape[0]
    counts = np.bincount(pt, weights=np.asarray(obs.w) > 0, minlength=n_pts)
    cum = np.cumsum(counts)
    total = cum[-1] if len(cum) else 0
    bounds = [0]
    for k in range(1, n_shards):
        bounds.append(int(np.searchsorted(cum, total * k / n_shards)))
    bounds.append(n_pts)
    bounds = np.maximum.accumulate(np.array(bounds))

    order = np.argsort(pt, kind="stable")
    pt_s = pt[order]
    shard_sizes_p = [bounds[k + 1] - bounds[k] for k in range(n_shards)]
    p_shard = max(max(shard_sizes_p), 1)

    uvs, cams, pls, ws, Xs, rngs = [], [], [], [], [], []
    m_shard = 0
    per_shard = []
    for k in range(n_shards):
        lo, hi = bounds[k], bounds[k + 1]
        sel = order[(pt_s >= lo) & (pt_s < hi)]
        per_shard.append(sel)
        m_shard = max(m_shard, len(sel))
    m_shard = max(m_shard, 1)
    for k in range(n_shards):
        lo, hi = bounds[k], bounds[k + 1]
        sel = per_shard[k]
        pad = m_shard - len(sel)
        uvs.append(np.pad(np.asarray(obs.uv)[sel], ((0, pad), (0, 0))))
        cams.append(np.pad(np.asarray(obs.cam)[sel], (0, pad)))
        pls.append(np.pad(pt[sel] - lo, (0, pad)))
        ws.append(np.pad(np.asarray(obs.w)[sel], (0, pad)))
        Xp = np.zeros((p_shard, 3), X.dtype)
        Xp[: hi - lo] = X[lo:hi]
        Xs.append(Xp)
        rngs.append([lo, hi - lo])
    return ShardedProblem(
        uv=np.stack(uvs).astype(np.float32),
        cam=np.stack(cams).astype(np.int32),
        pt_local=np.stack(pls).astype(np.int32),
        w=np.stack(ws).astype(np.float32),
        X=np.stack(Xs).astype(np.float32),
        pt_rng=np.array(rngs, np.int32),
        p_shard=p_shard,
    )


def merge_points(sp: ShardedProblem, X_sharded: np.ndarray, n_pts: int) -> np.ndarray:
    out = np.zeros((n_pts, 3), np.float32)
    for k in range(X_sharded.shape[0]):
        lo, cnt = sp.pt_rng[k]
        out[lo : lo + cnt] = X_sharded[k, :cnt]
    return out


class DistributedBA:
    """Sharded LM bundle adjuster over a 1-D mesh axis ("ba")."""

    def __init__(
        self,
        mesh: Mesh = None,
        axis: str = "ba",
        huber_px: float = 2.0,
        cg_iters: int = 30,
    ):
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), (axis,))
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.huber = huber_px
        self.cg_iters = cg_iters
        self._step = None

    def _build_step(self, p_shard: int):
        axis = self.axis

        def shard_step(Rs, ts, Xs, uv, cam, ptl, w, lam, free, K):
            # inside shard_map: Xs (1, Ps, 3) -> local block; obs rows local
            params = BAParams(Rs, ts, Xs[0])
            obs = BAObs(uv[0], cam[0], ptl[0], w[0])
            params, lam, cost, acc = lm_iteration(
                params, obs, K, lam, free,
                huber_px=self.huber, cg_iters=self.cg_iters,
                n_points=p_shard, axis_name=axis,
            )
            return params.Rs, params.ts, params.X[None], lam, cost, acc

        spec_rep = P()
        spec_sh = P(self.axis)
        fn = shard_map(
            shard_step,
            mesh=self.mesh,
            in_specs=(spec_rep, spec_rep, spec_sh, spec_sh, spec_sh, spec_sh,
                      spec_sh, spec_rep, spec_rep, spec_rep),
            out_specs=(spec_rep, spec_rep, spec_sh, spec_rep, spec_rep, spec_rep),
            check_vma=False,
        )
        return jax.jit(fn)

    def run(
        self,
        params: BAParams,
        obs: BAObs,
        K,
        fixed_cams=(0,),
        iters: int = 20,
        lam0: float = 1e-3,
        verbose: bool = False,
    ) -> Tuple[BAParams, list]:
        n_dev = self.mesh.devices.size
        sp = partition_problem(params, obs, n_dev)
        step = self._build_step(sp.p_shard)
        C = params.Rs.shape[0]
        free = jnp.ones((C,), jnp.float32).at[jnp.array(fixed_cams)].set(0.0)
        shard = NamedSharding(self.mesh, P(self.axis))
        rep = NamedSharding(self.mesh, P())
        # Multi-HOST path (SURVEY §2.3 comm backend): when the mesh spans
        # processes, plain device_put cannot place non-addressable shards —
        # every process builds the same global NumPy problem (deterministic
        # partitioner above) and contributes its local shards via
        # make_array_from_callback; fetches read the local replica.
        multi = jax.process_count() > 1

        def put(x, sh):
            x = np.asarray(x)
            if multi:
                return jax.make_array_from_callback(
                    x.shape, sh, lambda idx: x[idx])
            return jax.device_put(jnp.asarray(x), sh)

        def rep_np(a):
            """Host value of a replicated global array."""
            return np.asarray(a.addressable_data(0)) if multi \
                else np.asarray(a)

        Rs = put(params.Rs, rep)
        ts = put(params.ts, rep)
        Xs = put(sp.X, shard)
        uv = put(sp.uv, shard)
        cam = put(sp.cam, shard)
        ptl = put(sp.pt_local, shard)
        w = put(sp.w, shard)
        Kd = put(np.asarray(K, np.float32), rep)
        lam = put(np.float32(lam0), rep)
        free = put(np.asarray(free), rep)
        costs = []
        for it in range(iters):
            Rs, ts, Xs, lam, cost, acc = step(Rs, ts, Xs, uv, cam, ptl, w, lam, free, Kd)
            costs.append(float(rep_np(cost)))
            if verbose:
                print(f"  dist-LM it {it}: cost {costs[-1]:.4f} "
                      f"lam {float(rep_np(lam)):.2e}")
        if multi:
            # gather the sharded point blocks: reshard to replicated (one
            # all-gather over the mesh), then read the local replica
            Xs = jax.jit(lambda x: x, out_shardings=rep)(Xs)
        X = merge_points(sp, rep_np(Xs), params.X.shape[0])
        return BAParams(rep_np(Rs), rep_np(ts), X), costs

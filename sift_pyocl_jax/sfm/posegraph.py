"""Pose-graph optimization over SE(3).

Given relative pose measurements Z_ij between cameras, optimize absolute
world-to-camera poses T_i minimizing the Huber-weighted sum of
|| log( Z_ij * T_j^-1 * T_i ) ||^2   (right residual on T_j relative to T_i;
Z_ij is the measured i->j transform, i.e. T_j ≈ Z_ij * T_i).

Gauss-Newton with a dense 6Cx6C system — pose graphs are camera-count sized
(tiny next to the point system), so a dense solve is the right call.
New subsystem per BASELINE.json ("pose-graph optimization").
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .geometry import pose_compose, pose_inverse, pose_retract, so3_log


class PoseGraph(NamedTuple):
    """Static-capacity edge list."""

    i: jnp.ndarray       # (E,) int32 source camera
    j: jnp.ndarray       # (E,) int32 target camera
    Z_R: jnp.ndarray     # (E,3,3) measured relative rotation (i->j)
    Z_t: jnp.ndarray     # (E,3) measured relative translation
    w: jnp.ndarray       # (E,) f32 edge weight (0 = padding)


def relative_pose(Ri, ti, Rj, tj):
    """Z = T_j * T_i^-1 : the i->j transform."""
    Rinv, tinv = pose_inverse(Ri, ti)
    return pose_compose(Rj, tj, Rinv, tinv)


def _edge_residual(Ri, ti, Rj, tj, ZR, Zt):
    """6-vector log residual of T_j vs Z * T_i."""
    PR, Pt = pose_compose(ZR, Zt, Ri, ti)      # predicted T_j
    Jinv_R, Jinv_t = pose_inverse(Rj, tj)
    ER, Et = pose_compose(PR, Pt, Jinv_R, Jinv_t)  # E = pred * T_j^-1
    return jnp.concatenate([so3_log(ER), Et])


@partial(jax.jit, static_argnames=("iters", "huber"))
def optimize_pose_graph(
    Rs: jnp.ndarray,      # (C,3,3) initial absolute poses
    ts: jnp.ndarray,      # (C,3)
    graph: PoseGraph,
    free: jnp.ndarray,    # (C,) f32 1=optimize, 0=fixed (gauge)
    iters: int = 15,
    huber: float = 0.1,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gauss-Newton pose-graph solve.  Returns (Rs, ts, final cost)."""
    C = Rs.shape[0]
    E = graph.i.shape[0]

    def residual_all(Rs, ts):
        def one(i, j, ZR, Zt):
            return _edge_residual(Rs[i], ts[i], Rs[j], ts[j], ZR, Zt)
        return jax.vmap(one)(graph.i, graph.j, graph.Z_R, graph.Z_t)  # (E,6)

    def jac_edge(Rs, ts, i, j, ZR, Zt):
        f = lambda xi_i, xi_j: _edge_residual(
            *pose_retract(Rs[i], ts[i], xi_i), *pose_retract(Rs[j], ts[j], xi_j), ZR, Zt
        )
        Ji = jax.jacfwd(f, argnums=0)(jnp.zeros(6), jnp.zeros(6))  # (6,6)
        Jj = jax.jacfwd(f, argnums=1)(jnp.zeros(6), jnp.zeros(6))
        return Ji, Jj

    def step(carry, _):
        Rs, ts, lam = carry
        r = residual_all(Rs, ts)                        # (E,6)
        nrm = jnp.sqrt(jnp.sum(r * r, -1) + 1e-12)
        wr = graph.w * jnp.minimum(1.0, huber / nrm)
        Ji, Jj = jax.vmap(lambda i, j, ZR, Zt: jac_edge(Rs, ts, i, j, ZR, Zt))(
            graph.i, graph.j, graph.Z_R, graph.Z_t
        )                                               # (E,6,6) each
        # dense 6C x 6C normal matrix via scatter-add of edge blocks
        H = jnp.zeros((C, 6, C, 6))
        g = jnp.zeros((C, 6))
        JiT = jnp.swapaxes(Ji, 1, 2) * wr[:, None, None]
        JjT = jnp.swapaxes(Jj, 1, 2) * wr[:, None, None]
        H = H.at[graph.i, :, graph.i, :].add(JiT @ Ji)
        H = H.at[graph.j, :, graph.j, :].add(JjT @ Jj)
        H = H.at[graph.i, :, graph.j, :].add(JiT @ Jj)
        H = H.at[graph.j, :, graph.i, :].add(JjT @ Ji)
        g = g.at[graph.i].add(-jnp.einsum("eij,ej->ei", JiT, r))
        g = g.at[graph.j].add(-jnp.einsum("eij,ej->ei", JjT, r))
        # gauge: project out fixed cameras
        mask = free[:, None]
        Hm = H.reshape(6 * C, 6 * C)
        fm = jnp.repeat(free, 6)
        Hm = Hm * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
        Hm = Hm + lam * jnp.diag(jnp.diag(Hm)) + 1e-8 * jnp.eye(6 * C)
        gm = g.reshape(-1) * fm
        dx = jnp.linalg.solve(Hm, gm).reshape(C, 6) * mask
        Rs2, ts2 = jax.vmap(pose_retract)(Rs, ts, dx)
        c_old = jnp.sum(wr * jnp.sum(r * r, -1))
        r2 = residual_all(Rs2, ts2)
        nrm2 = jnp.sqrt(jnp.sum(r2 * r2, -1) + 1e-12)
        wr2 = graph.w * jnp.minimum(1.0, huber / nrm2)
        c_new = jnp.sum(wr2 * jnp.sum(r2 * r2, -1))
        acc = c_new < c_old
        Rs = jnp.where(acc, Rs2, Rs)
        ts = jnp.where(acc, ts2, ts)
        lam = jnp.where(acc, lam * 0.5, lam * 4.0)
        return (Rs, ts, lam), c_new

    (Rs, ts, _), costs = lax.scan(step, (Rs, ts, jnp.float32(1e-4)), None, length=iters)
    return Rs, ts, costs[-1]

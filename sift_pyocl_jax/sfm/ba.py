"""Sparse bundle adjustment: Levenberg-Marquardt with a matrix-free
Schur-complement CG solve.

New subsystem — the distributed backend BASELINE.json specifies ("sparse
bundle adjustment with a Schur-complement reduction, keyframes and map blocks
sharded, camera/point reduction via collectives").  No reference
counterpart (SURVEY.md §2.3).

Design:
  * Observation-major layout: (M,) arrays of (cam_id, pt_id, uv, weight) with
    static capacity and 0-weight padding.
  * Per-observation 2x6 / 2x3 Jacobian blocks in closed form
    (geometry.project_jacobians) — checked against jacfwd in the tests.
  * Point (V) blocks: batched closed-form 3x3 inverses, always local.
  * The reduced camera system S = U_damped - W V^-1 W^T is never assembled:
    CG applies it matrix-free with two segment_sums and two gathers per
    matvec — dense, static-shape work, and every camera-side reduction is a
    single `psum` away from the multi-host version.
  * `axis_name` switches the same code between single-device and
    shard_map-distributed execution: observations and points are sharded,
    cameras are replicated, and exactly the camera-side reductions
    (U, g_c, CG matvec accumulator, cost, residual stats) cross the mesh.

Robustness: Huber IRLS weights re-evaluated each LM iteration.
Gauge: arbitrary cameras can be frozen via `fixed` mask (projected CG).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .geometry import pose_retract, project


class BAParams(NamedTuple):
    """Optimization parameters (the pytree being optimized)."""

    Rs: jnp.ndarray   # (C,3,3)
    ts: jnp.ndarray   # (C,3)
    X: jnp.ndarray    # (P,3)


class BAObs(NamedTuple):
    """Static-capacity observation table (sharded along M when distributed)."""

    uv: jnp.ndarray   # (M,2) f32 pixel measurements
    cam: jnp.ndarray  # (M,) int32
    pt: jnp.ndarray   # (M,) int32 (LOCAL point index when sharded)
    w: jnp.ndarray    # (M,) f32, 0 = padding


def _psum(x, axis_name):
    return lax.psum(x, axis_name) if axis_name is not None else x


# --- reduction helpers -----------------------------------------------------
# XLA lowers segment_sum to scatter-add, which serializes on duplicate
# indices — at VO shapes (M=4k obs, C=8 cams, P=2k points) the scatters can
# outweigh the FLOPs of the BA iteration.  Two structure-exploiting paths:
#   * cam_blocked: the VO window stores observations in per-frame BLOCKS
#     (obs.cam == repeat(arange(C), M//C)), so camera reductions are a
#     reshape + sum and camera gathers a broadcast — no scatter, no gather.
#   * pt_onehot: point reductions/gathers become matmuls against a one-hot
#     (P, M) matrix built ONCE per LM iteration (matmul work + one 33 MB
#     read per CG matvec instead of a serialized scatter).


def _seg_cam(vals, cam, n_cams, blocked):
    if blocked:
        return vals.reshape((n_cams, -1) + vals.shape[1:]).sum(axis=1)
    return jax.ops.segment_sum(vals, cam, num_segments=n_cams)


def _take_cam(x, cam, blocked):
    if blocked:
        m = cam.shape[0]
        reps = m // x.shape[0]
        return jnp.broadcast_to(
            x[:, None], (x.shape[0], reps) + x.shape[1:]
        ).reshape((m,) + x.shape[1:])
    return x[cam]


def _pt_onehot_matrix(pt, n_points):
    """(P, M) f32 one-hot of obs.pt (pt < 0 rows are all-zero, matching
    segment_sum's drop of negative ids)."""
    return (
        pt[None, :] == jnp.arange(n_points, dtype=pt.dtype)[:, None]
    ).astype(jnp.float32)


def _seg_pt(vals, pt, n_points, G):
    if G is not None:
        flat = vals.reshape(vals.shape[0], -1)
        out = lax.dot_general(
            G, flat, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return out.reshape((n_points,) + vals.shape[1:])
    return jax.ops.segment_sum(vals, pt, num_segments=n_points)


def _take_pt(y, pt, G):
    """y[pt] as G^T @ y when G is given (pt < 0 rows read zero — callers
    always multiply these rows by zero-weight W blocks)."""
    if G is not None:
        flat = y.reshape(y.shape[0], -1)
        out = lax.dot_general(
            G, flat, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return out.reshape((pt.shape[0],) + y.shape[1:])
    return y[pt]


def residuals(params: BAParams, obs: BAObs, K) -> jnp.ndarray:
    """(M,2) reprojection residuals."""
    R = params.Rs[obs.cam]
    t = params.ts[obs.cam]
    X = params.X[obs.pt]
    p, _ = jax.vmap(lambda R_, t_, X_: project(K, R_, t_, X_))(R, t, X)
    return p - obs.uv


def robust_weights(r: jnp.ndarray, w: jnp.ndarray, huber_px: float) -> jnp.ndarray:
    """Huber IRLS weights on the residual norm."""
    nrm = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
    return w * jnp.minimum(1.0, huber_px / nrm)


def robust_cost(r: jnp.ndarray, w: jnp.ndarray, huber_px: float, axis_name=None):
    """Sum of Huber losses (the true objective used for accept/reject)."""
    n2 = jnp.sum(r * r, axis=-1)
    nrm = jnp.sqrt(n2 + 1e-12)
    quad = 0.5 * n2
    lin = huber_px * (nrm - 0.5 * huber_px)
    cost = jnp.sum(w * jnp.where(nrm <= huber_px, quad, lin))
    return _psum(cost, axis_name)


def _jac_blocks(params: BAParams, obs: BAObs, K):
    """Per-observation Jacobians: (M,2,6) wrt camera tangent, (M,2,3) wrt point.

    Closed-form (geometry.project_jacobians) — the earlier per-observation
    `jacfwd` formulation traced se3_exp with 9 tangents per observation and
    dominated the BA build cost at VO shapes."""
    from .geometry import project_jacobians

    return project_jacobians(
        K, params.Rs[obs.cam], params.ts[obs.cam], params.X[obs.pt]
    )


def _inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], -1),
            jnp.stack([A21, A22, A23], -1),
            jnp.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


class _System(NamedTuple):
    U: jnp.ndarray      # (C,6,6) damped camera blocks (already psum'd)
    Vinv: jnp.ndarray   # (P,3,3) inverted damped point blocks (local)
    W: jnp.ndarray      # (M,6,3) cross blocks (local)
    g_c: jnp.ndarray    # (C,6)   camera gradient (psum'd)
    g_p: jnp.ndarray    # (P,3)   point gradient (local)
    G: Optional[jnp.ndarray]  # (P,M) one-hot of obs.pt when pt_onehot


def build_system(
    params: BAParams,
    obs: BAObs,
    K,
    lam: jnp.ndarray,
    huber_px: float,
    n_points: int,
    axis_name=None,
    cam_blocked: bool = False,
    pt_onehot: bool = False,
) -> Tuple[_System, jnp.ndarray]:
    """Weighted, damped normal-equation blocks; returns (system, robust cost)."""
    r = residuals(params, obs, K)
    wq = robust_weights(r, obs.w, huber_px)
    cost = robust_cost(r, obs.w, huber_px, axis_name)
    Jc, Jp = _jac_blocks(params, obs, K)
    n_cams = params.Rs.shape[0]
    G = _pt_onehot_matrix(obs.pt, n_points) if pt_onehot else None

    JcT = jnp.swapaxes(Jc, 1, 2)  # (M,6,2)
    JpT = jnp.swapaxes(Jp, 1, 2)  # (M,3,2)
    wq_ = wq[:, None, None]
    Um = wq_ * (JcT @ Jc)                 # (M,6,6)
    Vm = wq_ * (JpT @ Jp)                 # (M,3,3)
    W = wq_ * (JcT @ Jp)                  # (M,6,3)
    gcm = -(wq[:, None] * jnp.einsum("mij,mj->mi", JcT, r))  # (M,6)
    gpm = -(wq[:, None] * jnp.einsum("mij,mj->mi", JpT, r))  # (M,3)

    U = _seg_cam(Um, obs.cam, n_cams, cam_blocked)
    g_c = _seg_cam(gcm, obs.cam, n_cams, cam_blocked)
    U = _psum(U, axis_name)
    g_c = _psum(g_c, axis_name)
    V = _seg_pt(Vm, obs.pt, n_points, G)
    g_p = _seg_pt(gpm, obs.pt, n_points, G)

    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    # Marquardt damping: lam * (diag + small identity floor)
    U = U + lam * (eye6 * jnp.diagonal(U, axis1=1, axis2=2)[:, :, None] * eye6 + 1e-8 * eye6)
    V = V + lam * (eye3 * jnp.diagonal(V, axis1=1, axis2=2)[:, :, None] * eye3 + 1e-8 * eye3)
    return _System(U, _inv3(V), W, g_c, g_p, G), cost


def _schur_matvec(sys: _System, obs: BAObs, x: jnp.ndarray, free: jnp.ndarray,
                  n_points: int, axis_name=None,
                  cam_blocked: bool = False) -> jnp.ndarray:
    """Apply S = U - W V^-1 W^T to x (C,6) without assembling S."""
    x = x * free[:, None]
    xg = _take_cam(x, obs.cam, cam_blocked)
    u = jnp.einsum("mij,mi->mj", sys.W, xg)                   # (M,3) = W^T x
    q = _seg_pt(u, obs.pt, n_points, sys.G)                   # (P,3)
    y = jnp.einsum("pij,pj->pi", sys.Vinv, q)                 # (P,3)
    z = jnp.einsum("mij,mj->mi", sys.W, _take_pt(y, obs.pt, sys.G))  # (M,6)
    acc = _seg_cam(z, obs.cam, x.shape[0], cam_blocked)
    acc = _psum(acc, axis_name)
    Ux = jnp.einsum("cij,cj->ci", sys.U, x)
    return (Ux - acc) * free[:, None]


def _cg(matvec, b, iters: int):
    """Fixed-iteration conjugate gradients (b and x are (C,6) pytrees-as-arrays)."""
    x0 = jnp.zeros_like(b)
    r0 = b
    p0 = r0
    rs0 = jnp.sum(r0 * r0)

    def body(_, st):
        x, r, p, rs = st
        Ap = matvec(p)
        denom = jnp.sum(p * Ap)
        alpha = rs / jnp.where(jnp.abs(denom) > 1e-20, denom, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.sum(r * r)
        beta = rs_new / jnp.where(rs > 1e-20, rs, 1e-20)
        p = r + beta * p
        return (x, r, p, rs_new)

    x, _, _, _ = lax.fori_loop(0, iters, body, (x0, r0, p0, rs0))
    return x


def solve_step_dense(
    sys: _System, obs: BAObs, free: jnp.ndarray, n_points: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact Schur solve for small camera counts (the VO window: 6C <= ~100).

    Assembles S = U - W V^-1 W^T explicitly as a (6C, 6C) matrix and solves
    it directly — replaces cg_iters matrix-free matvecs (each a full pass
    over the one-hot G) with ONE pass to build the per-point camera blocks
    A[p,c] = sum_{m: pt=p, cam=c} W_m and a tiny dense solve.  Requires
    cam_blocked layout and pt_onehot=True (sys.G present).
    """
    C = sys.U.shape[0]
    M = obs.pt.shape[0]
    obs_f = M // C
    hp = jax.lax.Precision.HIGHEST
    Wb = sys.W.reshape(C, obs_f, 6, 3)
    Gb = sys.G.reshape(n_points, C, obs_f)
    # A[p,c] (6,3): camera-c cross block restricted to point p
    A = jnp.einsum("pcf,cfij->pcij", Gb, Wb, precision=hp)
    T = jnp.einsum("pcij,pjk->pcik", A, sys.Vinv, precision=hp)  # A V^-1
    S2 = jnp.einsum("pcik,pdjk->cidj", T, A, precision=hp)  # (C,6,C,6)
    # U on the block diagonal, minus the point-coupling blocks (no scatter)
    Ubd = jnp.einsum("cij,cd->cidj", sys.U, jnp.eye(C, dtype=sys.U.dtype))
    S = (Ubd - S2).reshape(C * 6, C * 6)
    b = sys.g_c - jnp.einsum("pcij,pj->ci", T, sys.g_p, precision=hp)
    # gauge fixing: zero fixed-camera rows/cols, identity on their diagonal
    m6 = jnp.repeat(free.astype(S.dtype), 6)
    S = S * m6[:, None] * m6[None, :] + jnp.diag(1.0 - m6)
    b = b.reshape(-1) * m6
    dc = jnp.linalg.solve(S, b).reshape(C, 6)
    # back-substitute points: dp = V^-1 (g_p - W^T dc)
    q = jnp.einsum("pcij,ci->pj", A, dc, precision=hp)
    dp = jnp.einsum("pij,pj->pi", sys.Vinv, sys.g_p - q)
    return dc, dp


def solve_step(
    sys: _System, obs: BAObs, free: jnp.ndarray, n_points: int,
    cg_iters: int = 30, axis_name=None, cam_blocked: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One damped step: camera updates (C,6) and point updates (P,3)."""
    # Schur RHS: b = g_c - W V^-1 g_p   (camera side, reduced over shards)
    y = jnp.einsum("pij,pj->pi", sys.Vinv, sys.g_p)           # (P,3)
    z = jnp.einsum("mij,mj->mi", sys.W, _take_pt(y, obs.pt, sys.G))  # (M,6)
    red = _seg_cam(z, obs.cam, sys.g_c.shape[0], cam_blocked)
    red = _psum(red, axis_name)
    b = (sys.g_c - red) * free[:, None]
    mv = lambda x: _schur_matvec(sys, obs, x, free, n_points, axis_name,
                                 cam_blocked)
    dc = _cg(mv, b, cg_iters)
    # back-substitute points: dp = V^-1 (g_p - W^T dc)
    u = jnp.einsum("mij,mi->mj", sys.W, _take_cam(dc, obs.cam, cam_blocked))
    q = _seg_pt(u, obs.pt, n_points, sys.G)
    dp = jnp.einsum("pij,pj->pi", sys.Vinv, sys.g_p - q)
    return dc, dp


def apply_step(params: BAParams, dc: jnp.ndarray, dp: jnp.ndarray) -> BAParams:
    Rs, ts = jax.vmap(pose_retract)(params.Rs, params.ts, dc)
    return BAParams(Rs, ts, params.X + dp)


@partial(
    jax.jit,
    static_argnames=("huber_px", "cg_iters", "n_points", "axis_name",
                     "cam_blocked", "pt_onehot", "dense_schur"),
)
def lm_iteration(
    params: BAParams,
    obs: BAObs,
    K: jnp.ndarray,
    lam: jnp.ndarray,
    free: jnp.ndarray,
    huber_px: float = 2.0,
    cg_iters: int = 30,
    n_points: int = 0,
    axis_name=None,
    cam_blocked: bool = False,
    pt_onehot: bool = False,
    dense_schur: bool = False,
):
    """One accept/reject LM iteration.  Returns (params, lam, cost, accepted).

    cam_blocked: observations are stored in per-camera blocks (obs.cam ==
    repeat(arange(C), M//C), the VO window layout) — camera reductions
    become reshape+sum instead of serialized scatter-adds.
    pt_onehot: point reductions/gathers via one-hot matmuls instead
    of scatter/gather — wins when M*P is small enough for the (P,M) one-hot
    to be cheap (VO shapes), loses at large SfM sizes.
    dense_schur: assemble and solve the (6C,6C) reduced camera system
    exactly instead of running CG — strictly better steps AND cheaper when
    C is small (requires cam_blocked and pt_onehot)."""
    if dense_schur:
        assert cam_blocked and pt_onehot, "dense_schur needs both layouts"
    nP = n_points or params.X.shape[0]
    sys, cost = build_system(params, obs, K, lam, huber_px, nP, axis_name,
                             cam_blocked, pt_onehot)
    if dense_schur:
        dc, dp = solve_step_dense(sys, obs, free, nP)
    else:
        dc, dp = solve_step(sys, obs, free, nP, cg_iters, axis_name,
                            cam_blocked)
    cand = apply_step(params, dc, dp)
    r_new = residuals(cand, obs, K)
    new_cost = robust_cost(r_new, obs.w, huber_px, axis_name)
    accept = new_cost < cost
    params = jax.tree.map(
        lambda a, b: jnp.where(accept, a, b), cand, params
    )
    lam = jnp.where(accept, jnp.maximum(lam * 0.4, 1e-9), jnp.minimum(lam * 4.0, 1e6))
    return params, lam, cost, accept


def run_ba(
    params: BAParams,
    obs: BAObs,
    K,
    fixed_cams=(0,),
    iters: int = 20,
    huber_px: float = 2.0,
    cg_iters: int = 30,
    lam0: float = 1e-3,
    verbose: bool = False,
    fetch_costs: bool = True,
):
    """Host-driven LM loop (single device).  Returns (params, costs).

    fetch_costs=False skips the per-iteration host fetch of the cost
    scalar: the iterations then pipeline as pure async dispatches with no
    device->host sync between them (IncrementalSfM's periodic BA, which
    never reads the costs, runs this way), and only the final cost is
    fetched."""
    C = params.Rs.shape[0]
    free = jnp.ones((C,), jnp.float32).at[jnp.array(fixed_cams)].set(0.0)
    lam = jnp.float32(lam0)
    costs = []
    cost = None
    for it in range(iters):
        params, lam, cost, acc = lm_iteration(
            params, obs, K, lam, free,
            huber_px=huber_px, cg_iters=cg_iters, n_points=params.X.shape[0],
        )
        if fetch_costs:
            costs.append(float(cost))
        if verbose:
            print(f"  LM it {it}: cost {float(cost):.4f} lam {float(lam):.2e} acc {bool(acc)}")
    if not fetch_costs and cost is not None:
        costs.append(float(cost))
    return params, costs

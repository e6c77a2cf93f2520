"""On-device 2D pose-graph optimizer (Levenberg–Marquardt, dense normal eqs).

Replacement for the Ceres solver vendored by the reference
(/root/reference/src/optimization_2d/pose_graph_2d.cc).  Same problem, new
solve path:

- residual per edge ``[R(θa)ᵀ(pb−pa) − p̂ab ; normalize(θb−θa−θ̂ab)]``
  whitened by √information — parity with ``PoseGraph2dErrorTerm``
  (/root/reference/include/optimization_2d/pose_graph_2d_error_term.h:62-116),
- angles live on the circle: residuals are wrapped and parameters
  re-normalized after every accepted step — the manifold treatment of
  ``AngleLocalParameterization``
  (/root/reference/include/optimization_2d/angle_local_parameterization.h),
- the base pose (slot 0) is held constant
  (/root/reference/src/optimization_2d/pose_graph_2d.cc:104-108),
- Levenberg–Marquardt with adaptive damping, bounded iterations — the
  reference runs LM over SPARSE_NORMAL_CHOLESKY with ≤300 iterations
  (/root/reference/src/optimization_2d/pose_graph_2d.cc:186-200).

Instead of Ceres' sparse Cholesky on CPU, the normal equations are assembled
**densely** by scatter-adding 3×3 edge blocks into a ``(3K, 3K)`` matrix and
solved with an on-device Cholesky — SLAM graphs here are ≤ a few thousand
nodes, where one fused assembly + ``cho_solve`` beats any sparse structure on
the accelerator.  Everything is masked static-shape, so the whole solve runs under
``jit``/``lax.cond`` inside the SLAM step.  A matrix-free CG variant for
sharded multi-host graphs lives in ``nislam_tpu.parallel.solver``.

The **with-scale** variant (``PoseGraph2dErrorTermWithScale``,
pose_graph_2d_error_term.h:119-177) jointly estimates one global metric scale
``s`` multiplying every translation measurement, free iff the camera height
is inaccurate (/root/reference/src/map_builder.cc:219-227; wired but disabled
in the reference — implemented for real here, SURVEY §7 non-goals note).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from nislam_tpu.core.se2 import einsum, normalize_angle, rotation2d


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    max_iterations: int = 100
    mu_init: float = 1e-4
    mu_factor: float = 10.0
    mu_min: float = 1e-9
    mu_max: float = 1e8
    # Relative cost-decrease stop — Ceres' function_tolerance default (1e-6,
    # what the reference's Solve inherits); 1e-9 would run every solve to
    # max_iterations.
    rtol: float = 1e-6
    estimate_scale: bool = False  # with-scale variant


class PoseGraphProblem(NamedTuple):
    """Static-shape masked pose-graph instance (robot-frame constraints)."""

    poses: jnp.ndarray  # (K, 3) initial values
    pose_mask: jnp.ndarray  # (K,) bool — live slots
    from_slot: jnp.ndarray  # (E,) i32
    to_slot: jnp.ndarray  # (E,) i32
    T: jnp.ndarray  # (E, 3) measured relative pose (robot frame)
    sqrt_info: jnp.ndarray  # (E, 3, 3) — Iᵀ/² (LLT factor, matrixL)
    edge_mask: jnp.ndarray  # (E,) bool


def sqrt_information(info: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky factor of the information matrix — the reference
    whitens with ``information.llt().matrixL()``
    (pose_graph_2d.cc:74: sqrt_information)."""
    return jnp.linalg.cholesky(info)


def residuals(
    poses: jnp.ndarray, prob: PoseGraphProblem, scale: jnp.ndarray
) -> jnp.ndarray:
    """(E, 3) whitened residuals; masked edges contribute zero."""
    pa = poses[prob.from_slot]
    pb = poses[prob.to_slot]
    rat = rotation2d(pa[:, 2])  # (E, 2, 2)
    dp = pb[:, :2] - pa[:, :2]
    r_xy = einsum("eji,ej->ei", rat, dp) - scale * prob.T[:, :2]
    r_th = normalize_angle(pb[:, 2] - pa[:, 2] - prob.T[:, 2])
    r = jnp.concatenate([r_xy, r_th[:, None]], axis=-1)
    r = einsum("eij,ej->ei", prob.sqrt_info, r)
    return jnp.where(prob.edge_mask[:, None], r, 0.0)


def _edge_jacobians(
    poses: jnp.ndarray, prob: PoseGraphProblem, scale: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Analytic whitened Jacobians (Ja, Jb, Js) per edge.

    Ja = ∂r/∂pose_a (E,3,3), Jb = ∂r/∂pose_b, Js = ∂r/∂s (E,3).
    """
    pa = poses[prob.from_slot]
    pb = poses[prob.to_slot]
    th = pa[:, 2]
    c, s = jnp.cos(th), jnp.sin(th)
    dp = pb[:, :2] - pa[:, :2]
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    # Rᵀ(θa) and dRᵀ/dθ · (pb - pa)
    # Rᵀ = [[c, s], [-s, c]]; dRᵀ/dθ = [[-s, c], [-c, -s]]
    drt_dp = jnp.stack(
        [-s * dp[:, 0] + c * dp[:, 1], -c * dp[:, 0] - s * dp[:, 1]], axis=-1
    )
    ja = jnp.stack(
        [
            jnp.stack([-c, -s, drt_dp[:, 0]], axis=-1),
            jnp.stack([s, -c, drt_dp[:, 1]], axis=-1),
            jnp.stack([zeros, zeros, -ones], axis=-1),
        ],
        axis=-2,
    )  # (E, 3, 3)
    jb = jnp.stack(
        [
            jnp.stack([c, s, zeros], axis=-1),
            jnp.stack([-s, c, zeros], axis=-1),
            jnp.stack([zeros, zeros, ones], axis=-1),
        ],
        axis=-2,
    )
    js = jnp.concatenate([-prob.T[:, :2], jnp.zeros_like(th)[:, None]], axis=-1)
    ja = einsum("eij,ejk->eik", prob.sqrt_info, ja)
    jb = einsum("eij,ejk->eik", prob.sqrt_info, jb)
    js = einsum("eij,ej->ei", prob.sqrt_info, js)
    m = prob.edge_mask[:, None]
    return ja * m[..., None], jb * m[..., None], js * m


def _assemble_normal_eqs(
    poses: jnp.ndarray, prob: PoseGraphProblem, scale: jnp.ndarray, est_scale: bool
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Dense H = JᵀJ (N,N), g = Jᵀr (N,), and the current cost.

    N = 3K (+1 when estimating scale).  Block scatter-add with duplicate
    indices — XLA lowers ``.at[].add`` with repeated rows to a deterministic
    on-device scatter.
    """
    k = poses.shape[0]
    r = residuals(poses, prob, scale)
    cost = 0.5 * jnp.sum(r * r)
    ja, jb, js = _edge_jacobians(poses, prob, scale)

    haa = einsum("eji,ejk->eik", ja, ja)
    hab = einsum("eji,ejk->eik", ja, jb)
    hbb = einsum("eji,ejk->eik", jb, jb)
    ga = einsum("eji,ej->ei", ja, r)
    gb = einsum("eji,ej->ei", jb, r)

    h = jnp.zeros((k, 3, k, 3), jnp.float32)
    f, t = prob.from_slot, prob.to_slot
    h = h.at[f, :, f, :].add(haa)
    h = h.at[f, :, t, :].add(hab)
    h = h.at[t, :, f, :].add(jnp.swapaxes(hab, -1, -2))
    h = h.at[t, :, t, :].add(hbb)
    g = jnp.zeros((k, 3), jnp.float32).at[f].add(ga).at[t].add(gb)

    h = h.reshape(3 * k, 3 * k)
    g = g.reshape(3 * k)
    if est_scale:
        hs_col = jnp.zeros((k, 3), jnp.float32)
        hs_col = hs_col.at[f].add(einsum("eij,ei->ej", ja, js))
        hs_col = hs_col.at[t].add(einsum("eij,ei->ej", jb, js))
        hs_col = hs_col.reshape(3 * k)
        hss = jnp.sum(js * js)
        gs = jnp.sum(js * r)
        h = jnp.block(
            [[h, hs_col[:, None]], [hs_col[None, :], hss[None, None]]]
        )
        g = jnp.concatenate([g, gs[None]])
    return h, g, cost


def _pin(h: jnp.ndarray, g: jnp.ndarray, free: jnp.ndarray):
    """Clamp non-free variables: unit diagonal rows/cols, zero gradient.

    Pins the base pose and all dead slots — the masked-static analogue of
    ``problem->SetParameterBlockConstant`` (pose_graph_2d.cc:104-108)."""
    fm = free.astype(h.dtype)
    h = h * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
    return h, g * fm


def solve_pose_graph(
    prob: PoseGraphProblem,
    cfg: SolverConfig = SolverConfig(),
    *,
    init_scale: float | jnp.ndarray = 1.0,
    scale_free: bool | jnp.ndarray = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """LM solve; returns ``(poses, scale, final_cost)``.

    Fully jittable: runs a ``lax.while_loop`` over damped Gauss-Newton steps
    with gain-ratio-free accept/reject damping (classic LM μ schedule).
    """
    k = prob.poses.shape[0]
    n = 3 * k + (1 if cfg.estimate_scale else 0)
    free = jnp.repeat(prob.pose_mask, 3).at[:3].set(False)  # pin base slot 0
    if cfg.estimate_scale:
        free = jnp.concatenate(
            [free, jnp.asarray(scale_free, bool).reshape(1)]
        )

    def pack(poses, scale):
        x = poses.reshape(3 * k)
        if cfg.estimate_scale:
            x = jnp.concatenate([x, jnp.asarray(scale, jnp.float32).reshape(1)])
        return x

    def unpack(x):
        poses = x[: 3 * k].reshape(k, 3)
        scale = x[3 * k] if cfg.estimate_scale else jnp.asarray(1.0, jnp.float32)
        return poses, scale

    def norm_poses(poses):
        return poses.at[:, 2].set(normalize_angle(poses[:, 2]))

    x0 = pack(norm_poses(prob.poses), jnp.asarray(init_scale, jnp.float32))

    def cost_of(x):
        poses, scale = unpack(x)
        r = residuals(poses, prob, scale)
        return 0.5 * jnp.sum(r * r)

    def body(state):
        x, mu, cost, it, done = state
        poses, scale = unpack(x)
        h, g, _ = _assemble_normal_eqs(poses, prob, scale, cfg.estimate_scale)
        h, g = _pin(h, g, free)
        hd = h + mu * jnp.diag(jnp.diag(h))  # LM: scale-invariant damping
        # Cholesky solve of the damped SPD system.
        l = jnp.linalg.cholesky(hd)
        delta = jax.scipy.linalg.cho_solve((l, True), -g)
        solve_ok = jnp.all(jnp.isfinite(delta))
        x_new = x + jnp.where(solve_ok, delta, 0.0)
        p_new, s_new = unpack(x_new)
        x_new = pack(norm_poses(p_new), s_new)
        new_cost = cost_of(x_new)
        accept = jnp.logical_and(solve_ok, new_cost < cost)
        x = jnp.where(accept, x_new, x)
        rel_drop = (cost - new_cost) / jnp.maximum(cost, 1e-30)
        done = jnp.logical_and(accept, rel_drop < cfg.rtol)
        cost = jnp.where(accept, new_cost, cost)
        mu = jnp.where(
            accept,
            jnp.maximum(mu / cfg.mu_factor, cfg.mu_min),
            jnp.minimum(mu * cfg.mu_factor, cfg.mu_max),
        )
        return x, mu, cost, it + 1, done

    def cond(state):
        _, mu, _, it, done = state
        return jnp.logical_and(
            it < cfg.max_iterations, jnp.logical_and(~done, mu < cfg.mu_max)
        )

    state = (
        x0,
        jnp.asarray(cfg.mu_init, jnp.float32),
        cost_of(x0),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )
    x, _, cost, _, _ = jax.lax.while_loop(cond, body, state)
    poses, scale = unpack(x)
    # Dead slots keep their (zero) values; base stays pinned by construction.
    poses = jnp.where(prob.pose_mask[:, None], poses, prob.poses)
    return poses, scale, cost

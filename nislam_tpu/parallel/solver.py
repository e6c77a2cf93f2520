"""Distributed pose-graph solver: edge-sharded Gauss-Newton over collectives.

BASELINE config 5: the pose-graph solve for multi-host maps.  The dense
LM/Cholesky solver (``nislam_tpu.core.pose_graph``) is ideal up to a few
thousand poses on one chip; at larger scale the edges are sharded across
devices and the reduced normal equations are never materialized — each
Gauss-Newton step solves ``(JᵀJ + μD) δ = −Jᵀr`` **matrix-free** with
Jacobi-preconditioned conjugate gradients, where every Hessian-vector
product is assembled from the local edge shard and combined with one
``psum`` over the mesh axis (the analogue of a distributed
Schur solve; cf. SURVEY §2.3).

Poses are replicated (they are tiny: 3K floats); edges — the O(E) data —
are sharded.  The whole solver runs inside one ``shard_map``, so every CG
iteration costs exactly one ``psum`` of a (3K,) vector over the mesh.

Same residual/whitening/pinning semantics as the dense solver (and the
Ceres reference it mirrors — /root/reference/src/optimization_2d/).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nislam_tpu.core.pose_graph import PoseGraphProblem, _edge_jacobians, residuals
from nislam_tpu.core.se2 import einsum, normalize_angle


@dataclasses.dataclass(frozen=True)
class CGSolverConfig:
    outer_iterations: int = 20  # Gauss-Newton steps
    cg_iterations: int = 64  # CG steps per GN step
    cg_tol: float = 1e-6
    damping: float = 1e-6  # Levenberg diagonal damping


def _local_jtj_vec(
    poses: jnp.ndarray, prob: PoseGraphProblem, x: jnp.ndarray
) -> jnp.ndarray:
    """Local-shard JᵀJ·x (shape (K, 3)) — no collectives."""
    ja, jb, _ = _edge_jacobians(poses, prob, jnp.float32(1.0))
    xa = x[prob.from_slot]  # (E, 3)
    xb = x[prob.to_slot]
    jx = einsum("eij,ej->ei", ja, xa) + einsum("eij,ej->ei", jb, xb)
    out = jnp.zeros_like(x)
    out = out.at[prob.from_slot].add(einsum("eij,ei->ej", ja, jx))
    out = out.at[prob.to_slot].add(einsum("eij,ei->ej", jb, jx))
    return out


def _local_grad_and_diag(
    poses: jnp.ndarray, prob: PoseGraphProblem
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Local Jᵀr, diag(JᵀJ), and ½‖r‖² for the shard."""
    r = residuals(poses, prob, jnp.float32(1.0))
    ja, jb, _ = _edge_jacobians(poses, prob, jnp.float32(1.0))
    g = jnp.zeros_like(poses)
    g = g.at[prob.from_slot].add(einsum("eij,ei->ej", ja, r))
    g = g.at[prob.to_slot].add(einsum("eij,ei->ej", jb, r))
    d = jnp.zeros_like(poses)
    d = d.at[prob.from_slot].add(einsum("eij,eij->ej", ja, ja))
    d = d.at[prob.to_slot].add(einsum("eij,eij->ej", jb, jb))
    cost = 0.5 * jnp.sum(r * r)
    return g, d, cost


def solve_pose_graph_cg(
    prob: PoseGraphProblem,
    mesh: Mesh,
    axis: str = "bank",
    cfg: CGSolverConfig = CGSolverConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Distributed GN-CG solve; returns (poses, final_cost).

    ``prob`` edge arrays must be padded to a multiple of the mesh axis size
    (masked edges contribute zero).  Poses are replicated in/out.
    """
    nshards = mesh.shape[axis]
    e = prob.from_slot.shape[0]
    if e % nshards:
        raise ValueError(f"edge capacity {e} not divisible by {nshards} shards")

    def solver(poses, pose_mask, from_slot, to_slot, T, sqrt_info, edge_mask):
        # Pin base slot + dead slots.  Computed INSIDE the manual region —
        # a closure-captured array would carry an Auto-mesh sharding into
        # the Manual context and fail mesh-consistency checks.
        free = jnp.logical_and(
            pose_mask, jnp.arange(poses.shape[0]) > 0
        )[:, None]
        local = PoseGraphProblem(
            poses=poses,
            pose_mask=pose_mask,
            from_slot=from_slot,
            to_slot=to_slot,
            T=T,
            sqrt_info=sqrt_info,
            edge_mask=edge_mask,
        )

        def psum(v):
            return jax.lax.psum(v, axis)

        def gn_step(_, poses):
            g, d, _ = _local_grad_and_diag(poses, local)
            g = psum(g)
            d = psum(d)
            g = jnp.where(free, g, 0.0)
            dinv = jnp.where(free, 1.0 / (d + cfg.damping + 1e-12), 0.0)

            def hvp(x):
                hx = psum(_local_jtj_vec(poses, local, x)) + cfg.damping * x
                return jnp.where(free, hx, 0.0)

            # Jacobi-preconditioned CG on H δ = −g.
            b = -g
            x0 = jnp.zeros_like(b)
            r0 = b
            z0 = dinv * r0
            p0 = z0
            rz0 = jnp.sum(r0 * z0)

            def cg_body(state):
                x, r, p, rz, it = state
                hp = hvp(p)
                alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-30)
                x = x + alpha * p
                r = r - alpha * hp
                z = dinv * r
                rz_new = jnp.sum(r * z)
                beta = rz_new / jnp.maximum(rz, 1e-30)
                p = z + beta * p
                return x, r, p, rz_new, it + 1

            def cg_cond(state):
                _, r, _, _, it = state
                return jnp.logical_and(
                    it < cfg.cg_iterations, jnp.sum(r * r) > cfg.cg_tol**2
                )

            delta, *_ = jax.lax.while_loop(
                cg_cond, cg_body, (x0, r0, p0, rz0, jnp.int32(0))
            )
            poses = poses + jnp.where(free, delta, 0.0)
            return poses.at[:, 2].set(normalize_angle(poses[:, 2]))

        poses = jax.lax.fori_loop(0, cfg.outer_iterations, gn_step, poses)
        _, _, cost = _local_grad_and_diag(poses, local)
        return poses, psum(cost)

    sharded = jax.shard_map(
        solver,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
    )
    poses0 = prob.poses.at[:, 2].set(normalize_angle(prob.poses[:, 2]))
    poses, cost = sharded(
        poses0, prob.pose_mask, prob.from_slot, prob.to_slot, prob.T,
        prob.sqrt_info, prob.edge_mask,
    )
    poses = jnp.where(prob.pose_mask[:, None], poses, prob.poses)
    return poses, cost

"""SE(2) pose algebra — pure jnp, batched, f32.

Poses are ``(..., 3)`` arrays ``(x, y, θ)``.  Parity with
/root/reference/src/utils.cc:134-152 (``ComputeRelativePose`` /
``ComputeAbsolutePose``) and the Ceres angle normalization
(/root/reference/include/optimization_2d/normalize_angle.h:43-49).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

# Pose and pose-graph contractions feed keyframe decisions and the solve:
# keep them in full float32 (a GPU may otherwise run float32 dots in TF32).
einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def normalize_angle(theta: jnp.ndarray) -> jnp.ndarray:
    """Normalize radians into [-π, π)."""
    two_pi = 2.0 * math.pi
    return theta - two_pi * jnp.floor((theta + math.pi) / two_pi)


def rotation2d(theta: jnp.ndarray) -> jnp.ndarray:
    """(..., 2, 2) rotation matrix R(θ) — parity with ``RotationMatrix2D``
    (/root/reference/include/optimization_2d/pose_graph_2d_error_term.h:43-51)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def relative_pose(pose1: jnp.ndarray, pose2: jnp.ndarray) -> jnp.ndarray:
    """Pose of 2 expressed in frame 1: ``(R1ᵀ(p2−p1), normalize(θ2−θ1))``."""
    r1t = rotation2d(pose1[..., 2])
    dp = pose2[..., :2] - pose1[..., :2]
    xy = einsum("...ji,...j->...i", r1t, dp)
    th = normalize_angle(pose2[..., 2] - pose1[..., 2])
    return jnp.concatenate([xy, th[..., None]], axis=-1)


def absolute_pose(pose1: jnp.ndarray, rel: jnp.ndarray) -> jnp.ndarray:
    """Compose: world pose of ``rel`` given in frame ``pose1``."""
    r1 = rotation2d(pose1[..., 2])
    xy = pose1[..., :2] + einsum("...ij,...j->...i", r1, rel[..., :2])
    th = normalize_angle(pose1[..., 2] + rel[..., 2])
    return jnp.concatenate([xy, th[..., None]], axis=-1)

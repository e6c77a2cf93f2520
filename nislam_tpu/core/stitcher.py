"""Occupancy-mosaic map stitcher: scatter-add rasterization on device.

Re-design of ``MapStitcher`` (/root/reference/src/map_stitcher.cc).
The reference forward-rasterizes every keyframe pixel through its pose into
hash-keyed 1000×1000 integer cells with a per-pixel double loop
(map_stitcher.cc:95-111) and re-averages incrementally.  Here the map is a
bounded dense canvas of running sums — ``data`` (Σ intensity) and ``weight``
(Σ hits) — and one frame's insert is a single vectorized scatter-add of H·W
points; the full recompute after loop optimization (map_stitcher.cc:135-145,
the reference's most expensive event) is one ``lax.fori_loop`` of batched
scatters over the keyframe bank instead of a Python loop over hash maps.

Geometry parity (map_stitcher.cc:36-111): the frame pose (robot frame) is
converted robot → image-plane → center-based (``ConvertRobotPoseToImagePlane``
+ ``ConvertPrincipalToCenter``); each pixel (j, i) lands at
``int(R(θ)·(i−cx, j−cy) + t)`` with C truncation; intensities are scaled
to 0…100 (map_stitcher.cc:16-18).

Deviation (documented): the reference's incremental re-average multiplies the
new frame's cell *sum* by its hit count when merging (map_stitcher.cc:
113-132), which double-counts pixels that alias to the same output cell; we
keep exact running sums, which equals the reference whenever each output
pixel is hit ≤ once per frame (the common case) and is strictly more correct
otherwise.  The occupancy value published is ``100 − mean_intensity`` with
−1 for unseen cells, matching the ROS grid conversion
(/root/reference/src/visualization.cc:81-129).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from nislam_tpu.core.camera import CameraOps
from nislam_tpu.core.config import MapStitcherConfig
from nislam_tpu.core.map_store import KeyframeBank
from nislam_tpu.core.se2 import rotation2d


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StitchCanvas:
    """Bounded occupancy canvas; origin at the canvas center.

    Canvas pixel (row, col) covers image-plane world pixel
    ``(col − size/2, row − size/2)`` (x = image-plane u, y = v), i.e. the
    trajectory origin sits mid-canvas.
    """

    data: jnp.ndarray  # (S, S) f32 — Σ intensity (0..100 scale)
    weight: jnp.ndarray  # (S, S) f32 — Σ hits
    # Image-plane pixel at the canvas center (MapStitcherConfig.canvas_center;
    # static — part of the program, not state).
    center_x: int = dataclasses.field(default=0, metadata=dict(static=True))
    center_y: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def size(self) -> int:
        return self.data.shape[0]


def make_canvas(cfg: MapStitcherConfig) -> StitchCanvas:
    s = cfg.canvas_size
    cx, cy = cfg.canvas_center
    return StitchCanvas(
        data=jnp.zeros((s, s), jnp.float32),
        weight=jnp.zeros((s, s), jnp.float32),
        center_x=int(cx),
        center_y=int(cy),
    )


def _frame_targets(
    image_hw: Tuple[int, int], pose_robot: jnp.ndarray, camera: CameraOps
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Integer canvas-relative coordinates (x, y) of every pixel of a frame
    at ``pose_robot`` — the rasterization map of map_stitcher.cc:44-66."""
    h, w = image_hw
    image_pose = camera.principal_to_center(camera.robot_to_image_plane(pose_robot))
    r = rotation2d(image_pose[2])
    cx, cy = w / 2.0, h / 2.0
    iw = jnp.arange(w, dtype=jnp.float32) - cx  # (W,)
    ih = jnp.arange(h, dtype=jnp.float32)[:, None] - cy  # (H, 1)
    x = r[0, 0] * iw + r[0, 1] * ih + image_pose[0]  # (H, W)
    y = r[1, 0] * iw + r[1, 1] * ih + image_pose[1]
    # C truncation toward zero (static_cast<int>, map_stitcher.cc:98-99).
    return jnp.trunc(x).astype(jnp.int32), jnp.trunc(y).astype(jnp.int32)


def insert_frame(
    canvas: StitchCanvas,
    image: jnp.ndarray,
    pose_robot: jnp.ndarray,
    camera: CameraOps,
    *,
    enabled: jnp.ndarray | bool = True,
    sign: float = 1.0,
) -> StitchCanvas:
    """Rasterize one frame (f32 intensities in [0, 1]) into the canvas.

    ``InsertFrame`` + ``AddImageToOccupancy`` (map_stitcher.cc:14-111) as a
    single scatter-add.  Out-of-canvas points are dropped (the reference's
    infinite hash plane is bounded here; size the canvas to the deployment
    area).  ``enabled`` masks the write for use under jit.  ``sign=-1.0``
    SUBTRACTS the frame's contribution — the canvas keeps exact running
    sums, so removal is the negated scatter (used when ring eviction
    retires a keyframe from an online canvas; ADVICE r2 #3).
    """
    h, w = image.shape[-2], image.shape[-1]
    xi, yi = _frame_targets((h, w), pose_robot, camera)
    half = canvas.size // 2
    col = xi - canvas.center_x + half
    row = yi - canvas.center_y + half
    inb = (col >= 0) & (col < canvas.size) & (row >= 0) & (row < canvas.size)
    ok = jnp.logical_and(jnp.asarray(enabled), inb)
    # Flatten to 1D scatter; clamp dropped indices to 0 with zero weight.
    idx = jnp.where(ok, row * canvas.size + col, 0).reshape(-1)
    vals = jnp.where(ok, image * (sign * 100.0), 0.0).reshape(-1)
    wts = sign * ok.astype(jnp.float32).reshape(-1)
    data = canvas.data.reshape(-1).at[idx].add(vals).reshape(canvas.data.shape)
    wsum = canvas.weight.reshape(-1).at[idx].add(wts).reshape(canvas.weight.shape)
    return dataclasses.replace(canvas, data=data, weight=wsum)


def recompute(
    canvas: StitchCanvas, bank: KeyframeBank, camera: CameraOps
) -> StitchCanvas:
    """Full re-rasterization of every stored keyframe with current poses —
    ``RecomputeOccupancy`` (map_stitcher.cc:135-145), fired after loop
    optimization.  One fori_loop of masked scatters; O(K·H·W) scatter points
    total, entirely on device."""
    if bank.images.shape[1] == 0:
        raise ValueError(
            "keyframe bank stores no images (MapConfig.store_images=False); "
            "the stitcher needs raw frames to rasterize"
        )
    fresh = dataclasses.replace(
        canvas,
        data=jnp.zeros_like(canvas.data),
        weight=jnp.zeros_like(canvas.weight),
    )

    def body(i, cv):
        return insert_frame(
            cv, bank.images[i], bank.poses[i], camera, enabled=i < bank.count
        )

    return jax.lax.fori_loop(0, bank.capacity, body, fresh)


def occupancy_grid(canvas: StitchCanvas) -> jnp.ndarray:
    """(S, S) int8 occupancy: ``100 − mean intensity``, −1 where unseen —
    the ``nav_msgs::OccupancyGrid`` conversion of visualization.cc:81-129."""
    seen = canvas.weight >= 1.0
    mean = canvas.data / jnp.maximum(canvas.weight, 1.0)
    val = jnp.clip(100.0 - mean, 0.0, 100.0)
    return jnp.where(seen, val, -1.0).astype(jnp.int8)


def occupancy_origin(camera: CameraOps, canvas: StitchCanvas) -> jnp.ndarray:
    """Metric (x, y) of canvas pixel (0, 0) — ``GetOccupancyMapOrigin``
    (/root/reference/src/map_builder.cc:308-330): the image-plane pixel at
    the canvas corner converted to the robot frame."""
    half = canvas.size // 2
    corner = jnp.asarray(
        [canvas.center_x - half, canvas.center_y - half, 0.0], jnp.float32
    )
    return camera.image_plane_to_robot(corner)[:2]


def map_resolution(camera: CameraOps) -> jnp.ndarray:
    """Metric size of one canvas pixel — ``MapBuilder::GetMapResolution``
    → ``Camera::GetLengthOfPixel``."""
    return camera.length_of_pixel()

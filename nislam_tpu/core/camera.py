"""Camera model: undistortion + 2D pose coordinate conversions.

Behavioral parity with ``Camera`` (/root/reference/src/camera.cc).  The
undistortion remap grid (``initUndistortRectifyMap`` + optimal new camera
matrix, camera.cc:45-47) is precomputed once on the host — via OpenCV when
available for exact parity, else a numpy fallback — and applied on-device
as one bilinear gather fused into the front-end program.

The three 2D pose coordinate frames (camera.cc:136-242):

- **image plane**: pixels ``(u, v, θ)`` — raw KCC output,
- **camera / normalized**: ``(u/fx, v/fy, θ)``,
- **robot / metric**: ``extrinsics @ (h·x, h·y, θ)`` with camera height h.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nislam_tpu.core.config import CameraConfig
from nislam_tpu.core.se2 import einsum, rotation2d
from nislam_tpu.ops.warp import bilinear_sample


def _undistort_maps_numpy(cfg: CameraConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy fallback for cv2.getOptimalNewCameraMatrix(α=0) + initUndistortRectifyMap."""
    fx, cx, fy, cy = cfg.intrinsics
    k1, k2, p1, p2, k3 = cfg.distortion
    w, h = cfg.image_width, cfg.image_height

    def distort(xy):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([fx * xd + cx, fy * yd + cy], axis=-1)

    if not any(cfg.distortion):
        new_k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    else:
        # Inner-rectangle estimate: undistort a border grid (Newton inverse),
        # then fit the largest all-valid rectangle — the α=0 policy.
        n = 32
        us = np.linspace(0, w - 1, n)
        vs = np.linspace(0, h - 1, n)
        border = np.concatenate(
            [
                np.stack([us, np.zeros(n)], -1),
                np.stack([us, np.full(n, h - 1.0)], -1),
                np.stack([np.zeros(n), vs], -1),
                np.stack([np.full(n, w - 1.0), vs], -1),
            ]
        )
        xy = (border - np.array([cx, cy])) / np.array([fx, fy])
        und = xy.copy()
        for _ in range(20):
            d = (distort(und) - np.array([cx, cy])) / np.array([fx, fy])
            und = und + (xy - d)
        u0 = und[2 * n : 3 * n, 0].max()
        u1 = und[3 * n :, 0].min()
        v0 = und[:n, 1].max()
        v1 = und[n : 2 * n, 1].min()
        nfx = (w - 1) / max(u1 - u0, 1e-9)
        nfy = (h - 1) / max(v1 - v0, 1e-9)
        new_k = np.array([[nfx, 0, -nfx * u0], [0, nfy, -nfy * v0], [0, 0, 1.0]])

    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (uu - new_k[0, 2]) / new_k[0, 0]
    y = (vv - new_k[1, 2]) / new_k[1, 1]
    src = distort(np.stack([x, y], axis=-1))
    return src[..., 0].astype(np.float32), src[..., 1].astype(np.float32), new_k


def _undistort_maps(cfg: CameraConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    try:
        import cv2  # exact OpenCV parity when available

        fx, cx, fy, cy = cfg.intrinsics
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        d = np.asarray(cfg.distortion, np.float64)
        size = (cfg.image_width, cfg.image_height)
        new_k, _ = cv2.getOptimalNewCameraMatrix(k, d, size, 0, size)
        m1, m2 = cv2.initUndistortRectifyMap(k, d, None, new_k, size, cv2.CV_32FC1)
        return m1, m2, new_k
    except ImportError:
        return _undistort_maps_numpy(cfg)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraOps:
    """Device-side camera state: remap grid + frame-conversion constants."""

    cfg: CameraConfig = dataclasses.field(metadata=dict(static=True))
    identity_remap: bool = dataclasses.field(metadata=dict(static=True))
    map_x: jnp.ndarray  # (H, W) f32 source columns
    map_y: jnp.ndarray  # (H, W) f32 source rows
    new_k: jnp.ndarray  # (3, 3) f32 rectified intrinsics
    extrinsics: jnp.ndarray  # (3, 3) f32
    extrinsics_inv: jnp.ndarray  # (3, 3) f32

    # -- intrinsics of the rectified camera ---------------------------------
    @property
    def fx(self):
        return self.new_k[0, 0]

    @property
    def fy(self):
        return self.new_k[1, 1]

    # -- image I/O ----------------------------------------------------------
    def undistort(self, image: jnp.ndarray) -> jnp.ndarray:
        """``Camera::UndistortImage`` (camera.cc:92-103) as a bilinear gather."""
        if self.identity_remap:
            return image
        return bilinear_sample(image, self.map_x, self.map_y)

    # -- 2D pose frame conversions (camera.cc:136-242) ----------------------
    def image_plane_to_camera(self, pose: jnp.ndarray) -> jnp.ndarray:
        u, v, th = pose[..., 0], pose[..., 1], pose[..., 2]
        return jnp.stack([u / self.fx, v / self.fy, th], axis=-1)

    def camera_to_image_plane(self, pose: jnp.ndarray) -> jnp.ndarray:
        x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
        return jnp.stack([x * self.fx, y * self.fy, th], axis=-1)

    def camera_to_robot(self, pose: jnp.ndarray) -> jnp.ndarray:
        h = self.cfg.height
        v = jnp.stack([h * pose[..., 0], h * pose[..., 1], pose[..., 2]], axis=-1)
        return einsum("ij,...j->...i", self.extrinsics, v)

    def robot_to_camera(self, pose: jnp.ndarray) -> jnp.ndarray:
        h = self.cfg.height
        v = einsum("ij,...j->...i", self.extrinsics_inv, pose)
        return jnp.stack([v[..., 0] / h, v[..., 1] / h, v[..., 2]], axis=-1)

    def image_plane_to_robot(self, pose: jnp.ndarray) -> jnp.ndarray:
        return self.camera_to_robot(self.image_plane_to_camera(pose))

    def robot_to_image_plane(self, pose: jnp.ndarray) -> jnp.ndarray:
        return self.camera_to_image_plane(self.robot_to_camera(pose))

    def _o_bias(self) -> jnp.ndarray:
        """(W/2 − cx', H/2 − cy') — camera.cc:142,154."""
        return jnp.stack(
            [
                self.cfg.image_width * 0.5 - self.new_k[0, 2],
                self.cfg.image_height * 0.5 - self.new_k[1, 2],
            ]
        )

    def center_to_principal(self, pose: jnp.ndarray) -> jnp.ndarray:
        """``ConvertCenterToPrincipal`` (camera.cc:148-158): correlation
        shifts are about the image *center*; pose chains are about the
        *principal point*."""
        th = pose[..., 2]
        r = rotation2d(th)
        bias = self._o_bias()
        corr = bias - einsum("...ij,j->...i", r, bias)
        xy = pose[..., :2] + corr
        return jnp.concatenate([xy, th[..., None]], axis=-1)

    def principal_to_center(self, pose: jnp.ndarray) -> jnp.ndarray:
        """``ConvertPrincipalToCenter`` (camera.cc:136-146)."""
        th = pose[..., 2]
        r = rotation2d(th)
        bias = self._o_bias()
        corr = bias - einsum("...ij,j->...i", r, bias)
        xy = pose[..., :2] - corr
        return jnp.concatenate([xy, th[..., None]], axis=-1)

    def length_of_pixel(self) -> jnp.ndarray:
        """Metric size of one pixel — ``GetLengthOfPixel`` (camera.cc:129-134)."""
        real = self.image_plane_to_robot(jnp.array([1.0, 1.0, 0.0]))
        return (real[0] + real[1]) / 2.0


def make_camera_ops(cfg: CameraConfig) -> CameraOps:
    identity = not any(cfg.distortion)
    if identity:
        fx, cx, fy, cy = cfg.intrinsics
        new_k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float32)
        w, h = cfg.image_width, cfg.image_height
        map_x, map_y = np.meshgrid(
            np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
        )
    else:
        map_x, map_y, new_k = _undistort_maps(cfg)
    ext = np.asarray(cfg.extrinsics, np.float32).reshape(3, 3)
    return CameraOps(
        cfg=cfg,
        identity_remap=identity,
        map_x=jnp.asarray(map_x),
        map_y=jnp.asarray(map_y),
        new_k=jnp.asarray(new_k, dtype=jnp.float32),
        extrinsics=jnp.asarray(ext),
        extrinsics_inv=jnp.asarray(np.linalg.inv(ext)),
    )

"""Pinhole camera and ray generation (counterpart of
``ceres_tpu/models/camera.py``).

The reference camera model:

  dir      = normalize(camera.dir)
  image_u  = normalize(cross(dir, up)) * tan(fov * pi/360)
  image_v  = normalize(cross(image_u, dir)) * tan(fov * pi/360) * (h / w)
  u(i)     = 2 * (i + 0.5) / w - 1      (i along width)
  v(j)     = 2 * (j + 0.5) / h - 1      (j along height)
  ray      = (eye, normalize(u * image_u + v * image_v + dir))
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.models.mesh import cross

_PI = 3.14159265


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: eye, view direction (need not be normalised), up,
    and the full horizontal field of view in degrees."""

    eye: torch.Tensor  # (3,)
    dir: torch.Tensor  # (3,)
    up: torch.Tensor   # (3,)
    fov: torch.Tensor  # scalar

    @staticmethod
    def make(eye, dir, up, fov, dtype=torch.float32, device=None) -> "Camera":
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)
        return Camera(eye=t(eye), dir=t(dir), up=t(up), fov=t(fov))


def camera_basis(camera: Camera, width: int, height: int):
    """(dir, image_u, image_v) of the image plane."""
    d = _normalize(camera.dir)
    image_w = torch.tan(camera.fov * (_PI / 180.0 * 0.5))
    side = cross(d, camera.up)
    iu = _normalize(side) * image_w
    iv = _normalize(cross(side, d)) * image_w * (height / width)
    return d, iu, iv


def camera_ray_columns(camera: Camera, width: int, height: int):
    """Normalised view directions as 3 separate (height, width) planes.

    Row j, column i is the ray of pixel (i, j); all rays share
    ``camera.eye``. Normalised with ``rsqrt`` like the JAX package, which
    may round differently from XLA's by an ulp.
    """
    d, iu, iv = camera_basis(camera, width, height)
    dtype, device = camera.eye.dtype, camera.eye.device
    i = torch.arange(width, dtype=dtype, device=device)
    j = torch.arange(height, dtype=dtype, device=device)
    u = (2.0 * (i + 0.5) / width - 1.0)[None, :]    # (1, W)
    v = (2.0 * (j + 0.5) / height - 1.0)[:, None]   # (H, 1)
    cols = tuple(u * iu[a] + v * iv[a] + d[a] for a in range(3))
    inv = torch.rsqrt(cols[0] * cols[0] + cols[1] * cols[1]
                      + cols[2] * cols[2])
    return tuple(c * inv for c in cols)


def camera_rays_rows(camera: Camera, width: int, height: int, row_start,
                     num_rows: int) -> torch.Tensor:
    """Normalised view directions of pixel rows [row_start, row_start +
    num_rows), shape (num_rows, width, 3)."""
    d, iu, iv = camera_basis(camera, width, height)
    dtype, device = camera.eye.dtype, camera.eye.device
    i = torch.arange(width, dtype=dtype, device=device)
    j = row_start + torch.arange(num_rows, dtype=dtype, device=device)
    u = 2.0 * (i + 0.5) / width - 1.0
    v = 2.0 * (j + 0.5) / height - 1.0
    dirs = (u[None, :, None] * iu[None, None, :]
            + v[:, None, None] * iv[None, None, :] + d[None, None, :])
    return _normalize(dirs)


def camera_rays(camera: Camera, width: int, height: int) -> torch.Tensor:
    """Normalised view directions of every pixel, (height, width, 3): row
    j, column i is the ray of pixel (i, j), all from ``camera.eye``. The
    dense form of the brute-force path."""
    return camera_rays_rows(camera, width, height, 0, height)

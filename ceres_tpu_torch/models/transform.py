"""Affine transforms (counterpart of ``ceres_tpu/models/transform.py``).

A 3x3 matrix ``a`` plus a translation ``v``, applied as ``a @ p + v``,
with the reference's composition rules: ``rotate`` multiplies by the
Markley & Crassidis direction-cosine matrix (the transpose of the usual
active Rodrigues matrix) on the right, ``scale`` multiplies the matrix
only, ``translate`` adds to ``v`` only. Products run in full float32
(``ops.intersect.full_fp32_matmul``), as the JAX package asks for
``Precision.HIGHEST``. Differentiable with respect to ``a``, ``v`` and the
points.

A keyframe track is a stacked Transform: ``a`` (F, 3, 3) and ``v`` (F, 3),
one transform a frame (``parallel.sharded.turntable_transforms``);
``frame(k)`` slices frame k out, as the JAX package slices its stacked
pytree.
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.ops.intersect import full_fp32_matmul


def _markley_dcm(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """The rotation factor for ``angle`` radians about ``axis``
    (row-major 3x3)."""
    n = axis / torch.linalg.vector_norm(axis)
    s, c = torch.sin(angle), torch.cos(angle)
    x, y, z = n[0], n[1], n[2]
    one_c = 1.0 - c
    return torch.stack([
        torch.stack([c + one_c * x * x, one_c * x * y + s * z,
                     one_c * x * z - s * y]),
        torch.stack([one_c * y * x - s * z, c + one_c * y * y,
                     one_c * y * z + s * x]),
        torch.stack([one_c * z * x + s * y, one_c * z * y - s * x,
                     c + one_c * z * z]),
    ])


@dataclasses.dataclass(frozen=True)
class Transform:
    """Affine transform ``p -> a @ p + v``."""

    a: torch.Tensor  # (3, 3), or (F, 3, 3) for a track of F frames
    v: torch.Tensor  # (3,), or (F, 3)

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Transform":
        return Transform(a=torch.eye(3, dtype=dtype, device=device),
                         v=torch.zeros(3, dtype=dtype, device=device))

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.a.dtype, device=self.a.device)

    def rotate(self, axis, angle) -> "Transform":
        """Compose with a rotation of ``angle`` radians about ``axis``."""
        with full_fp32_matmul():
            a = self.a @ _markley_dcm(self._t(axis), self._t(angle))
        return Transform(a=a, v=self.v)

    def scale(self, s) -> "Transform":
        return Transform(a=self.a * self._t(s), v=self.v)

    def translate(self, t) -> "Transform":
        return Transform(a=self.a, v=self.v + self._t(t))

    @property
    def num_frames(self):
        """F for a stacked track, None for one transform."""
        return self.a.shape[0] if self.a.dim() == 3 else None

    def frame(self, k) -> "Transform":
        """Frame ``k`` (an int or a slice) of a stacked track."""
        return Transform(a=self.a[k], v=self.v[k])

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        """Apply to points of shape (..., 3); a stacked track of F frames
        returns (F, ..., 3), frame by frame."""
        if self.num_frames is not None:
            return torch.stack([self.frame(k)(p)
                                for k in range(self.num_frames)])
        with full_fp32_matmul():
            return p @ self.a.T + self.v


def transform_mesh_vertices(transform: Transform,
                            vertices: torch.Tensor) -> torch.Tensor:
    """Apply a Transform to a (V, 3) vertex tensor; the caller rebuilds
    the soup from the result (``triangle_soup``)."""
    return transform(vertices)


def rotate_vertices_about_axis(vertices, axis: int, degrees) -> torch.Tensor:
    """Rotate (V, 3) vertices about coordinate axis 0, 1 or 2 (x, y, z)
    by ``degrees``, the reference's rotate_triangles<Axis>. Takes a
    tensor or a numpy array; returns a tensor."""
    vertices = torch.as_tensor(vertices)
    rad = torch.as_tensor(degrees, dtype=vertices.dtype,
                          device=vertices.device) * (3.14159265359 / 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    rot = torch.stack([torch.stack(r) for r in rows])
    with full_fp32_matmul():
        return vertices @ rot.T

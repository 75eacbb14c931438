"""Triangle-soup scene model (counterpart of ``ceres_tpu/models/mesh.py``).

Conventions kept exactly:
  * the triangle record is the Möller-Trumbore form ``p0, e1 = p0 - p1,
    e2 = p2 - p0, n = cross(e1, e2)`` (left-handed normal);
  * vertex normals accumulate the unnormalised face normal (|n| = 2 *
    area, so the average is area-weighted) onto the face's three corners
    and are normalised once at the end.

Everything is plain torch on the input tensors' device, differentiable
with respect to the vertices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ceres_tpu_torch.utils import minmax


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An indexed triangle mesh: (V, 3) float vertices and (F, 3) int32
    faces."""

    vertices: torch.Tensor
    faces: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]


@dataclasses.dataclass(frozen=True)
class TriangleSoup:
    """Flat per-triangle tensors in precomputed Möller-Trumbore form.

    ``p0``, ``e1``, ``e2``, ``n`` are (F, 3). ``corner_normals`` is
    (F, 3, 3): the averaged, normalised vertex normal at each corner in
    face winding order.
    """

    p0: torch.Tensor
    e1: torch.Tensor  # p0 - p1
    e2: torch.Tensor  # p2 - p0
    n: torch.Tensor   # cross(e1, e2): left-handed, |n| = 2 * area
    corner_normals: Optional[torch.Tensor] = None

    @property
    def num_triangles(self) -> int:
        return self.p0.shape[0]

    @property
    def p1(self) -> torch.Tensor:
        return self.p0 - self.e1

    @property
    def p2(self) -> torch.Tensor:
        return self.p0 + self.e2

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-triangle AABBs: ((F, 3) lo, (F, 3) hi), with XLA's min and
        max (-0 below +0)."""
        p0, p1, p2 = self.p0, self.p1, self.p2
        return (minmax.fmin(minmax.fmin(p0, p1), p2),
                minmax.fmax(minmax.fmax(p0, p1), p2))

    def centers(self) -> torch.Tensor:
        """Triangle centroids, (F, 3): the sum of the corners times f32(1/3),
        as XLA computes the JAX package's division by 3 under ``jit``."""
        total = self.p0 + self.p1 + self.p2
        return total * torch.tensor(1.0 / 3.0, dtype=total.dtype)

    def areas(self) -> torch.Tensor:
        """Triangle areas, |n| / 2, (F,)."""
        return 0.5 * torch.linalg.vector_norm(self.n, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cross(a, b) over the last axis, one rounding per product and sum.

    Written out rather than ``torch.linalg.cross`` so that no fused CUDA
    kernel contracts ``a * b - c * d`` into an FMA: the port's float
    results then follow the same operation order on every device.
    """
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def face_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Unnormalised left-handed face normals: cross(p0 - p1, p2 - p0)."""
    f = faces.long()
    p0, p1, p2 = vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]
    return cross(p0 - p1, p2 - p0)


def vertex_normals(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted averaged vertex normals, (V, 3), normalised.

    Each face normal is scatter-added (``index_add``) onto its three
    corner vertices. Vertices that no face references stay zero.
    """
    f = faces.long()
    n = face_normals(vertices, faces)
    acc = torch.zeros_like(vertices)
    for k in range(3):
        acc = acc.index_add(0, f[:, k], n)
    length = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.where(length > 0, length, torch.ones_like(length))


def triangle_soup(vertices: torch.Tensor, faces: torch.Tensor,
                  with_normals: bool = True) -> TriangleSoup:
    """Build the flat Möller-Trumbore triangle records from an indexed mesh."""
    f = faces.long()
    p0, p1, p2 = vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]
    e1 = p0 - p1
    e2 = p2 - p0
    corner = vertex_normals(vertices, faces)[f] if with_normals else None
    return TriangleSoup(p0=p0, e1=e1, e2=e2, n=cross(e1, e2),
                        corner_normals=corner)


def soup_from_points(p0: torch.Tensor, p1: torch.Tensor,
                     p2: torch.Tensor) -> TriangleSoup:
    """Triangle records straight from three (F, 3) corner-point tensors."""
    e1 = p0 - p1
    e2 = p2 - p0
    return TriangleSoup(p0=p0, e1=e1, e2=e2, n=cross(e1, e2))


def subdivide(vertices, faces, levels: int = 1):
    """Midpoint (1 -> 4) subdivision of an indexed mesh, ``levels`` times.

    The large-scene generator (4x subdivided bunny: 1,271,808 triangles).
    Shared edges get shared midpoints, so the surface stays watertight.
    NumPy on the host, like OBJ loading; returns numpy arrays.
    """
    v = np.asarray(vertices)
    f = np.asarray(faces)
    for _ in range(levels):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        edges_sorted = np.sort(edges, axis=1)
        uniq, inv = np.unique(edges_sorted, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mids = 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])
        m01 = inv[:len(f)] + len(v)
        m12 = inv[len(f):2 * len(f)] + len(v)
        m20 = inv[2 * len(f):] + len(v)
        v = np.concatenate([v, mids])
        f = np.concatenate([
            np.stack([f[:, 0], m01, m20], 1),
            np.stack([m01, f[:, 1], m12], 1),
            np.stack([m20, m12, f[:, 2]], 1),
            np.stack([m01, m12, m20], 1),
        ]).astype(f.dtype)
    return v.astype(np.asarray(vertices).dtype), f

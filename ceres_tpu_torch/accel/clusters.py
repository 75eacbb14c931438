"""Triangle clusters, the walk's acceleration structure (counterpart of
``ceres_tpu/accel/clusters.py``: ``CLUSTER_SIZE``, ``ClusterSet`` and
the common-origin weights of ``cluster_weights_common_origin_packed``).

A cluster is a group of at most C = 128 spatially coherent triangles
with one AABB. A ray tile slab-tests the box, and on overlap the walk
kernel evaluates Möller-Trumbore against all C triangles at once.
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.models.mesh import cross

CLUSTER_SIZE = 128

# Rows of the common-origin weight planes, (N_c, WEIGHT_PLANES, C).
WEIGHT_PLANES = 10


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Padded triangle clusters.

    ``perm`` maps the packed slot (cluster * C + i) back to the original
    triangle id, -1 marking padding slots. Padding triangles are all-zero
    records, which Möller-Trumbore rejects (det = 0).
    """

    p0: torch.Tensor    # (N_c, C, 3)
    e1: torch.Tensor    # (N_c, C, 3)
    e2: torch.Tensor    # (N_c, C, 3)
    n: torch.Tensor     # (N_c, C, 3)
    lo: torch.Tensor    # (N_c, 3) cluster AABB min corners
    hi: torch.Tensor    # (N_c, 3) cluster AABB max corners
    perm: torch.Tensor  # (N_c * C,) int32, original triangle id or -1

    @property
    def num_clusters(self) -> int:
        return self.p0.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.p0.shape[1]


def cluster_weights_common_origin(clusters: ClusterSet,
                                  origin: torch.Tensor) -> torch.Tensor:
    """Möller-Trumbore weights for rays from one common origin:
    (N_c, 10, C) f32 planes [cu.xyz, cv.xyz, n.xyz, tn].

    With p0 taken relative to ``origin``, cu = cross(p0, e2),
    cv = cross(p0, e1) and tn = dot(n, p0), a ray direction d has the
    numerators u = dot(cu, d), v = dot(cv, d), det = dot(n, d), t = tn.
    Each plane is one 128-float row per cluster, so a thread block reads
    a cluster's 5 KB of weights as coalesced rows. The JAX package packs
    the same numbers as (N_c, 8, 4C) lane slabs, a TPU layout.
    """
    p0 = clusters.p0 - origin
    cu = cross(p0, clusters.e2)
    cv = cross(p0, clusters.e1)
    n = clusters.n
    tn = n[..., 0] * p0[..., 0] + n[..., 1] * p0[..., 1] + n[..., 2] * p0[..., 2]
    planes = torch.cat([cu, cv, n, tn[..., None]], dim=-1)   # (N_c, C, 10)
    return planes.transpose(1, 2).contiguous()

"""Triangle clusters, the walk's acceleration structure (counterpart of
``ceres_tpu/accel/clusters.py``: ``CLUSTER_SIZE``, ``ClusterSet``,
``_check_soup_size``, ``build_clusters``, ``build_clusters_treelet``,
``refit_clusters`` and the common-origin weights of
``cluster_weights_common_origin_packed``).

A cluster is a group of at most C = 128 spatially coherent triangles
with one AABB. A ray tile slab-tests the box, and on overlap the walk
kernel evaluates Möller-Trumbore against all C triangles at once.

The device builders run in torch on the soup's device: the morton-run
cut (``build_clusters``) and the LBVH treelet cut
(``build_clusters_treelet``, the default structure of ``render()``),
with the JAX package's static budgets and fallbacks, so cluster count,
super width and the walk variant they select are the same. Every shape
follows from the triangle count, and no builder reads the device (the
fallbacks are selected by ``torch.where`` on device flags), so each can
be captured in a CUDA graph: the counterpart of the JAX package building
them under ``jax.jit``. A structure built once is refitted to moved
vertices (``refit_clusters``), as the train step does every step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ceres_tpu_torch.accel import lbvh as lbvh_mod
from ceres_tpu_torch.accel import morton
from ceres_tpu_torch.models.mesh import TriangleSoup, cross
from ceres_tpu_torch.utils import minmax

CLUSTER_SIZE = 128

# Rows of the common-origin weight planes, (N_c, WEIGHT_PLANES, C), and
# of the generic-origin planes, (N_c, GENERIC_PLANES, C).
WEIGHT_PLANES = 10
GENERIC_PLANES = 16

# Triangle ids ride the JAX package's winner table as exact f32 values,
# which caps a soup below 2^24 triangles; the port keeps the same limit.
_MAX_TRIANGLES = 1 << 24

# Supers of the two-level walk: S member slots (8..32, one uint32 bitmask)
# chosen to keep the super count near _SUPER_TARGET.
_SUPER_TARGET = 1024
_SUPER_MAX = 32


def _super_slots(n_c: int) -> int:
    """Member slots per super for ``n_c`` fine clusters."""
    s = 8
    while -(-n_c // s) > _SUPER_TARGET and s < _SUPER_MAX:
        s *= 2
    return s


def _check_soup_size(T: int) -> None:
    if T >= _MAX_TRIANGLES:
        raise ValueError(
            f"scene has {T} triangles; triangle ids are exact f32 values in "
            f"the JAX package's winner table, which caps a soup at "
            f"{_MAX_TRIANGLES - 1} triangles")


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    """Padded triangle clusters.

    ``perm`` maps the packed slot (cluster * C + i) back to the original
    triangle id, -1 marking padding slots. Padding triangles are all-zero
    records, which Möller-Trumbore rejects (det = 0); padding clusters
    carry the empty box (lo = +inf, hi = -inf).

    ``super_first``/``super_S`` (optional) carry the tree-derived super
    level of the two-level walk: super j's members are the fine ids
    [super_first[j], super_first[j + 1]), at most ``super_S`` of them.
    ``super_first`` is padded with N_c past the real supers.
    """

    p0: torch.Tensor    # (N_c, C, 3)
    e1: torch.Tensor    # (N_c, C, 3)
    e2: torch.Tensor    # (N_c, C, 3)
    n: torch.Tensor     # (N_c, C, 3)
    lo: torch.Tensor    # (N_c, 3) cluster AABB min corners
    hi: torch.Tensor    # (N_c, 3) cluster AABB max corners
    perm: torch.Tensor  # (N_c * C,) int32, original triangle id or -1
    super_first: Optional[torch.Tensor] = None  # (N_s,) int32 first fine id
    super_S: int = 0                             # member slots per super

    @property
    def num_clusters(self) -> int:
        return self.p0.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.p0.shape[1]


def build_clusters(soup: TriangleSoup,
                   cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """Sort triangles along the morton curve and pack runs of C: the
    fallback structure (soups of at most C triangles, or a treelet cut
    that overflows its budget)."""
    T = soup.num_triangles
    _check_soup_size(T)
    C = cluster_size
    num_clusters = -(-T // C)
    pad = num_clusters * C - T
    order = morton.morton_order(soup.centers().detach())
    perm = torch.cat([order, torch.full((pad,), -1, dtype=torch.int32,
                                        device=soup.p0.device)])
    return ClusterSet(*_pack_records(perm, soup, num_clusters, C), perm=perm)


def _pack_records(perm, soup: TriangleSoup, n_c: int, C: int):
    """(p0, e1, e2, n, lo, hi) of the n_c clusters of C slots that
    ``perm`` fills from ``soup``: records gathered (zero at padding
    slots, differentiable w.r.t. the soup) and each box the exact bound
    of its member triangles, (+inf, -inf) for an empty cluster,
    detached."""
    valid = (perm >= 0)[:, None]
    gather = perm.clamp(min=0).long()

    def pack(x):
        return torch.where(valid, x[gather], 0.0).reshape(n_c, C, 3)

    p0, e1, e2, n = (pack(x) for x in (soup.p0, soup.e1, soup.e2, soup.n))
    pd = p0.detach()
    tri_lo, tri_hi = lbvh_mod._corner_bounds(pd, pd - e1.detach(),
                                             pd + e2.detach())
    vmask = valid.reshape(n_c, C, 1)
    lo = minmax.amin(torch.where(vmask, tri_lo, torch.inf), 1)
    hi = minmax.amax(torch.where(vmask, tri_hi, -torch.inf), 1)
    return p0, e1, e2, n, lo, hi


def _scatter_box(index, values, n_rows, fill, reduce):
    """(n_rows, 3) min ("amin") or max ("amax") of ``values`` rows by
    ``index``, starting from ``fill``: ``.at[index].min/max`` with XLA's
    float order."""
    base = minmax.ordered(torch.full((n_rows, 3), fill, dtype=values.dtype,
                                     device=values.device))
    base.scatter_reduce_(0, index.long()[:, None].expand(-1, 3),
                         minmax.ordered(values), reduce=reduce,
                         include_self=True)
    return minmax.from_ordered(base)


def build_clusters_treelet(soup: TriangleSoup,
                           cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """LBVH treelet clusters: a cluster is a maximal subtree of <= C
    triangles, so its box is a real BVH node box.

    The static budget of the JAX package is kept: triangles scatter into
    n_cap = 2 * ceil(T / C) clusters, and a cut that needs more falls back
    to fixed morton runs inside the same budget. The super level for the
    two-level walk is a second cut at <= S fine clusters per super
    (``lbvh.super_cut``, S = ``_super_slots(n_cap)``), stored as the
    (n_s_cap,) first-member table with n_s_cap = 2 * ceil(n_cap / S); it
    falls back to uniform S-runs of fine ids when the fine cut fell back
    or the super cut overflows. The structure (perm, boxes, supers) is
    detached; the records stay differentiable w.r.t. the soup.

    As in the JAX package, each fallback is computed beside the cut and
    selected on the device (``torch.where`` on a 0-d flag): the build
    never reads the device, so it can be captured in a CUDA graph.
    """
    T = soup.num_triangles
    _check_soup_size(T)
    C = cluster_size
    if T < 2 or T <= C:
        return build_clusters(soup, cluster_size)
    n_cap = 2 * (-(-T // C))
    dev = soup.p0.device

    bvh = lbvh_mod.build_lbvh(soup)
    starts, cut_of = lbvh_mod.cluster_cut(bvh, C)
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    run_of = pos // C
    # Both cuts are computed and one is selected on the device: a 0-d
    # flag, never read on the host.
    use_cut = starts.sum() <= n_cap
    cluster_of = torch.where(use_cut, cut_of, run_of)
    seg_start = torch.where(
        use_cut, torch.cummax(torch.where(starts > 0, pos, 0), 0).values,
        run_of * C)
    slot = (cluster_of * C + (pos - seg_start)).long()

    order = bvh.order
    perm = torch.full((n_cap * C,), -1, dtype=torch.int32, device=dev)
    perm[slot] = order
    gather = order.long()

    def pack(x):
        g = torch.zeros((n_cap * C, 3), dtype=x.dtype, device=dev)
        return g.index_put((slot,), x[gather]).reshape(n_cap, C, 3)

    p0, e1, e2, n = (pack(x) for x in (soup.p0, soup.e1, soup.e2, soup.n))
    lo = _scatter_box(cluster_of, bvh.leaf_lo, n_cap, float("inf"), "amin")
    hi = _scatter_box(cluster_of, bvh.leaf_hi, n_cap, -float("inf"), "amax")

    S = _super_slots(n_cap)
    n_s_cap = 2 * (-(-n_cap // S))
    starts2, super_of = lbvh_mod.super_cut(
        bvh, torch.where(use_cut, starts, (pos % C == 0).to(torch.int32)), S)
    use_super = use_cut & (starts2.sum() <= n_s_cap)
    # First sorted position of each super by a min scatter; positions
    # that start no super, and supers past the budget, go to the extra
    # slot n_s_cap, sliced off (the JAX package's dropped slot).
    into = torch.where((starts2 == 1) & (super_of < n_s_cap), super_of,
                       n_s_cap).long()
    sp = torch.full((n_s_cap + 1,), T, dtype=torch.int32, device=dev)
    sp = sp.scatter_reduce_(0, into, pos, reduce="amin")[:n_s_cap]
    first_cut = torch.where(sp < T, cluster_of[sp.clamp(0, T - 1).long()],
                            n_cap)
    first_uniform = torch.clamp(
        torch.arange(n_s_cap, dtype=torch.int32, device=dev) * S, max=n_cap)
    super_first = torch.where(use_super, first_cut, first_uniform)
    return ClusterSet(p0=p0, e1=e1, e2=e2, n=n, lo=lo, hi=hi, perm=perm,
                      super_first=super_first.to(torch.int32), super_S=S)


def refit_clusters(clusters: ClusterSet, soup: TriangleSoup) -> ClusterSet:
    """Refit a cluster structure to moved vertices of the same mesh.

    The cut (``perm``) and the super level (``super_first``,
    ``super_S``) are kept; the records are gathered again from ``soup``
    (zero at padding slots) and each box is recomputed as the exact bound
    of its member triangles, (+inf, -inf) for an empty cluster. A gather
    and a segmented min/max in place of the LBVH build: boxes stay exact
    at any deformation, only their tightness degrades. The boxes are
    detached; the records stay differentiable w.r.t. ``soup``.
    """
    return ClusterSet(
        *_pack_records(clusters.perm, soup, clusters.num_clusters,
                       clusters.cluster_size),
        perm=clusters.perm, super_first=clusters.super_first,
        super_S=clusters.super_S)


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


def cluster_weights_generic(clusters: ClusterSet,
                            origin_shift: torch.Tensor) -> torch.Tensor:
    """Möller-Trumbore weights for rays with their own origins:
    (N_c, 16, C) f32 planes [cu.xyz, cv.xyz, n.xyz, tn, e2.xyz, e1.xyz].

    The first 10 planes are ``cluster_weights_common_origin(clusters,
    origin_shift)``. A ray with direction d and origin o (both relative
    to ``origin_shift``) and c = cross(d, o) has the numerators
    u = dot(cu, d) - dot(e2, c), v = dot(cv, d) - dot(e1, c),
    det = dot(n, d) and t = tn - dot(n, o): the JAX package's
    ``cluster_weights_generic_packed`` rows [d, d x o, o, 1], with the
    negations of -e2, -e1 and -n moved into the walk's operation order.
    """
    planes = cluster_weights_common_origin(clusters, origin_shift)
    edges = torch.cat([clusters.e2, clusters.e1], dim=-1)    # (N_c, C, 6)
    return torch.cat([planes, edges.transpose(1, 2)], dim=1).contiguous()

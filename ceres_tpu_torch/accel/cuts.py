"""Treelet cut of a host quality BVH into a ClusterSet (counterpart of
``ceres_tpu/accel/cuts.py``: ``_cut_flatbvh``, ``_pack_clusterset``,
``clusters_from_flatbvh``, ``build_clusters_quality``).

A cluster is the primitive set of a highest node with <= C primitives,
its AABB the node's real box. The cut is host-side NumPy, a copy of the
JAX package's (which imports ``jax``); the per-triangle records are
gathered from the soup in torch, so the ClusterSet stays differentiable
with respect to the vertices while the structure (perm, boxes) is
detached.

``clusters_from_flatbvh`` also makes the JAX package's second cut, the
super level of the two-level walk (``ClusterSet.super_first``): a
maximal-subtree cut at <= ``_super_slots(n_c)`` fine clusters per
super, so a big scene's quality cut walks over tree-tight supers.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ceres_tpu_torch.accel import golden_builders as gb
from ceres_tpu_torch.accel.clusters import (CLUSTER_SIZE, ClusterSet,
                                            _pack_records, _super_slots)
from ceres_tpu_torch.models.mesh import TriangleSoup

# The JAX package's other quality builders, not ported yet.
_UNPORTED_BUILDERS = ("binned", "sbvh", "ploc", "reinsert")


def _cut_flatbvh(bvh: gb.FlatBvh, cluster_size: int):
    """Greedy maximal-subtree cut. Returns (prim id lists, lo, hi,
    super_first) in the JAX package's emission order (depth first, second
    child first), as its ``_cut_flatbvh(..., "auto")``: a second
    maximal-subtree cut groups <= ``_super_slots(n_c)`` fine clusters per
    super, and fine clusters are emitted super by super, so each super's
    members are contiguous fine ids."""
    prim_count = bvh.prim_count.astype(np.int64)
    first = bvh.first_child.astype(np.int64)
    counts = np.zeros(bvh.node_count, np.int64)
    gcount = np.zeros(bvh.node_count, np.int64)  # fine clusters in subtree

    # Subtree primitive and fine-cluster counts, iterative post-order.
    order = []
    stack = [0]
    while stack:
        i = stack.pop()
        order.append(i)
        if prim_count[i] == 0:
            stack.append(int(first[i]))
            stack.append(int(first[i]) + 1)
    for i in reversed(order):
        if prim_count[i] > 0:
            counts[i] = prim_count[i]
        else:
            counts[i] = counts[first[i]] + counts[first[i] + 1]
        gcount[i] = 1 if counts[i] <= cluster_size else (
            gcount[first[i]] + gcount[first[i] + 1]
            if prim_count[i] == 0 else 1)

    def subtree_prims(i: int) -> np.ndarray:
        out = []
        st = [i]
        while st:
            j = st.pop()
            if prim_count[j] > 0:
                out.append(
                    bvh.prim_indices[first[j]:first[j] + prim_count[j]])
            else:
                st.append(int(first[j]))
                st.append(int(first[j]) + 1)
        return np.concatenate(out)

    super_slots = _super_slots(int(gcount[0]))
    groups: List[np.ndarray] = []
    los, his = [], []

    def emit_fine(i: int) -> None:
        st = [i]
        while st:
            j = st.pop()
            if counts[j] <= cluster_size:
                groups.append(subtree_prims(j))
                los.append(bvh.bounds[j, 0::2])
                his.append(bvh.bounds[j, 1::2])
            else:
                st.append(int(first[j]))
                st.append(int(first[j]) + 1)

    super_first = []
    stack = [0]
    while stack:
        i = stack.pop()
        if gcount[i] <= super_slots:
            super_first.append(len(groups))
            emit_fine(i)
        else:
            stack.append(int(first[i]))
            stack.append(int(first[i]) + 1)
    return (groups, np.asarray(los, np.float32),
            np.asarray(his, np.float32), np.asarray(super_first, np.int32))


def _pack_clusterset(soup: TriangleSoup, groups, los, his,
                     cluster_size: int) -> ClusterSet:
    n_c = len(groups)
    C = cluster_size
    perm = np.full((n_c * C,), -1, np.int32)
    for k, g in enumerate(groups):
        if g.shape[0] > C:
            raise ValueError(f"cluster {k} holds {g.shape[0]} > {C} triangles")
        perm[k * C:k * C + g.shape[0]] = g
    device = soup.p0.device
    perm_t = torch.as_tensor(perm, device=device)
    if soup.p0.dtype != torch.float32:
        # The host tree's boxes are float32 and need not bound float64
        # triangles: take each cluster's exact bound in the soup's dtype.
        # (The JAX package keeps the float32 boxes here, cuts.py:115.)
        return ClusterSet(*_pack_records(perm_t, soup, n_c, C), perm=perm_t)
    gather = perm_t.clamp(min=0).long()
    valid = (perm_t >= 0)[:, None]

    def pack(x):
        g = torch.where(valid, x[gather], torch.zeros((), dtype=x.dtype,
                                                      device=device))
        return g.reshape(n_c, C, 3)

    return ClusterSet(p0=pack(soup.p0), e1=pack(soup.e1), e2=pack(soup.e2),
                      n=pack(soup.n),
                      lo=torch.as_tensor(los, device=device),
                      hi=torch.as_tensor(his, device=device), perm=perm_t)


def clusters_from_flatbvh(soup: TriangleSoup, bvh: gb.FlatBvh,
                          cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """Cut a host FlatBvh into a ClusterSet, with the super level of the
    two-level walk taken from the same tree."""
    groups, los, his, super_first = _cut_flatbvh(bvh, cluster_size)
    cs = _pack_clusterset(soup, groups, los, his, cluster_size)
    return dataclasses.replace(
        cs, super_first=torch.as_tensor(super_first, device=cs.lo.device),
        super_S=_super_slots(len(groups)))


def build_clusters_quality(soup: TriangleSoup, builder: str = "sweep",
                           cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """One-call quality ClusterSet for static-geometry frame loops: a
    SweepSAH build on the host, then the treelet cut. Built once before
    the frame loop, like the reference's pre-loop BVH build.

    Only ``builder="sweep"`` is ported; binned, sbvh, ploc and reinsert
    wait for ROADMAP item M9. Any other name raises ``ValueError``, as in
    the JAX package.
    """
    if builder in _UNPORTED_BUILDERS:
        raise NotImplementedError(
            f"builder {builder!r} is not ported yet (ROADMAP item M9); "
            "use builder='sweep'")
    if builder != "sweep":
        raise ValueError(f"unknown builder: {builder}")
    p0 = soup.p0.detach().cpu().numpy()
    p1 = p0 - soup.e1.detach().cpu().numpy()
    p2 = soup.e2.detach().cpu().numpy() + p0
    pts = np.stack([p0, p1, p2], 1)
    lo, hi, centers = pts.min(1), pts.max(1), pts.mean(1)
    bvh = gb.build_sweep_sah(lo, hi, centers)
    return clusters_from_flatbvh(soup, bvh, cluster_size)

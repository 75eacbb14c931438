"""Treelet cuts of quality BVHs into ClusterSets (counterpart of
``ceres_tpu/accel/cuts.py``: ``_cut_flatbvh``, ``_cut_ploc``,
``_pack_clusterset``, ``clusters_from_flatbvh``, ``clusters_from_ploc``,
``build_clusters_quality``).

Any built tree, a host FlatBvh (SweepSAH, BinnedSAH, SBVH, reinsertion)
or the PLOC tree, becomes a ClusterSet by the maximal-subtree cut: a
cluster is the primitive set of a highest node with <= C primitives, its
AABB the node's real box. The cut is host-side NumPy, a copy of the JAX
package's (which imports ``jax``); the per-triangle records are gathered
from the soup in torch, so the ClusterSet stays differentiable with
respect to the vertices while the structure (perm, boxes) is detached.

``clusters_from_flatbvh`` also makes the JAX package's second cut, the
super level of the two-level walk (``ClusterSet.super_first``): a
maximal-subtree cut at <= ``_super_slots(n_c)`` fine clusters per
super, so a big scene's quality cut walks over tree-tight supers. As in
the JAX package, the supers are stored without the treelet cut's budget
check (n_s <= 2 * ceil(n_c / S)): nothing downstream sizes by it (the
prepass and the walks take n_s from ``super_first``). The PLOC cut has
no super level.

An SBVH's leaves may hold the same triangle more than once (spatial
splits duplicate straddling references). A duplicate is one more member
of its cluster, as in the JAX package: the walk's closest-t winner does
not change by seeing a triangle twice, and the winner table is per slot.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List

import numpy as np
import torch

from ceres_tpu_torch.accel import golden_builders as gb
from ceres_tpu_torch.accel.clusters import (CLUSTER_SIZE, ClusterSet,
                                            _pack_records, _super_slots)
from ceres_tpu_torch.models.mesh import TriangleSoup


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


def _cut_ploc(tree, cluster_size: int):
    """The same cut on a PlocTree (children coded: negative =
    -(leaf_pos + 1)). Returns (prim id lists, lo, hi) in the JAX
    package's emission order."""
    left = _numpy(tree.left)
    right = _numpy(tree.right)
    order = _numpy(tree.order)
    node_lo = _numpy(tree.node_lo)
    node_hi = _numpy(tree.node_hi)
    leaf_lo = _numpy(tree.leaf_lo)
    leaf_hi = _numpy(tree.leaf_hi)
    root = int(tree.root)
    n_int = left.shape[0]
    counts = np.zeros(n_int, np.int64)

    def kids(i):
        return int(left[i]), int(right[i])

    order_post = []
    stack = [root]
    while stack:
        i = stack.pop()
        order_post.append(i)
        for c in kids(i):
            if c >= 0:
                stack.append(c)
    for i in reversed(order_post):
        c = 0
        for ch in kids(i):
            c += 1 if ch < 0 else counts[ch]
        counts[i] = c

    def subtree_leaves(i: int) -> np.ndarray:
        out = []
        st = [i]
        while st:
            j = st.pop()
            for ch in kids(j):
                if ch < 0:
                    out.append(-(ch + 1))
                else:
                    st.append(ch)
        return order[np.asarray(out, np.int64)]

    groups, los, his = [], [], []
    stack = [root]
    while stack:
        i = stack.pop()
        if counts[i] <= cluster_size:
            groups.append(subtree_leaves(i))
            los.append(node_lo[i])
            his.append(node_hi[i])
        else:
            for ch in kids(i):
                if ch < 0:
                    pos = -(ch + 1)
                    groups.append(order[pos:pos + 1])
                    los.append(leaf_lo[pos])
                    his.append(leaf_hi[pos])
                else:
                    stack.append(ch)
    return (groups, np.asarray(los, np.float32),
            np.asarray(his, np.float32))


def _numpy(x) -> np.ndarray:
    """A tree field (tensor on any device, or array) as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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


def clusters_from_ploc(soup: TriangleSoup, tree,
                       cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """Cut a PLOC tree (``accel.ploc.build_ploc``) into a ClusterSet (no
    super level, as in the JAX package)."""
    groups, los, his = _cut_ploc(tree, cluster_size)
    return _pack_clusterset(soup, groups, los, his, cluster_size)


def build_flatbvh(soup: TriangleSoup, builder: str) -> gb.FlatBvh:
    """The host FlatBvh of ``builder`` (sweep | binned | sbvh | reinsert)
    over the soup's triangles, as ``build_clusters_quality`` builds it."""
    p0 = soup.p0.detach().cpu().numpy()
    p1 = p0 - soup.e1.detach().cpu().numpy()
    p2 = soup.e2.detach().cpu().numpy() + p0
    pts = np.stack([p0, p1, p2], 1)
    lo, hi, centers = pts.min(1), pts.max(1), pts.mean(1)
    if builder == "sweep":
        return gb.build_sweep_sah(lo, hi, centers)
    if builder == "binned":
        from ceres_tpu_torch.accel import native

        return native.build_binned_sah_fast(lo, hi, centers)
    if builder == "sbvh":
        from ceres_tpu_torch.accel.sbvh import build_sbvh

        return build_sbvh(p0, p1, p2)
    if builder == "reinsert":
        from ceres_tpu_torch.accel.reinsertion import optimize_reinsertion

        return optimize_reinsertion(gb.build_sweep_sah(lo, hi, centers))
    raise ValueError(f"unknown builder: {builder}")


def build_clusters_quality(soup: TriangleSoup, builder: str = "sweep",
                           cluster_size: int = CLUSTER_SIZE) -> ClusterSet:
    """One-call quality ClusterSet for static-geometry frame loops: a
    build on the host (PLOC: on the soup's device), then the treelet cut.
    Built once before the frame loop, like the reference's pre-loop BVH
    build; keep ``build_clusters_treelet`` for builds inside a step.

    ``builder``: sweep (SweepSAH, the default) | binned (BinnedSAH, the
    native C++ build where g++ exists) | sbvh (spatial splits) | ploc
    (on the device) | reinsert (SweepSAH, then reinsertion). Any other
    name, ``"lbvh"`` included, raises ``ValueError`` as in the JAX
    package. A float64 soup gets each cluster's exact float64 bound.
    """
    if builder == "ploc":
        from ceres_tpu_torch.accel import ploc

        return clusters_from_ploc(soup, ploc.build_ploc(soup), cluster_size)
    return clusters_from_flatbvh(soup, build_flatbvh(soup, builder),
                                 cluster_size)


def cut_record(cs: ClusterSet, tree=None) -> dict:
    """A cut's fingerprint, as ``tests/fixtures/torch_port_builders.json``
    keeps the JAX package's: the cluster count, ``super_S``, the length
    of ``super_first``, and a sha256 each of ``perm`` (int32), ``lo`` and
    ``hi`` (float32) and ``super_first`` (int32); with a PLOC ``tree``,
    also its ``root`` and the hashes of its ``order``, ``left`` and
    ``right`` (int32)."""

    def digest(x, dtype):
        data = np.ascontiguousarray(_numpy(x), dtype)
        return hashlib.sha256(data.tobytes()).hexdigest()

    first = cs.super_first
    rec = {"num_clusters": int(cs.num_clusters), "super_S": int(cs.super_S),
           "n_super_first": 0 if first is None else int(first.shape[0]),
           "perm": digest(cs.perm, np.int32),
           "lo": digest(cs.lo, np.float32), "hi": digest(cs.hi, np.float32),
           "super_first": None if first is None else digest(first, np.int32)}
    if tree is not None:
        rec["root"] = int(tree.root)
        for name in ("order", "left", "right"):
            rec[name] = digest(getattr(tree, name), np.int32)
    return rec

"""LBVH: Karras-style linear BVH from a sort and vectorised searches, in
torch on the soup's device (counterpart of ``ceres_tpu/accel/lbvh.py``:
``Lbvh``, ``_delta_fn``, ``build_lbvh``, ``_child_box``,
``_refit_boxes``, ``refit``, ``sah_cost``, ``cluster_cut``,
``super_cut``).

T leaves (one per triangle, in morton order) and T - 1 internal nodes.
Internal node i covers the sorted range [range_lo[i], range_hi[i]] and
splits it at gamma[i]; every node's range and split is found on its own
by fixed-trip doubling and binary searches over the sorted (code, index)
keys, then boxes are refit bottom-up by fixed-depth passes. No step
depends on another node's result, so each is a handful of whole-tensor
ops. Every array equals the JAX package's: the argsort is stable, the
leading-zero count is exact integer arithmetic, scatters send the
entries XLA's ``mode="drop"`` drops to one extra row that is sliced off,
and box unions use XLA's min/max (``utils.minmax``). Index arithmetic
runs in int64 and is returned as int32, as in the JAX package.

Every shape is fixed by the triangle count and no step reads the device
(no ``nonzero``, no boolean-mask index, no host copy), so the build and
both cuts can be captured in a CUDA graph, as the JAX package builds
them under ``jax.jit``.
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.accel import morton
from ceres_tpu_torch.models.mesh import TriangleSoup
from ceres_tpu_torch.utils import minmax

# Refit passes: morton trees over (code, index) keys are at most 62 deep.
MAX_DEPTH = 64


@dataclasses.dataclass(frozen=True)
class Lbvh:
    """Flattened LBVH over T morton-sorted triangles.

    Internal node arrays have length T - 1 (node 0 is the root); leaf k is
    the k-th sorted triangle. ``left``/``right`` encode children as
    internal-node ids >= 0 or ``-(leaf_id + 1)`` for leaves.
    """

    order: torch.Tensor        # (T,) int32 sorted position -> triangle id
    left: torch.Tensor         # (T-1,) int32
    right: torch.Tensor        # (T-1,) int32
    range_lo: torch.Tensor     # (T-1,) int32 inclusive
    range_hi: torch.Tensor     # (T-1,) int32 inclusive
    parent: torch.Tensor       # (T-1,) int32, -1 for the root
    leaf_parent: torch.Tensor  # (T,) int32 parent internal node of each leaf
    node_lo: torch.Tensor      # (T-1, 3) internal-node AABB min
    node_hi: torch.Tensor      # (T-1, 3)
    leaf_lo: torch.Tensor      # (T, 3) leaf AABB min (sorted order)
    leaf_hi: torch.Tensor      # (T, 3)

    @property
    def num_triangles(self) -> int:
        return self.order.shape[0]


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the 32-bit pattern of each int, 32 for 0 (the
    counterpart of ``jax.lax.clz``; exact, by halving shifts)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    zero = x == 0
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - shift))   # the top ``shift`` bits are clear
        n = torch.where(small, n + shift, n)
        x = torch.where(small, x << shift, x)
    return torch.where(zero, 32, n)


def _delta_fn(hi_keys, lo_keys, n):
    """delta(i, j): common-prefix length of keys i and j; -1 out of range."""

    def delta(i, j):
        ok = (j >= 0) & (j <= n - 1)
        js = j.clamp(0, n - 1)
        hx = hi_keys[i] ^ hi_keys[js]
        lx = lo_keys[i] ^ lo_keys[js]
        d = torch.where(hx != 0, _clz32(hx), 32 + _clz32(lx))
        return torch.where(ok, d, -1)

    return delta


def _corner_bounds(p0, p1, p2):
    """Per-triangle AABB (lo, hi) of three corner arrays, XLA min/max."""
    return (minmax.fmin(minmax.fmin(p0, p1), p2),
            minmax.fmax(minmax.fmax(p0, p1), p2))


def build_lbvh(soup: TriangleSoup) -> Lbvh:
    """Build the LBVH of a triangle soup (T >= 2)."""
    T = soup.num_triangles
    if T < 2:
        raise ValueError("LBVH needs at least 2 triangles")
    dev = soup.p0.device
    centers = soup.centers().detach()
    codes = morton.morton_codes(centers, minmax.amin(centers, 0),
                                minmax.amax(centers, 0))
    order = torch.argsort(codes, stable=True)
    hi_keys = codes[order].to(torch.int64)   # sorted
    lo_keys = torch.arange(T, device=dev)    # tiebreak: unique by position

    n = T
    delta = _delta_fn(hi_keys, lo_keys, n)
    i = torch.arange(n - 1, device=dev)

    # Direction: toward the longer common prefix.
    d = torch.where(delta(i, i + 1) >= delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)

    # Upper bound of the range length by doubling (32 steps cover T < 2^31).
    lmax = torch.full_like(i, 2)
    for _ in range(32):
        grow = delta(i, i + lmax * d) > delta_min
        lmax = torch.where(grow, lmax * 2, lmax)

    # Binary search of the other end j = i + l * d.
    l = torch.zeros_like(i)
    step = lmax
    for _ in range(33):
        step = torch.clamp(step // 2, min=1)
        ok = delta(i, i + (l + step) * d) > delta_min
        l = torch.where(ok, l + step, l)
    j = i + l * d

    # Split position gamma by binary search on the node's own prefix.
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    step = l
    for _ in range(33):
        step = (step + 1) // 2
        ok = delta(i, i + (s + step) * d) > delta_node
        s = torch.where(ok & (s + step < l), s + step, s)
    gamma = i + s * d + torch.clamp(d, max=0)

    rlo = torch.minimum(i, j)
    rhi = torch.maximum(i, j)
    left_is_leaf = rlo == gamma
    right_is_leaf = rhi == gamma + 1
    left = torch.where(left_is_leaf, -(gamma + 1), gamma)
    right = torch.where(right_is_leaf, -(gamma + 2), gamma + 1)

    # Parents by scatter; as in the JAX package, the other kind of child
    # goes to an out-of-range slot: one extra row, sliced off.
    parent = torch.full((n,), -1, dtype=torch.int64, device=dev)
    leaf_parent = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    for child, is_leaf in ((gamma, left_is_leaf), (gamma + 1, right_is_leaf)):
        parent[torch.where(is_leaf, n - 1, child)] = i
        leaf_parent[torch.where(is_leaf, child, n)] = i
    parent, leaf_parent = parent[:n - 1], leaf_parent[:n]

    # Leaf AABBs in sorted order.
    p0 = soup.p0.detach()
    p1 = p0 - soup.e1.detach()
    p2 = p0 + soup.e2.detach()
    leaf_lo, leaf_hi = _corner_bounds(p0[order], p1[order], p2[order])
    node_lo, node_hi = _refit_boxes(left, right, leaf_lo, leaf_hi)

    i32 = torch.int32
    return Lbvh(order=order.to(i32), left=left.to(i32), right=right.to(i32),
                range_lo=rlo.to(i32), range_hi=rhi.to(i32),
                parent=parent.to(i32), leaf_parent=leaf_parent.to(i32),
                node_lo=node_lo, node_hi=node_hi,
                leaf_lo=leaf_lo, leaf_hi=leaf_hi)


def _child_box(c, node_lo, node_hi, leaf_lo, leaf_hi):
    """AABB of a child encoded as internal id or -(leaf + 1)."""
    is_leaf = (c < 0)[:, None]
    leaf_id = (-c - 1).clamp(min=0).long()
    int_id = c.clamp(min=0).long()
    return (torch.where(is_leaf, leaf_lo[leaf_id], node_lo[int_id]),
            torch.where(is_leaf, leaf_hi[leaf_id], node_hi[int_id]))


def _refit_boxes(left, right, leaf_lo, leaf_hi):
    """Bottom-up AABBs by MAX_DEPTH dense passes of child gather + min/max:
    every pass finalises the next level up. The unions take XLA's float
    order exactly: on ``minmax.ordered`` int keys, or, where the leaf
    boxes carry gradients, with ``minmax.fmin``/``fmax`` on the floats
    (the same values, and gradients split at ties as ``jnp.minimum``
    splits them). The int keys take one operation a union where
    fmin/fmax take nine; the build, which runs 64 passes of two unions,
    took a median 179.4 ms (148.9-210.2) on the bunny, the dragon and the
    4x bunny with fmin/fmax alone against 123.5 ms (106.0-187.7) with the
    int keys (means of 5 builds, two runs of each form of
    ``chip_smoke.py`` phase 13 in one call in turns, NVIDIA H100 80GB HBM3
    at 700 W)."""
    n1 = left.shape[0]
    inf = leaf_lo.new_full((), float("inf"))   # a fill, not a host copy
    grad = leaf_lo.requires_grad or leaf_hi.requires_grad
    key = (lambda x: x) if grad else minmax.ordered
    unkey = (lambda x: x) if grad else minmax.from_ordered
    lower, upper = ((minmax.fmin, minmax.fmax) if grad
                    else (torch.minimum, torch.maximum))
    node_lo = key(inf).expand(n1, 3)
    node_hi = key(-inf).expand(n1, 3)
    leaf_lo, leaf_hi = key(leaf_lo), key(leaf_hi)
    for _ in range(MAX_DEPTH):
        llo, lhi = _child_box(left, node_lo, node_hi, leaf_lo, leaf_hi)
        rlo, rhi = _child_box(right, node_lo, node_hi, leaf_lo, leaf_hi)
        node_lo, node_hi = lower(llo, rlo), upper(lhi, rhi)
    return unkey(node_lo), unkey(node_hi)


def refit(bvh: Lbvh, soup: TriangleSoup) -> Lbvh:
    """Recompute every AABB of ``bvh`` for moved vertices, keeping the
    topology: leaf boxes from the soup's corners in sorted order, then
    the node boxes bottom-up. Differentiable w.r.t. the soup."""
    order = bvh.order.long()
    p0 = soup.p0[order]
    leaf_lo, leaf_hi = _corner_bounds(p0, (soup.p0 - soup.e1)[order],
                                      (soup.p0 + soup.e2)[order])
    node_lo, node_hi = _refit_boxes(bvh.left, bvh.right, leaf_lo, leaf_hi)
    return dataclasses.replace(bvh, node_lo=node_lo, node_hi=node_hi,
                               leaf_lo=leaf_lo, leaf_hi=leaf_hi)


def sah_cost(bvh: Lbvh, traversal_cost: float = 1.0) -> torch.Tensor:
    """Whole-tree SAH cost with leaves of one triangle, normalised by the
    root's half area: (traversal_cost * sum(inner half areas) + sum(leaf
    half areas)) / root half area."""

    def half_area(lo, hi):
        d = hi - lo
        return d[..., 0] * (d[..., 1] + d[..., 2]) + d[..., 1] * d[..., 2]

    inner = half_area(bvh.node_lo, bvh.node_hi).sum() * traversal_cost
    leaves = half_area(bvh.leaf_lo, bvh.leaf_hi).sum()
    return (inner + leaves) / half_area(bvh.node_lo[0], bvh.node_hi[0])


def _starts(T, cut, range_lo, leaf_cut, device):
    """(T,) int32 0/1 marks of the cut nodes' first positions and of the
    singleton leaves, and each position's group id (prefix sum - 1). The
    nodes and leaves not cut mark the extra slot T, sliced off (the JAX
    package's dropped slot)."""
    # index_fill_, not ``starts[idx] = 1``: that copies the 1 from host
    # memory, which a CUDA graph capture refuses.
    starts = torch.zeros(T + 1, dtype=torch.int32, device=device)
    starts.index_fill_(0, torch.where(cut, range_lo.long(), T), 1)
    starts.index_fill_(0, torch.where(leaf_cut, torch.arange(T, device=device),
                                      T), 1)
    starts = starts[:T]
    return starts, torch.cumsum(starts, 0, dtype=torch.int32) - 1


def cluster_cut(bvh: Lbvh, cluster_size: int):
    """Partition sorted triangles into treelet clusters of <= cluster_size.

    A node is cut when its range fits a cluster but its parent's does not;
    cut ranges tile [0, T). Returns (starts, cluster_of_sorted_pos).
    """
    T = bvh.num_triangles
    size = bvh.range_hi - bvh.range_lo + 1
    psize = torch.where(bvh.parent >= 0, size[bvh.parent.clamp(min=0).long()],
                        T + 1)
    cut = (size <= cluster_size) & (psize > cluster_size)
    # Leaves whose parent is already too big form singleton clusters.
    leaf_cut = size[bvh.leaf_parent.long()] > cluster_size
    return _starts(T, cut, bvh.range_lo, leaf_cut, size.device)


def super_cut(bvh: Lbvh, fine_starts: torch.Tensor, max_fine: int):
    """Second-level treelet cut: supers of <= ``max_fine`` fine clusters.

    A super is a maximal subtree holding at most ``max_fine`` fine-cluster
    starts, so it is a real tree node whose box is a union of whole fine
    clusters, and its fine members are contiguous in cut order. Returns
    (starts2, super_of_pos), encoded as in ``cluster_cut``.
    """
    T = bvh.num_triangles
    ps = torch.cumsum(fine_starts, 0, dtype=torch.int32)
    lo = bvh.range_lo
    cnt = ps[bvh.range_hi.long()] - torch.where(
        lo > 0, ps[(lo - 1).clamp(min=0).long()], 0)
    pcnt = torch.where(bvh.parent >= 0, cnt[bvh.parent.clamp(min=0).long()],
                       T + 1)
    cut = (cnt <= max_fine) & (pcnt > max_fine)
    leaf_cut = cnt[bvh.leaf_parent.long()] > max_fine
    return _starts(T, cut, lo, leaf_cut, cnt.device)

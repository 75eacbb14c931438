"""PLOC: parallel locally-ordered agglomerative clustering, in torch on the
soup's device (counterpart of ``ceres_tpu/accel/ploc.py``: ``PlocTree``,
``build_ploc``, ``sah_cost``).

Morton-sort the leaves, then repeatedly let every cluster pick the
neighbour of least union area within +-``search_radius`` places of the
sorted order; mutual pairs merge. One round is whole-tensor work:
windowed union areas by rolled arrays, mutual matches by a gather,
compaction by a cumsum. At least one pair (the global minimum) merges a
round, so the loop ends in <= T-1 rounds (about log T in practice). The
JAX package runs the rounds in a ``lax.while_loop``; here the loop
condition is one host read of the round's merge count.

Every array equals the JAX package's: the same stable morton order, the
strict ``<`` and the order of the ``d`` loop that decide ties, XLA's
signed-zero min and max for stored boxes (``utils.minmax``), and the
dropped scatters of ``mode="drop"`` sent into one padding slot that is
sliced off.

Output is a binary tree in the LBVH child encoding (internal id >= 0,
leaf encoded -(leaf+1)); leaves are the morton-ordered triangles.
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.accel import morton
from ceres_tpu_torch.models.mesh import TriangleSoup
from ceres_tpu_torch.utils import minmax

SEARCH_RADIUS = 14


@dataclasses.dataclass(frozen=True)
class PlocTree:
    order: torch.Tensor    # (T,) int32 morton order: sorted pos -> tri id
    left: torch.Tensor     # (T-1,) int32 child code (internal id or -(leaf+1))
    right: torch.Tensor    # (T-1,)
    node_lo: torch.Tensor  # (T-1, 3)
    node_hi: torch.Tensor  # (T-1, 3)
    leaf_lo: torch.Tensor  # (T, 3)
    leaf_hi: torch.Tensor  # (T, 3)
    root: int              # internal id of the root
    rounds: int = 0        # merge rounds of the build (0: not built here)


def _half_area(lo, hi):
    d = (hi - lo).clamp(min=0.0)
    return d[..., 0] * (d[..., 1] + d[..., 2]) + d[..., 1] * d[..., 2]


def _fma_f32(a, b, c):
    """a * b + c in float32, rounded once. The float64 product is exact;
    the float64 sum is rounded to odd (an inexact sum whose last bit is
    even moves one ulp towards the exact value, found by TwoSum), and a
    round to odd at 53 bits followed by one to nearest at 24 is the
    correctly rounded result."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # s + err == p + c exactly
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def _round_area(lo, hi):
    """``_half_area`` as XLA compiles it into the JAX package's round on
    the CPU: fma(d1, d2, d0 * (d1 + d2)). The fused sum can round a near
    tie the other way: on the dragon, leaf 1462 ties 1461 and 1463 under
    the fused form (0.012852783314883709 both) and prefers 1461 under
    the plain one (1463's pair: 0.012852784246206284), so the trees part
    at internal node 361 (``tests/test_torch_builders.py``). A float64
    soup takes the plain form: the JAX package's ``build_ploc`` does not
    run under x64 (its loop carry mixes int32 and int64), so there is no
    float64 tree to match."""
    if lo.dtype != torch.float32:
        return _half_area(lo, hi)
    d = (hi - lo).clamp(min=0.0)
    return _fma_f32(d[..., 1], d[..., 2], d[..., 0] * (d[..., 1] + d[..., 2]))


def build_ploc(soup: TriangleSoup,
               search_radius: int = SEARCH_RADIUS) -> PlocTree:
    """Build the PLOC tree of a soup (T >= 2) on its device."""
    T = soup.num_triangles
    if T < 2:
        raise ValueError("PLOC needs at least 2 triangles")
    dev = soup.p0.device
    p0 = soup.p0.detach()
    p1 = p0 - soup.e1.detach()
    p2 = p0 + soup.e2.detach()
    # The JAX package divides by 3.0 eagerly (outside jit), a true
    # division; a 0-d tensor divisor keeps torch from taking a reciprocal.
    # (TriangleSoup.centers() multiplies by f32(1/3), as jitted builders
    # compute it.)
    total = p0 + p1 + p2
    centers = total / total.new_tensor(3.0)
    order = morton.morton_order(centers)
    ol = order.long()
    pts = torch.stack([p0[ol], p1[ol], p2[ol]], dim=1)
    leaf_lo = minmax.amin(pts, 1)
    leaf_hi = minmax.amax(pts, 1)

    # One pool: leaves [0, T), internals [T, 2T-1), and slot 2T-1 where
    # the scatters of non-merging entries land (sliced off at the end).
    n_nodes = 2 * T - 1
    inf = torch.full((T, 3), float("inf"), dtype=leaf_lo.dtype, device=dev)
    all_lo = torch.cat([leaf_lo, inf])
    all_hi = torch.cat([leaf_hi, -inf])
    active = torch.arange(T, device=dev)          # node-pool ids, padded
    left = torch.zeros(T, dtype=torch.int64, device=dev)   # slot T-1: drop
    right = torch.zeros(T, dtype=torch.int64, device=dev)
    idx = torch.arange(T, device=dev)
    num_active, num_internal, rounds = T, 0, 0

    def encode(pool_id):
        return torch.where(pool_id < T, -(pool_id + 1), pool_id - T)

    while num_active > 1:
        valid = idx < num_active
        ids = torch.where(valid, active, 0)
        alo = all_lo[ids]
        ahi = all_hi[ids]

        best_area = torch.full((T,), float("inf"), dtype=alo.dtype,
                               device=dev)
        best_j = idx
        for d in range(1, search_radius + 1):
            # Pair (i, i+d): union area, valid when both ends are active.
            u_lo = minmax.fmin(alo, torch.roll(alo, -d, 0))
            u_hi = minmax.fmax(ahi, torch.roll(ahi, -d, 0))
            area = _round_area(u_lo, u_hi)
            ok = valid & (idx + d < num_active)
            area = torch.where(ok, area, float("inf"))
            # i prefers i+d
            better = area < best_area
            best_area = torch.where(better, area, best_area)
            best_j = torch.where(better, idx + d, best_j)
            # i+d prefers i
            area_s = torch.roll(area, d, 0)
            better = area_s < best_area
            best_area = torch.where(better, area_s, best_area)
            best_j = torch.where(better, idx - d, best_j)

        bj = best_j.clamp(0, T - 1)
        mutual = (best_j[bj] == idx) & valid
        merge_lead = mutual & (best_j > idx)     # i merges with j = best_j > i

        # Allocate new internal nodes for the leads.
        lead_rank = torch.cumsum(merge_lead.long(), 0) - 1
        new_id = T + num_internal + lead_rank     # node-pool id
        n_merges = int(merge_lead.sum())

        j_ids = active[bj]
        m_lo = minmax.fmin(alo, all_lo[j_ids])
        m_hi = minmax.fmax(ahi, all_hi[j_ids])

        tgt = torch.where(merge_lead, new_id, n_nodes)
        all_lo[tgt] = m_lo
        all_hi[tgt] = m_hi
        itgt = torch.where(merge_lead, new_id - T, T - 1)
        left[itgt] = encode(ids)
        right[itgt] = encode(j_ids)

        # Compact: leads become their new node, partners vanish.
        partner = mutual & (best_j < idx)
        keep = valid & ~partner
        entry = torch.where(merge_lead, new_id, active)
        pos = torch.cumsum(keep.long(), 0) - 1
        active = torch.zeros(T + 1, dtype=torch.int64, device=dev)
        active[torch.where(keep, pos, T)] = entry
        active = active[:T]
        num_active -= n_merges
        num_internal += n_merges
        rounds += 1

    return PlocTree(order=order, left=left[:T - 1].to(torch.int32),
                    right=right[:T - 1].to(torch.int32),
                    node_lo=all_lo[T:n_nodes], node_hi=all_hi[T:n_nodes],
                    leaf_lo=leaf_lo, leaf_hi=leaf_hi,
                    root=int(active[0]) - T, rounds=rounds)


def sah_cost(tree: PlocTree, traversal_cost: float = 1.0) -> torch.Tensor:
    """Whole-tree SAH cost over the root's area, leaf size 1."""
    inner = torch.sum(_half_area(tree.node_lo, tree.node_hi)) * traversal_cost
    leaves = torch.sum(_half_area(tree.leaf_lo, tree.leaf_hi))
    root = tree.root
    return (inner + leaves) / _half_area(tree.node_lo[root],
                                         tree.node_hi[root])

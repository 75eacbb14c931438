"""Host-side SweepSAH and BinnedSAH builders and the flat BVH layout
(counterpart of ``ceres_tpu/accel/golden_builders.py``: ``FlatBvh``,
``_Builder``, ``SweepSahBuilder``, ``BinnedSahBuilder``,
``build_sweep_sah``, ``build_binned_sah``, ``sah_cost``, ``validate``,
``optimize_node_layout``, ``traverse_closest``).

A copy in NumPy, not an import: ``ceres_tpu`` imports ``jax`` at package
import, and the port runs where JAX is not installed. Every builder must
stay node-identical to the JAX package's (float64 internally, the same
stable sorts and tie-breaks); ``tests/test_torch_accel.py`` and
``tests/test_torch_builders.py`` hold it to that. The native C++ form of
the binned builder is ``ceres_tpu_torch.accel.native``.

Flat layout:
  * at most 2N-1 nodes, root at index 0, children allocated as an
    adjacent pair so one index addresses both;
  * bounds interleaved [minx, maxx, miny, maxy, minz, maxz];
  * ``prim_count == 0`` marks an inner node; leaves own the range
    [first_child, first_child + prim_count) of ``prim_indices``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TRAVERSAL_COST = 1.0
MAX_DEPTH = 64
MAX_LEAF_SIZE = 16


@dataclasses.dataclass
class FlatBvh:
    bounds: np.ndarray        # (N, 6) interleaved min/max per axis
    prim_count: np.ndarray    # (N,) uint32, 0 => inner node
    first_child: np.ndarray   # (N,) uint32: child pair index or prim range start
    prim_indices: np.ndarray  # (T,) uint32
    node_count: int

    def is_leaf(self, i: int) -> bool:
        return self.prim_count[i] > 0


def _half_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * (d[..., 1] + d[..., 2]) + d[..., 1] * d[..., 2]


def _interleave(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    out = np.empty(lo.shape[:-1] + (6,), lo.dtype)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


class _Builder:
    """Shared top-down recursion; subclasses supply ``_find_split``. A
    node becomes a leaf when no split beats the leaf cost, or, past
    ``max_leaf_size``, takes a forced median split."""

    def __init__(self, tri_lo, tri_hi, centers, max_leaf_size=MAX_LEAF_SIZE):
        self.lo = np.asarray(tri_lo, np.float64)
        self.hi = np.asarray(tri_hi, np.float64)
        self.centers = np.asarray(centers, np.float64)
        self.max_leaf = max_leaf_size
        T = self.lo.shape[0]
        self.bounds = np.zeros((2 * T + 1, 6), np.float32)
        self.prim_count = np.zeros(2 * T + 1, np.uint32)
        self.first_child = np.zeros(2 * T + 1, np.uint32)
        self.order = np.arange(T, dtype=np.uint32)
        self.node_count = 1

    def build(self) -> FlatBvh:
        T = self.lo.shape[0]
        self._set_bounds(0, np.arange(T))
        self._recurse(0, 0, T, 0)
        n = self.node_count
        return FlatBvh(bounds=self.bounds[:n].copy(),
                       prim_count=self.prim_count[:n].copy(),
                       first_child=self.first_child[:n].copy(),
                       prim_indices=self.order.copy(),
                       node_count=n)

    def _set_bounds(self, node, prim_ids):
        lo = self.lo[prim_ids].min(axis=0)
        hi = self.hi[prim_ids].max(axis=0)
        self.bounds[node] = _interleave(lo.astype(np.float32),
                                        hi.astype(np.float32))

    def _make_leaf(self, node, begin, end):
        self.prim_count[node] = end - begin
        self.first_child[node] = begin

    def _recurse(self, node, begin, end, depth):
        size = end - begin
        if size <= 1 or depth >= MAX_DEPTH:
            self._make_leaf(node, begin, end)
            return
        ids = self.order[begin:end]
        split = self._find_split(ids)
        if split is None:
            if size <= self.max_leaf:
                self._make_leaf(node, begin, end)
                return
            # Forced median split along the widest axis.
            axis = int(np.argmax(self.hi[ids].max(0) - self.lo[ids].min(0)))
            order = np.argsort(self.centers[ids][:, axis], kind="stable")
            mid = size // 2
            new_ids = ids[order]
        else:
            axis, new_ids, mid = split
        self.order[begin:end] = new_ids
        left = self.node_count
        self.node_count += 2  # children adjacent
        self.first_child[node] = left
        self.prim_count[node] = 0
        self._set_bounds(left, self.order[begin:begin + mid])
        self._set_bounds(left + 1, self.order[begin + mid:end])
        self._recurse(left, begin, begin + mid, depth + 1)
        self._recurse(left + 1, begin + mid, end, depth + 1)

    def _leaf_cost(self, size):
        return float(size)

    def _find_split(self, ids):
        raise NotImplementedError


class SweepSahBuilder(_Builder):
    """Exact full-sweep SAH: every split position on every axis is
    evaluated."""

    def _find_split(self, ids):
        size = ids.shape[0]
        best = (np.inf, None, None)
        node_area = _half_area(self.lo[ids].min(0), self.hi[ids].max(0))
        for axis in range(3):
            order = np.argsort(self.centers[ids][:, axis], kind="stable")
            lo_s, hi_s = self.lo[ids][order], self.hi[ids][order]
            # prefix/suffix running unions
            left_lo = np.minimum.accumulate(lo_s, 0)
            left_hi = np.maximum.accumulate(hi_s, 0)
            right_lo = np.minimum.accumulate(lo_s[::-1], 0)[::-1]
            right_hi = np.maximum.accumulate(hi_s[::-1], 0)[::-1]
            k = np.arange(1, size)
            cost = (_half_area(left_lo[:-1], left_hi[:-1]) * k
                    + _half_area(right_lo[1:], right_hi[1:]) * (size - k))
            i = int(np.argmin(cost))
            if cost[i] < best[0]:
                best = (cost[i], axis, order, i + 1)
        # Leaf when the split costs at least the leaf (primitive count).
        if best[1] is None or (
                best[0] / node_area + TRAVERSAL_COST >= self._leaf_cost(size)
                and size <= self.max_leaf):
            return None
        _, axis, order, mid = best
        return axis, ids[order], mid


class BinnedSahBuilder(_Builder):
    """Binned SAH with ``bin_count`` centroid bins per axis (16, as the
    reference's static app builds)."""

    def __init__(self, *args, bin_count: int = 16, **kwargs):
        super().__init__(*args, **kwargs)
        self.bin_count = bin_count

    def _find_split(self, ids):
        size = ids.shape[0]
        c = self.centers[ids]
        node_area = _half_area(self.lo[ids].min(0), self.hi[ids].max(0))
        best = (np.inf, None, None)
        for axis in range(3):
            cmin, cmax = c[:, axis].min(), c[:, axis].max()
            if cmax <= cmin:
                continue
            which = np.minimum(
                ((c[:, axis] - cmin) / (cmax - cmin)
                 * self.bin_count).astype(np.int64),
                self.bin_count - 1)
            counts = np.bincount(which, minlength=self.bin_count)
            bin_lo = np.full((self.bin_count, 3), np.inf)
            bin_hi = np.full((self.bin_count, 3), -np.inf)
            for b in range(self.bin_count):
                sel = which == b
                if sel.any():
                    bin_lo[b] = self.lo[ids][sel].min(0)
                    bin_hi[b] = self.hi[ids][sel].max(0)
            left_lo = np.minimum.accumulate(bin_lo, 0)
            left_hi = np.maximum.accumulate(bin_hi, 0)
            right_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1]
            right_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1]
            lcnt = np.cumsum(counts)
            cost = (_half_area(left_lo[:-1], left_hi[:-1]) * lcnt[:-1]
                    + _half_area(right_lo[1:], right_hi[1:])
                    * (size - lcnt[:-1]))
            cost = np.where((lcnt[:-1] == 0) | (lcnt[:-1] == size),
                            np.inf, cost)
            b = int(np.argmin(cost))
            if cost[b] < best[0]:
                best = (cost[b], axis, (which <= b))
        if best[1] is None or (
                best[0] / node_area + TRAVERSAL_COST >= self._leaf_cost(size)
                and size <= self.max_leaf):
            return None
        _, axis, left_sel = best
        mid = int(left_sel.sum())
        if mid == 0 or mid == size:
            return None
        new_ids = np.concatenate([ids[left_sel], ids[~left_sel]])
        return axis, new_ids, mid


def build_sweep_sah(tri_lo, tri_hi, centers, **kw) -> FlatBvh:
    return SweepSahBuilder(tri_lo, tri_hi, centers, **kw).build()


def build_binned_sah(tri_lo, tri_hi, centers, **kw) -> FlatBvh:
    return BinnedSahBuilder(tri_lo, tri_hi, centers, **kw).build()


def sah_cost(bvh: FlatBvh) -> float:
    """Whole-tree SAH cost over the root's area."""
    lo = bvh.bounds[:, 0::2]
    hi = bvh.bounds[:, 1::2]
    areas = _half_area(lo, hi)
    leaf = bvh.prim_count > 0
    cost = (np.sum(areas[leaf] * bvh.prim_count[leaf])
            + TRAVERSAL_COST * np.sum(areas[~leaf]))
    return float(cost / areas[0])


def validate(bvh: FlatBvh) -> None:
    """Assert the layout's invariants: leaf ranges partition the
    primitives, child pairs lie in range and nest in their parent, and no
    node is dead."""
    T = bvh.prim_indices.shape[0]
    seen = np.zeros(T, bool)
    stack = [0]
    visited = 0
    while stack:
        i = stack.pop()
        visited += 1
        lo_i = bvh.bounds[i, 0::2]
        hi_i = bvh.bounds[i, 1::2]
        if bvh.prim_count[i] > 0:
            a = int(bvh.first_child[i])
            b = a + int(bvh.prim_count[i])
            assert b <= T
            assert not seen[a:b].any(), "leaf ranges overlap"
            seen[a:b] = True
        else:
            c = int(bvh.first_child[i])
            assert 0 < c < bvh.node_count - 1, "child pair out of range"
            for ch in (c, c + 1):  # adjacent pair invariant
                assert (bvh.bounds[ch, 0::2] >= lo_i - 1e-4).all()
                assert (bvh.bounds[ch, 1::2] <= hi_i + 1e-4).all()
                stack.append(ch)
    assert seen.all(), "leaf ranges must cover all primitives"
    assert visited == bvh.node_count, "dead nodes in layout"
    assert sorted(bvh.prim_indices.tolist()) == list(range(T))


def optimize_node_layout(bvh: FlatBvh) -> FlatBvh:
    """Reorder child pairs so that pairs of larger surface area come first
    in memory: the topology is unchanged, the root stays at 0."""
    lo = bvh.bounds[:, 0::2]
    hi = bvh.bounds[:, 1::2]
    areas = _half_area(lo, hi)
    inner = np.where(bvh.prim_count == 0)[0]
    pair_first = bvh.first_child[inner].astype(np.int64)
    pair_area = areas[pair_first] + areas[pair_first + 1]
    order = np.argsort(-pair_area, kind="stable")

    remap = np.zeros(bvh.node_count, np.int64)
    remap[0] = 0
    next_slot = 1
    for k in order:
        c = pair_first[k]
        remap[c] = next_slot
        remap[c + 1] = next_slot + 1
        next_slot += 2

    n = bvh.node_count
    bounds = np.zeros_like(bvh.bounds)
    prim_count = np.zeros_like(bvh.prim_count)
    first_child = np.zeros_like(bvh.first_child)
    bounds[remap] = bvh.bounds
    prim_count[remap] = bvh.prim_count
    fc = bvh.first_child.astype(np.int64)
    # A leaf's first_child is a primitive-range start (it may exceed
    # node_count): clip it before the (unused) remap lookup.
    first_child[remap] = np.where(
        bvh.prim_count == 0,
        remap[np.minimum(fc, n - 1)].astype(np.uint32),
        bvh.first_child)
    return FlatBvh(bounds=bounds, prim_count=prim_count,
                   first_child=first_child,
                   prim_indices=bvh.prim_indices.copy(), node_count=n)


def traverse_closest(bvh: FlatBvh, p0, e1, e2, n, origins, dirs,
                     tmin=0.0, tmax=np.inf):
    """Stack traversal closest hit, one Python loop a ray: the oracle of
    the tests (test scale only).

    Returns (t, u, v, prim_id, hit_mask) as NumPy arrays.
    """
    R = origins.shape[0]
    out_t = np.full(R, np.inf)
    out_u = np.zeros(R)
    out_v = np.zeros(R)
    out_id = np.full(R, -1, np.int64)
    for r in range(R):
        o, d = origins[r], dirs[r]
        inv = 1.0 / np.where(np.abs(d) < 1e-30,
                             np.where(d >= 0, 1e-30, -1e-30), d)
        t_best = tmax
        stack = [0]
        while stack:
            i = stack.pop()
            lo = bvh.bounds[i, 0::2]
            hi = bvh.bounds[i, 1::2]
            t0 = (lo - o) * inv
            t1 = (hi - o) * inv
            tn = max(np.minimum(t0, t1).max(), tmin)
            tf = min(np.maximum(t0, t1).min(), t_best)
            if tn > tf:
                continue
            if bvh.prim_count[i] > 0:
                a = int(bvh.first_child[i])
                for k in range(a, a + int(bvh.prim_count[i])):
                    tri = int(bvh.prim_indices[k])
                    c = p0[tri] - o
                    rr = np.cross(d, c)
                    det = n[tri].dot(d)
                    if det == 0:
                        continue
                    u = rr.dot(e2[tri]) / det
                    v = rr.dot(e1[tri]) / det
                    t = n[tri].dot(c) / det
                    if (u >= 0 and v >= 0 and 1 - u - v >= 0
                            and tmin <= t <= t_best):
                        t_best = t
                        out_t[r], out_u[r], out_v[r] = t, u, v
                        out_id[r] = tri
            else:
                c = int(bvh.first_child[i])
                stack.append(c)
                stack.append(c + 1)
    return out_t, out_u, out_v, out_id, out_id >= 0

"""Host-side SweepSAH builder and flat BVH layout (counterpart of
``ceres_tpu/accel/golden_builders.py``: ``FlatBvh``, ``SweepSahBuilder``,
``build_sweep_sah``).

A copy in NumPy, not an import: ``ceres_tpu`` imports ``jax`` at package
import, and the port runs where JAX is not installed. The copy must stay
node-identical to the JAX package's builder (float64 internally, the
same stable sorts and tie-breaks); ``tests/test_torch_accel.py`` holds
it to that. The binned SAH builder waits for ROADMAP item M9.

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


def _half_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return d[..., 0] * (d[..., 1] + d[..., 2]) + d[..., 1] * d[..., 2]


def _interleave(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    out = np.empty(lo.shape[:-1] + (6,), lo.dtype)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


class SweepSahBuilder:
    """Exact full-sweep SAH, top-down: every split position on every axis
    is evaluated; a node becomes a leaf when no split beats the leaf cost
    (or, past ``max_leaf_size``, a median split is forced)."""

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
                best[0] / node_area + TRAVERSAL_COST >= float(size)
                and size <= self.max_leaf):
            return None
        _, axis, order, mid = best
        return axis, ids[order], mid


def build_sweep_sah(tri_lo, tri_hi, centers, **kw) -> FlatBvh:
    return SweepSahBuilder(tri_lo, tri_hi, centers, **kw).build()

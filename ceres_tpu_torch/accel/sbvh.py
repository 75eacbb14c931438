"""Spatial-split BVH (SBVH) builder, Stich et al. 2009 (counterpart of
``ceres_tpu/accel/sbvh.py``: ``split_triangle_box``,
``SpatialSplitBvhBuilder``, ``build_sbvh``, ``validate_sbvh``).

A NumPy copy of the JAX package's host builder, node for node the same
(``tests/test_torch_builders.py``). It emits the same FlatBvh layout as
``golden_builders`` (child pairs adjacent, interleaved bounds), but its
leaf ranges index a *reference* array that may hold duplicates: spatial
splits duplicate straddling primitives into both children, within a
budget of ``split_factor`` x T. The cut (``accel.cuts``) takes a
duplicate as one more member of its cluster.

Constants: ``split_factor = 0.3`` (the duplication budget), ``alpha =
1e-5`` (spatial splits are tried only where the object split's children
overlap by more than alpha x the root's area), 64 spatial bins.
"""

from __future__ import annotations

import numpy as np

from ceres_tpu_torch.accel.golden_builders import (
    MAX_DEPTH,
    MAX_LEAF_SIZE,
    TRAVERSAL_COST,
    FlatBvh,
    _half_area,
    _interleave,
)

SPLIT_FACTOR = 0.3
ALPHA = 1e-5
BIN_COUNT = 64


def _nmin3(x, y):
    """np.minimum of two float triples: ``y``'s component where they
    compare equal (so the sign of a zero is NumPy's)."""
    return [x[0] if x[0] < y[0] else y[0], x[1] if x[1] < y[1] else y[1],
            x[2] if x[2] < y[2] else y[2]]


def _nmax3(x, y):
    """np.maximum of two float triples: ``y``'s component where equal."""
    return [x[0] if x[0] > y[0] else y[0], x[1] if x[1] > y[1] else y[1],
            x[2] if x[2] > y[2] else y[2]]


def _split_box(verts, axis: int, pos: float):
    """``split_triangle_box`` on Python floats: ``verts`` three (x, y, z)
    float64 triples; returns lists (left_lo, left_hi, right_lo,
    right_hi). The same IEEE operations as the NumPy form one component
    at a time, several times faster on one triangle."""
    inf = float("inf")
    left_lo, left_hi = [inf] * 3, [-inf] * 3
    right_lo, right_hi = [inf] * 3, [-inf] * 3
    for i in range(3):
        a = verts[i]
        b = verts[(i + 1) % 3]
        if a[axis] <= pos:
            left_lo, left_hi = _nmin3(left_lo, a), _nmax3(left_hi, a)
        if a[axis] >= pos:
            right_lo, right_hi = _nmin3(right_lo, a), _nmax3(right_hi, a)
        # Edge straddles the plane -> both boxes get the crossing point.
        if (a[axis] < pos < b[axis]) or (b[axis] < pos < a[axis]):
            t = (pos - a[axis]) / (b[axis] - a[axis])
            q = [a[0] + t * (b[0] - a[0]), a[1] + t * (b[1] - a[1]),
                 a[2] + t * (b[2] - a[2])]
            q[axis] = pos  # exact, regardless of FP in the lerp
            left_lo, left_hi = _nmin3(left_lo, q), _nmax3(left_hi, q)
            right_lo, right_hi = _nmin3(right_lo, q), _nmax3(right_hi, q)
    return left_lo, left_hi, right_lo, right_hi


def split_triangle_box(p0, p1, p2, axis: int, pos: float):
    """Clip a triangle at the plane x[axis] = pos; return both halves' AABBs.

    Walk the three edges; each vertex extends its own side's box; an edge
    crossing the plane contributes the (exactly-on-plane) intersection
    point to *both* boxes. Returns ((left_lo, left_hi), (right_lo,
    right_hi)) as float64 arrays; a side the triangle never touches comes
    back as an empty box (lo > hi).
    """
    verts = np.asarray([p0, p1, p2], np.float64).tolist()
    llo, lhi, rlo, rhi = _split_box(verts, axis, pos)
    return ((np.asarray(llo), np.asarray(lhi)),
            (np.asarray(rlo), np.asarray(rhi)))


class SpatialSplitBvhBuilder:
    """Golden SBVH: full-sweep object splits + binned spatial splits.

    Works over *references* — (primitive id, clipped AABB, center) triples —
    so one triangle may appear in several leaves. ``build`` returns a
    FlatBvh whose ``prim_indices`` has ``reference_count >= T`` entries.
    """

    def __init__(self, p0, p1, p2, max_leaf_size: int = MAX_LEAF_SIZE,
                 split_factor: float = SPLIT_FACTOR,
                 bin_count: int = BIN_COUNT, alpha: float = ALPHA):
        self.p0 = np.asarray(p0, np.float64)
        self.p1 = np.asarray(p1, np.float64)
        self.p2 = np.asarray(p2, np.float64)
        T = self.p0.shape[0]
        pts = np.stack([self.p0, self.p1, self.p2], axis=1)
        self.verts = pts.tolist()  # per triangle, for _split_box
        self.tri_lo = pts.min(axis=1)
        self.tri_hi = pts.max(axis=1)
        self.max_leaf = max_leaf_size
        self.bin_count = bin_count
        self.alpha = alpha
        self.budget = int(split_factor * T)
        cap = 2 * (T + self.budget) + 1
        self.bounds = np.zeros((cap, 6), np.float32)
        self.prim_count = np.zeros(cap, np.uint32)
        self.first_child = np.zeros(cap, np.uint32)
        self.node_count = 1
        # Reference soup: start with one reference per primitive.
        self.ref_id = list(range(T))
        self.ref_lo = [self.tri_lo[i].copy() for i in range(T)]
        self.ref_hi = [self.tri_hi[i].copy() for i in range(T)]
        self.out_refs: list[int] = []
        self.leaves: list[tuple[int, int, int]] = []  # (node, start, count)

    # -- shared helpers ----------------------------------------------------

    def _union(self, refs):
        lo = np.min([self.ref_lo[r] for r in refs], axis=0)
        hi = np.max([self.ref_hi[r] for r in refs], axis=0)
        return lo, hi

    def build(self) -> FlatBvh:
        T = self.p0.shape[0]
        if T == 0:
            raise ValueError("empty scene")
        refs = list(range(T))
        lo, hi = self._union(refs)
        self.root_area = float(_half_area(lo, hi))
        self.bounds[0] = _interleave(lo.astype(np.float32),
                                     hi.astype(np.float32))
        self._recurse(0, refs, 0)
        # Emit leaf ranges into the flat reference array.
        for node, start, count in self.leaves:
            self.first_child[node] = start
            self.prim_count[node] = count
        n = self.node_count
        return FlatBvh(bounds=self.bounds[:n].copy(),
                       prim_count=self.prim_count[:n].copy(),
                       first_child=self.first_child[:n].copy(),
                       prim_indices=np.asarray(self.out_refs, np.uint32),
                       node_count=n)

    def _make_leaf(self, node, refs):
        start = len(self.out_refs)
        self.out_refs.extend(self.ref_id[r] for r in refs)
        self.leaves.append((node, start, len(refs)))

    # -- object split (full sweep, sweep_sah_builder semantics) ------------

    def _object_split(self, refs):
        size = len(refs)
        lo = np.asarray([self.ref_lo[r] for r in refs])
        hi = np.asarray([self.ref_hi[r] for r in refs])
        centers = (lo + hi) * 0.5
        best = (np.inf, None, None, None, 0.0)
        for axis in range(3):
            order = np.argsort(centers[:, axis], kind="stable")
            lo_s, hi_s = lo[order], hi[order]
            left_lo = np.minimum.accumulate(lo_s, 0)
            left_hi = np.maximum.accumulate(hi_s, 0)
            right_lo = np.minimum.accumulate(lo_s[::-1], 0)[::-1]
            right_hi = np.maximum.accumulate(hi_s[::-1], 0)[::-1]
            k = np.arange(1, size)
            cost = (_half_area(left_lo[:-1], left_hi[:-1]) * k
                    + _half_area(right_lo[1:], right_hi[1:]) * (size - k))
            i = int(np.argmin(cost))
            if cost[i] < best[0]:
                # Overlap of the two children (drives the spatial-split
                # attempt decision, spatial_split_bvh_builder.hpp:237-247).
                olo = np.maximum(left_lo[i], right_lo[i + 1])
                ohi = np.minimum(left_hi[i], right_hi[i + 1])
                overlap = float(_half_area(olo, ohi)) if (ohi > olo).all() else 0.0
                best = (cost[i], axis, order, i + 1, overlap)
        cost, axis, order, mid, overlap = best
        left = [refs[j] for j in order[:mid]]
        right = [refs[j] for j in order[mid:]]
        return cost, left, right, overlap

    # -- spatial split (binned, with reference clipping) --------------------

    def _spatial_split(self, refs, node_lo, node_hi):
        """Best binned spatial split; returns (cost, axis, position) or None."""
        best = (np.inf, None, None)
        K = self.bin_count
        lo = np.asarray([self.ref_lo[r] for r in refs])
        hi = np.asarray([self.ref_hi[r] for r in refs])
        for axis in range(3):
            extent = node_hi[axis] - node_lo[axis]
            if extent <= 0:
                continue
            edges = node_lo[axis] + extent * np.arange(1, K) / K
            # Chained-bin entry/exit counts (the reference streams each
            # reference through the bins it straddles, :296-346); here the
            # per-bin clipped boxes come from repeated plane clips.
            first = np.clip(((lo[:, axis] - node_lo[axis]) / extent * K)
                            .astype(np.int64), 0, K - 1)
            last = np.clip(((hi[:, axis] - node_lo[axis]) / extent * K)
                           .astype(np.int64), 0, K - 1)
            bins_lo = [[np.inf] * 3 for _ in range(K)]
            bins_hi = [[-np.inf] * 3 for _ in range(K)]
            entry = np.zeros(K, np.int64)
            exit_ = np.zeros(K, np.int64)
            for j, r in enumerate(refs):
                entry[first[j]] += 1
                exit_[last[j]] += 1
                cur_lo = self.ref_lo[r].tolist()
                cur_hi = self.ref_hi[r].tolist()
                i = int(self.ref_id[r])
                for b in range(first[j], last[j] + 1):
                    if b < last[j]:
                        (seg, cur) = self._clip_box(
                            i, cur_lo, cur_hi, axis,
                            node_lo[axis] + extent * (b + 1) / K)
                        cur_lo, cur_hi = cur
                    else:
                        seg = (cur_lo, cur_hi)
                    bins_lo[b] = _nmin3(bins_lo[b], seg[0])
                    bins_hi[b] = _nmax3(bins_hi[b], seg[1])
            bin_lo = np.asarray(bins_lo)
            bin_hi = np.asarray(bins_hi)
            left_lo = np.minimum.accumulate(bin_lo, 0)
            left_hi = np.maximum.accumulate(bin_hi, 0)
            right_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1]
            right_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1]
            lcnt = np.cumsum(entry)
            rcnt = np.cumsum(exit_[::-1])[::-1]
            cost = (_half_area(left_lo[:-1], left_hi[:-1]) * lcnt[:-1]
                    + _half_area(right_lo[1:], right_hi[1:]) * rcnt[1:])
            cost = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, cost)
            b = int(np.argmin(cost))
            if cost[b] < best[0]:
                best = (float(cost[b]), axis, float(edges[b]))
        if best[1] is None:
            return None
        return best

    def _clip_ref(self, tri, cur_lo, cur_hi, axis, pos):
        """Clip reference (already a sub-box of triangle ``tri``) at a plane.

        Returns ((left_lo, left_hi), (right_lo, right_hi)) as float64
        arrays, both intersected with the incoming reference box (chained
        clipping).
        """
        (llo, lhi), (rlo, rhi) = self._clip_box(
            tri, cur_lo.tolist(), cur_hi.tolist(), axis, pos)
        return ((np.asarray(llo), np.asarray(lhi)),
                (np.asarray(rlo), np.asarray(rhi)))

    def _clip_box(self, tri, cur_lo, cur_hi, axis, pos):
        """``_clip_ref`` on lists of Python floats, with NumPy's rules."""
        llo, lhi, rlo, rhi = _split_box(self.verts[tri], axis, pos)
        llo = _nmax3(llo, cur_lo)
        lhi = _nmin3(lhi, cur_hi)
        rlo = _nmax3(rlo, cur_lo)
        rhi = _nmin3(rhi, cur_hi)
        # Python's min and max keep their first argument on a tie.
        lhi[axis] = min(lhi[axis], pos)
        rlo[axis] = max(rlo[axis], pos)
        return (llo, lhi), (rlo, rhi)

    def _apply_spatial(self, refs, axis, pos):
        """Partition references at the plane, duplicating straddlers.

        Straddling references are duplicated while the budget lasts
        (clipped boxes on both sides); once exhausted they are *unsplit* to
        the side holding more of their extent (the reference's unsplitting
        fallback, :422-454).
        """
        left, right = [], []
        for r in refs:
            if self.ref_hi[r][axis] <= pos:
                left.append(r)
            elif self.ref_lo[r][axis] >= pos:
                right.append(r)
            else:
                (llo, lhi), (rlo, rhi) = self._clip_ref(
                    int(self.ref_id[r]), self.ref_lo[r], self.ref_hi[r],
                    axis, pos)
                degenerate = (lhi < llo).any() or (rhi < rlo).any()
                if self.budget > 0 and not degenerate:
                    self.budget -= 1
                    self.ref_lo[r], self.ref_hi[r] = llo, lhi
                    left.append(r)
                    self.ref_id.append(self.ref_id[r])
                    self.ref_lo.append(rlo)
                    self.ref_hi.append(rhi)
                    right.append(len(self.ref_id) - 1)
                else:
                    mid = (self.ref_lo[r][axis] + self.ref_hi[r][axis]) * 0.5
                    (left if mid <= pos else right).append(r)
        return left, right

    # -- recursion ----------------------------------------------------------

    def _recurse(self, node, refs, depth):
        size = len(refs)
        if size <= 1 or depth >= MAX_DEPTH:
            self._make_leaf(node, refs)
            return
        node_lo, node_hi = self._union(refs)
        node_area = float(_half_area(node_lo, node_hi))

        obj_cost, obj_l, obj_r, overlap = self._object_split(refs)
        use_spatial = None
        # Try a spatial split only when object-split children overlap
        # significantly (alpha threshold on root area, :74-75,237-247).
        if overlap > self.alpha * self.root_area and self.budget > 0:
            sp = self._spatial_split(refs, node_lo, node_hi)
            if sp is not None and sp[0] < obj_cost:
                use_spatial = sp

        best_cost = use_spatial[0] if use_spatial else obj_cost
        if (best_cost / max(node_area, 1e-300) + TRAVERSAL_COST
                >= size and size <= self.max_leaf):
            self._make_leaf(node, refs)
            return

        if use_spatial:
            _, axis, pos = use_spatial
            left, right = self._apply_spatial(refs, axis, pos)
            if not left or not right:  # numerical corner: fall back
                left, right = obj_l, obj_r
        else:
            left, right = obj_l, obj_r

        child = self.node_count
        self.node_count += 2  # adjacent child pair (bvh.hpp:86-91)
        self.first_child[node] = child
        self.prim_count[node] = 0
        for c, part in ((child, left), (child + 1, right)):
            lo, hi = self._union(part)
            self.bounds[c] = _interleave(lo.astype(np.float32),
                                         hi.astype(np.float32))
        self._recurse(child, left, depth + 1)
        self._recurse(child + 1, right, depth + 1)


def build_sbvh(p0, p1, p2, **kw) -> FlatBvh:
    return SpatialSplitBvhBuilder(p0, p1, p2, **kw).build()


def validate_sbvh(bvh: FlatBvh, num_triangles: int) -> None:
    """SBVH-specific invariants: leaf ranges partition the reference array
    (which may repeat primitive ids), every primitive appears at least
    once, and child boxes nest in their parent."""
    R = bvh.prim_indices.shape[0]
    seen = np.zeros(R, bool)
    covered = np.zeros(num_triangles, bool)
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
            assert b <= R
            assert not seen[a:b].any(), "leaf reference ranges overlap"
            seen[a:b] = True
            covered[bvh.prim_indices[a:b].astype(np.int64)] = True
        else:
            c = int(bvh.first_child[i])
            assert 0 < c < bvh.node_count - 1
            for ch in (c, c + 1):
                assert (bvh.bounds[ch, 0::2] >= lo_i - 1e-4).all()
                assert (bvh.bounds[ch, 1::2] <= hi_i + 1e-4).all()
                stack.append(ch)
    assert seen.all(), "reference array has dead entries"
    assert covered.all(), "a primitive vanished from every leaf"
    assert visited == bvh.node_count

"""Heuristic primitive pre-splitting, Karras & Aila 2013 (counterpart of
``ceres_tpu/accel/presplit.py``: ``split_priorities``, ``presplit_refs``,
``repair_bvh_leaves``, ``build_with_presplit``).

A NumPy copy of the JAX package's host pass, reference for reference the
same (``tests/test_torch_builders.py``). Long, thin primitives whose
boxes overestimate them badly are split into several grid-aligned
reference boxes before the build, which improves any builder's SAH:
  * priority ``cbrt(extent * (2 * half_area - area))``;
  * a global budget of ``split_factor`` x T splits, spread over the
    primitives in proportion to priority (largest remainders rounded up);
  * splits at power-of-2 grid planes: each reference box is cut at the
    coarsest grid plane inside it along its largest axis, clipping the
    triangle itself (``sbvh.split_triangle_box``) so boxes stay tight;
  * ``repair_bvh_leaves`` maps references back to primitives after the
    build and drops repeats within a leaf.
No path of ``cuts.build_clusters_quality`` takes it; it is a builder
option, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ceres_tpu_torch.accel.golden_builders import FlatBvh, _half_area
from ceres_tpu_torch.accel.sbvh import split_triangle_box

GRID_BITS = 20  # grid resolution exponent; planes live at k / 2^b fractions


def split_priorities(tri_lo, tri_hi, areas) -> np.ndarray:
    """Per-primitive split priority (heuristic_primitive_splitter.hpp:25-37)."""
    tri_lo = np.asarray(tri_lo, np.float64)
    tri_hi = np.asarray(tri_hi, np.float64)
    extent = (tri_hi - tri_lo).max(axis=1)
    box_area = 2.0 * _half_area(tri_lo, tri_hi)
    excess = np.maximum(box_area - np.asarray(areas, np.float64), 0.0)
    return np.cbrt(extent * excess)


def _grid_plane(lo: float, hi: float, world_lo: float, world_ext: float):
    """Coarsest power-of-2 grid plane strictly inside (lo, hi), or None.

    Grid planes sit at world_lo + world_ext * k / 2^b; the coarsest plane
    inside an interval is found by descending b until one fits — the
    power-of-2 alignment of the reference splitter (:92-110).
    """
    if not (hi > lo) or world_ext <= 0:
        return None
    a = (lo - world_lo) / world_ext
    b = (hi - world_lo) / world_ext
    for bits in range(1, GRID_BITS + 1):
        scale = float(1 << bits)
        k = np.floor(a * scale) + 1.0
        pos = world_lo + world_ext * (k / scale)
        if lo < pos < hi:
            return float(pos)
    return None


def presplit_refs(p0, p1, p2, split_factor: float = 0.5):
    """Split primitives into reference boxes under a global budget.

    Returns (ref_ids (R,) int64, ref_lo (R, 3), ref_hi (R, 3)) with
    R <= T * (1 + split_factor) + T. References cover each primitive's
    geometry exactly (clipped boxes union to the original box).
    """
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    T = p0.shape[0]
    pts = np.stack([p0, p1, p2], axis=1)
    tri_lo = pts.min(axis=1)
    tri_hi = pts.max(axis=1)
    areas = 0.5 * np.linalg.norm(
        np.cross(p0 - p1, p2 - p0), axis=1)

    pri = split_priorities(tri_lo, tri_hi, areas)
    budget = int(round(split_factor * T))
    total = pri.sum()
    if total <= 0 or budget <= 0:
        counts = np.zeros(T, np.int64)
    else:
        # Proportional distribution with largest-remainder rounding (the
        # prefix-sum budget distribution of :44-74).
        raw = pri / total * budget
        counts = np.floor(raw).astype(np.int64)
        rem = budget - counts.sum()
        if rem > 0:
            frac_order = np.argsort(-(raw - counts), kind="stable")
            counts[frac_order[:rem]] += 1

    world_lo = tri_lo.min(axis=0)
    world_ext = (tri_hi.max(axis=0) - world_lo).max()

    ref_ids: list[int] = []
    ref_lo: list[np.ndarray] = []
    ref_hi: list[np.ndarray] = []
    for i in range(T):
        queue = [(tri_lo[i].copy(), tri_hi[i].copy(), int(counts[i]))]
        while queue:
            lo, hi, k = queue.pop()
            plane = None
            axis = int(np.argmax(hi - lo))
            if k > 0:
                plane = _grid_plane(float(lo[axis]), float(hi[axis]),
                                    float(world_lo[axis]), float(world_ext))
            if plane is None:
                ref_ids.append(i)
                ref_lo.append(lo)
                ref_hi.append(hi)
                continue
            (llo, lhi), (rlo, rhi) = split_triangle_box(
                p0[i], p1[i], p2[i], axis, plane)
            llo = np.maximum(llo, lo)
            lhi = np.minimum(lhi, hi)
            rlo = np.maximum(rlo, lo)
            rhi = np.minimum(rhi, hi)
            lhi[axis] = min(lhi[axis], plane)
            rlo[axis] = max(rlo[axis], plane)
            if (lhi < llo).any() or (rhi < rlo).any():
                ref_ids.append(i)
                ref_lo.append(lo)
                ref_hi.append(hi)
                continue
            kl = (k - 1) // 2
            queue.append((llo, lhi, kl))
            queue.append((rlo, rhi, k - 1 - kl))
    return (np.asarray(ref_ids, np.int64), np.asarray(ref_lo),
            np.asarray(ref_hi))


def repair_bvh_leaves(bvh: FlatBvh, ref_ids: np.ndarray) -> FlatBvh:
    """Remap reference indices to primitive ids and dedup within each leaf.

    The repair pass of heuristic_primitive_splitter.hpp:139-151: after
    building over references, ``prim_indices`` entries are reference ids;
    map them through ``ref_ids`` and drop duplicates of the same primitive
    inside one leaf, compacting the array and leaf ranges.
    """
    new_indices: list[int] = []
    first_child = bvh.first_child.copy()
    prim_count = bvh.prim_count.copy()
    for node in range(bvh.node_count):
        if bvh.prim_count[node] == 0:
            continue
        a = int(bvh.first_child[node])
        ids = ref_ids[bvh.prim_indices[a:a + int(bvh.prim_count[node])]
                      .astype(np.int64)]
        uniq = list(dict.fromkeys(ids.tolist()))  # order-preserving dedup
        first_child[node] = len(new_indices)
        prim_count[node] = len(uniq)
        new_indices.extend(uniq)
    return FlatBvh(bounds=bvh.bounds.copy(), prim_count=prim_count,
                   first_child=first_child,
                   prim_indices=np.asarray(new_indices, np.uint32),
                   node_count=bvh.node_count)


def build_with_presplit(builder_fn, p0, p1, p2,
                        split_factor: float = 0.5, **builder_kw) -> FlatBvh:
    """Pre-split, build over references with any golden builder, repair.

    ``builder_fn`` is e.g. golden_builders.build_binned_sah — it receives
    reference boxes/centers; leaf indices are remapped back to primitive
    ids and deduped (so the result traverses like a plain-triangle BVH,
    with duplicates across — never within — leaves).
    """
    ref_ids, ref_lo, ref_hi = presplit_refs(p0, p1, p2, split_factor)
    centers = (ref_lo + ref_hi) * 0.5
    bvh = builder_fn(ref_lo, ref_hi, centers, **builder_kw)
    return repair_bvh_leaves(bvh, ref_ids)

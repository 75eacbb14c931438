"""SAH reinsertion optimizer, Meister & Bittner 2018 (counterpart of
``ceres_tpu/accel/reinsertion.py``: ``compute_parents``, ``_Opt``,
``optimize_reinsertion``).

A NumPy copy of the JAX package's host pass over a FlatBvh, move for move
the same (``tests/test_torch_builders.py``): the ``heapq`` order of the
search and the stable-argsort schedule decide the result. Candidates are
applied serially in the schedule's order (no locks needed: the winner of
a conflict is the move applied first).

Per candidate node n (it needs a parent p and a grandparent g):
  1. remove n: its sibling s is promoted into p's slot, the (n, s) pair
     slot is freed, ancestors refit;
  2. find the best reinsertion target x by branch and bound over direct
     plus induced SAH cost;
  3. rebuild the pair in the freed slot: x's content moves down beside n,
     x becomes their parent, ancestors refit.
A move is kept only when the SAH cost strictly falls. The schedule's
stride u runs 9 -> 1 over nodes ordered by area, and the pass repeats
until a round gains less than ``min_gain = 0.1`` of the root's area.
"""

from __future__ import annotations

import heapq

import numpy as np

from ceres_tpu_torch.accel.golden_builders import FlatBvh, _half_area

MIN_GAIN = 0.1  # termination threshold, in root-area units


def compute_parents(bvh: FlatBvh) -> np.ndarray:
    parent = np.full(bvh.node_count, -1, np.int64)
    inner = np.where(bvh.prim_count == 0)[0]
    c = bvh.first_child[inner].astype(np.int64)
    parent[c] = inner
    parent[c + 1] = inner
    return parent


class _Opt:
    def __init__(self, bvh: FlatBvh):
        self.lo = bvh.bounds[:, 0::2].astype(np.float64)
        self.hi = bvh.bounds[:, 1::2].astype(np.float64)
        self.prim_count = bvh.prim_count.astype(np.int64)
        self.first_child = bvh.first_child.astype(np.int64)
        self.parent = compute_parents(bvh)
        self.n = bvh.node_count

    # -- bookkeeping ---------------------------------------------------------

    def _adopt(self, slot):
        """Point ``slot``'s children (if inner) back at it."""
        if self.prim_count[slot] == 0:
            c = self.first_child[slot]
            self.parent[c] = slot
            self.parent[c + 1] = slot

    def _refit_up(self, node):
        while node >= 0:
            c = self.first_child[node]
            self.lo[node] = np.minimum(self.lo[c], self.lo[c + 1])
            self.hi[node] = np.maximum(self.hi[c], self.hi[c + 1])
            node = self.parent[node]

    def _copy_slot(self, dst, src):
        self.lo[dst] = self.lo[src]
        self.hi[dst] = self.hi[src]
        self.prim_count[dst] = self.prim_count[src]
        self.first_child[dst] = self.first_child[src]
        self._adopt(dst)

    def inner_area(self) -> float:
        inner = self.prim_count == 0
        return float(_half_area(self.lo[inner], self.hi[inner]).sum())

    # -- the reinsertion move --------------------------------------------------

    def try_reinsert(self, n) -> bool:
        p = self.parent[n]
        if p < 0:
            return False
        g = self.parent[p]
        if g < 0:
            return False  # needs a grandparent (reference :84-88)
        before = self.inner_area()
        c = self.first_child[p]
        s = c + 1 if n == c else c

        # Stash n and s; promote s into p; free the pair slot (c, c+1).
        stash = (self.lo[n].copy(), self.hi[n].copy(),
                 self.prim_count[n], self.first_child[n])
        self._copy_slot(p, s)
        self._refit_up(g)

        # Branch-and-bound search for the best target (excluding the freed
        # pair and n's own subtree — n's interior slots are still live).
        b_lo, b_hi = stash[0], stash[1]
        area_n = float(_half_area(b_lo, b_hi))
        bl0, bl1, bl2 = b_lo.tolist()
        bh0, bh1, bh2 = b_hi.tolist()
        lo, hi = self.lo, self.hi
        best_cost = np.inf
        best_x = -1
        heap = [(0.0, 0)]  # (induced cost, node)
        while heap:
            induced, x = heapq.heappop(heap)
            if induced + area_n >= best_cost:
                break  # lower bound: every remaining entry is worse
            # The freed pair slots are n's and s's old slots; n's interior
            # still parent-chains up to slot n, so skipping the pair slots
            # prunes n's whole subtree (no cycles possible) and s's old
            # slot (dead).
            if x == c or x == c + 1:
                continue
            # The union's and x's half areas in Python floats: the same
            # float64 operations as _half_area, NumPy's tie rules kept
            # (np.minimum/np.maximum return their second operand, and
            # np.maximum(d, 0.0) an empty extent's +0).
            l0, l1, l2 = lo[x].tolist()
            h0, h1, h2 = hi[x].tolist()
            d0 = (h0 if h0 > bh0 else bh0) - (l0 if l0 < bl0 else bl0)
            d1 = (h1 if h1 > bh1 else bh1) - (l1 if l1 < bl1 else bl1)
            d2 = (h2 if h2 > bh2 else bh2) - (l2 if l2 < bl2 else bl2)
            d0 = d0 if d0 > 0.0 else 0.0
            d1 = d1 if d1 > 0.0 else 0.0
            d2 = d2 if d2 > 0.0 else 0.0
            direct = d0 * (d1 + d2) + d1 * d2
            total = induced + direct
            if total < best_cost:
                best_cost = total
                best_x = x
            d0, d1, d2 = h0 - l0, h1 - l1, h2 - l2
            d0 = d0 if d0 > 0.0 else 0.0
            d1 = d1 if d1 > 0.0 else 0.0
            d2 = d2 if d2 > 0.0 else 0.0
            child_induced = induced + direct - (d0 * (d1 + d2) + d1 * d2)
            if self.prim_count[x] == 0 and child_induced + area_n < best_cost:
                cc = int(self.first_child[x])
                heapq.heappush(heap, (child_induced, cc))
                heapq.heappush(heap, (child_induced, cc + 1))

        def undo():
            self._copy_slot(s, p)  # demote the promoted sibling back
            self.lo[n], self.hi[n] = stash[0], stash[1]
            self.prim_count[n] = stash[2]
            self.first_child[n] = stash[3]
            self._adopt(n)
            self.prim_count[p] = 0
            self.first_child[p] = c
            self.parent[c] = p
            self.parent[c + 1] = p
            self._refit_up(p)

        if best_x < 0:
            undo()
            return False

        x = best_x
        # Build the new pair in the freed slots: x's content beside n's.
        self._copy_slot(c, x)
        self.lo[c + 1], self.hi[c + 1] = stash[0], stash[1]
        self.prim_count[c + 1] = stash[2]
        self.first_child[c + 1] = stash[3]
        self._adopt(c + 1)
        self.prim_count[x] = 0
        self.first_child[x] = c
        self.parent[c] = x
        self.parent[c + 1] = x
        self.lo[x] = np.minimum(self.lo[c], self.lo[c + 1])
        self.hi[x] = np.maximum(self.hi[c], self.hi[c + 1])
        self._refit_up(self.parent[x])

        if self.inner_area() >= before:
            # Not an improvement — roll back by reversing the insertion,
            # then undoing the removal, then deflating x's ancestor chain
            # (insertion refit grew it to include n's box).
            self._copy_slot(x, c)
            undo()
            self._refit_up(self.parent[x])
            return False
        return True

    def to_flat(self, prim_indices) -> FlatBvh:
        bounds = np.zeros((self.n, 6), np.float32)
        bounds[:, 0::2] = self.lo
        bounds[:, 1::2] = self.hi
        return FlatBvh(bounds=bounds,
                       prim_count=self.prim_count.astype(np.uint32),
                       first_child=self.first_child.astype(np.uint32),
                       prim_indices=prim_indices.copy(),
                       node_count=self.n)


def optimize_reinsertion(bvh: FlatBvh, max_rounds: int = 3,
                         min_gain: float = MIN_GAIN) -> FlatBvh:
    """Iteratively reinsert high-area nodes while SAH cost decreases.

    Candidate schedule mirrors the reference anneal (:200-207): stride u
    runs 9 -> 1 over nodes ordered by surface area; rounds repeat until the
    total inner-area gain of a round falls below ``min_gain`` (in root-area
    units) or ``max_rounds`` is hit.
    """
    opt = _Opt(bvh)
    root_area = float(_half_area(opt.lo[0], opt.hi[0]))
    for _ in range(max_rounds):
        start = opt.inner_area()
        for u in range(9, 0, -1):
            areas = _half_area(opt.lo, opt.hi)
            order = np.argsort(-areas, kind="stable")
            for n in order[::u]:
                if n == 0:
                    continue
                opt.try_reinsert(int(n))
        gain = (start - opt.inner_area()) / max(root_area, 1e-300)
        if gain <= min_gain:
            break
    return opt.to_flat(bvh.prim_indices)

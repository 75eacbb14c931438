"""The walk kernels' wrappers and their plain PyTorch versions.

The wrappers replace the variants of the JAX package's Pallas walk
(``ceres_tpu/ops/megakernel.py`` ``_make_walk_kernel`` via
``_walk_pallas``), one mode each:

  * ``walk_closest``: closest hit of rays from a common origin
    (``mode="closest"``); with ``window=True`` only hits with t in each
    ray's [tmin, tmax] count (``window=True`` there);
  * ``walk_any_dest``: occlusion of segments from a common origin
    (``mode="any_dest"``, the shadow wavefront cast from the sun);
  * ``walk_any``: occlusion of rays with their own origins, t >= 0 with
    no upper bound (``mode="any"``, the reference-exact shadow rays);

each flat or two-level (``S > 1``), with weights staged per visit or
streamed (``stream=True``). The kernels are CUDA C++ for sm_90a in
``csrc/walk.cu``: the streamed flat and the two-level forms walk each
tile on a thread-block cluster, the resident flat form on one CTA
(``walk_solo``); on 128-ray tiles every form is the split walk (ray
groups walk segments of a tile's key row apart, and a replay recounts
the visits: ``_split_walk_plain`` models it).
Each wrapper dispatches on the device of its tensors:

  * CPU tensors go to the plain version (the CPU tests run it);
  * CUDA tensors launch the kernel, or raise: there is no fallback.

The plain versions define the exact results. They use elementwise
products, never a matmul, in the kernel's operation order, so the kernel
matches them bit for bit on the card. Streaming changes where the
weights sit, not what is computed: one plain version serves both forms.

Inputs, for n_tiles tiles of R rays and n_c clusters of C = 128. R is
TILE = 512, or REGROUP_TILE = 128 for ``walk_any_dest`` (the shadow
wavefront regrouped by receiver, ``megakernel.any_hit_to_point(regroup=)``),
and is read off the inputs as ``rays.shape[1] // n_tiles``:
  counts (n_tiles,) int32   real candidates per tile;
  keys   (n_tiles, n_k) int32, ascending (``prepass._tile_candidate_keys``),
         n_k = n_c (flat) or n_s supers (two-level);
  rays   (rows, n_tiles * R) f32 ray rows (``RAY_ROWS``):
           closest, any_dest  [d.x, d.y, d.z, root-exit cap];
           closest + window   [d.xyz, cap, tmin, tmax];
           any                [d.xyz, (d x o).xyz, o.xyz, cap];
  w      (n_c [+ S], planes, 128) f32 weight planes, 10 for common-origin
         rays (``clusters.cluster_weights_common_origin``) and 16 for
         ``walk_any`` (``clusters.cluster_weights_generic``), zero-padded
         by S blocks for the two-level walk;
  occ0   (n_tiles * R,) int32 rays that start occluded (occlusion modes);
and for the two-level walk (``prepass._hier_setup``):
  hull   (n_tiles, 16) f32 per-tile hull scalars;
  bbox   (n_s, 8, S) f32 member boxes;
  first  (n_s,) int32 first fine block of each super.
Each returns (out (n_tiles * R,) int32, visits), with ``out`` the
packed winner slot id (cid * C + lane, -1 for a miss) or the occlusion
flag, and ``visits`` (n_tiles,) int32 each tile's executed block visits,
the traversal statistic.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_tpu_torch.accel.clusters import (_SUPER_MAX, CLUSTER_SIZE,
                                            GENERIC_PLANES, WEIGHT_PLANES)
from ceres_tpu_torch.ops.prepass import _BIG, _ULP_PAD, TILE, _cid_bits
from ceres_tpu_torch.utils import native, spans
from ceres_tpu_torch.utils.minmax import fmax, fmin

# The walk's early exit stays conservative only while this slack, in int
# ulps of the f32 pattern, dominates every way the carried t keys
# understate true distances: here the cleared low lane bits (127 ulp).
_PRUNE_PAD = 256
_DEST_EPS = 4e-6   # t-window margin for shadow rays at the receiving point

_IMASK = CLUSTER_SIZE - 1
# "No hit" sentinel whose low lane bits are zero, and its bits.
_BIG_CLEAN_I = int(np.float32(_BIG).view(np.int32) & ~np.int32(_IMASK))
_BIG_CLEAN = float(np.int32(_BIG_CLEAN_I).view(np.float32))
_NEG_I = int(np.float32(-1.0).view(np.int32))  # bits of -1.0: drops out of a max
_DEST_SCALE = float(np.float32(1.0 - _DEST_EPS))
_IMAX = 0x7FFFFFFF

# Per mode: ray rows, weight planes, and the row of the root-exit cap.
RAY_ROWS = {"closest": 4, "closest_window": 6, "any_dest": 4, "any": 10}
_PLANES = {"closest": WEIGHT_PLANES, "closest_window": WEIGHT_PLANES,
           "any_dest": WEIGHT_PLANES, "any": GENERIC_PLANES}
_TCAP_ROW = {"closest": 3, "closest_window": 3, "any_dest": 3, "any": 9}

REGROUP_TILE = 128  # rays per tile of the regrouped shadow wavefront
# Tile widths each mode's kernels take: the JAX package regroups only the
# any_dest wavefront.
TILES = {m: (TILE, REGROUP_TILE) if m == "any_dest" else (TILE,)
         for m in RAY_ROWS}

# Block visits a segment of the split walk (the kernels on REGROUP_TILE
# rays): 0 takes walk.cu's kSeg128; the card tests set a few to split
# small inputs.
_SPLIT_SEG = 0

# Tiles evaluated at once by the plain versions: bounds their
# (tiles, R, 128) temporaries to 32 MB each at R = 512, 8 MB at R = 128.
_PLAIN_CHUNK = 128


def _variant(mode: str, S: int, stream: bool, tile: int = TILE) -> str:
    return (f"walk_{mode}" + ("_hier" if S > 1 else "")
            + ("_stream" if stream else "")
            + ("" if tile == TILE else f"_t{tile}"))


# Kernel launches per variant since the last reset_launches(), the
# counter ``walk.launches`` of ``utils.spans``. Counted where a wrapper
# launches its kernel and nowhere else.
launches = spans.counter(
    "walk.launches", [_variant(m, S, st, tile) for m in RAY_ROWS
                      for tile in TILES[m] for S in (1, 2)
                      for st in (False, True)])


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def resident_clusters(mode: str, S: int, stream: bool,
                      device: torch.device, tile: int = TILE) -> int:
    """How many tiles of ``tile`` rays a walk has on ``device`` at once:
    thread-block clusters of a cluster walk (two-level, or streamed flat),
    or CTAs of the resident flat walk."""
    _check_tile(mode, tile)
    lib = native.load("walk")
    n = lib.ceres_walk_resident_clusters(list(RAY_ROWS).index(mode),
                                         int(S > 1), int(stream), tile,
                                         device.index)
    if n < 0:
        raise RuntimeError(f"{_variant(mode, S, stream, tile)}: "
                           f"{native.error_text(lib, -n)}")
    return n


def _check_tile(mode, tile):
    if tile not in TILES[mode]:
        raise ValueError(f"walk_{mode}: tiles of {tile} rays; the kernels "
                         f"take {' or '.join(map(str, TILES[mode]))}")


def _tile_of(keys, rays):
    """The tile width R of a walk's inputs: rays.shape[1] // n_tiles."""
    n_tiles = keys.shape[0]
    if n_tiles == 0:
        raise ValueError("no ray tiles")
    return rays.shape[1] // n_tiles


def _inputs(mode, counts, keys, rays, w, occ0, hull, bbox, first, S):
    """A walk's input rows for ``native.check``, each with the dtype and
    shape it must have, after the checks that are the walk's alone."""
    n_tiles, n_k = keys.shape
    tile = _tile_of(keys, rays)
    _check_tile(mode, tile)
    if S > 1:
        if not 2 <= S <= _SUPER_MAX:
            raise ValueError(f"S = {S}: a super holds 2..{_SUPER_MAX} blocks")
        if hull is None or bbox is None or first is None:
            raise ValueError("the two-level walk needs hull, bbox and first")
    elif hull is not None or bbox is not None or first is not None:
        raise ValueError("hull, bbox and first belong to the two-level "
                         "walk (S > 1)")
    if w.data_ptr() % 16:
        raise ValueError("w must be 16-byte aligned (cp.async copies)")
    i32, f32 = torch.int32, torch.float32
    return [("counts", counts, i32, (n_tiles,)),
            ("keys", keys, i32, (n_tiles, n_k)),
            ("rays", rays, f32, (RAY_ROWS[mode], n_tiles * tile)),
            ("w", w, f32, (n_k if S == 1 else w.shape[0], _PLANES[mode],
                           CLUSTER_SIZE)),
            ("occ0", occ0, i32, (n_tiles * tile,)),
            ("hull", hull, f32, (n_tiles, 16)),
            ("bbox", bbox, f32, (n_k, 8, S)),
            ("first", first, i32, (n_k,))]


def _run(mode, counts, keys, rays, w, occ0, hull, bbox, first, S, stream):
    """Check a walk's inputs, then run its plain version on CPU tensors
    or launch its kernel: (out, visits)."""
    tensors = _inputs(mode, counts, keys, rays, w, occ0, hull, bbox, first, S)
    cpu = rays.device.type == "cpu"
    if cpu:   # on the card, the launcher checks them
        native.check("walk", tensors)
    with spans.span("walk"):
        if not cpu:
            return _launch(mode, tensors, keys, rays, S, stream)
        if mode in ("any_dest", "any"):
            return _occlusion_plain(mode, counts, keys, rays, w, occ0, hull,
                                    bbox, first, S)[:2]
        return _walk_closest_plain(counts, keys, rays, w, hull, bbox, first,
                                   S=S, window=mode == "closest_window")


def _launch(mode, tensors, keys, rays, S, stream):
    if rays.device.type != "cuda":
        raise ValueError(f"walk_{mode}: no kernel for device {rays.device}")
    n_tiles, n_k = keys.shape
    tile = _tile_of(keys, rays)
    out = torch.empty(n_tiles * tile, dtype=torch.int32, device=rays.device)
    visits = torch.empty(n_tiles, dtype=torch.int32, device=rays.device)
    # The split walk's scratch (128-ray tiles): a counter, each ray's
    # first occluding position, and the tiles with later segments, their
    # units and offsets.
    n_scratch = 2 + (tile + 3) * n_tiles
    scratch = None if tile == TILE else torch.empty(
        n_scratch, dtype=torch.int32, device=rays.device)
    native.launch(
        "walk", "ceres_walk",
        [*tensors, ("out", out, torch.int32, out.shape),
         ("visits", visits, torch.int32, visits.shape),
         ("scratch", scratch, torch.int32, (n_scratch,))],
        [list(RAY_ROWS).index(mode), tile, int(stream), n_tiles, n_k,
         (1 << _cid_bits(n_k)) - 1, S, _SPLIT_SEG],
        launches, _variant(mode, S, stream, tile))
    return out, visits


def walk_closest(counts, keys, rays, w, hull=None, bbox=None, first=None, *,
                 S=1, stream=False, window=False):
    """Closest hit per ray: (packed slot ids, visits). ``window=True``:
    ``rays`` carries tmin and tmax rows, and a hit counts only with t in
    [tmin, tmax]."""
    return _run("closest_window" if window else "closest", counts, keys,
                rays, w, None, hull, bbox, first, S, stream)


def walk_any_dest(counts, keys, rays, w, occ0, hull=None, bbox=None,
                  first=None, *, S=1, stream=False):
    """Occlusion of each segment from the common origin (t = 0) to its
    receiving point (t = 1): (flags, visits)."""
    return _run("any_dest", counts, keys, rays, w, occ0, hull, bbox, first,
                S, stream)


def walk_any(counts, keys, rays, w, occ0, hull=None, bbox=None, first=None,
             *, S=1, stream=False):
    """Occlusion of rays with their own origins: any triangle at t >= 0,
    however far (flags, visits)."""
    return _run("any", counts, keys, rays, w, occ0, hull, bbox, first, S,
                stream)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _numerators(r, wj):
    """Möller-Trumbore terms of every (ray, triangle) pair.

    r: (rows, t, R) ray rows; wj: (t, planes, C) weight planes, 10
    (common origin: r = [d, ...]) or 16 (generic: r = [d, d x o, o, ...]).
    Returns (uvw, nd, nt, s) broadcastable to (t, R, C), in the kernel's
    operation order: uvw = min(u, v, det - u - v) * sign(det), the
    barycentric sign test, and nt the t numerator."""
    dx, dy, dz = (r[a][:, :, None] for a in range(3))
    p = [wj[:, i, None, :] for i in range(wj.shape[1])]
    nu = dx * p[0] + dy * p[1] + dz * p[2]
    nv = dx * p[3] + dy * p[4] + dz * p[5]
    nd = dx * p[6] + dy * p[7] + dz * p[8]
    nt = p[9]
    if len(p) == GENERIC_PLANES:
        cx, cy, cz, ox, oy, oz = (r[a][:, :, None] for a in range(3, 9))
        nu = nu - (cx * p[10] + cy * p[11] + cz * p[12])
        nv = nv - (cx * p[13] + cy * p[14] + cz * p[15])
        nt = nt - (ox * p[6] + oy * p[7] + oz * p[8])
    s = torch.where(nd >= 0, 1.0, -1.0)
    uvw = torch.minimum(torch.minimum(nu * s, nv * s), (nd - nu - nv) * s)
    return uvw, nd, nt, s


def _pair_keys(r, wj, window=False):
    """Winner keys of every (ray, triangle) pair of a closest visit,
    (t, R, C) int32: the t bits with the lane bits cleared | the lane, or
    _BIG_CLEAN's bits | the lane for a miss (with ``window``, also a t
    outside the ray's [tmin, tmax], rows 4 and 5 of r). The key min over
    the lanes is the visit's closest hit, ties to the lower lane."""
    uvw, nd, nt, s = _numerators(r, wj)
    ok = (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
    t = torch.where(ok, nt * torch.reciprocal(nd), _BIG_CLEAN)
    if window:
        tmin, tmax = r[4][:, :, None], r[5][:, :, None]
        t = torch.where((t >= tmin) & (t <= tmax), t, _BIG_CLEAN)
    lane = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=wj.device)
    return (t.view(torch.int32) & ~_IMASK) | lane


def _pair_hits(r, wj, mode):
    """Occluding (ray, triangle) pairs of a shadow visit, (t, R, C) bool:
    mode ``any_dest`` between the origin and the receiver, ``any`` at
    t >= 0."""
    uvw, nd, nt, s = _numerators(r, wj)
    if mode == "any":
        return (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
    win = ((nt - _DEST_SCALE * nd) * s <= 0) & (nt * s >= 0)
    return (uvw >= 0) & (nd != 0) & win


def _member_entries(hull, bb):
    """Int-key entry bounds of each tile's hull against its super's S
    member boxes (the kernel's member_entry, vectorised).

    hull: (t, 16) hull rows; bb: (t, 8, S) member boxes. Returns (t, S)
    int32: the slab entry bits, or the bits of _BIG where culled."""
    tn = tf = None
    for a in range(3):
        la = bb[:, a] - hull[:, 12 + a, None]
        ha = bb[:, 3 + a] - hull[:, 9 + a, None]
        ia, ib = hull[:, a, None], hull[:, 3 + a, None]
        c0, c1, c2, c3 = la * ia, la * ib, ha * ia, ha * ib
        emin = fmin(fmin(c0, c1), fmin(c2, c3))
        emax = fmax(fmax(c0, c1), fmax(c2, c3))
        wide = hull[:, 6 + a, None] > 0
        emin = torch.where(wide, -_BIG, emin)
        emax = torch.where(wide, _BIG, emax)
        tn = emin if tn is None else fmax(tn, emin)
        tf = emax if tf is None else fmin(tf, emax)
    tn = fmax(tn, torch.zeros_like(tn))
    ok = ((tn * (1.0 - _ULP_PAD) <= tf.clamp(max=_BIG) * (1.0 + _ULP_PAD))
          & (bb[:, 6] == 0))
    return torch.where(ok, tn, _BIG).view(torch.int32)


def _walk(counts, keys, rays, tcap_row, state, prune_of, visit, hier=None):
    """The per-tile walk, vectorised over tiles.

    Tiles step k in lockstep; a tile runs candidate k while k < count and
    its k-th entry bound (id bits masked) is within its prune, and once it
    stops it stays done, exactly the kernel's loop. Flat walk: candidate k
    is one block. Two-level walk (``hier`` = (hull, bbox, first, S)):
    candidate k is a super, whose live members the tile visits smallest
    entry first (ties to the lowest slot) while that entry is within its
    live prune; tiles take member steps in lockstep too, and a tile whose
    next entry exceeds its prune stays stopped, since neither changes.
    ``state`` is a tuple of (n_tiles, R) tensors, updated in place;
    ``prune_of(tcap, *state)`` is the per-tile prune and ``visit(bid, r,
    *state)`` the new state of the visiting tiles, given their ray rows
    r (rows, t, R). Returns the executed block visits per tile
    ((n_tiles,) int32).
    """
    n_tiles, n_k = keys.shape
    cmask = (1 << _cid_bits(n_k)) - 1
    r = rays.reshape(rays.shape[0], n_tiles, -1)
    tcap = rays[tcap_row].view(torch.int32).reshape(n_tiles, -1)
    prune = prune_of(tcap, *state)
    done = torch.zeros(n_tiles, dtype=torch.bool, device=keys.device)
    visits = torch.zeros(n_tiles, dtype=torch.int32, device=keys.device)

    def visit_blocks(tiles, bid):
        visits[tiles] += 1
        for ch, b in zip(tiles.split(_PLAIN_CHUNK), bid.split(_PLAIN_CHUNK)):
            new = visit(b, r[:, ch], *(x[ch] for x in state))
            for x, y in zip(state, new):
                x[ch] = y
            prune[ch] = prune_of(tcap[ch], *new)

    for k in range(int(counts.max())):
        key_k = keys[:, k]
        run = ~done & (k < counts) & ((key_k & ~cmask) <= prune)
        done |= ~run
        tiles = run.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        cand = key_k[tiles] & cmask
        if hier is None:
            visit_blocks(tiles, cand)
            continue
        hull, bbox, first, S = hier
        sid = cand.long()
        ent = _member_entries(hull[tiles], bbox[sid])            # (t, S)
        live = torch.ones_like(ent, dtype=torch.bool)
        slot = torch.arange(S, dtype=torch.int32, device=keys.device)
        while True:
            masked = torch.where(live, ent, _IMAX)
            m = masked.amin(dim=1)
            go = m <= prune[tiles]
            if not bool(go.any()):
                break
            s = torch.where(masked == m[:, None], slot, _IMAX).amin(dim=1)
            rows = go.nonzero().squeeze(1)
            live[rows, s[rows].long()] = False
            visit_blocks(tiles[rows], first[sid[rows]] + s[rows])
    return visits


def _hier(hull, bbox, first, S):
    return None if S == 1 else (hull, bbox, first, S)


def _walk_closest_plain(counts, keys, rays, w, hull=None, bbox=None,
                        first=None, *, S=1, stream=False, window=False):
    """Plain version of the closest kernels: per ray the best t key, ties
    to the lower lane and the earlier visit; with the window, pairs with
    t outside [tmin, tmax] count as misses. ``stream`` is accepted, so a
    wrapper's arguments fit, and ignored: it moves no result."""
    del stream
    mode = "closest_window" if window else "closest"
    best = torch.full((keys.shape[0], _tile_of(keys, rays)), _BIG_CLEAN_I,
                      dtype=torch.int32, device=keys.device)
    pid = torch.full_like(best, -1)

    def prune_of(tcap, best, pid):
        return torch.minimum(best, tcap).amax(dim=1) + _PRUNE_PAD

    def visit(bid, r, best, pid):
        kmin = _pair_keys(r, w[bid.long()], window).amin(dim=2)
        t_new = kmin & ~_IMASK
        better = t_new < best
        return (torch.where(better, t_new, best),
                torch.where(better, bid[:, None] * CLUSTER_SIZE
                            + (kmin & _IMASK), pid))

    visits = _walk(counts, keys, rays, _TCAP_ROW[mode], (best, pid),
                   prune_of, visit, _hier(hull, bbox, first, S))
    return pid.reshape(-1), visits


def _walk_any_dest_plain(counts, keys, rays, w, occ0, hull=None, bbox=None,
                         first=None, *, S=1, stream=False):
    """Plain version of the common-origin shadow kernels: per ray, any
    occluder between the origin (t = 0) and the receiver (t = 1 -
    _DEST_EPS). ``stream`` is ignored, as in ``_walk_closest_plain``."""
    del stream
    return _occlusion_plain("any_dest", counts, keys, rays, w, occ0, hull,
                            bbox, first, S)[:2]


def _walk_any_plain(counts, keys, rays, w, occ0, hull=None, bbox=None,
                    first=None, *, S=1, stream=False):
    """Plain version of the generic-origin shadow kernels: per ray, any
    triangle at t >= 0 from its own origin, with no upper bound.
    ``stream`` is ignored, as in ``_walk_closest_plain``."""
    del stream
    return _occlusion_plain("any", counts, keys, rays, w, occ0, hull, bbox,
                            first, S)[:2]


def _occlusion_plain(mode, counts, keys, rays, w, occ0, hull, bbox, first,
                     S):
    """The occlusion walk of ``mode`` (any_dest or any): (flags, visits
    per tile, pairs), with ``pairs`` (0-dim int64) the ray-triangle pairs
    the walk had to test: in each visit, for each ray not yet occluded,
    the lanes up to its first occluder, or all C. The kernels skip the
    other pairs, so their bound counts these."""
    occ = occ0.reshape(keys.shape[0], -1).clone()
    tested = torch.zeros(occ.shape, dtype=torch.int64, device=occ.device)

    def prune_of(tcap, occ, tested):
        return torch.where(occ > 0, _NEG_I, tcap).amax(dim=1) + _PRUNE_PAD

    def visit(bid, r, occ, tested):
        hits = _pair_hits(r, w[bid.long()], mode)
        hit = hits.any(dim=2)
        upto = torch.where(hit, hits.to(torch.uint8).argmax(dim=2) + 1,
                           CLUSTER_SIZE)
        return (occ | hit.to(torch.int32),
                tested + torch.where(occ == 0, upto, 0))

    visits = _walk(counts, keys, rays, _TCAP_ROW[mode], (occ, tested),
                   prune_of, visit, _hier(hull, bbox, first, S))
    return occ.reshape(-1), visits, tested.sum()


def _split_walk_plain(counts, keys, rays, w, occ0, hull=None, bbox=None,
                      first=None, *, S=1, seg=256, groups=8):
    """The split walk's schedule (``walk.cu``'s split_walk, split_list,
    split_more and split_replay: the any_dest kernels on 128-ray tiles),
    in plain PyTorch: (flags, visits), which must equal
    ``_walk_any_dest_plain``'s.

    A unit is a set of R / ``groups`` of a tile's rays over one segment of
    its key row: ``seg`` candidates (two-level: ``seg // S`` supers, at
    least one). It visits the segment's blocks in order while their
    entry is within the unit's own prune (its live rays' caps +
    _PRUNE_PAD), and notes each ray's first occluding position (flat: the
    candidate's index; two-level: _SUPER_MAX x the super's index + the
    member's rank in entry order). The first segment runs on the tile's
    ray groups (rays in order). A tile with candidates past it, rays no
    unit has found occluded and the next candidate within their prune
    runs each later segment on those rays, R / ``groups`` a unit in ray
    order, each unit starting with the rays that no earlier segment has
    found occluded. Then each tile's sequential walk is replayed from the
    positions: before position q its live rays are those whose first
    occluder is at q or later."""
    n_tiles, n_k = keys.shape
    R = _tile_of(keys, rays)
    cmask = (1 << _cid_bits(n_k)) - 1
    step = _SUPER_MAX if S > 1 else 1
    if S > 1:
        seg = max(1, seg // S)
    r = rays.reshape(rays.shape[0], n_tiles, R)
    tcap = rays[_TCAP_ROW["any_dest"]].view(torch.int32).reshape(n_tiles, R)
    occ = occ0.reshape(n_tiles, R)
    pstar = torch.full((n_tiles, R), _IMAX, dtype=torch.int32)
    size = R // groups

    def ranked(tile, cid):
        """The blocks of super cid in entry order, with their entries."""
        ent = _member_entries(hull[tile:tile + 1], bbox[cid:cid + 1])[0]
        order = sorted(range(S), key=lambda s: (int(ent[s]), s))
        return [(int(first[cid]) + s, int(ent[s])) for s in order]

    def unit(tile, ids, k0, k1, opening):
        live = occ[tile, ids] == 0
        if not opening:
            live &= pstar[tile, ids] >= k0 * step
        found = torch.full((len(ids),), _IMAX, dtype=torch.int32)
        rg, cap = r[:, tile:tile + 1, ids], tcap[tile, ids]

        def prune():
            return int(torch.where(live, cap, _NEG_I).max()) + _PRUNE_PAD

        p = prune()
        for k in range(k0, k1):
            key = int(keys[tile, k])
            if key & ~cmask > p:
                break
            blocks = ([(key & cmask, key & ~cmask)] if S == 1
                      else ranked(tile, key & cmask))
            for j, (blk, entry) in enumerate(blocks):
                if entry > p:
                    break
                hit = _pair_hits(rg, w[blk][None], "any_dest").any(dim=2)[0]
                found[hit & live] = k * step + j
                live &= ~hit
                p = prune()
        pstar[tile, ids] = (found if opening
                            else torch.minimum(pstar[tile, ids], found))

    for tile in range(n_tiles):
        for grp in range(groups):
            unit(tile, torch.arange(grp * size, (grp + 1) * size), 0,
                 min(int(counts[tile]), seg), True)
    for tile in range(n_tiles):
        count = int(counts[tile])
        live = ((occ[tile] == 0) & (pstar[tile] == _IMAX)).nonzero()[:, 0]
        if (count <= seg or live.numel() == 0
                or int(keys[tile, seg]) & ~cmask
                > int(tcap[tile, live].max()) + _PRUNE_PAD):
            continue
        for k0 in range(seg, count, seg):
            for ids in live.split(size):
                unit(tile, ids, k0, min(count, k0 + seg), False)

    visits = torch.zeros(n_tiles, dtype=torch.int32)
    for tile in range(n_tiles):
        at = torch.where(occ[tile] != 0, -1, pstar[tile])

        def prune_at(q):
            return (int(torch.where(at >= q, tcap[tile], _NEG_I).max())
                    + _PRUNE_PAD)

        n = 0
        while (n < int(counts[tile])
               and int(keys[tile, n]) & ~cmask <= prune_at(n * step)):
            n += 1
        if S == 1:
            visits[tile] = n
            continue
        for k in range(n):
            for j, (_, entry) in enumerate(
                    ranked(tile, int(keys[tile, k]) & cmask)):
                if entry > prune_at(k * step + j):
                    break
                visits[tile] += 1
    return (occ | (pstar != _IMAX).to(torch.int32)).reshape(-1), visits

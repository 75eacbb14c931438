"""Interval-culling prepass in torch (counterpart of
``ceres_tpu/ops/megakernel.py`` ``_safe_inverse``, ``_interval_entry``,
``_hull``, ``_cid_bits``, ``_tile_candidate_keys``, ``_ray_tcap``,
``_scene_root``, ``_pad_rays``).

Rays arrive in spatially coherent tiles of TILE = 512. Each tile is
summarised by the interval hull of its ray directions, and every
(tile, cluster) pair is culled with one conservative slab test: O(tiles
x clusters), no ray dimension. Survivors are packed into one int32 key
per pair, (entry-bound f32 bits with the low cid bits cleared) | cluster
id, and sorted ascending per tile. The bit pattern of a non-negative f32
orders like the float, so the sort is front to back.

Keys and counts are bit-identical to the JAX package's: every step is
one IEEE f32 operation in the same order, with no sums that a compiler
could contract. Common-origin wavefronts pre-shift the boxes by their
origin; generic-origin rays (``any_hit``) also carry a per-tile origin
hull, which widens each box by the spread of the tile's origins.

Also here: which walk variant a scene takes (flat or two-level, weights
resident or streamed, by the JAX package's rules) and the two-level
walk's inputs (``_super_members``, ``_tile_hulls``, ``_hier_setup``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ceres_tpu_torch.accel.clusters import CLUSTER_SIZE, _super_slots
from ceres_tpu_torch.utils import minmax
from ceres_tpu_torch.utils.minmax import fmax as _fmax
from ceres_tpu_torch.utils.minmax import fmin as _fmin

TILE = 512           # rays per walk tile (one 16 x 32 pixel block)

_BIG = 3.0e37        # "no hit" sentinel, finite to keep slab math NaN-free
_VALID_CUT = 1.0e37  # entries >= this are padding, never real candidates
_INV_CLAMP = 1e30
_ULP_PAD = 4e-6      # conservative slab widening: never cull a true hit


def _safe_inverse(d: torch.Tensor) -> torch.Tensor:
    """Sign-preserving epsilon-clamped 1/d."""
    sign = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
    return torch.where(d.abs() < 1e-30, sign * _INV_CLAMP, 1.0 / d)


def _interval_entry(lo, hi, dlo, dhi, olo=None, ohi=None):
    """Conservative slab test of each tile's ray hull against the cluster
    boxes.

    lo, hi: (N_c, 3); dlo, dhi: (n_t, 3) direction hulls; olo, ohi: (n_t,
    3) origin hulls, or None for rays from a common origin at 0 (boxes
    pre-shifted). Returns (n_t, N_c) f32: a lower bound of any member
    ray's slab entry distance where overlap is possible, _BIG where no
    member ray can overlap. Axes whose direction interval straddles zero
    do not restrict. An origin hull folds into the box: box - [olo, ohi]
    is a wider box.
    """
    empty = (hi < lo).any(dim=-1)[None, :]           # (1, N_c)
    tn = tf = None
    for a in range(3):
        la = lo[None, :, a]                          # (1, N_c)
        ha = hi[None, :, a]
        if olo is not None:
            la = la - ohi[:, a:a + 1]                # (n_t, N_c)
            ha = ha - olo[:, a:a + 1]
        ia = _safe_inverse(dlo[:, a:a + 1])          # (n_t, 1)
        ib = _safe_inverse(dhi[:, a:a + 1])
        c0, c1, c2, c3 = la * ia, la * ib, ha * ia, ha * ib
        emin = _fmin(_fmin(c0, c1), _fmin(c2, c3))
        emax = _fmax(_fmax(c0, c1), _fmax(c2, c3))
        straddle = (dlo[:, a:a + 1] < 0) & (dhi[:, a:a + 1] > 0)
        emin = torch.where(straddle, -_BIG, emin)
        emax = torch.where(straddle, _BIG, emax)
        tn = emin if tn is None else _fmax(tn, emin)
        tf = emax if tf is None else _fmin(tf, emax)
    tn = _fmax(tn, torch.zeros_like(tn))
    hit = tn * (1.0 - _ULP_PAD) <= tf.clamp(max=_BIG) * (1.0 + _ULP_PAD)
    return torch.where(hit & ~empty, tn, _BIG)


def _hull(cols, alive):
    """3-tuple of (n_t, R) ray columns -> per-tile (lo, hi) hulls (n_t, 3)
    over the alive rays."""
    los = [torch.where(alive, x, _BIG).amin(dim=1) for x in cols]
    his = [torch.where(alive, x, -_BIG).amax(dim=1) for x in cols]
    return torch.stack(los, dim=-1), torch.stack(his, dim=-1)


def _cid_bits(n_c: int) -> int:
    """Low-bit width reserved for a cluster id in a packed candidate key."""
    return max(1, (n_c - 1).bit_length())


def _tile_candidate_keys(lo, hi, dirs_tiled, origins_tiled=None, alive=None):
    """Per-tile candidate keys, sorted front to back, as one int32 tensor.

    dirs_tiled: 3-tuple of (n_tiles, R) direction columns (origins_tiled
    likewise, None for a common origin at 0). Clearing the
    low cid bits of the entry bound only lowers it, so a key stays a
    conservative lower bound of any member ray's hit distance. Returns
    (keys (n_tiles, N_c) int32 ascending, counts (n_tiles,) int32 of real
    candidates).
    """
    if alive is None:
        alive = (dirs_tiled[0] * dirs_tiled[0] + dirs_tiled[1] * dirs_tiled[1]
                 + dirs_tiled[2] * dirs_tiled[2]) > 0.0
    dlo, dhi = _hull(dirs_tiled, alive)
    if origins_tiled is None:
        tn = _interval_entry(lo, hi, dlo, dhi)
    else:
        tn = _interval_entry(lo, hi, dlo, dhi, *_hull(origins_tiled, alive))
    # Tiles with no alive rays (all padding or all skipped) get nothing.
    tn = torch.where(alive.any(dim=1)[:, None], tn, _BIG)
    counts = (tn < _VALID_CUT).sum(dim=1, dtype=torch.int32)
    n_c = tn.shape[1]
    cmask = (1 << _cid_bits(n_c)) - 1
    cid = torch.arange(n_c, dtype=torch.int32, device=tn.device)[None, :]
    keys = (tn.view(torch.int32) & ~cmask) | cid
    return torch.sort(keys, dim=1).values, counts


def _ray_tcap(root_lo, root_hi, dir_cols, origin_cols=None):
    """Per-ray visit cap: exit distance from the scene's root AABB, for
    rays from ``origin_cols`` (None: a common origin at 0, root box
    pre-shifted).

    Every cluster box lies inside the root box, so a ray that found no
    hit is done once the walk passes its root exit. Rays that miss the
    root (or are padding) get -1 and never extend the walk.
    """
    tn = tf = alive = None
    for a in range(3):
        d = dir_cols[a]
        inv = _safe_inverse(d)
        if origin_cols is None:
            t0 = root_lo[a] * inv
            t1 = root_hi[a] * inv
        else:
            t0 = (root_lo[a] - origin_cols[a]) * inv
            t1 = (root_hi[a] - origin_cols[a]) * inv
        near = _fmin(t0, t1)
        far = _fmax(t0, t1)
        tn = near if tn is None else _fmax(tn, near)
        tf = far if tf is None else _fmin(tf, far)
        sq = d * d
        alive = sq if alive is None else alive + sq
    tn = _fmax(tn, torch.zeros_like(tn))
    hit = (tn * (1.0 - _ULP_PAD) <= tf * (1.0 + _ULP_PAD)) & (alive > 0.0)
    return torch.where(hit, tf * (1.0 + _ULP_PAD), -1.0)


def _scene_root(cs):
    """Root AABB over the non-empty cluster boxes."""
    nonempty = (cs.hi >= cs.lo).all(dim=-1, keepdim=True)
    root_lo = torch.where(nonempty, cs.lo, _BIG).amin(dim=0)
    root_hi = torch.where(nonempty, cs.hi, -_BIG).amax(dim=0)
    return root_lo, root_hi


def _pad_rays(x: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """(R,) -> (R_pad,) zero-padded to a multiple of ``tile``."""
    return F.pad(x, (0, (-x.shape[0]) % tile))


# ---------------------------------------------------------------------------
# Walk variant choice and the two-level walk's super inputs
# ---------------------------------------------------------------------------

# Above this many blocks the walk goes two-level: the prepass and its sort
# run over supers of up to S blocks, and the kernel gates each member with
# an in-kernel slab test. The JAX package's threshold, kept so the same
# scenes take the same variant; the card's own flat-vs-two-level times
# may move it (ROADMAP open question).
_HIER_MIN_CLUSTERS = 12288

# The JAX package keeps weights resident while its packed layout fits
# 8 MiB, and streams them beyond. That layout is (blocks, 8, 4C) f32 =
# 16 KiB a block for common-origin rays and (blocks, 16, 4C) = 32 KiB
# for generic rays, so generic walks stream above 256 blocks and
# common-origin walks above 512. The port applies the same rule to its
# block count.
_RESIDENT_W_BYTES = 8 << 20
COMMON_ROWS = 8      # packed feature rows [d, 1], padded to 8
GENERIC_ROWS = 16    # packed feature rows [d, d x o, o, 1], padded to 16


def _use_stream(n_blocks: int, packed_rows: int = COMMON_ROWS) -> bool:
    """Stream the weights of a walk over ``n_blocks`` blocks (padding
    included) whose JAX packed layout has ``packed_rows`` feature rows?"""
    return n_blocks * packed_rows * 4 * CLUSTER_SIZE * 4 > _RESIDENT_W_BYTES


def _super_factor(n_c: int) -> int:
    """Blocks per super: 1 = flat walk; else _super_slots."""
    if n_c <= _HIER_MIN_CLUSTERS:
        return 1
    return _super_slots(n_c)


def _super_members(lo, hi, first, S):
    """Super-level inputs from a first-member table.

    ``lo``/``hi`` are the (N_c, 3) fine boxes, already shifted into the
    walk's frame; super j's members are the fine ids [first[j],
    first[j + 1]), at most S. Returns the (n_s, 3) union boxes (super_lo,
    super_hi) for the prepass, empty-aware, and the (n_s, 8, S) member-box
    tensor the kernel gates with: rows 0-2 lo.xyz, 3-5 hi.xyz, 6 the empty
    flag, 7 zero.
    """
    n_c = lo.shape[0]
    n_s = first.shape[0]
    member = first[:, None] + torch.arange(S, dtype=torch.int32,
                                           device=first.device)[None, :]
    nxt = torch.cat([first[1:], first.new_full((1,), n_c)])
    valid = (member < nxt[:, None]) & (member < n_c)
    midx = member.clamp(0, n_c - 1).long()
    mlo = lo[midx]                                       # (n_s, S, 3)
    mhi = hi[midx]
    empty = (mhi < mlo).any(dim=-1) | ~valid             # (n_s, S)
    super_lo = minmax.amin(torch.where(empty[..., None], _BIG, mlo), 1)
    super_hi = minmax.amax(torch.where(empty[..., None], -_BIG, mhi), 1)
    bbox = torch.cat([mlo.transpose(1, 2), mhi.transpose(1, 2),
                      empty[:, None, :].to(lo.dtype),
                      lo.new_zeros((n_s, 1, S))], dim=1)
    return super_lo, super_hi, bbox.contiguous()


def _tile_hulls(dirs_tiled, alive, origins_tiled=None):
    """(n_tiles, 16) per-tile hull scalars for the in-kernel member gate:
    [1/dlo.xyz, 1/dhi.xyz, straddle.xyz, olo.xyz, ohi.xyz, 0], the
    precomputed pieces of the _interval_entry test. Common-origin
    wavefronts (``origins_tiled`` None) have a zero origin hull (their
    boxes are pre-shifted)."""
    dlo, dhi = _hull(dirs_tiled, alive)
    st = ((dlo < 0) & (dhi > 0)).to(dlo.dtype)
    zero = torch.zeros_like(dlo)
    olo, ohi = ((zero, zero) if origins_tiled is None
                else _hull(origins_tiled, alive))
    return torch.cat([_safe_inverse(dlo), _safe_inverse(dhi), st, olo, ohi,
                      zero[:, :1]], dim=-1).contiguous()


def _hier_setup(lo, hi, dirs_tiled, alive, w, cs=None, origins_tiled=None):
    """Choose the flat or the two-level walk and build its inputs.

    Returns (S, hull, bbox, first, cull_lo, cull_hi, w). For S == 1 the
    inputs pass through (flat walk). For S > 1 the prepass boxes become
    the super unions, ``w`` gets S zero blocks (the kernel reads members
    as first + s), and the kernel gets the hull table, the member boxes
    and the first-member table. Supers come from the ClusterSet's tree
    cut when it has one, else uniform S-runs of consecutive blocks.
    ``origins_tiled`` (generic rays) fills the hulls' origin columns.
    """
    n_c = lo.shape[0]
    S = _super_factor(n_c)
    if S == 1:
        return 1, None, None, None, lo, hi, w
    if cs is not None and cs.super_first is not None and cs.super_S > 1:
        S = cs.super_S
        first = cs.super_first
    else:
        n_s = -(-n_c // S)
        first = torch.clamp(torch.arange(n_s, dtype=torch.int32,
                                         device=lo.device) * S, max=n_c)
    super_lo, super_hi, bbox = _super_members(lo, hi, first, S)
    hull = _tile_hulls(dirs_tiled, alive, origins_tiled)
    # Member reads run to first + S - 1 <= n_c + S - 1: zero blocks
    # (rejected by Möller-Trumbore, and gated off anyway).
    w = F.pad(w, (0, 0, 0, 0, 0, S))
    return S, hull, bbox, first.contiguous(), super_lo, super_hi, w

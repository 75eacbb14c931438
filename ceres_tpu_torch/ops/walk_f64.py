"""All-float64 cluster walk (counterpart of
``ceres_tpu/ops/walk_f64.py``: ``_prepass``, ``_walk``,
``closest_search_f64``, ``any_hit_f64``, ``any_hit_to_point_f64``).

The accelerated float64 path searches in float32 (``megakernel._detach_f32``)
and recomputes every observed value in float64 at the winners, so its
winner itself can be wrong where sheets lie closer than float32
resolution or coordinates span more than 2^24. This module searches in
float64 throughout, in the two phases of the walk kernels: the interval
prepass (``ops.prepass``, run in float64) sorts each tile's candidate
clusters by entry bound, then each tile walks its own list front to
back, one candidate a visit (a batched float64 Möller-Trumbore of its
rays against the cluster's triangles), while the next entry bound is at
most the tile's prune, the maximum over its rays of min(best t, root
exit). No prune pad: nothing here understates t.

The prepass also has two forms, chosen the same way: on the card one
kernel a call (``prepass_f64_kernel`` in ``csrc/walk_f64.cu``: per tile
the slab test of every cluster box, the survivors compacted and sorted
in one CTA; counted in ``prepass_f64.launches``), elsewhere the plain
whole-tensor passes and stable argsort (``_prepass_plain``), which the
card tests hold the kernel to on the same card tensors. Rows up to each
tile's count are bit-equal; past it the kernel writes ``_BIG`` and the
other clusters' ids, which nothing reads.

Two forms of the walk, chosen by the tensors' device:

  * on the card, one kernel (``csrc/walk_f64.cu``, built and launched by
    ``utils.native``), one thread a ray. Where the rows are longer than
    ``_SOLO_ROW`` candidates, each tile on a cluster of CTAs: the walk
    goes in rounds of as many candidates as the cluster has CTAs, one a
    CTA; the CTAs exchange their rays' outcomes through distributed
    shared memory and each replays the plain rule over the round in
    order, dropping the outcomes past the stop, so a tile's chain of
    visits is spread over the cluster's SMs. Shorter rows, one CTA a
    tile. Each launch adds one to its mode's key of the counter
    ``walk_f64.launches``, and in the cluster form of
    ``walk_f64.clustered`` (``utils.spans``). No step of this path reads
    the device, so a frame with ``f64_exact`` is captured as a CUDA graph
    (``render.renderer.render_graph``);
  * on the CPU, the plain frontier loop (``_walk_plain``): every active
    tile of a chunk advances one candidate a step, and each step's
    activity is read on the host. Chunks (``_CHUNK`` = 64 tiles, as in
    the JAX package) bound the (chunk, 512, C) float64 intermediates. A
    tile's visits and result do not depend on its chunk: its activity is
    its own, and monotone (entries ascend, prunes only fall).

Both give the same winner slots, flags and visits bit for bit: the card
tests hold the kernel to ``_walk_plain`` run on the same card tensors,
the inputs that each entry point's prepass returns (``_closest_inputs``,
``_any_inputs``, ``_any_dest_inputs``). Each entry point stamps the spans
``prepass.f64`` (prepass, weight planes and caps) and ``walk.f64`` (the
walk). They record no autograd graph: they return integers.
"""

from __future__ import annotations

import torch

from ceres_tpu_torch.ops.prepass import (_BIG, _ULP_PAD, _VALID_CUT, TILE,
                                         _hull, _interval_entry, _pad_rays,
                                         _ray_tcap, _scene_root)
from ceres_tpu_torch.ops.walk import _DEST_EPS
from ceres_tpu_torch.utils import native, spans

_CHUNK = 64          # tiles a chunk of the plain loop, as in the JAX package
MODES = ("closest", "any", "any_dest")
# Rows of at most this many candidates walk one CTA a tile, longer ones on
# the kernel's cluster form. A row of n_c candidates chains at most n_c
# visits; where they are few, the cluster's CTAs that wait on others'
# visits cost more than the chains they cut (PERF.md).
_SOLO_ROW = 512

# Kernel launches by mode since the last reset_launches(), the counters
# ``walk_f64.launches`` (the walk), ``walk_f64.clustered`` (the walk's
# launches in the cluster form) and ``prepass_f64.launches`` (the prepass)
# of ``utils.spans``. Counted where a launch succeeds and nowhere else.
launches = spans.counter("walk_f64.launches", MODES)
clustered = spans.counter("walk_f64.clustered", MODES)
prepass_launches = spans.counter("prepass_f64.launches", MODES)


def reset_launches() -> None:
    for counts in (launches, clustered, prepass_launches):
        for name in counts:
            counts[name] = 0


def _cross(u, v):
    """cross(u, v) over the last axis."""
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]],
                       dim=-1)


def _dots(x, w):
    """(n, TILE, 3) rays x (n, C, 3) triangles -> (n, TILE, C) dots."""
    return (x[..., 0, None] * w[:, None, :, 0]
            + x[..., 1, None] * w[:, None, :, 1]
            + x[..., 2, None] * w[:, None, :, 2])


def _tile_rays(dir_cols, origin_cols=None, alive_cols=None):
    """The rays in tiles: (dirs, origins or None, each a 3-tuple of
    (n_t, TILE) columns, alive (n_t, TILE))."""
    dirs_tiled = tuple(_pad_rays(c).reshape(-1, TILE) for c in dir_cols)
    alive = (dirs_tiled[0] * dirs_tiled[0] + dirs_tiled[1] * dirs_tiled[1]
             + dirs_tiled[2] * dirs_tiled[2]) > 0.0
    if alive_cols is not None:
        alive = alive & _pad_rays(alive_cols).reshape(-1, TILE)
    orig_tiled = None if origin_cols is None else tuple(
        _pad_rays(c).reshape(-1, TILE) for c in origin_cols)
    return dirs_tiled, orig_tiled, alive


def _prepass(cs, shift, dir_cols, origin_cols=None, alive_cols=None, *,
             mode):
    """Sorted float64 candidate lists: (order, ent_sorted, counts, dirs
    (n_t, TILE, 3), origins likewise or None, alive (n_t, TILE)).
    ``origin_cols`` are relative to ``shift``; ``alive_cols`` (bool (R,))
    marks the rays that walk; ``mode`` is the walk's, for the counter.
    The kernel on the card, the plain passes elsewhere."""
    if cs.lo.device.type == "cuda":
        return _prepass_card(cs, shift, dir_cols, origin_cols, alive_cols,
                             mode)
    return _prepass_plain(cs, shift, dir_cols, origin_cols, alive_cols)


def _prepass_plain(cs, shift, dir_cols, origin_cols=None, alive_cols=None):
    """``_prepass`` in whole-tensor torch passes: the slab test of every
    (tile, cluster) pair, then a stable sort of every row."""
    dirs_tiled, orig_tiled, alive = _tile_rays(dir_cols, origin_cols,
                                               alive_cols)
    lo, hi = cs.lo - shift, cs.hi - shift
    dlo, dhi = _hull(dirs_tiled, alive)
    if orig_tiled is None:
        ent = _interval_entry(lo, hi, dlo, dhi)
    else:
        ent = _interval_entry(lo, hi, dlo, dhi, *_hull(orig_tiled, alive))
    ent = torch.where(alive.any(dim=1)[:, None], ent, _BIG)
    # Stable, as jnp.argsort: the walk breaks equal-t ties by visit order.
    order = torch.argsort(ent, dim=1, stable=True)
    ent_sorted = torch.take_along_dim(ent, order, dim=1)
    counts = (ent_sorted < _VALID_CUT).sum(dim=1)
    d3 = torch.stack(dirs_tiled, dim=-1)
    o3 = None if orig_tiled is None else torch.stack(orig_tiled, dim=-1)
    return order, ent_sorted, counts, d3, o3, alive


def _prepass_card(cs, shift, dir_cols, origin_cols, alive_cols, mode):
    """``_prepass_plain`` with the slab test, compaction and sort as one
    kernel (``_prepass_kernel``); the tiles' hulls are torch reductions
    over their rays."""
    dirs_tiled, orig_tiled, alive = _tile_rays(dir_cols, origin_cols,
                                               alive_cols)
    dlo, dhi = _hull(dirs_tiled, alive)
    olo = ohi = None
    if orig_tiled is not None:
        olo, ohi = _hull(orig_tiled, alive)
    order, ent, counts = _prepass_kernel(cs.lo - shift, cs.hi - shift, dlo,
                                         dhi, olo, ohi, alive.any(dim=1),
                                         mode)
    d3 = torch.stack(dirs_tiled, dim=-1)
    o3 = None if orig_tiled is None else torch.stack(orig_tiled, dim=-1)
    return order, ent, counts, d3, o3, alive


def _prepass_kernel(lo, hi, dlo, dhi, olo, ohi, live, mode):
    """One launch of ``prepass_f64_kernel`` (``csrc/walk_f64.cu``), one
    CTA a tile: (order, ent_sorted, counts) of the boxes ``lo``, ``hi``
    (N_c, 3), already relative to the rays' shift, against each tile's
    direction hull ``dlo``, ``dhi`` (n_t, 3) and origin hull (or None),
    for the tiles with a ``live`` ray. Rows equal the plain version's up
    to counts; past it ent_sorted is ``_BIG`` and order the other
    clusters' ids. A failed launch raises."""
    if mode not in MODES:
        raise ValueError(f"prepass_f64: unknown mode {mode!r}")
    dev = lo.device
    n_t, n_c = live.shape[0], lo.shape[0]
    ent = torch.empty((n_t, n_c), dtype=torch.float64, device=dev)
    order = torch.empty((n_t, n_c), dtype=torch.int64, device=dev)
    counts = torch.empty(n_t, dtype=torch.int64, device=dev)
    f64 = torch.float64
    native.launch("walk_f64", "ceres_prepass_f64", [
        ("lo", lo, f64, (n_c, 3)), ("hi", hi, f64, (n_c, 3)),
        ("dlo", dlo, f64, (n_t, 3)), ("dhi", dhi, f64, (n_t, 3)),
        ("olo", olo, f64, (n_t, 3)), ("ohi", ohi, f64, (n_t, 3)),
        ("live", live, torch.bool, (n_t,)), ("ent", ent, f64, ent.shape),
        ("order", order, torch.int64, order.shape),
        ("counts", counts, torch.int64, counts.shape)],
        [n_t, n_c], prepass_launches, mode)
    return order, ent, counts


def _weights(cs, shift):
    """The per-cluster weight planes of triangles relative to ``shift``:
    (cu, cv, n, tn), each (N_c, C, 3) but tn (N_c, C). The JAX package
    gathers the records a step and computes the same elementwise values
    from them."""
    p0 = cs.p0 - shift
    cu, cv, nn = _cross(p0, cs.e2), _cross(p0, cs.e1), cs.n
    tn = (nn[..., 0] * p0[..., 0] + nn[..., 1] * p0[..., 1]
          + nn[..., 2] * p0[..., 2])
    return cu, cv, nn, tn


def _planes(cs, weights, generic):
    """The kernel's (N_c, K, C) weight planes: cu, cv, n (3 each) and tn,
    then for rays with their own origins e1 and e2 (K = 10 or 16)."""
    cu, cv, nn, tn = weights
    rows = [x[..., a] for x in (cu, cv, nn) for a in range(3)] + [tn]
    if generic:
        rows += [x[..., a] for x in (cs.e1, cs.e2) for a in range(3)]
    return torch.stack(rows, dim=1)


def _walk(cs, weights, order, ent, counts, d3, o3, alive, tcap, tmin=None,
          tmax=None, occ0=None, *, mode):
    """The walk -> (out (n_t, TILE) int32, executed visits, a 0-dim int64).

    ``out`` holds packed winner slot ids (``mode="closest"``, -1 for a
    miss) or occlusion flags (``"any"``, ``"any_dest"``). ``weights`` are
    ``_weights`` of the rays' shift; ``tmin``/``tmax`` (n_t, TILE) accept
    closest hits only inside each ray's window; ``occ0`` (n_t, TILE) int
    marks rays that start occluded. The kernel on the card, the plain
    loop elsewhere.
    """
    with spans.span("walk.f64"):
        if ent.device.type == "cuda":
            out, visits = _walk_card(cs, weights, order, ent, counts, d3, o3,
                                     alive, tcap, tmin, tmax, occ0, mode)
            return out, visits.sum()
        return _walk_plain(cs, weights, order, ent, counts, d3, o3, alive,
                           tcap, tmin, tmax, occ0, mode=mode)


def _walk_card(cs, weights, order, ent, counts, d3, o3, alive, tcap, tmin,
               tmax, occ0, mode):
    """``_walk_plain`` as one kernel (``csrc/walk_f64.cu``), a cluster
    of CTAs a tile where rows hold more than ``_SOLO_ROW`` candidates,
    else one CTA a tile: (out, each tile's executed visits (n_t,) int64).
    A failed launch raises."""
    n_t, n_c = ent.shape
    if mode not in MODES:
        raise ValueError(f"walk_f64: unknown mode {mode!r}")
    w = _planes(cs, weights, o3 is not None)
    cluster = n_c > _SOLO_ROW
    out = torch.empty((n_t, TILE), dtype=torch.int32, device=ent.device)
    visits = torch.empty(n_t, dtype=torch.int64, device=ent.device)
    f64, i64, rays = torch.float64, torch.int64, (n_t, TILE)
    native.launch("walk_f64", "ceres_walk_f64", [
        ("ent", ent, f64, (n_t, n_c)), ("order", order, i64, (n_t, n_c)),
        ("counts", counts, i64, (n_t,)), ("dirs", d3, f64, (*rays, 3)),
        ("origins", o3, f64, (*rays, 3)), ("alive", alive, torch.bool, rays),
        ("tcap", tcap, f64, rays), ("tmin", tmin, f64, rays),
        ("tmax", tmax, f64, rays), ("occ0", occ0, torch.int32, rays),
        ("w", w, f64, w.shape), ("out", out, torch.int32, rays),
        ("visits", visits, i64, (n_t,))],
        [n_t, n_c, cs.cluster_size, MODES.index(mode), int(cluster)],
        (launches, clustered) if cluster else launches, mode)
    return out, visits


def _walk_plain(cs, weights, order, ent, counts, d3, o3, alive, tcap,
                tmin=None, tmax=None, occ0=None, *, mode, chunk=None):
    """The chunked frontier walk, plain torch: ``_walk``'s result.
    ``chunk`` tiles a chunk (default ``_CHUNK``) bound its intermediates
    and change nothing else."""
    n_t, n_c = ent.shape
    C = cs.cluster_size
    chunk = chunk or _CHUNK
    any_mode = mode in ("any", "any_dest")
    cu, cv, nn, tn = weights
    one = torch.ones((), dtype=tn.dtype, device=tn.device)

    def mt_step(cid, tiles):
        """(ok, t) of the tiles' rays against clusters ``cid``, each
        (n, TILE, C); t is inf where rejected."""
        d = d3[tiles]
        nu, nv, nd = _dots(d, cu[cid]), _dots(d, cv[cid]), _dots(d, nn[cid])
        nt = tn[cid][:, None, :]
        if o3 is not None:
            o = o3[tiles]
            dxo = _cross(d, o)
            nu = nu - _dots(dxo, cs.e2[cid])
            nv = nv - _dots(dxo, cs.e1[cid])
            nt = nt - _dots(o, nn[cid])
        s = torch.where(nd >= 0, one, -one)
        uvw = torch.minimum(torch.minimum(nu * s, nv * s), (nd - nu - nv) * s)
        if mode == "any_dest":
            win = ((nt - (1.0 - _DEST_EPS) * nd) * s <= 0) & (nt * s >= 0)
            ok = (uvw >= 0) & (nd != 0) & win
        else:
            ok = (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
        t = torch.where(ok, nt / torch.where(nd != 0, nd, one), torch.inf)
        if tmin is not None:
            t = torch.where((t >= tmin[tiles][..., None])
                            & (t <= tmax[tiles][..., None]), t, torch.inf)
        return ok, t

    out = torch.empty((n_t, TILE), dtype=torch.int32, device=ent.device)
    steps = torch.zeros((), dtype=torch.int64, device=ent.device)
    for c0 in range(0, n_t, chunk):
        tiles = torch.arange(c0, min(c0 + chunk, n_t), device=ent.device)
        tcap_c = torch.where(alive[tiles], tcap[tiles], -one)
        if any_mode:
            state = occ0[tiles] > 0
        else:
            state = torch.full((tiles.shape[0], TILE), torch.inf,
                               dtype=tn.dtype, device=tn.device)
            slot = torch.full((tiles.shape[0], TILE), -1, dtype=torch.int64,
                              device=tn.device)
        for k in range(n_c):
            if any_mode:
                prune = torch.where(state, -one, tcap_c).amax(dim=1)
            else:
                prune = torch.minimum(state, tcap_c).amax(dim=1)
            act = (k < counts[tiles]) & (ent[tiles, k] <= prune)
            rows = act.nonzero().squeeze(1)
            if rows.numel() == 0:
                break
            tl = tiles[rows]
            cid = order[tl, k]
            ok, t = mt_step(cid, tl)
            live = alive[tl]
            if any_mode:
                state[rows] |= ok.any(dim=2) & live
            else:
                t_c, lane = t.min(dim=2)
                better = live & (t_c < state[rows])
                state[rows] = torch.where(better, t_c, state[rows])
                slot[rows] = torch.where(better, cid[:, None] * C + lane,
                                         slot[rows])
            steps += rows.numel()
        out[tiles] = (state if any_mode else slot).to(torch.int32)
    return out, steps


def _counters(steps):
    return {"traversal_steps": steps, "mt_block_visits": steps}


def _no_skip(skip, R, device):
    return (torch.zeros(R, dtype=torch.bool, device=device) if skip is None
            else skip)


def _closest_inputs(cs, eye, dir_cols, tmin=None, tmax=None):
    """``closest_search_f64``'s prepass: the keywords of ``_walk`` (and of
    ``_walk_plain``, which the card tests hold the kernel to)."""
    R = dir_cols[0].shape[0]
    with spans.span("prepass.f64"):
        order, ent, counts, d3, _, alive = _prepass(cs, eye, dir_cols,
                                                     mode="closest")
        root_lo, root_hi = _scene_root(cs)
        dp = tuple(_pad_rays(c) for c in dir_cols)
        tcap = _ray_tcap(root_lo - eye, root_hi - eye, dp).reshape(-1, TILE)
        tmin_t = tmax_t = None
        if tmin is not None or tmax is not None:
            def per_ray(x, fill):
                x = fill if x is None else x
                if not isinstance(x, torch.Tensor):
                    # A fill, not a host copy: nothing waits on the card.
                    x = eye.new_full((), float(x))
                x = x.to(dtype=eye.dtype, device=eye.device)
                return _pad_rays(x.expand(R).contiguous()).reshape(-1, TILE)

            tmin_t, tmax_t = per_ray(tmin, 0.0), per_ray(tmax, _BIG)
            tcap = torch.where(tcap < 0, tcap,
                               torch.minimum(tcap, tmax_t * (1.0 + _ULP_PAD)))
        weights = _weights(cs, eye)
    return dict(cs=cs, weights=weights, order=order, ent=ent, counts=counts,
                d3=d3, o3=None, alive=alive, tcap=tcap, tmin=tmin_t,
                tmax=tmax_t, mode="closest")


def _any_inputs(cs, origin_shift, origin_cols, dir_cols, skip=None):
    """``any_hit_f64``'s prepass, as ``_closest_inputs``."""
    skip = _no_skip(skip, dir_cols[0].shape[0], cs.lo.device)
    with spans.span("prepass.f64"):
        o = tuple(origin_cols[a] - origin_shift[a] for a in range(3))
        order, ent, counts, d3, o3, alive = _prepass(cs, origin_shift,
                                                     dir_cols, o, ~skip,
                                                     mode="any")
        root_lo, root_hi = _scene_root(cs)
        tcap = _ray_tcap(root_lo - origin_shift, root_hi - origin_shift,
                         tuple(_pad_rays(c) for c in dir_cols),
                         tuple(_pad_rays(c) for c in o))
        occ0 = _pad_rays(skip.to(torch.int32)).reshape(-1, TILE)
        weights = _weights(cs, origin_shift)
    return dict(cs=cs, weights=weights, order=order, ent=ent, counts=counts,
                d3=d3, o3=o3, alive=alive, tcap=tcap.reshape(-1, TILE),
                occ0=occ0, mode="any")


def _any_dest_inputs(cs, dest, point_cols, skip=None):
    """``any_hit_to_point_f64``'s prepass, as ``_closest_inputs``."""
    skip = _no_skip(skip, point_cols[0].shape[0], cs.lo.device)
    with spans.span("prepass.f64"):
        d = tuple(point_cols[a] - dest[a] for a in range(3))
        order, ent, counts, d3, _, alive = _prepass(cs, dest, d, None, ~skip,
                                                    mode="any_dest")
        root_lo, root_hi = _scene_root(cs)
        tcap = _ray_tcap(root_lo - dest, root_hi - dest,
                         tuple(_pad_rays(c) for c in d)).clamp(
                             max=1.0 + _ULP_PAD)
        occ0 = _pad_rays(skip.to(torch.int32)).reshape(-1, TILE)
        weights = _weights(cs, dest)
    return dict(cs=cs, weights=weights, order=order, ent=ent, counts=counts,
                d3=d3, o3=None, alive=alive, tcap=tcap.reshape(-1, TILE),
                occ0=occ0, mode="any_dest")


@torch.no_grad()
def closest_search_f64(cs, eye, dir_cols, tmin=None, tmax=None):
    """All-float64 winner search, in place of ``megakernel._closest_search``:
    (packed slot ids (R,) int32, counters). ``cs``, ``eye`` and the rays
    are float64; the ClusterSet is the one the accelerated path walks.
    ``tmin``/``tmax`` (scalar or per-ray) as there."""
    slot, steps = _walk(**_closest_inputs(cs, eye, dir_cols, tmin, tmax))
    return slot.reshape(-1)[:dir_cols[0].shape[0]], _counters(steps)


@torch.no_grad()
def any_hit_f64(cs, origin_shift, origin_cols, dir_cols, skip=None):
    """All-float64 occlusion of rays with their own origins
    (``megakernel.any_hit`` semantics): (bool (R,), counters)."""
    R = dir_cols[0].shape[0]
    skip = _no_skip(skip, R, cs.lo.device)
    occ, steps = _walk(**_any_inputs(cs, origin_shift, origin_cols, dir_cols,
                                    skip))
    return (occ.reshape(-1)[:R] > 0) & ~skip, _counters(steps)


@torch.no_grad()
def any_hit_to_point_f64(cs, dest, point_cols, skip=None):
    """All-float64 occlusion of the segments from ``dest`` to each point
    (``megakernel.any_hit_to_point`` semantics): (bool (R,), counters)."""
    R = point_cols[0].shape[0]
    skip = _no_skip(skip, R, cs.lo.device)
    occ, steps = _walk(**_any_dest_inputs(cs, dest, point_cols, skip))
    return (occ.reshape(-1)[:R] > 0) & ~skip, _counters(steps)

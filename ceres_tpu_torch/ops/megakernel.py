"""Closest-hit and shadow search over triangle clusters (counterpart of
``ceres_tpu/ops/megakernel.py``: ``_detach_f32``, ``_closest_search``,
``_winner_tuv``, ``winner_table`` (with ``_winner_table_cols``),
``closest_hit_common_origin``, ``any_hit``, ``any_hit_to_point``).

Two phases per wavefront: the culling prepass (``ops.prepass``) sorts
each ray tile's candidate clusters front to back, then a walk kernel
(``ops.walk``) visits them with early exit and returns integers only:
winner slot ids or occlusion flags. The search is always float32 and
detached. Everything a caller observes, the hit (t, u, v), the triangle
id and the shading payload, is gathered at the winners and recomputed in
plain torch, so gradients with respect to vertices, camera and ray
directions flow through the gather and ``_winner_tuv`` with no custom
autograd function.

Scenes past ``prepass._HIER_MIN_CLUSTERS`` blocks walk two-level, over
supers of up to S blocks, and weights past the resident budget are
streamed (``prepass._hier_setup``, ``prepass._use_stream``): the JAX
package's rules, so the same scene takes the same kernel variant.
Without ``clusters`` the entry points build the LBVH treelet cut on the
device (``accel.clusters.build_clusters_treelet``), as the JAX package
does.

Rays with their own origins (``any_hit``, the reference-exact shadow
rays) walk generic-origin weights and tile hulls that carry the spread
of the tile's origins. ``closest_hit_common_origin(tmin=, tmax=)``
accepts hits only inside each ray's window and caps the walk at tmax.

A float64 soup builds its cut in float64 and searches in float32, with
every observed value recomputed in float64 at the winners; with
``exact_f64=True`` the search itself runs in float64 (``ops.walk_f64``:
its own kernel on the card, the plain frontier loop on the CPU).

``any_hit_to_point(regroup=True)`` re-tiles the shadow wavefront by the
receiving points' morton codes, into tiles of ``_REGROUP_TILE`` = 128
rays walked by the any_dest kernels' 128-ray forms, as the JAX package
does (off by default in both).
"""

from __future__ import annotations

import dataclasses

import torch

from ceres_tpu_torch.accel import morton
from ceres_tpu_torch.accel.clusters import (build_clusters_treelet,
                                            cluster_weights_common_origin,
                                            cluster_weights_generic)
from ceres_tpu_torch.models.mesh import TriangleSoup
from ceres_tpu_torch.ops import walk, walk_f64
from ceres_tpu_torch.ops.intersect import Hit
from ceres_tpu_torch.ops.prepass import (
    _BIG, COMMON_ROWS, GENERIC_ROWS, TILE, _ULP_PAD, _hier_setup, _pad_rays,
    _ray_tcap, _scene_root, _super_factor, _tile_candidate_keys, _use_stream)
from ceres_tpu_torch.utils import spans

# Rays per tile of the shadow wavefront regrouped by receiver (the JAX
# package's name; its CERES_REGROUP_TILE override has no counterpart).
_REGROUP_TILE = walk.REGROUP_TILE


def _cols(x):
    """(R, 3) tensor or 3-tuple of (R,) columns -> 3-tuple of columns."""
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return tuple(x.unbind(-1))


def _detached(x, dtype=None):
    """Detach tensors (also inside tuples and dataclasses), casting the
    floating ones to ``dtype`` when given."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.to(dtype) if dtype and x.is_floating_point() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_detached(v, dtype) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _detached(getattr(x, f.name), dtype)
            for f in dataclasses.fields(x)})
    return x


def _detach_f32(x):
    """Detach and cast floating tensors (also inside tuples and
    dataclasses) to float32, the search precision."""
    return _detached(x, torch.float32)


def _treelet(soup: TriangleSoup, clusters):
    """``clusters``, or the LBVH treelet cut of ``soup`` built on its
    device and in its dtype when None (the JAX package's default
    structure)."""
    if clusters is not None:
        return clusters
    with spans.span("build"):
        return build_clusters_treelet(_detached(soup))


def _check_f64(soup: TriangleSoup, cs) -> None:
    """``exact_f64`` searches a float64 soup's float64 ClusterSet."""
    for name, x in (("soup", soup.p0), ("ClusterSet", cs.lo)):
        if x.dtype != torch.float64:
            raise ValueError(f"exact_f64 requires a float64 {name}, got "
                             f"{x.dtype}")


def _tiles(cols, tile=TILE):
    return tuple(c.reshape(-1, tile) for c in cols)


def _walk_inputs(cs, shift, w, ray_rows, dirs_tiled, alive,
                 origins_tiled=None):
    """The walk's inputs: (args, opts) for ``walk.walk_*(*args, **opts)``;
    args = (counts, keys, rays, w), opts = the two-level inputs (hull,
    bbox, first, S) and ``stream``. ``shift`` is the point the weights
    and ray rows are relative to (the common origin, or the scene centre
    for rays with their own ``origins_tiled``). The prepass (the form's
    inputs, the slab test, the keys, their sort and the counts) is the
    span ``prepass.flat`` or ``prepass.hier``, by the form the walk
    takes."""
    form = "flat" if _super_factor(cs.lo.shape[0]) == 1 else "hier"
    with spans.span(f"prepass.{form}"):
        S, hull, bbox, first, cull_lo, cull_hi, w = _hier_setup(
            cs.lo - shift, cs.hi - shift, dirs_tiled, alive, w, cs=cs,
            origins_tiled=origins_tiled)
        keys, counts = _tile_candidate_keys(cull_lo, cull_hi, dirs_tiled,
                                            origins_tiled, alive=alive)
    rows = COMMON_ROWS if origins_tiled is None else GENERIC_ROWS
    return ((counts, keys, torch.stack(ray_rows), w),
            {"hull": hull, "bbox": bbox, "first": first, "S": S,
             "stream": _use_stream(w.shape[0], rows)})


def _per_ray(x, R, fill, like):
    """A scalar or (R,) window bound -> (R,) float32 (``fill`` if None)."""
    if x is None:
        return torch.full((R,), fill, dtype=torch.float32, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=like.device).expand(R).contiguous()


def _closest_inputs(cs, eye, dir_cols, tmin=None, tmax=None):
    """The closest walk's (args, opts) for rays ``dir_cols`` from ``eye``:
    weights, root-exit caps, padded ray rows, the prepass's sorted
    candidate keys and, past the two-level threshold, the super inputs.
    With ``tmin``/``tmax`` (scalar or per-ray) the rays carry their
    [tmin, tmax] window rows, the cap is clamped to tmax and opts gain
    ``window=True``. Detached float32."""
    cs, eye, dir_cols, tmin, tmax = _detach_f32((cs, eye, dir_cols, tmin,
                                                 tmax))
    root_lo, root_hi = _scene_root(cs)
    dp = tuple(_pad_rays(c) for c in dir_cols)
    dirs_tiled = _tiles(dp)
    alive = (dirs_tiled[0] * dirs_tiled[0] + dirs_tiled[1] * dirs_tiled[1]
             + dirs_tiled[2] * dirs_tiled[2]) > 0.0
    tcap = _ray_tcap(root_lo - eye, root_hi - eye, dp)
    rows = [*dp, tcap]
    window = tmin is not None or tmax is not None
    if window:
        R = dir_cols[0].shape[0]
        tmin_p = _pad_rays(_per_ray(tmin, R, 0.0, tcap))
        tmax_p = _pad_rays(_per_ray(tmax, R, _BIG, tcap))
        # No candidate past tmax can matter: cap the walk there (padded
        # like the root exit). Dead rays keep the cap -1.
        rows[3] = torch.where(tcap < 0, tcap,
                              torch.minimum(tcap,
                                            tmax_p * (1.0 + _ULP_PAD)))
        rows += [tmin_p, tmax_p]
    w = cluster_weights_common_origin(cs, eye)
    args, opts = _walk_inputs(cs, eye, w, rows, dirs_tiled, alive)
    if window:
        opts["window"] = True
    return args, opts


def _closest_search(cs, eye, dir_cols, tmin=None, tmax=None):
    """Detached winner search: (packed slot ids (R,) int32, counters)."""
    R = dir_cols[0].shape[0]
    with spans.span("closest.prep"):
        args, opts = _closest_inputs(cs, eye, dir_cols, tmin, tmax)
    pidx, visits = walk.walk_closest(*args, **opts)
    steps = visits.sum()
    return pidx[:R], {"traversal_steps": steps, "mt_block_visits": steps}


def _winner_tuv(rec, eye, dir_cols):
    """Möller-Trumbore (t, u, v) at the (ray, winning triangle) pairs.

    ``rec`` holds the gathered winner-table columns [p0 x3, e1 x3, e2 x3,
    ...]. The face normal is recomputed as cross(e1, e2), the same
    formula the soup stores.
    """
    p0, e1, e2 = rec[0:3], rec[3:6], rec[6:9]
    n = (e1[1] * e2[2] - e1[2] * e2[1],
         e1[2] * e2[0] - e1[0] * e2[2],
         e1[0] * e2[1] - e1[1] * e2[0])
    d = dir_cols
    c = tuple(p0[a] - eye[a] for a in range(3))
    r = (d[1] * c[2] - d[2] * c[1],
         d[2] * c[0] - d[0] * c[2],
         d[0] * c[1] - d[1] * c[0])
    det = n[0] * d[0] + n[1] * d[1] + n[2] * d[2]
    # det == 0 only at masked (non-winner) rays; keep 1/0 out of gradients.
    inv = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    u = (r[0] * e2[0] + r[1] * e2[1] + r[2] * e2[2]) * inv
    v = (r[0] * e1[0] + r[1] * e1[1] + r[2] * e1[2]) * inv
    t = (n[0] * c[0] + n[1] * c[1] + n[2] * c[2]) * inv
    return t, u, v


def winner_table(soup: TriangleSoup, clusters, payload=None):
    """The (N_c * C, 9 + P) winner table in cluster-slot order: [p0 x3,
    e1 x3, e2 x3, payload...], zero at padding slots; build it once and
    pass it back as ``table_cols`` in a static-geometry frame loop.

    Built from ``soup``, not the detached cluster tensors, so gradients
    reach the vertices through the gather (a prebuilt table passed to a
    train step cuts them). Triangle ids are not a column: they are
    gathered from ``clusters.perm`` as integers.
    """
    valid = (clusters.perm >= 0)[:, None]
    rows = torch.cat([soup.p0, soup.e1, soup.e2,
                      *(c[:, None] for c in payload or ())], dim=1)
    return torch.where(valid, _gather_rows(rows, clusters.perm.clamp(min=0)),
                       0.0)


def _gather_rows(table, idx):
    """``table[idx]`` for a 2-D table, differentiable, as
    ``index_select``: its backward adds each row's gradient with atomics
    (``index_add_``), where the backward of advanced indexing
    (``index_put_`` with accumulate) sums an index's repeats serially on
    the card. Every miss and padding ray reads slot 0 and every padding
    slot triangle 0: a million repeats in a 1080p frame."""
    return table.index_select(0, idx.long())


def closest_hit_common_origin(soup: TriangleSoup, eye, dirs, clusters=None,
                              with_counts=False, payload=None, tmin=None,
                              tmax=None, normal_cols=False, exact_f64=False,
                              table_cols=None):
    """Closest hit of normalised ``dirs`` rays all starting at ``eye``.

    ``dirs`` is (R, 3) or a 3-tuple of (R,) columns; ``clusters`` is a
    prebuilt ClusterSet of this soup (None: the treelet cut is built).
    ``tmin``/``tmax`` (scalar or per-ray (R,)) accept only hits with
    tmin <= t <= tmax (default [0, _BIG)); tmax also caps the walk.
    ``payload`` (P per-triangle (T,) columns) rides the winner gather:
    returns (hit, payload columns), zero at misses. ``normal_cols=True``
    prepends the winner's face normal, recomputed from the gathered
    edges. ``with_counts=True`` adds the measured counters (executed
    cluster visits and MT pairs). ``exact_f64=True`` searches a float64
    soup in float64 (``ops.walk_f64``) instead of float32.
    """
    dir_cols = _cols(dirs)
    cs = _treelet(soup, clusters)
    if exact_f64:
        _check_f64(soup, cs)
        pidx, counts = walk_f64.closest_search_f64(cs, eye, dir_cols, tmin,
                                                   tmax)
    else:
        pidx, counts = _closest_search(cs, eye, dir_cols, tmin, tmax)
    table = table_cols
    if table is None:
        with spans.span("build"):
            table = winner_table(soup, cs, payload)
    with spans.span("closest.gather"):
        mask = pidx >= 0
        idx = pidx.clamp(min=0).long()
        rec = _gather_rows(table, idx).t().contiguous().unbind(0)
        t, u, v = _winner_tuv(rec, eye, dir_cols)
        hit = Hit(t=torch.where(mask, t, torch.inf),
                  u=torch.where(mask, u, 0.0),
                  v=torch.where(mask, v, 0.0),
                  prim_id=torch.where(mask, cs.perm[idx], 0),
                  mask=mask)
        out_pay = tuple(rec[9:])
        if normal_cols:
            e1, e2 = rec[3:6], rec[6:9]
            out_pay = (e1[1] * e2[2] - e1[2] * e2[1],
                       e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]) + out_pay
    out = (hit,) if payload is None and not normal_cols else (hit, out_pay)
    if with_counts:
        counts["mt_pairs"] = (counts["mt_block_visits"]
                              * TILE * cs.cluster_size)
        out = out + (counts,)
    return out[0] if len(out) == 1 else out


def any_hit(soup: TriangleSoup, origin_shift, origins, dirs, skip=None,
            clusters=None, with_counts=False, exact_f64=False):
    """Occlusion of rays (origins[i], dirs[i]): True where a ray hits
    any triangle at t >= 0, however far (the reference's shadow ray with
    tmax = inf).

    ``origins``/``dirs`` are (R, 3) or 3-tuples of (R,) columns.
    ``origin_shift`` (3,) is the point the weights and ray origins are
    taken relative to, for conditioning (the renderer passes the scene
    centre); the result does not depend on it beyond rounding. ``skip``
    marks rays whose answer is irrelevant (no primary hit); they generate
    no traversal work. Boolean, detached. ``exact_f64=True`` searches in
    float64 (``ops.walk_f64``).
    """
    R = _cols(dirs)[0].shape[0]
    cs = _treelet(soup, clusters)
    if skip is None:
        skip = torch.zeros(R, dtype=torch.bool, device=cs.lo.device)
    if exact_f64:
        _check_f64(soup, cs)
        result, counts = walk_f64.any_hit_f64(
            cs, origin_shift, _cols(origins), _cols(dirs), skip)
        steps = counts["traversal_steps"]
    else:
        with spans.span("shadow.prep"):
            args, opts = _any_inputs(cs, origin_shift, origins, dirs, skip)
        occ, visits = walk.walk_any(*args, **opts)
        steps = visits.sum()
        result = (occ[:R] == 1) & ~skip
    if with_counts:
        return result, {"traversal_steps": steps, "mt_block_visits": steps,
                        "mt_pairs": steps * TILE * cs.cluster_size}
    return result


def _any_inputs(cs, shift, origins, dirs, skip):
    """The generic shadow walk's (args, opts) for rays from ``origins``
    along ``dirs``, relative to ``shift``; ``skip`` (bool (R,)) marks rays
    that start occluded: args = (counts, keys, rays, w, occ0) with ray
    rows [d, d x o, o, cap], opts as in ``_walk_inputs``. Detached
    float32."""
    cs, shift, o_cols, d_cols = _detach_f32((cs, shift, _cols(origins),
                                             _cols(dirs)))
    root_lo, root_hi = _scene_root(cs)
    dp = tuple(_pad_rays(c) for c in d_cols)
    op = tuple(_pad_rays(o_cols[a] - shift[a]) for a in range(3))
    dirs_tiled, orig_tiled = _tiles(dp), _tiles(op)
    occ0 = _pad_rays(skip.to(torch.int32))
    alive = (occ0.reshape(-1, TILE) == 0) & (
        (dirs_tiled[0] * dirs_tiled[0] + dirs_tiled[1] * dirs_tiled[1]
         + dirs_tiled[2] * dirs_tiled[2]) > 0.0)
    # d x o once here, so the kernel and its plain version read the same
    # floats. Padding rays have zero dirs: cap -1, never occluded.
    dxo = (dp[1] * op[2] - dp[2] * op[1],
           dp[2] * op[0] - dp[0] * op[2],
           dp[0] * op[1] - dp[1] * op[0])
    tcap = _ray_tcap(root_lo - shift, root_hi - shift, dp, op)
    w = cluster_weights_generic(cs, shift)
    args, opts = _walk_inputs(cs, shift, w, [*dp, *dxo, *op, tcap],
                              dirs_tiled, alive, orig_tiled)
    return args + (occ0,), opts


def any_hit_to_point(soup: TriangleSoup, dest, points, skip=None,
                     clusters=None, with_counts=False, exact_f64=False,
                     regroup=None):
    """Occlusion between each ``points[i]`` and the common point ``dest``:
    the shadow wavefront, every ray aimed at the one sun.

    The wavefront runs as rays from ``dest`` (t = 0) to each receiving
    point (t = 1), so it is a common-origin wavefront. An occluder lies
    strictly between light and receiver. ``skip`` marks rays whose answer
    is irrelevant (no primary hit); they generate no traversal work.
    Boolean, detached. ``exact_f64=True`` searches in float64
    (``ops.walk_f64``) and ignores ``regroup``.

    ``regroup`` (any truthy value) re-tiles the wavefront by receiver, as
    the JAX package's ``regroup=True``: rays in the stable order of their
    points' morton codes over the scene root, skipped rays last, in tiles
    of ``_REGROUP_TILE`` = 128, so a tile is a compact surface patch. The
    flags are the same; tiles, visits and ``mt_pairs`` (visits x 128 x C)
    are not. None and False leave it off. The JAX package's "auto" mode
    and its ``CERES_SHADOW_REGROUP`` override have no counterpart here.
    """
    R = _cols(points)[0].shape[0]
    cs = _treelet(soup, clusters)
    if skip is None:
        skip = torch.zeros(R, dtype=torch.bool, device=cs.lo.device)
    tile = TILE
    if exact_f64:
        _check_f64(soup, cs)
        result, counts = walk_f64.any_hit_to_point_f64(cs, dest,
                                                       _cols(points), skip)
        steps = counts["traversal_steps"]
    else:
        perm = None
        with spans.span("shadow.prep"):
            if regroup:
                perm = _receiver_order(cs, points, skip)
                points = tuple(c[perm] for c in _cols(points))
                skip = skip[perm]
                tile = _REGROUP_TILE
            args, opts = _any_dest_inputs(cs, dest, points, skip, tile)
        occ, visits = walk.walk_any_dest(*args, **opts)
        steps = visits.sum()
        result = (occ[:R] == 1) & ~skip
        if perm is not None:   # back to the caller's ray order
            result = torch.empty_like(result).index_put_((perm,), result)
    if with_counts:
        return result, {"traversal_steps": steps, "mt_block_visits": steps,
                        "mt_pairs": steps * tile * cs.cluster_size}
    return result


def _receiver_order(cs, points, skip):
    """The regrouped shadow wavefront's ray order ((R,) int64): a stable
    argsort of the receiving points' morton codes over the scene root,
    skipped rays given the largest code so they sort last, in their own
    order. Stable, as ``jnp.argsort``: every skipped ray shares one code,
    and another order of ties gives other tiles and other visits."""
    cs, p_cols = _detach_f32((cs, _cols(points)))
    root_lo, root_hi = _scene_root(cs)
    code = morton.morton_codes(torch.stack(p_cols, dim=-1), root_lo, root_hi)
    code = torch.where(skip, 0x7FFFFFFF, code)
    return torch.argsort(code, stable=True)


def _any_dest_inputs(cs, dest, points, skip, tile=TILE):
    """The shadow walk's (args, opts) for segments from ``dest`` to
    ``points`` in tiles of ``tile`` rays, ``skip`` (bool (R,)) marking
    rays that start occluded: args = (counts, keys, rays, w, occ0), opts
    as in ``_walk_inputs``. Detached float32."""
    cs, dest, p_cols = _detach_f32((cs, dest, _cols(points)))
    root_lo, root_hi = _scene_root(cs)
    dp = tuple(_pad_rays(p_cols[a] - dest[a], tile) for a in range(3))
    occ0 = _pad_rays(skip.to(torch.int32), tile)
    alive = (occ0.reshape(-1, tile) == 0) & (
        (dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2]).reshape(-1, tile)
        > 0.0)
    # Nothing past the receiving point can occlude: cap the walk at t = 1
    # (+ slack). Padding rays (zero dirs) keep the cap -1.
    tcap = _ray_tcap(root_lo - dest, root_hi - dest, dp).clamp(max=1.0 + _ULP_PAD)
    w = cluster_weights_common_origin(cs, dest)
    args, opts = _walk_inputs(cs, dest, w, [*dp, tcap], _tiles(dp, tile),
                              alive)
    return args + (occ0,), opts

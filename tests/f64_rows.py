"""Crafted inputs of the float64 walk (``ops.walk_f64._walk``), shared by
the CPU tests (``test_torch_f64.py``: the cluster kernel's round rule,
modelled in plain torch) and the card tests (``test_torch_cuda.py``: the
kernel against the plain loop). No JAX here.

A crafted input keeps a real input's clusters and rays and gives each of
its tiles chosen rays and a chosen candidate row, so that the plain
loop's stop falls where a test wants it: ``stop_specs`` puts it right
after a chosen position while a later candidate of the same round holds
a hit for a ray that the plain loop leaves without one; ``twin_specs``
puts two candidates with equal t for a ray next to each other."""

import dataclasses

import torch

from ceres_tpu_torch.ops import walk_f64
from ceres_tpu_torch.ops.prepass import _BIG

RAY_KEYS = ("d3", "o3", "alive", "tcap", "tmin", "tmax", "occ0")


def outcome(w, tile, cids):
    """The rays of ``tile`` against each candidate of ``cids`` alone, in
    the plain loop's operations: closest, (t, slot), each (n, TILE), the
    smallest t of a ray (inf where none) and its packed slot id (the first
    lane of it); occlusion, (flag (n, TILE), None)."""
    cs, (cu, cv, nn, tn) = w["cs"], w["weights"]
    c = torch.as_tensor(cids, device=tn.device).reshape(-1)
    d = w["d3"][tile].expand(c.shape[0], -1, -1)
    one = torch.ones((), dtype=tn.dtype, device=tn.device)
    dots = walk_f64._dots
    nu, nv, nd = dots(d, cu[c]), dots(d, cv[c]), dots(d, nn[c])
    nt = tn[c][:, None, :]
    if w.get("o3") is not None:
        o = w["o3"][tile].expand(c.shape[0], -1, -1)
        dxo = walk_f64._cross(d, o)
        nu = nu - dots(dxo, cs.e2[c])
        nv = nv - dots(dxo, cs.e1[c])
        nt = nt - dots(o, nn[c])
    s = torch.where(nd >= 0, one, -one)
    uvw = torch.minimum(torch.minimum(nu * s, nv * s), (nd - nu - nv) * s)
    if w["mode"] == "any_dest":
        win = (((nt - (1.0 - walk_f64._DEST_EPS) * nd) * s <= 0)
               & (nt * s >= 0))
        ok = (uvw >= 0) & (nd != 0) & win
    else:
        ok = (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
    if w["mode"] != "closest":
        return ok.any(dim=2), None
    t = torch.where(ok, nt / torch.where(nd != 0, nd, one), torch.inf)
    if w.get("tmin") is not None:
        t = torch.where((t >= w["tmin"][tile][None, :, None])
                        & (t <= w["tmax"][tile][None, :, None]), t,
                        torch.inf)
    t_c, lane = t.min(dim=2)
    return t_c, c[:, None] * cs.cluster_size + lane


def hit_table(w, tile, chunk=16):
    """(N_c, TILE) bool: which clusters give each ray of ``tile`` a hit
    (closest: a t below inf) or an occluder."""
    n = w["cs"].num_clusters
    rows = []
    for c0 in range(0, n, chunk):
        res, _ = outcome(w, tile, torch.arange(c0, min(c0 + chunk, n)))
        rows.append(res < torch.inf if w["mode"] == "closest" else res)
    return torch.cat(rows)


def craft(w, specs, width=1):
    """``w`` with one tile a spec. A spec is a dict: ``rays``, the (tile,
    lane) of the rays it copies into its first lanes (direction, origin,
    window, occ0 and root exit each its own; the other lanes dead);
    optional ``caps``, the rays' root exits instead; ``row``, its
    (cluster, entry) candidates in order, its count their number. Rows
    are padded to the longest, and to at least ``width``, with entries
    of ``_BIG``."""
    dev = w["ent"].device
    n_t, n_c = len(specs), max([width] + [len(s["row"]) for s in specs])
    out = dict(w)
    for key in RAY_KEYS:
        x = w.get(key)
        if x is None:
            continue
        new = torch.zeros((n_t,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        for i, s in enumerate(specs):
            for lane, (t, r) in enumerate(s["rays"]):
                new[i, lane] = x[t, r]
            if key == "tcap" and s.get("caps") is not None:
                new[i, :len(s["caps"])] = torch.as_tensor(
                    s["caps"], dtype=x.dtype, device=dev)
        out[key] = new
    ent = torch.full((n_t, n_c), _BIG, dtype=torch.float64, device=dev)
    order = torch.zeros((n_t, n_c), dtype=torch.int64, device=dev)
    for i, s in enumerate(specs):
        for k, (cid, e) in enumerate(s["row"]):
            order[i, k], ent[i, k] = cid, e
    out.update(ent=ent, order=order, counts=torch.tensor(
        [len(s["row"]) for s in specs], dtype=torch.int64, device=dev))
    return out


def _two_rays(w, tiles=4):
    """(a, b, x, y, fillers): ray a (a (tile, lane)) that cluster x hits,
    ray b that x misses and cluster y hits, and the clusters that hit
    neither; a's hit at x lies below its root exit. The rays come from
    the ``tiles`` tiles with the most results."""
    want, _ = walk_f64._walk_plain(**w)
    live = w["alive"] if w.get("occ0") is None else (w["alive"]
                                                     & (w["occ0"] == 0))
    got = ((want >= 0) if w["mode"] == "closest" else (want > 0)) & live
    rays = []  # (ray, the clusters that hit it)
    for tile in got.sum(dim=1).argsort(descending=True)[:tiles].tolist():
        table = hit_table(w, tile)
        for lane in (table.any(dim=0) & live[tile]).nonzero()[:, 0].tolist():
            rays.append(((tile, lane), table[:, lane]))
    for a, hit_a in rays:
        for x in hit_a.nonzero()[:, 0].tolist():
            if w["mode"] == "closest":
                t0 = float(outcome(w, a[0], [x])[0][0, a[1]])
                if not t0 < float(w["tcap"][a]):
                    continue
            for b, hit_b in rays:
                if b != a and not bool(hit_b[x]):
                    y = int(hit_b.nonzero()[0, 0])
                    free = (~hit_a & ~hit_b).nonzero()[:, 0].tolist()
                    return a, b, x, y, free
    raise AssertionError("no two rays with distinct hits")


def stop_specs(w, positions):
    """One spec a position p, and two more: the plain walk stops right
    after candidate p, a's hit at cluster x, so that candidate p + 1 is
    the first not visited: cluster y, which holds a hit for b, a ray
    that nothing visited hits. Entries: 0 up to p, then a's root exit
    e; b's root exit e / 1000, so that once x has hit a (closest: t below
    e) or occluded it, no ray admits e. Then a row of 3 (x first: count
    3, the stop after 1) and a row of none."""
    a, b, x, y, free = _two_rays(w)
    e = float(w["tcap"][a])
    caps = [e, e / 1000.0]
    specs = []
    for p in positions:
        assert len(free) >= p + 2, (len(free), p)
        row = ([(c, 0.0) for c in free[:p]] + [(x, 0.0), (y, e)]
               + [(c, e) for c in free[p:p + 2]])
        specs.append(dict(rays=[a, b], caps=caps, row=row))
    specs.append(dict(rays=[a, b], caps=caps,
                      row=[(x, 0.0), (y, e), (free[0], e)]))
    specs.append(dict(rays=[a, b], caps=caps, row=[]))
    return specs


def twin_specs(w, positions):
    """``w`` with a twin of cluster x (the same triangles, id N_c) and one
    spec a (position p, twin first): ray a's candidates at p and p + 1
    are x and its twin, in that order or the twin first, every entry 0,
    so the plain walk visits both and keeps the earlier one's slot."""
    a, _, x, _, free = _two_rays(w)
    cs = w["cs"]
    n_c = cs.num_clusters

    def twin(t):
        return torch.cat([t, t[x:x + 1]])

    w = dict(w, cs=dataclasses.replace(
        cs, p0=twin(cs.p0), e1=twin(cs.e1), e2=twin(cs.e2), n=twin(cs.n),
        lo=twin(cs.lo), hi=twin(cs.hi), perm=torch.cat(
            [cs.perm, cs.perm.reshape(n_c, -1)[x]])),
             weights=tuple(twin(t) for t in w["weights"]))
    specs = []
    for p, twin_first in positions:
        pair = [n_c, x] if twin_first else [x, n_c]
        row = free[:p] + pair + free[p:p + 2]
        specs.append(dict(rays=[a], row=[(c, 0.0) for c in row]))
    return w, specs


def tile_of(w, tile):
    """``w`` cut to one tile."""
    return {k: v[tile:tile + 1] if k in ("order", "ent", "counts", *RAY_KEYS)
            and v is not None else v for k, v in w.items()}


def tile_visits(w):
    """Each tile's visits by the plain loop, one tile at a time."""
    return torch.stack([walk_f64._walk_plain(**tile_of(w, t))[1]
                        for t in range(w["ent"].shape[0])])

"""What a frame's walks need: executed block visits and ray-triangle
pairs of the plain front-to-back walk, on the walk kernels' own inputs.

A frozen copy of the plain versions in ``ceres_tpu_torch/ops/walk.py``
(``_numerators``, ``_pair_keys``, ``_pair_hits``, ``_member_entries``,
``_walk``, ``_walk_closest_plain``, ``_occlusion_plain``) with the
constants they read (``ops/prepass.py``'s ``_BIG``, ``_ULP_PAD`` and
``_cid_bits``, ``accel/clusters.py``'s ``CLUSTER_SIZE`` and
``GENERIC_PLANES``, ``utils/minmax.py``'s ``fmin``/``fmax``), kept here
so that a faster kernel on the same inputs reads the same work. Pairs:
closest walks, every ray against every lane of every visit; shadow
walks, each ray not yet occluded, the lanes up to its first occluder.
Plain torch; imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

CLUSTER_SIZE = 128
GENERIC_PLANES = 16
_BIG = 3.0e37
_ULP_PAD = 4e-6
_PRUNE_PAD = 256
_DEST_EPS = 4e-6
_IMASK = CLUSTER_SIZE - 1
_BIG_CLEAN_I = int(np.float32(_BIG).view(np.int32) & ~np.int32(_IMASK))
_BIG_CLEAN = float(np.int32(_BIG_CLEAN_I).view(np.float32))
_NEG_I = int(np.float32(-1.0).view(np.int32))
_DEST_SCALE = float(np.float32(1.0 - _DEST_EPS))
_IMAX = 0x7FFFFFFF
_TCAP_ROW = {"closest": 3, "closest_window": 3, "any_dest": 3, "any": 9}
_PLAIN_CHUNK = 128


def _cid_bits(n_c: int) -> int:
    return max(1, (n_c - 1).bit_length())


def _fmax(a, b):
    both0 = (a == 0) & (b == 0)
    return torch.where(both0, a + b, torch.maximum(a, b))


def _fmin(a, b):
    both0 = (a == 0) & (b == 0)
    return torch.where(both0, -((-a) + (-b)), torch.minimum(a, b))


def _numerators(r, wj):
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
    uvw, nd, nt, s = _numerators(r, wj)
    ok = (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
    t = torch.where(ok, nt * torch.reciprocal(nd), _BIG_CLEAN)
    if window:
        tmin, tmax = r[4][:, :, None], r[5][:, :, None]
        t = torch.where((t >= tmin) & (t <= tmax), t, _BIG_CLEAN)
    lane = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=wj.device)
    return (t.view(torch.int32) & ~_IMASK) | lane


def _pair_hits(r, wj, mode):
    uvw, nd, nt, s = _numerators(r, wj)
    if mode == "any":
        return (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
    win = ((nt - _DEST_SCALE * nd) * s <= 0) & (nt * s >= 0)
    return (uvw >= 0) & (nd != 0) & win


def _member_entries(hull, bb):
    tn = tf = None
    for a in range(3):
        la = bb[:, a] - hull[:, 12 + a, None]
        ha = bb[:, 3 + a] - hull[:, 9 + a, None]
        ia, ib = hull[:, a, None], hull[:, 3 + a, None]
        c0, c1, c2, c3 = la * ia, la * ib, ha * ia, ha * ib
        emin = _fmin(_fmin(c0, c1), _fmin(c2, c3))
        emax = _fmax(_fmax(c0, c1), _fmax(c2, c3))
        wide = hull[:, 6 + a, None] > 0
        emin = torch.where(wide, -_BIG, emin)
        emax = torch.where(wide, _BIG, emax)
        tn = emin if tn is None else _fmax(tn, emin)
        tf = emax if tf is None else _fmin(tf, emax)
    tn = _fmax(tn, torch.zeros_like(tn))
    ok = ((tn * (1.0 - _ULP_PAD) <= tf.clamp(max=_BIG) * (1.0 + _ULP_PAD))
          & (bb[:, 6] == 0))
    return torch.where(ok, tn, _BIG).view(torch.int32)


def _walk(counts, keys, rays, tcap_row, state, prune_of, visit, hier=None):
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
        ent = _member_entries(hull[tiles], bbox[sid])
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


def _hier(opts):
    S = opts.get("S", 1)
    return None if S == 1 else (opts["hull"], opts["bbox"], opts["first"], S)


def closest(counts, keys, rays, w, opts):
    """(visits per tile, pairs) of a closest walk."""
    window = bool(opts.get("window", False))
    mode = "closest_window" if window else "closest"
    tile = rays.shape[1] // keys.shape[0]
    best = torch.full((keys.shape[0], tile), _BIG_CLEAN_I, dtype=torch.int32,
                      device=keys.device)
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
                   prune_of, visit, _hier(opts))
    return visits, int(visits.sum()) * tile * CLUSTER_SIZE


def occlusion(mode, counts, keys, rays, w, occ0, opts):
    """(visits per tile, pairs) of an occlusion walk (``any_dest`` or
    ``any``)."""
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
                   prune_of, visit, _hier(opts))
    return visits, int(tested.sum())

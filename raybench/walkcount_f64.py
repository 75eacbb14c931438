"""What a frame's float64 walks need, and the least time one card could
take for them.

``count`` is a frozen copy of the plain frontier rule of
``ceres_tpu_torch/ops/walk_f64.py`` (``_walk_plain``, with ``_dots``,
``_cross`` and ``_DEST_EPS``), kept here so that a faster kernel on the
same inputs reads the same work: every tile walks its candidates front
to back while the next entry bound is at most its prune, the maximum
over its rays of min(best t, root exit) (closest) or of the root exit of
the unoccluded rays (occlusion), dead rays counting -1. It runs on the
walk's own inputs (recorded from the port's ``_walk`` during one eager
frame) and never reads what the kernel reports. Pairs: closest walks,
every live ray against every triangle of every visit; occlusion walks,
each live ray not yet occluded, the triangles up to its first occluder.
Plain torch; imports nothing of the port.

``bound`` gives a walk's least time: the larger of its pairs times the
float64 operations a pair (FLOPS_PER_PAIR) over the card's float64 peak
outside the tensor cores, and its bytes over the memory rate.
"""

from __future__ import annotations

import torch

TILE = 512
_DEST_EPS = 4e-6
_CHUNK = 1024
# float64 operations per ray-triangle pair of a visit, counted from
# ops/csrc/walk_f64.cu as raybench/roofline.py counts walk.cu's: the
# numerators, 15 (33 for rays with their own origins), the sign test, 8,
# and the mode's accept, 4 (closest, any) or 8 (any_dest).
FLOPS_PER_PAIR = {"closest": 27, "any_dest": 31, "any": 45}
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): float64 outside
# the tensor cores (a fused multiply-add counted as two), and HBM3.
PEAK_FLOPS = 34e12
PEAK_BYTES = 3.35e12


def _cross(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]],
                       dim=-1)


def _dots(x, w):
    return (x[..., 0, None] * w[:, None, :, 0]
            + x[..., 1, None] * w[:, None, :, 1]
            + x[..., 2, None] * w[:, None, :, 2])


def count(e1, e2, weights, order, ent, counts, d3, o3, alive, tcap,
          tmin=None, tmax=None, occ0=None, *, mode):
    """(visits per tile (n_t,) int64, pairs) of a float64 walk of
    ``mode`` on its inputs: the cluster edges ``e1``, ``e2`` (N_c, C, 3),
    the weight planes (cu, cv, n, tn), the sorted candidates (order, ent,
    counts), the rays (d3, o3 or None, alive, tcap, window, occ0)."""
    n_t, n_c = ent.shape
    cu, cv, nn, tn = weights
    any_mode = mode in ("any", "any_dest")
    one = torch.ones((), dtype=tn.dtype, device=tn.device)
    visits = torch.zeros(n_t, dtype=torch.int64, device=ent.device)
    pairs = torch.zeros((), dtype=torch.int64, device=ent.device)
    C = tn.shape[1]
    lane = torch.arange(1, C + 1, device=ent.device)
    for c0 in range(0, n_t, _CHUNK):
        tiles = torch.arange(c0, min(c0 + _CHUNK, n_t), device=ent.device)
        tcap_c = torch.where(alive[tiles], tcap[tiles], -one)
        if any_mode:
            state = occ0[tiles] > 0
        else:
            state = torch.full((tiles.shape[0], TILE), torch.inf,
                               dtype=tn.dtype, device=tn.device)
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
            visits[tl] += 1
            cid = order[tl, k]
            d = d3[tl]
            nu, nv = _dots(d, cu[cid]), _dots(d, cv[cid])
            nd = _dots(d, nn[cid])
            nt = tn[cid][:, None, :]
            if o3 is not None:
                o = o3[tl]
                dxo = _cross(d, o)
                nu = nu - _dots(dxo, e2[cid])
                nv = nv - _dots(dxo, e1[cid])
                nt = nt - _dots(o, nn[cid])
            s = torch.where(nd >= 0, one, -one)
            uvw = torch.minimum(torch.minimum(nu * s, nv * s),
                                (nd - nu - nv) * s)
            live = alive[tl]
            if mode == "any_dest":
                win = ((nt - (1.0 - _DEST_EPS) * nd) * s <= 0) & (nt * s >= 0)
                ok = (uvw >= 0) & (nd != 0) & win
            else:
                ok = (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
            if any_mode:
                hit = ok.any(dim=2)
                upto = torch.where(hit, (ok * lane).masked_fill(~ok, C + 1)
                                   .amin(dim=2), C)
                pairs += torch.where(live & ~state[rows], upto, 0).sum()
                state[rows] |= hit & live
                continue
            pairs += live.sum() * C
            t = torch.where(ok, nt / torch.where(nd != 0, nd, one),
                            torch.inf)
            if tmin is not None:
                t = torch.where((t >= tmin[tl][..., None])
                                & (t <= tmax[tl][..., None]), t, torch.inf)
            t_c = t.amin(dim=2)
            state[rows] = torch.where(live & (t_c < state[rows]), t_c,
                                      state[rows])
    return visits, int(pairs)


def bound(mode, inputs: dict, visits: int, pairs: int):
    """(seconds, "operations" or "bytes") for a float64 walk of
    ``visits`` executed block visits that tests ``pairs`` pairs. Bytes:
    the rays, their caps, windows and flags and the tiles' counts read
    once, the entries a tile reads (its visits and the one that stops
    it: a float64 bound and an int64 cluster id each), each visit's
    weight planes (K x C float64), and the outputs (one int32 a ray, one
    int64 a tile) written once."""
    rays = [inputs[k] for k in ("d3", "o3", "alive", "tcap", "tmin",
                                "tmax", "occ0", "counts")
            if inputs.get(k) is not None]
    n_t = inputs["ent"].shape[0]
    C = inputs["weights"][3].shape[1]
    planes = 16 if inputs.get("o3") is not None else 10
    nbytes = (sum(x.numel() * x.element_size() for x in rays)
              + (visits + n_t) * 16 + visits * planes * C * 8
              + n_t * TILE * 4 + n_t * 8)
    t_ops = pairs * FLOPS_PER_PAIR[mode] / PEAK_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

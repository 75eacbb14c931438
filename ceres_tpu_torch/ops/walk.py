"""The two walk kernels' wrappers and their plain PyTorch versions.

``walk_closest`` and ``walk_any_dest`` replace the flat, resident
``closest`` and ``any_dest`` variants of the JAX package's Pallas walk
(``ceres_tpu/ops/megakernel.py`` ``_make_walk_kernel`` via
``_walk_pallas``). The kernels are CUDA C++ for sm_90a in
``csrc/walk.cu``. Each wrapper dispatches on the device of its tensors:

  * CPU tensors go to the plain version (the CPU tests run it);
  * CUDA tensors launch the kernel, or raise: there is no fallback.

The plain versions define the exact results. They use elementwise
products, never a matmul, in the kernel's operation order, so the kernel
matches them bit for bit on the card.

Inputs, for n_tiles tiles of TILE = 512 rays and n_c clusters of C = 128:
  counts (n_tiles,) int32   real candidates per tile;
  keys   (n_tiles, n_c) int32, ascending (``prepass._tile_candidate_keys``);
  rays   (4, n_tiles * 512) f32 rows [d.x, d.y, d.z, root-exit cap];
  w      (n_c, 10, 128) f32 (``clusters.cluster_weights_common_origin``);
  occ0   (n_tiles * 512,) int32 rays that start occluded (any_dest only).
Each returns (out (n_tiles * 512,) int32, steps), with ``out`` the packed
winner slot id (cid * C + lane, -1 for a miss) or the occlusion flag, and
``steps`` the executed cluster visits (0-dim int64), the traversal
statistic.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_tpu_torch.accel.clusters import CLUSTER_SIZE, WEIGHT_PLANES
from ceres_tpu_torch.ops.prepass import _BIG, TILE, _cid_bits

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

# Tiles evaluated at once by the plain versions: bounds their
# (tiles, 512, 128) temporaries to 32 MB each.
_PLAIN_CHUNK = 128

# Kernel launches per wrapper since the last reset_launches(). Counted
# where a wrapper launches its kernel and nowhere else.
launches = {"walk_closest": 0, "walk_any_dest": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(counts, keys, rays, w, occ0=None):
    n_tiles, n_c = keys.shape
    want = {"counts": (counts, (n_tiles,), torch.int32),
            "keys": (keys, (n_tiles, n_c), torch.int32),
            "rays": (rays, (4, n_tiles * TILE), torch.float32),
            "w": (w, (n_c, WEIGHT_PLANES, CLUSTER_SIZE), torch.float32)}
    if occ0 is not None:
        want["occ0"] = (occ0, (n_tiles * TILE,), torch.int32)
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_tiles == 0:
        raise ValueError("no ray tiles")


def _launch(name, counts, keys, rays, w, occ0=None):
    from ceres_tpu_torch.ops import _build

    if rays.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {rays.device}")
    lib = _build.load()
    n_tiles, n_c = keys.shape
    out = torch.empty(n_tiles * TILE, dtype=torch.int32, device=rays.device)
    visits = torch.empty(n_tiles, dtype=torch.int32, device=rays.device)
    ptrs = [counts.data_ptr(), keys.data_ptr(), rays.data_ptr(), w.data_ptr()]
    if occ0 is not None:
        ptrs.append(occ0.data_ptr())
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = getattr(lib, f"ceres_{name}")(
        *ptrs, out.data_ptr(), visits.data_ptr(), n_tiles, n_c,
        (1 << _cid_bits(n_c)) - 1, rays.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.ceres_error_string(err).decode()} ({err})")
    launches[name] += 1
    return out, visits.sum()


def walk_closest(counts, keys, rays, w):
    """Closest hit per ray: (packed slot ids, steps)."""
    _check(counts, keys, rays, w)
    if rays.device.type == "cpu":
        return _walk_closest_plain(counts, keys, rays, w)
    return _launch("walk_closest", counts, keys, rays, w)


def walk_any_dest(counts, keys, rays, w, occ0):
    """Occlusion of each segment from the common origin (t = 0) to its
    receiving point (t = 1): (flags, steps)."""
    _check(counts, keys, rays, w, occ0)
    if rays.device.type == "cpu":
        return _walk_any_dest_plain(counts, keys, rays, w, occ0)
    return _launch("walk_any_dest", counts, keys, rays, w, occ0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _numerators(d, wj):
    """Möller-Trumbore terms of every (ray, triangle) pair.

    d: (3, t, R) directions; wj: (t, 10, C) weight planes. Returns
    (uvw, nd, nt, s) broadcastable to (t, R, C), in the kernel's
    operation order: uvw = min(u, v, det - u - v) * sign(det), the
    barycentric sign test, and nt the t numerator."""
    dx, dy, dz = (d[a][:, :, None] for a in range(3))
    p = [wj[:, i, None, :] for i in range(WEIGHT_PLANES)]
    nu = dx * p[0] + dy * p[1] + dz * p[2]
    nv = dx * p[3] + dy * p[4] + dz * p[5]
    nd = dx * p[6] + dy * p[7] + dz * p[8]
    nt = p[9]
    s = torch.where(nd >= 0, 1.0, -1.0)
    uvw = torch.minimum(torch.minimum(nu * s, nv * s), (nd - nu - nv) * s)
    return uvw, nd, nt, s


def _walk(counts, keys, rays, state, prune_of, visit):
    """The per-tile walk, vectorised over tiles.

    Tiles step k in lockstep; a tile runs visit k while k < count and its
    k-th entry bound (cid bits masked) is within its prune, and once it
    stops it stays done, exactly the kernel's loop. ``state`` is a tuple
    of (n_tiles, R) tensors, updated in place; ``prune_of(tcap, *state)``
    is the per-tile prune and ``visit(cid, d, *state)`` the new state of
    the visiting tiles. Returns the executed visits (0-dim int64).
    """
    n_tiles, n_c = keys.shape
    cmask = (1 << _cid_bits(n_c)) - 1
    d = rays[:3].reshape(3, n_tiles, TILE)
    tcap = rays[3].view(torch.int32).reshape(n_tiles, TILE)
    prune = prune_of(tcap, *state)
    done = torch.zeros(n_tiles, dtype=torch.bool, device=keys.device)
    visits = torch.zeros(n_tiles, dtype=torch.int64, device=keys.device)
    for k in range(int(counts.max())):
        key_k = keys[:, k]
        run = ~done & (k < counts) & ((key_k & ~cmask) <= prune)
        done |= ~run
        tiles = run.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        visits[tiles] += 1
        for ch in tiles.split(_PLAIN_CHUNK):
            cid = key_k[ch] & cmask
            new = visit(cid, d[:, ch], *(x[ch] for x in state))
            for x, y in zip(state, new):
                x[ch] = y
            prune[ch] = prune_of(tcap[ch], *new)
    return visits.sum()


def _walk_closest_plain(counts, keys, rays, w):
    """Plain version of the closest kernel: per ray the best t key, ties
    to the lower lane and the earlier cluster."""
    n_rays = rays.shape[1]
    lane = torch.arange(CLUSTER_SIZE, dtype=torch.int32, device=keys.device)
    best = torch.full((n_rays // TILE, TILE), _BIG_CLEAN_I, dtype=torch.int32,
                      device=keys.device)
    pid = torch.full_like(best, -1)

    def prune_of(tcap, best, pid):
        return torch.minimum(best, tcap).amax(dim=1) + _PRUNE_PAD

    def visit(cid, d, best, pid):
        uvw, nd, nt, s = _numerators(d, w[cid.long()])
        ok = (torch.minimum(uvw, nt * s) >= 0) & (nd != 0)
        t = torch.where(ok, nt * torch.reciprocal(nd), _BIG_CLEAN)
        kmin = ((t.view(torch.int32) & ~_IMASK) | lane).amin(dim=2)
        t_new = kmin & ~_IMASK
        better = t_new < best
        return (torch.where(better, t_new, best),
                torch.where(better, cid[:, None] * CLUSTER_SIZE
                            + (kmin & _IMASK), pid))

    steps = _walk(counts, keys, rays, (best, pid), prune_of, visit)
    return pid.reshape(-1), steps


def _walk_any_dest_plain(counts, keys, rays, w, occ0):
    """Plain version of the shadow kernel: per ray, any occluder between
    the origin (t = 0) and the receiver (t = 1 - _DEST_EPS)."""
    occ = occ0.reshape(-1, TILE).clone()

    def prune_of(tcap, occ):
        return torch.where(occ > 0, _NEG_I, tcap).amax(dim=1) + _PRUNE_PAD

    def visit(cid, d, occ):
        uvw, nd, nt, s = _numerators(d, w[cid.long()])
        win = ((nt - _DEST_SCALE * nd) * s <= 0) & (nt * s >= 0)
        ok = (uvw >= 0) & (nd != 0) & win
        return (occ | ok.any(dim=2).to(torch.int32),)

    steps = _walk(counts, keys, rays, (occ,), prune_of, visit)
    return occ.reshape(-1), steps

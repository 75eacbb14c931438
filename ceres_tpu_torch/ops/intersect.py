"""Möller-Trumbore ray-triangle intersection as a matrix product, and the
brute-force oracle (counterpart of ``ceres_tpu/ops/intersect.py``).

The reference evaluates Möller-Trumbore per (ray, triangle) pair:

    c = p0 - o;  r = d x c;  det = n . d
    u = (r . e2) / det;  v = (r . e1) / det;  t = (n . c) / det
    accept iff u >= 0, v >= 0, 1-u-v >= 0 and tmin <= t <= tmax.

Every numerator is bilinear in per-ray and per-triangle quantities
(r . e2 = d.(p0 x e2) - (d x o).e2 and n . c = n.p0 - n.o), so with the
per-ray features f = [d, d x o, o, 1] and a per-triangle (10, 4) weight
matrix with output channels (u_num, v_num, det, t_num), all numerators
of R rays x T triangles are one (R, 10) @ (10, 4T) product. Rays from a
common origin shift the world by it, and f collapses to [d, 1]; generic
rays shift by a scene reference point to keep |o| small.

``backend="bruteforce"`` renders with these: no acceleration structure,
O(R x T), the all-pairs oracle. The product is ``torch.matmul`` in full
float32 whatever the caller's matmul precision (TF32 is as coarse as the
bf16 the JAX package rules out), chunked over rays so that a chunk's
(chunk, T, 4) numerators stay small.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from ceres_tpu_torch.models.mesh import TriangleSoup, cross

# Pairs (rays x triangles) of one brute-force chunk at most: bounds the
# (chunk, T, 4) numerators and the decode temporaries to ~64 MB each.
_CHUNK_PAIRS = 1 << 22


@dataclasses.dataclass(frozen=True)
class Hit:
    """Closest hits of a wavefront; every field is (R,)."""

    t: torch.Tensor        # inf at misses
    u: torch.Tensor        # barycentric of p1, 0 at misses
    v: torch.Tensor        # barycentric of p2, 0 at misses
    prim_id: torch.Tensor  # original triangle id, 0 at misses
    mask: torch.Tensor     # bool, True where the ray hit


@contextlib.contextmanager
def full_fp32_matmul():
    """float32 matrix products in full float32 inside the block (no TF32
    on the card, no bf16 passes on the CPU), whatever the caller set."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def ray_features(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Generic per-ray feature vectors, (R, 10): [d, d x o, o, 1]."""
    ones = torch.ones(origins.shape[:-1] + (1,), dtype=origins.dtype,
                      device=origins.device)
    return torch.cat([dirs, cross(dirs, origins), origins, ones], dim=-1)


def ray_features_common_origin(dirs: torch.Tensor) -> torch.Tensor:
    """Feature vectors of rays from the (shifted) world origin: [d, 1]."""
    ones = torch.ones(dirs.shape[:-1] + (1,), dtype=dirs.dtype,
                      device=dirs.device)
    return torch.cat([dirs, ones], dim=-1)


def _dot_last(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def triangle_weights(soup: TriangleSoup,
                     origin_shift: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Per-triangle weight matrices, (T, 10, 4): rows are the features
    [d, d x o, o, 1], channels u_num, v_num, det, t_num. Ray origins given
    to :func:`ray_features` must be shifted by the same ``origin_shift``.
    Differentiable with respect to the soup."""
    p0 = soup.p0 if origin_shift is None else soup.p0 - origin_shift
    e1, e2, n = soup.e1, soup.e2, soup.n
    zeros3 = torch.zeros_like(p0)
    zeros1 = torch.zeros_like(p0[:, :1])
    w_u = torch.cat([cross(p0, e2), -e2, zeros3, zeros1], dim=-1)   # (T, 10)
    w_v = torch.cat([cross(p0, e1), -e1, zeros3, zeros1], dim=-1)
    w_det = torch.cat([n, zeros3, zeros3, zeros1], dim=-1)
    w_t = torch.cat([zeros3, zeros3, -n, _dot_last(n, p0)[:, None]], dim=-1)
    return torch.stack([w_u, w_v, w_det, w_t], dim=-1)


def triangle_weights_common_origin(soup: TriangleSoup,
                                   origin: torch.Tensor) -> torch.Tensor:
    """Weight matrices of rays that all start at ``origin``, (T, 4, 4):
    features [d, 1], u_num = d.(p0' x e2), v_num = d.(p0' x e1),
    det = d.n, t_num = n.p0' with p0' = p0 - origin."""
    p0 = soup.p0 - origin
    n = soup.n
    zeros1 = torch.zeros_like(p0[:, :1])
    w_u = torch.cat([cross(p0, soup.e2), zeros1], dim=-1)           # (T, 4)
    w_v = torch.cat([cross(p0, soup.e1), zeros1], dim=-1)
    w_det = torch.cat([n, zeros1], dim=-1)
    w_t = torch.cat([torch.zeros_like(p0), _dot_last(n, p0)[:, None]], dim=-1)
    return torch.stack([w_u, w_v, w_det, w_t], dim=-1)


def mt_numerators(features: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(R, K) features x (T, K, 4) weights -> (R, T, 4) numerators, one
    full-float32 matrix product."""
    T, K, _ = weights.shape
    flat = weights.permute(1, 0, 2).reshape(K, T * 4)
    with full_fp32_matmul():
        out = torch.matmul(features, flat)
    return out.reshape(features.shape[0], T, 4)


def decode_hits(numerators: torch.Tensor, tmin, tmax,
                valid: Optional[torch.Tensor] = None):
    """Per-pair accept mask and t/u/v from (..., 4) numerators.

    Returns (t, u, v, accept), t = +inf for rejected pairs. Comparisons
    with NaN are false, so NaN pairs reject, as in the reference. det == 0
    rejects, and the double ``where`` keeps every intermediate finite for
    autograd."""
    u_num, v_num, det, t_num = numerators.unbind(-1)
    degenerate = det == 0
    det_safe = torch.where(degenerate, 1.0, det)
    inv_det = torch.where(degenerate, 0.0, 1.0 / det_safe)
    u = u_num * inv_det
    v = v_num * inv_det
    t = t_num * inv_det
    w = 1.0 - u - v
    accept = ((u >= 0) & (v >= 0) & (w >= 0) & (t >= tmin) & (t <= tmax)
              & ~degenerate)
    if valid is not None:
        accept = accept & valid
    return torch.where(accept, t, torch.inf), u, v, accept


def _window(x, dtype, device, top):
    """A scalar or per-ray ((R,) or (R, 1)) window bound as a tensor that
    broadcasts against (R, T); ``top`` clamps +inf to the largest finite
    value, as the JAX package does."""
    x = torch.as_tensor(x, dtype=dtype, device=device)
    if top:
        x = torch.minimum(x, torch.tensor(torch.finfo(dtype).max,
                                          dtype=dtype, device=device))
    return x.reshape(-1, 1) if x.ndim else x


def _chunks(R, T, chunk):
    """Ray ranges of at most ``chunk`` rays and _CHUNK_PAIRS pairs."""
    step = max(1, min(chunk, _CHUNK_PAIRS // max(T, 1)))
    return [(i, min(i + step, R)) for i in range(0, R, step)]


def _rows(x, i, j):
    return x[i:j] if x.ndim else x


def closest_hit_bruteforce(features: torch.Tensor, weights: torch.Tensor,
                           tmin=0.0, tmax=float("inf"),
                           chunk: int = 2048) -> Hit:
    """Closest hit of R rays against all T triangles (no acceleration):
    the correctness and gradient reference. ``tmin``/``tmax`` are scalars
    or per-ray; rays run in chunks of at most ``chunk``. The winner is the
    first triangle at the smallest t; ``prim_id`` is 0 at misses."""
    R, T = features.shape[0], weights.shape[0]
    lo = _window(tmin, features.dtype, features.device, top=False)
    hi = _window(tmax, features.dtype, features.device, top=True)
    parts = []
    for i, j in _chunks(R, T, chunk):
        t, u, v, _ = decode_hits(mt_numerators(features[i:j], weights),
                                 _rows(lo, i, j), _rows(hi, i, j))
        prim = torch.argmin(t, dim=-1, keepdim=True)
        parts.append([x.gather(1, prim)[:, 0] for x in (t, u, v)]
                     + [prim[:, 0].to(torch.int32)])
    t, u, v, prim = (torch.cat(c) for c in zip(*parts))
    return Hit(t=t, u=u, v=v, prim_id=prim, mask=torch.isfinite(t))


def any_hit_bruteforce(features: torch.Tensor, weights: torch.Tensor,
                       tmin=0.0, tmax=float("inf"),
                       chunk: int = 2048) -> torch.Tensor:
    """Occlusion: (R,) bool, True where a ray hits any triangle with t in
    [tmin, tmax]."""
    R, T = features.shape[0], weights.shape[0]
    lo = _window(tmin, features.dtype, features.device, top=False)
    hi = _window(tmax, features.dtype, features.device, top=True)
    return torch.cat([
        decode_hits(mt_numerators(features[i:j], weights), _rows(lo, i, j),
                    _rows(hi, i, j))[3].any(dim=-1)
        for i, j in _chunks(R, T, chunk)])

"""Sphere primitives: batched ray-sphere intersection (counterpart of
``ceres_tpu/ops/sphere.py``: ``SphereHit``, ``intersect_pairs``,
``closest_hit``, ``any_hit``, ``normal_at``, ``_pairs_cols``,
``closest_hit_common_origin_cols``, ``any_hit_cols``).

The reference's sphere: the quadratic with normalised directions, oc =
o - c, b = oc.d, disc = b^2 - (|oc|^2 - r^2), roots -b -+ sqrt(disc); the
near root in [tmin, tmax] is taken, else the far one. A scene holds few
spheres next to its triangles, so every (ray, sphere) pair is evaluated
densely in plain torch. Differentiable with respect to centres, radii
and rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SphereHit(NamedTuple):
    t: torch.Tensor          # (R,) hit distance, +inf on a miss
    sphere_id: torch.Tensor  # (R,) int32
    mask: torch.Tensor       # (R,) bool


def _accept(b, c, tmin, tmax):
    """(R, S) accepted root of t^2 + 2bt + c = 0, +inf where none."""
    disc = b * b - c
    ok = disc >= 0
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    t_near = -b - sq
    t_far = -b + sq
    t = torch.where(t_near >= tmin, t_near, t_far)
    accept = ok & (t >= tmin) & (t <= tmax)
    return torch.where(accept, t, torch.inf)


def intersect_pairs(origins, dirs, centers, radii, tmin=0.0,
                    tmax=float("inf")):
    """All (ray, sphere) hit distances, (R, S), +inf where missed."""
    oc = origins[:, None, :] - centers[None, :, :]          # (R, S, 3)
    b = (oc * dirs[:, None, :]).sum(dim=-1)
    c = (oc * oc).sum(dim=-1) - radii[None, :] ** 2
    return _accept(b, c, tmin, tmax)


def closest_hit(origins, dirs, centers, radii, tmin=0.0,
                tmax=float("inf")) -> SphereHit:
    """The closest sphere of each ray."""
    t = intersect_pairs(origins, dirs, centers, radii, tmin, tmax)
    t_best, sid = t.min(dim=-1)
    return SphereHit(t=t_best, sphere_id=sid.to(torch.int32),
                     mask=torch.isfinite(t_best))


def any_hit(origins, dirs, centers, radii, tmin=0.0, tmax=float("inf")):
    """Occlusion of each ray by any sphere."""
    t = intersect_pairs(origins, dirs, centers, radii, tmin, tmax)
    return torch.isfinite(t).any(dim=-1)


def normal_at(point, centers, sphere_id):
    """Outward unit normal of the hit sphere at ``point``."""
    d = point - centers[sphere_id.long()]
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _window(x, like):
    """A scalar or (R,) bound, broadcastable against (R, S)."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x[:, None] if x.dim() == 1 else x


def _pairs_cols(o_cols, d_cols, centers, radii, tmin, tmax):
    """(R, S) accepted hit distances from per-ray column origins and
    directions; ``tmin``/``tmax`` scalars or (R,) columns."""
    b = c = None
    for a in range(3):
        oc = o_cols[a][:, None] - centers[None, :, a]       # (R, S)
        ocd = oc * d_cols[a][:, None]
        b = ocd if b is None else b + ocd
        c = oc * oc if c is None else c + oc * oc
    c = c - radii[None, :] ** 2
    return _accept(b, c, _window(tmin, b), _window(tmax, b))


def closest_hit_common_origin_cols(eye, dir_cols, centers, radii, tmin=0.0,
                                   tmax=float("inf")):
    """Closest sphere of column rays from one ``eye``: (t (R,), mask
    (R,), sphere_id (R,) int32, the 3-tuple of outward unit-normal
    columns at the hit points, zero at misses)."""
    R = dir_cols[0].shape[0]
    o_cols = tuple(eye[a].expand(R) for a in range(3))
    t = _pairs_cols(o_cols, dir_cols, centers, radii, tmin, tmax)
    t_best, sid = t.min(dim=-1)
    mask = torch.isfinite(t_best)
    # The winner's centre and radius: the JAX package takes them by a
    # one-hot matvec (a TPU layout choice); a gather gives the same values.
    cg = centers[sid]
    rg = torch.clamp(radii[sid], min=1e-30)
    t_safe = torch.where(mask, t_best, 0.0)
    nrm = tuple(torch.where(mask, (eye[a] + t_safe * dir_cols[a] - cg[:, a])
                            / rg, 0.0) for a in range(3))
    return t_best, mask, sid.to(torch.int32), nrm


def any_hit_cols(o_cols, d_cols, centers, radii, tmin=0.0, tmax=float("inf")):
    """Occlusion of column rays by any sphere; ``tmin``/``tmax`` may be
    per-ray (R,) columns (segment shadow tests)."""
    t = _pairs_cols(o_cols, d_cols, centers, radii, tmin, tmax)
    return torch.isfinite(t).any(dim=-1)

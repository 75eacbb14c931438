"""Shading models: Lambertian, Blinn-Phong and Gouraud smooth shading, and
the flat |normal| visualisation (counterpart of
``ceres_tpu/models/shading.py``).

The reference shading constants: ambient 0.2, diffuse 0.5 * |dot(sun, n)|,
specular 0.8 * dot(n, normalize(sun + view))^24, channel tint
(0.5, 0.0, 0.8) on (ambient + diffuse) only, clamp to [0, 1] per corner,
then a blend of the three corners. The (..., 3) forms serve the dense
brute-force path; the column forms (3-tuples of (R,) columns) the
cluster walk's.
"""

from __future__ import annotations

import torch

AMBIENT = 0.2
DIFFUSE_GAIN = 0.5
SPECULAR_GAIN = 0.8
SPECULAR_EXP = 24
TINT = (0.5, 0.0, 0.8)


def _integer_pow(x, n: int):
    """x ** n by repeated squaring, in the order XLA's integer power
    multiplies (x^24 = x^8 * x^16), so the roundings match."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def lambertian(sun_line: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """|dot(sun_line, normal)|, (..., 3) -> (...)."""
    return torch.abs(torch.sum(sun_line * normal, dim=-1))


def blinn_phong_spec(sun_line: torch.Tensor, normal: torch.Tensor,
                     view: torch.Tensor) -> torch.Tensor:
    """dot(normal, normalize(sun_line + view))^24; the even exponent makes
    negative bases positive, as the reference's std::pow does."""
    h = _normalize(sun_line + view)
    return _integer_pow(torch.sum(normal * h, dim=-1), SPECULAR_EXP)


def corner_shade(sun_line: torch.Tensor, normal: torch.Tensor,
                 view: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB of one corner normal before the barycentric blend;
    ``view`` is the negated primary-ray direction."""
    diffuse = DIFFUSE_GAIN * lambertian(sun_line, normal)
    specular = SPECULAR_GAIN * blinn_phong_spec(sun_line, normal, view)
    base = AMBIENT + diffuse
    tint = torch.as_tensor(TINT, dtype=base.dtype, device=base.device)
    return torch.clamp(base[..., None] * tint + specular[..., None], 0.0, 1.0)


def _corner_weights(u, v, reference_compat: bool):
    """Weights of corners (0, 1, 2): the true barycentrics (1-u-v, u, v),
    or the reference's (u, v, 1-u-v) with ``reference_compat``."""
    w = 1.0 - u - v
    return (u, v, w) if reference_compat else (w, u, v)


def smooth_shading(sun_line, corner_normals, view, u, v,
                   reference_compat: bool = False):
    """Gouraud smooth shading, (..., 3) forms: ``corner_normals``
    (..., 3, 3) holds the normals of corners 0, 1, 2; ``view`` is the
    primary-ray direction (not negated)."""
    neg_view = -view
    cs = [corner_shade(sun_line, corner_normals[..., k, :], neg_view)
          for k in range(3)]
    w0, w1, w2 = _corner_weights(u, v, reference_compat)
    return w0[..., None] * cs[0] + w1[..., None] * cs[1] + w2[..., None] * cs[2]


def flat_shading(normal: torch.Tensor) -> torch.Tensor:
    """|normalize(face normal)|: the reference's flat visualisation."""
    return torch.abs(_normalize(normal))


# ---------------------------------------------------------------------------
# Column forms: 3-tuples of (R,) columns
# ---------------------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize3(v, guard=None):
    """Normalised columns; ``guard`` masks rows whose length may be zero
    (misses, padding) to keep NaNs out of the result and its gradient."""
    sq = _dot3(v, v)
    if guard is not None:
        sq = torch.where(guard, sq, 1.0)
    inv = torch.rsqrt(sq)
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _corner_shade_cols(sun, n, neg_view):
    """Colour of one corner normal before the barycentric blend:
    3x (R,) -> 3x (R,) RGB."""
    lamb = torch.abs(_dot3(sun, n))
    h = _normalize3((sun[0] + neg_view[0], sun[1] + neg_view[1],
                     sun[2] + neg_view[2]))
    spec = SPECULAR_GAIN * _integer_pow(_dot3(n, h), SPECULAR_EXP)
    base = AMBIENT + DIFFUSE_GAIN * lamb
    return tuple(torch.clamp(base * TINT[a] + spec, 0.0, 1.0)
                 for a in range(3))


def smooth_shading_cols(sun_line, corner_cols, view, u, v,
                        reference_compat: bool = False):
    """Gouraud smooth shading.

    sun_line/view: 3-tuples of (R,); corner_cols: 9 (R,) corner-normal
    columns [n0 | n1 | n2]. Corner weights are the true barycentrics
    (1-u-v, u, v), or the reference's (u, v, 1-u-v) with
    ``reference_compat``. Returns a 3-tuple of (R,) RGB columns.
    """
    neg_view = (-view[0], -view[1], -view[2])
    cs = [_corner_shade_cols(sun_line, tuple(corner_cols[3 * k:3 * k + 3]),
                             neg_view)
          for k in range(3)]
    w0, w1, w2 = _corner_weights(u, v, reference_compat)
    return tuple(w0 * cs[0][a] + w1 * cs[1][a] + w2 * cs[2][a]
                 for a in range(3))


def flat_shading_cols(n, guard=None):
    """flat_shading in column form: |normalize(n)| per column."""
    return tuple(torch.abs(c) for c in _normalize3(n, guard=guard))

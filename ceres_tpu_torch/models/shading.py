"""Gouraud smooth shading in column form (counterpart of
``ceres_tpu/models/shading.py``).

The reference shading constants: ambient 0.2, diffuse 0.5 * |dot(sun, n)|,
specular 0.8 * dot(n, normalize(sun + view))^24, channel tint
(0.5, 0.0, 0.8) on (ambient + diffuse) only, clamp to [0, 1] per corner,
then a blend of the three corners. Rays are 3-tuples of (R,) columns.
"""

from __future__ import annotations

import torch

AMBIENT = 0.2
DIFFUSE_GAIN = 0.5
SPECULAR_GAIN = 0.8
SPECULAR_EXP = 24
TINT = (0.5, 0.0, 0.8)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize3(v):
    inv = torch.rsqrt(_dot3(v, v))
    return (v[0] * inv, v[1] * inv, v[2] * inv)


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


def smooth_shading_cols(sun_line, corner_cols, view, u, v):
    """Gouraud smooth shading.

    sun_line/view: 3-tuples of (R,); corner_cols: 9 (R,) corner-normal
    columns [n0 | n1 | n2]. Corner weights are the true barycentrics
    (1-u-v, u, v), the JAX package's default; its ``reference_compat``
    weights wait for ROADMAP item M8. Returns a 3-tuple of (R,) RGB
    columns.
    """
    neg_view = (-view[0], -view[1], -view[2])
    cs = [_corner_shade_cols(sun_line, tuple(corner_cols[3 * k:3 * k + 3]),
                             neg_view)
          for k in range(3)]
    w = 1.0 - u - v
    return tuple(w * cs[0][a] + u * cs[1][a] + v * cs[2][a]
                 for a in range(3))

"""Morton (Z-order) codes in torch (counterpart of
``ceres_tpu/accel/morton.py``).

10 bits per axis interleaved into a 30-bit code by log-step mask
splits, and the world -> grid quantisation (grid 2^10 per axis, clamped).
Codes and orders are equal to the JAX package's: the quantisation is
the same f32 operations, the bit work is exact in int64, and the order
is a *stable* argsort, so the many tied codes of a big mesh keep their
index order as ``jnp.argsort`` keeps it.
"""

from __future__ import annotations

import torch

from ceres_tpu_torch.utils import minmax

GRID_BITS = 10  # 10 bits per axis -> 30-bit codes, fit int32
GRID_DIM = 1 << GRID_BITS


def part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` so each lands every 3rd position
    (int64 out)."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_encode(ix, iy, iz) -> torch.Tensor:
    """Interleave three 10-bit grid coordinates into a 30-bit Z-order
    code: x in bit 0, y in bit 1, z in bit 2 of each triple. int32."""
    code = part1by2(ix) | (part1by2(iy) << 1) | (part1by2(iz) << 2)
    return code.to(torch.int32)


def quantize(points: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """World-space points -> int32 grid coordinates in [0, GRID_DIM).
    Degenerate extents (flat scenes) map to coordinate 0 on that axis."""
    extent = hi - lo
    # A tensor numerator: ``number / tensor`` is reciprocal-then-multiply
    # in torch, not one division.
    grid = extent.new_tensor(float(GRID_DIM))
    scale = torch.where(extent > 0, grid / extent, 0.0)
    g = (points - lo) * scale
    return g.to(torch.int32).clamp(0, GRID_DIM - 1)


def morton_codes(points: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Morton codes (N,) int32 of (N, 3) points inside the box [lo, hi]."""
    g = quantize(points, lo, hi)
    return morton_encode(g[:, 0], g[:, 1], g[:, 2])


def morton_order(points: torch.Tensor) -> torch.Tensor:
    """Stable argsort of points along the Z-order curve of their own
    bounding box, (N,) int32. Detached: gradients never flow through an
    order."""
    pts = points.detach()
    codes = morton_codes(pts, minmax.amin(pts, 0), minmax.amax(pts, 0))
    return torch.argsort(codes, stable=True).to(torch.int32)

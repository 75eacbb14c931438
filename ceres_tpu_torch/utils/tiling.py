"""Pixel-block swizzling (counterpart of ``ceres_tpu/utils/tiling.py``).

Ray tiles must be spatially coherent for cluster culling to bite: a
32 x 32 pixel block holds two 512-ray walk tiles, each a compact 16 x 32
screen region. Pure reshape/permute; the inverse restores raster order.
The (H, W) plane forms serve the column pipeline, the (H, W, C) forms
the row renders of ``parallel.sharded``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE_H = 32
TILE_W = 32


def pad_hw(x: torch.Tensor, th: int = TILE_H,
           tw: int = TILE_W) -> torch.Tensor:
    """Zero-pad (H, W, ...) so both dimensions are tile multiples."""
    H, W = x.shape[:2]
    pad = [0, 0] * (x.dim() - 2) + [0, (-W) % tw, 0, (-H) % th]
    return F.pad(x, pad) if any(pad) else x


def swizzle(x: torch.Tensor, th: int = TILE_H,
            tw: int = TILE_W) -> torch.Tensor:
    """(H, W, C) -> (n_tiles * th * tw, C) in pixel-block order,
    zero-padded (zero rays are inert)."""
    x = pad_hw(x, th, tw)
    H, W, C = x.shape
    x = x.reshape(H // th, th, W // tw, tw, C)
    return x.permute(0, 2, 1, 3, 4).reshape(-1, C)


def unswizzle(x: torch.Tensor, height: int, width: int, th: int = TILE_H,
              tw: int = TILE_W) -> torch.Tensor:
    """Inverse of swizzle: (n_rays, C) -> (height, width, C)."""
    Hp = height + (-height) % th
    Wp = width + (-width) % tw
    C = x.shape[-1]
    x = x.reshape(Hp // th, Wp // tw, th, tw, C)
    x = x.permute(0, 2, 1, 3, 4).reshape(Hp, Wp, C)
    return x[:height, :width]


def swizzle_plane(x: torch.Tensor, th: int = TILE_H,
                  tw: int = TILE_W) -> torch.Tensor:
    """(H, W) scalar plane -> (n_rays,) in pixel-block order, zero-padded
    so both dimensions are tile multiples (zero rays are inert)."""
    H, W = x.shape
    x = F.pad(x, (0, (-W) % tw, 0, (-H) % th))
    H, W = x.shape
    x = x.reshape(H // th, th, W // tw, tw)
    return x.permute(0, 2, 1, 3).reshape(-1)


def unswizzle_plane(x: torch.Tensor, height: int, width: int,
                    th: int = TILE_H, tw: int = TILE_W) -> torch.Tensor:
    """Inverse of swizzle_plane: (n_rays,) -> (height, width)."""
    Hp = height + (-height) % th
    Wp = width + (-width) % tw
    x = x.reshape(Hp // th, Wp // tw, th, tw)
    x = x.permute(0, 2, 1, 3).reshape(Hp, Wp)
    return x[:height, :width]

"""XLA's float min and max in torch.

XLA orders -0 below +0: ``minimum(-0, +0)`` is -0 and ``maximum(-0, +0)``
is +0 in either argument order, and its reductions and min/max scatters
follow the same rule. torch's ``minimum``/``maximum`` keep whichever
zero comes first, and its reductions leave the choice open. The port
bit-casts bounds into sort keys and compares entry bounds as int bits,
so the sign of a zero matters: every min and max that the JAX package
takes on such values goes through this module.

``ordered`` maps f32 to int32, and f64 to int64, so that signed int
order is that total order (negative patterns get their magnitude bits
flipped). A float reduction or scatter-min over the keys is then an
exact integer one, in any order. There are no NaNs on these paths.
"""

from __future__ import annotations

import torch


def fmax(a, b):
    """torch.maximum with XLA's signed zeros."""
    both0 = (a == 0) & (b == 0)
    return torch.where(both0, a + b, torch.maximum(a, b))


def fmin(a, b):
    """torch.minimum with XLA's signed zeros."""
    both0 = (a == 0) & (b == 0)
    return torch.where(both0, -((-a) + (-b)), torch.minimum(a, b))


# float dtype -> (its int key dtype, the sign bit's shift, magnitude mask)
_KEYS = {torch.float32: (torch.int32, 31, 0x7FFFFFFF),
         torch.float64: (torch.int64, 63, 0x7FFFFFFFFFFFFFFF)}
_FLOATS = {torch.int32: torch.float32, torch.int64: torch.float64}


def ordered(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 (f64 -> int64) key whose signed order is XLA's float
    order."""
    key, shift, mask = _KEYS[x.dtype]
    bits = x.contiguous().view(key)
    return bits ^ ((bits >> shift) & mask)


def from_ordered(k: torch.Tensor) -> torch.Tensor:
    """Inverse of ``ordered``."""
    _, shift, mask = _KEYS[_FLOATS[k.dtype]]
    return (k ^ ((k >> shift) & mask)).view(_FLOATS[k.dtype])


def amin(x: torch.Tensor, dim: int) -> torch.Tensor:
    return from_ordered(ordered(x).amin(dim=dim))


def amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return from_ordered(ordered(x).amax(dim=dim))

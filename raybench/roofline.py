"""The least time one card could take for a walk: the larger of its
operations over the card's fp32 peak and its bytes over its memory
bandwidth.

A frozen copy of ``chip_smoke.py``'s ``FLOPS_PER_PAIR``, ``PEAK_FLOPS``,
``PEAK_BYTES`` and ``bound()``, with the executed visits taken from the
plain walk (``walkcount.py``) instead of the kernel's report.
"""

from __future__ import annotations

# fp32 operations per ray-triangle pair of a visit, counted from
# ops/csrc/walk.cu (every multiply, add, min and comparison on every
# pair): the numerators, 15 (33 for generic rays), the sign test, 8, and
# the mode's accept, 4 (closest, any) or 8 (any_dest).
FLOPS_PER_PAIR = {"closest": 27, "closest_window": 27, "any_dest": 31,
                  "any": 45}
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): fp32 outside
# the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound(mode, args, opts, visits: int, pairs: int):
    """(seconds, "operations" or "bytes") for a walk of ``visits``
    executed block visits that tests ``pairs`` pairs. Bytes: the ray
    rows, counts, keys, start flags and two-level inputs read once, each
    visit's weight block, and the outputs written once."""
    counts, keys, rays, w = args[:4]
    inputs = [counts, keys, rays, *args[4:]]
    inputs += [opts[k] for k in ("hull", "bbox", "first")
               if opts.get(k) is not None]
    nbytes = (sum(x.numel() * x.element_size() for x in inputs)
              + visits * w[0].numel() * 4 + rays.shape[1] * 4
              + counts.numel() * 4)
    t_ops = pairs * FLOPS_PER_PAIR[mode] / PEAK_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

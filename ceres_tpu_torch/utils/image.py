"""Image output: binary PPM (P6) and PNG (counterpart of
``ceres_tpu/utils/image.py``, a NumPy copy: the JAX package imports
``jax`` when any of its modules is imported).

The reference's PPM writer: rows from j = height - 1 down to 0 (a
vertical flip), channels clamped to [0, 1] and scaled by 255. Both
writers give the JAX package's bytes for the same array.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(image: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0)
            * 255.0).astype(np.uint8)


def write_ppm(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) float image as binary P6 PPM, flipped
    vertically like the reference."""
    data = to_uint8(image)[::-1]  # rows j = H-1 .. 0
    h, w = data.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6 {w} {h} 255\n".encode())
        fh.write(data.tobytes())


def write_png(path: str, image: np.ndarray, flip: bool = True) -> None:
    """Write an (H, W, 3) float image as PNG (zlib, no image library)."""
    data = to_uint8(image)
    if flip:
        data = data[::-1]
    h, w = data.shape[:2]
    raw = b"".join(b"\x00" + data[row].tobytes() for row in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", header))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def write_image(path: str, image: np.ndarray) -> None:
    if path.endswith(".ppm"):
        write_ppm(path, image)
    elif path.endswith(".png"):
        write_png(path, image)
    else:
        raise ValueError(f"unsupported image format: {path}")

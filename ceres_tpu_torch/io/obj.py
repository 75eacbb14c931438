"""Wavefront OBJ loader (counterpart of ``ceres_tpu/io/obj.py``).

A copy of the JAX package's pure-Python parser, not an import of it:
``ceres_tpu`` imports ``jax`` at package import, and the port must run
where JAX is not installed. Same behaviour:

  * only ``v`` and ``f`` records are honoured; ``i/j/k`` face tokens keep
    the vertex index (the first field) only;
  * faces with more than three vertices are triangulated as a fan around
    the first vertex: (v0, v1, v2), (v0, v2, v3), ...;
  * negative indices are relative to the current end of the vertex list,
    positive indices are 1-based.

Returns numpy arrays; the soup and normals are built in torch
(``ceres_tpu_torch.models.mesh``).
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np


def _parse_index(token: str, num_vertices: int) -> int:
    """Resolve one face token 'i', 'i/j', 'i//k' or 'i/j/k' to a 0-based index."""
    idx = int(token.split("/", 1)[0])
    return num_vertices + idx if idx < 0 else idx - 1


def parse_obj(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse OBJ text into ((V,3) float32 vertices, (F,3) int32 faces)."""
    vertices: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] == "#":
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "f":
            nv = len(vertices)
            idx = [_parse_index(tok, nv) for tok in parts[1:]]
            for k in range(2, len(idx)):
                faces.append((idx[0], idx[k - 1], idx[k]))
    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    f = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    return v, f


def load_obj(path_or_file: Union[str, io.TextIOBase]) -> tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file (path or text stream) -> (vertices, faces) numpy arrays."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "r") as fh:
            return parse_obj(fh.read())
    return parse_obj(path_or_file.read())

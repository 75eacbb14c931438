"""The benchmark's inputs, made without the port: the mesh from its OBJ
file, the subdivided mesh, the camera, the seeded sun path and the
seeded vertex noise.

``parse_obj`` and ``subdivide`` are frozen copies of the algorithms of
``ceres_tpu_torch/io/obj.py`` (``parse_obj``) and
``ceres_tpu_torch/models/mesh.py`` (``subdivide``): the benchmark makes
the mesh itself and hands the same arrays to the port and the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def parse_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """((V, 3) float32 vertices, (F, 3) int32 faces) of an OBJ file: only
    ``v`` and ``f`` records, the first field of ``i/j/k`` tokens, faces
    of more than three vertices as a fan, negative indices relative to
    the end of the vertex list."""
    vertices, faces = [], []
    with open(path) as fh:
        for raw in fh:
            parts = raw.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                vertices.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f":
                n = len(vertices)
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/", 1)[0])
                    idx.append(n + i if i < 0 else i - 1)
                faces += [(idx[0], idx[k - 1], idx[k])
                          for k in range(2, len(idx))]
    return (np.asarray(vertices, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))


def subdivide(v: np.ndarray, f: np.ndarray, levels: int):
    """Midpoint (1 -> 4) subdivision, ``levels`` times; shared edges get
    shared midpoints."""
    dtype = v.dtype
    for _ in range(levels):
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0,
                              return_inverse=True)
        inv = inv.reshape(-1)
        mids = 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])
        m01, m12, m20 = (inv[k * len(f):(k + 1) * len(f)] + len(v)
                         for k in range(3))
        v = np.concatenate([v, mids])
        f = np.concatenate([np.stack([f[:, 0], m01, m20], 1),
                            np.stack([m01, f[:, 1], m12], 1),
                            np.stack([m20, m12, f[:, 2]], 1),
                            np.stack([m01, m12, m20], 1)]).astype(f.dtype)
    return v.astype(dtype), f


def mesh(cfg: dict, root: str) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's mesh as the reference takes it."""
    v, f = parse_obj(os.path.join(root, cfg["mesh"]))
    return subdivide(v, f, cfg.get("subdivide", 0))


def camera(cfg: dict, v: np.ndarray) -> dict:
    """eye, dir, up, fov of the configuration: ``look_at`` "centroid"
    aims at the vertices' mean, as ``bench.py`` does."""
    eye = np.asarray(cfg["eye"], np.float32)
    target = (v.mean(axis=0) if cfg["look_at"] == "centroid"
              else np.asarray(cfg["look_at"], np.float32))
    return {"eye": eye, "dir": (target - eye).astype(np.float32),
            "up": np.asarray(cfg["up"], np.float32),
            "fov": np.float32(cfg["fov"])}


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any whole number
    below 2**64)."""
    return torch.Generator(device=device).manual_seed(seed % 2**64)


def sun_path(cfg: dict, traffic: dict, seed: int, device):
    """(n, 3) float32 suns, n = ``sun_path``: ``bench.py``'s path, the
    configuration's sun plus k ``sun_step`` on every axis for k in [0,
    n), in an order drawn from the seed. Every seed renders the same
    suns: the frame's cost depends on where the sun is (about 1 in 4 more
    on the 4x bunny while the sun lies within the mesh's z range)."""
    n = traffic["sun_path"]
    k = torch.randperm(n, generator=generator(seed, "cpu"),
                       dtype=torch.int64).to(torch.float64)
    sun = torch.as_tensor(cfg["sun"], dtype=torch.float64)
    return (sun + k[:, None] * traffic["sun_step"]).to(torch.float32).to(
        device)


def noise_pool(v: torch.Tensor, scale: float, count: int, seed: int):
    """``count`` copies of the vertices ``v`` moved by seeded normal
    noise of ``scale`` times the mesh's extent (the largest distance of a
    coordinate from the mean), made on ``v``'s device in one call."""
    extent = float((v - v.mean(0)).abs().max())
    noise = torch.randn((count, *v.shape), generator=generator(
        seed, v.device), device=v.device, dtype=v.dtype)
    return v[None] + (scale * extent) * noise


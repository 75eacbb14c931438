"""Triangle soups that stress the LBVH build, shared by the CPU tests
(``test_torch_lbvh.py``, against the JAX package) and the card tests
(``test_torch_cuda.py``, kernels against the plain version). Each
returns (vertices (V, 3) float32, faces (F, 3) int32); no JAX here."""

import numpy as np


def comb():
    """38 triangles whose centroids lie on the x axis at grid cells 0-15
    (two each), 31, 63, ..., 1023: each power of two splits off one
    triangle near the root, so a cut at C = 32 needs 7 clusters, more
    than its budget 2 * ceil(38 / 32) = 4."""
    xs = np.concatenate([np.repeat(np.arange(16), 2),
                         [31, 63, 127, 255, 511, 1023]]) + 0.25
    verts = np.stack([np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1),
                      np.stack([xs + 0.1, np.ones_like(xs), xs * 0], 1),
                      np.stack([xs - 0.1, -np.ones_like(xs), xs * 0], 1)], 1)
    faces = np.arange(3 * len(xs)).reshape(-1, 3)
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int32)


def super_comb(C=8, groups=31):
    """``groups`` runs of C triangles with one centroid each, the run k
    at the grid cell of morton code 2^k - 1: each run splits off near
    the root, so the cut at C has one cluster a run (31, within its
    budget 62) and the super cut at S = 8 needs 24 supers, more than its
    budget 16."""
    cells = np.zeros((groups, 3))
    for k in range(groups):
        for j in range(k):
            cells[k, j % 3] += 1 << (j // 3)
    centers = np.repeat(cells + 0.25, C, axis=0)
    corners = np.asarray([[0.1, 0, 0], [-0.05, 0.1, 0], [-0.05, -0.1, 0]])
    verts = (centers[:, None] + corners).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(len(verts)).reshape(-1, 3).astype(np.int32)


def planes(n=300, seed=11):
    """2n triangles whose vertices lie on the coordinate planes: each
    vertex has one coordinate +0 or -0, and each triangle takes its
    corners from the vertices of one plane, so its box is flat there and
    bounded by zeros of both signs (XLA's -0 < +0 decides the boxes)."""
    rng = np.random.default_rng(seed)
    verts = rng.standard_normal((n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    verts[np.arange(n), axis] = np.copysign(
        np.float32(0), rng.choice([-1.0, 1.0], n)).astype(np.float32)
    groups = [np.flatnonzero(axis == a) for a in range(3)]
    faces = np.concatenate([rng.choice(g, (2 * n // 3, 3)) for g in groups])
    return verts, faces.astype(np.int32)


def tiny(T, seed=12):
    """T triangles: T = 2 two copies of one triangle (one tied morton
    code, split by position), else random ones."""
    rng = np.random.default_rng(seed)
    verts = rng.standard_normal((3 * T, 3)).astype(np.float32)
    if T == 2:
        verts[3:] = verts[:3]
    return verts, np.arange(3 * T).reshape(-1, 3).astype(np.int32)

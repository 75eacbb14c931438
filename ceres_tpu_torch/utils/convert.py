"""Scene state from the JAX package into the port's objects.

Each function takes the JAX package's object (or anything with the same
fields: numpy arrays, JAX arrays) and returns the port's counterpart on
``device``. Fields are read with ``np.asarray``, so this module needs no
JAX. The tests use it to run the JAX walk and the port's walk on the
same ClusterSet, independently of the port's own builder.
"""

from __future__ import annotations

import numpy as np
import torch

from ceres_tpu_torch.accel.clusters import ClusterSet
from ceres_tpu_torch.models.camera import Camera
from ceres_tpu_torch.models.mesh import TriangleSoup
from ceres_tpu_torch.models.transform import Transform


def tensor(x, device=None) -> torch.Tensor:
    """One array -> a tensor on ``device`` (dtype kept)."""
    return torch.as_tensor(np.array(x), device=device)


def soup(src, device=None) -> TriangleSoup:
    """A ``TriangleSoup`` (p0, e1, e2, n, corner_normals or None)."""
    cn = getattr(src, "corner_normals", None)
    return TriangleSoup(
        p0=tensor(src.p0, device), e1=tensor(src.e1, device),
        e2=tensor(src.e2, device), n=tensor(src.n, device),
        corner_normals=None if cn is None else tensor(cn, device))


def cluster_set(src, device=None) -> ClusterSet:
    """A ``ClusterSet``: records, boxes, ``perm`` and, where the source
    has one, the super level of the two-level walk."""
    first = getattr(src, "super_first", None)
    return ClusterSet(
        **{name: tensor(getattr(src, name), device)
           for name in ("p0", "e1", "e2", "n", "lo", "hi", "perm")},
        super_first=None if first is None else tensor(first, device),
        super_S=int(getattr(src, "super_S", 0)))


def flat_bvh(src):
    """A host ``FlatBvh`` (``accel.golden_builders``): its arrays copied,
    dtypes kept."""
    from ceres_tpu_torch.accel.golden_builders import FlatBvh

    return FlatBvh(bounds=np.array(src.bounds),
                   prim_count=np.array(src.prim_count),
                   first_child=np.array(src.first_child),
                   prim_indices=np.array(src.prim_indices),
                   node_count=int(src.node_count))


def ploc_tree(src, device=None):
    """A ``PlocTree`` (``accel.ploc``): its arrays as tensors on
    ``device``, dtypes kept; ``root`` an int, ``rounds`` 0 (unknown)."""
    from ceres_tpu_torch.accel.ploc import PlocTree

    return PlocTree(
        **{name: tensor(getattr(src, name), device)
           for name in ("order", "left", "right", "node_lo", "node_hi",
                        "leaf_lo", "leaf_hi")},
        root=int(np.asarray(src.root)))


def camera(src, device=None) -> Camera:
    """A ``Camera`` (eye, dir, up, fov), dtype kept."""
    return Camera(eye=tensor(src.eye, device), dir=tensor(src.dir, device),
                  up=tensor(src.up, device), fov=tensor(src.fov, device))


def transform(src, device=None) -> Transform:
    """A ``Transform`` (matrix ``a``, translation ``v``), dtype kept; a
    stacked track keeps its leading frame axis."""
    return Transform(a=tensor(src.a, device), v=tensor(src.v, device))


def spheres(src, device=None):
    """A (centers, radii) pair -> ((S, 3), (S,)) tensors, dtype kept."""
    centers, radii = src
    return (tensor(centers, device).reshape(-1, 3),
            tensor(radii, device).reshape(-1))


def train_state(params, adam_state, device=None):
    """A ``TrainState`` from the JAX package's: ``params`` a dict of
    arrays, ``adam_state`` optax's ``ScaleByAdamState`` (``count``, and
    ``mu``, ``nu`` dicts keyed like ``params``). The parameters become
    leaf tensors that require gradients; Adam's state per parameter is
    ``torch.optim.Adam``'s: step = count (a float32 CPU scalar, as Adam
    keeps it), exp_avg = mu, exp_avg_sq = nu."""
    # Imported here, so that importing this module does not load the
    # renderer and the training loop above it.
    from ceres_tpu_torch.diff.inverse import TrainState

    step = torch.tensor(float(np.asarray(adam_state.count)),
                        dtype=torch.float32)
    return TrainState(
        {k: tensor(v, device).requires_grad_() for k, v in params.items()},
        {k: {"step": step.clone(),
             "exp_avg": tensor(adam_state.mu[k], device),
             "exp_avg_sq": tensor(adam_state.nu[k], device)}
         for k in params})

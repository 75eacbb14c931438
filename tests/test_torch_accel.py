"""The port's host SweepSAH build, treelet cut and cluster weights against
the JAX package.

The builder and the cut are NumPy copies, so they are held exactly:
integer arrays and f32 bounds bit for bit, the cut's groups, ``perm``,
``lo`` and ``hi`` too. The weight planes are the JAX package's packed
weights re-indexed, within ``rtol=1e-6`` (cross products in f32 whose
rounding could differ under XLA's FMA contraction).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.accel import cuts as jcuts
from ceres_tpu.accel import golden_builders as jgb
from ceres_tpu.models.mesh import triangle_soup as jax_soup

from ceres_tpu_torch.accel import clusters as pcl
from ceres_tpu_torch.accel import cuts as pcuts
from ceres_tpu_torch.accel import golden_builders as pgb
from ceres_tpu_torch.models.mesh import triangle_soup as port_soup
from ceres_tpu_torch.utils import convert

torch.set_num_threads(1)


def _mesh(name, bunny, dragon):
    if name == "bunny":
        return bunny
    if name == "dragon":
        return dragon
    rng = np.random.default_rng(7)
    verts = rng.standard_normal((300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, (700, 3)).astype(np.int32)
    return verts, faces


def _boxes(verts, faces):
    p = verts[faces]                       # (F, 3 corners, 3)
    return p.min(1), p.max(1), p.mean(1)


@pytest.mark.parametrize("name", ["random", "bunny"])
def test_sweep_sah_is_node_identical(name, bunny, dragon):
    lo, hi, centers = _boxes(*_mesh(name, bunny, dragon))
    ref = jgb.build_sweep_sah(lo, hi, centers)
    got = pgb.build_sweep_sah(lo, hi, centers)
    assert got.node_count == ref.node_count
    for field in ("bounds", "prim_count", "first_child", "prim_indices"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["random", "bunny", "dragon"])
def test_quality_cut_matches(name, bunny, dragon):
    verts, faces = _mesh(name, bunny, dragon)
    ref = jcuts.build_clusters_quality(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False))
    got = pcuts.build_clusters_quality(
        port_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                  with_normals=False))
    assert got.num_clusters == ref.num_clusters
    assert got.perm.dtype == torch.int32
    for field in ("perm", "lo", "hi", "p0", "e1", "e2"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    np.testing.assert_allclose(got.n.numpy(), np.asarray(ref.n), rtol=0,
                               atol=1e-6)
    if name == "dragon":
        assert got.num_clusters > 256   # cid keys need more than 8 bits


def test_cut_groups_match(bunny):
    lo, hi, centers = _boxes(*bunny)
    bvh = jgb.build_sweep_sah(lo, hi, centers)
    ref_groups, ref_lo, ref_hi, ref_first = jcuts._cut_flatbvh(bvh, 128,
                                                               "auto")
    groups, got_lo, got_hi, got_first = pcuts._cut_flatbvh(
        pgb.FlatBvh(**vars(bvh)), 128)
    assert len(groups) == len(ref_groups) == 61
    for a, b in zip(groups, ref_groups):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_lo, ref_lo)
    np.testing.assert_array_equal(got_hi, ref_hi)
    np.testing.assert_array_equal(got_first, ref_first)


@pytest.mark.parametrize("name", ["random", "bunny"])
def test_weight_planes_are_packed_weights(name, bunny, dragon):
    verts, faces = _mesh(name, bunny, dragon)
    cs = jcuts.build_clusters_quality(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False))
    origin = np.asarray([0.05, 0.3, -0.7], np.float32)
    packed = np.asarray(jcl.cluster_weights_common_origin_packed(
        cs, jnp.asarray(origin)))                     # (N_c, 8, 4C)
    C = cs.cluster_size
    # Rows 0-2 hold [cu_a | cv_a | n_a | 0], row 3 [0 | 0 | 0 | tn].
    ref = np.concatenate([packed[:, 0:3, 0:C], packed[:, 0:3, C:2 * C],
                          packed[:, 0:3, 2 * C:3 * C],
                          packed[:, 3:4, 3 * C:4 * C]], axis=1)
    got = pcl.cluster_weights_common_origin(convert.cluster_set(cs),
                                            torch.as_tensor(origin))
    assert tuple(got.shape) == (cs.num_clusters, pcl.WEIGHT_PLANES, C)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("builder", ["binned", "sbvh", "ploc", "reinsert"])
def test_unported_builders_name_their_roadmap_item(builder, bunny):
    soup = port_soup(torch.as_tensor(bunny[0]), torch.as_tensor(bunny[1]),
                     with_normals=False)
    with pytest.raises(NotImplementedError, match="M9"):
        pcuts.build_clusters_quality(soup, builder=builder)

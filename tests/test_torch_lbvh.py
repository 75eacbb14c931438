"""The port's device builders against the JAX package's, exactly.

Subdivision, morton codes and order, every ``Lbvh`` array, both cuts
and the treelet ``ClusterSet`` are integer or box data, so they are held
bit for bit: integers equal, f32 boxes equal as bit patterns (the sign
of a zero included). The JAX builders run under ``jax.jit``, as
``render()`` runs them; there XLA turns the centroid's division by 3
into a multiply by f32(1/3), and the port does the same. Only the face
normals ``n`` of the packed records are held to ``atol=1e-6`` (XLA's
cross product rounds differently from the port's, as in
``test_torch_accel.py``).

Scenes: bunny (4,968 triangles, 78 treelet blocks), a seeded random
soup, a soup of at most C triangles (the fixed-run fallback), a
comb-shaped soup whose cut overflows its budget (the fixed-run fallback
inside the treelet budget, with uniform supers) and one whose fine cut
fits while its super cut overflows (the treelet cut with uniform
supers).

The builders have no data-dependent operation, what a CUDA graph
capture needs: they run under ``FakeTensorMode``, where an operation
whose output shape or a host value depends on the data (``nonzero``,
a boolean-mask index, ``.item()``) raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.accel import cuts as jcuts
from ceres_tpu.accel import lbvh as jlbvh
from ceres_tpu.accel import morton as jmorton
from ceres_tpu.models import mesh as jmesh
from ceres_tpu.ops import megakernel as jmk

from ceres_tpu_torch.accel import clusters as pcl
from ceres_tpu_torch.accel import cuts as pcuts
from ceres_tpu_torch.accel import lbvh as plbvh
from ceres_tpu_torch.accel import morton as pmorton
from ceres_tpu_torch.models import mesh as pmesh

torch.set_num_threads(1)

LBVH_FIELDS = ("order", "left", "right", "range_lo", "range_hi", "parent",
               "leaf_parent", "node_lo", "node_hi", "leaf_lo", "leaf_hi")


def _comb():
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


def _super_comb(C=8, groups=31):
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


def _mesh(name, bunny):
    if name == "bunny":
        return bunny
    if name == "comb":
        return _comb()
    if name == "super_comb":
        return _super_comb()
    rng = np.random.default_rng({"random": 3, "small": 4}[name])
    T = {"random": 900, "small": 100}[name]
    verts = rng.standard_normal((T // 2, 3)).astype(np.float32)
    faces = rng.integers(0, T // 2, (T, 3)).astype(np.int32)
    return verts, faces


def _soups(verts, faces):
    jsoup = jmesh.triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                                with_normals=False)
    psoup = pmesh.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                                with_normals=False)
    return jsoup, psoup


def _same(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.dtype == np.float32:
        assert got.dtype == np.float32, what
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32),
                                      what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      ref.astype(np.int64), what)


@pytest.mark.parametrize("levels", [1, 2])
def test_subdivide_matches(bunny, levels):
    verts, faces = bunny
    ref = jmesh.subdivide(verts, faces, levels)
    got = pmesh.subdivide(verts, faces, levels)
    for a, b, what in zip(got, ref, ("vertices", "faces")):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, what)
    assert got[1].shape[0] == faces.shape[0] * 4 ** levels


def test_morton_matches(bunny):
    ints = np.arange(-3, 1100, dtype=np.int32)
    _same(pmorton.part1by2(torch.as_tensor(ints)).to(torch.int32),
          jmorton.part1by2(jnp.asarray(ints)).astype(jnp.int32), "part1by2")
    rng = np.random.default_rng(8)
    g = rng.integers(0, 1024, (3, 500)).astype(np.int32)
    _same(pmorton.morton_encode(*(torch.as_tensor(x) for x in g)),
          jmorton.morton_encode(*(jnp.asarray(x) for x in g)), "encode")
    verts, faces = pmesh.subdivide(*bunny, 2)     # 79,488 triangles
    centers = verts[faces].mean(1).astype(np.float32)
    lo, hi = centers.min(0), centers.max(0)
    c_t, lo_t, hi_t = (torch.as_tensor(x) for x in (centers, lo, hi))
    c_j, lo_j, hi_j = (jnp.asarray(x) for x in (centers, lo, hi))
    _same(pmorton.quantize(c_t, lo_t, hi_t), jmorton.quantize(c_j, lo_j, hi_j),
          "quantize")
    codes = pmorton.morton_codes(c_t, lo_t, hi_t)
    _same(codes, jmorton.morton_codes(c_j, lo_j, hi_j), "codes")
    # Many codes tie on the 2^10 grid; the order must keep index order.
    assert len(np.unique(codes.numpy())) < len(codes)
    _same(pmorton.morton_order(c_t), jmorton.morton_order(c_j), "order")
    flat = centers.copy()
    flat[:, 1] = 0.5                                  # degenerate extent
    _same(pmorton.morton_order(torch.as_tensor(flat)),
          jmorton.morton_order(jnp.asarray(flat)), "flat order")


def test_clz_matches():
    rng = np.random.default_rng(9)
    x = np.concatenate([
        np.asarray([0, 1, 2, 3, -1, -2 ** 31, 2 ** 31 - 1], np.int32),
        rng.integers(-2 ** 31, 2 ** 31, 2000, dtype=np.int64).astype(np.int32),
        (1 << rng.integers(0, 31, 200)).astype(np.int32)])
    _same(plbvh._clz32(torch.as_tensor(x)),
          jax.lax.clz(jnp.asarray(x)), "clz")


@pytest.mark.parametrize("name", ["bunny", "random"])
def test_lbvh_and_cuts_match(name, bunny):
    jsoup, psoup = _soups(*_mesh(name, bunny))
    ref = jax.jit(jlbvh.build_lbvh)(jsoup)
    got = plbvh.build_lbvh(psoup)
    for field in LBVH_FIELDS:
        _same(getattr(got, field), getattr(ref, field), field)
    for C in (8, 128):
        rs, rc = jlbvh.cluster_cut(ref, C)
        gs, gc = plbvh.cluster_cut(got, C)
        _same(gs, rs, f"starts C={C}")
        _same(gc, rc, f"cluster_of C={C}")
        for S in (2, 8, 32):
            r2 = jlbvh.super_cut(ref, rs, S)
            g2 = plbvh.super_cut(got, gs, S)
            _same(g2[0], r2[0], f"starts2 C={C} S={S}")
            _same(g2[1], r2[1], f"super_of C={C} S={S}")


@pytest.mark.parametrize("name, C", [("bunny", 128), ("random", 128),
                                     ("small", 128), ("comb", 32),
                                     ("super_comb", 8)])
def test_treelet_clusterset_matches(name, C, bunny):
    jsoup, psoup = _soups(*_mesh(name, bunny))
    ref = jax.jit(jcl.build_clusters_treelet, static_argnums=1)(jsoup, C)
    got = pcl.build_clusters_treelet(psoup, C)
    for field in ("perm", "lo", "hi", "p0", "e1", "e2"):
        _same(getattr(got, field), getattr(ref, field), field)
    np.testing.assert_allclose(got.n.numpy(), np.asarray(ref.n), rtol=0,
                               atol=1e-6)
    assert got.super_S == ref.super_S
    T = psoup.num_triangles
    if name == "small":        # T <= C: fixed morton runs, no super level
        assert got.super_first is None and ref.super_first is None
        assert got.num_clusters == 1
        return
    _same(got.super_first, ref.super_first, "super_first")
    assert got.num_clusters == 2 * (-(-T // C))
    if name == "comb":         # the cut overflows its budget: fixed runs
        starts, _ = jlbvh.cluster_cut(jlbvh.build_lbvh(jsoup), C)
        assert int(starts.sum()) > got.num_clusters
        np.testing.assert_array_equal(got.perm.numpy()[:T],
                                      np.asarray(ref.perm)[:T])
        np.testing.assert_array_equal(got.super_first.numpy(), [0, 4])
    if name == "super_comb":   # the fine cut fits, the super cut does not
        bvh = plbvh.build_lbvh(psoup)
        starts, _ = plbvh.cluster_cut(bvh, C)
        starts2, _ = plbvh.super_cut(bvh, starts, got.super_S)
        n_s_cap = got.super_first.shape[0]
        assert int(starts.sum()) <= got.num_clusters
        assert int(starts2.sum()) > n_s_cap
        perm = got.perm.numpy().reshape(got.num_clusters, C)
        assert (perm[:int(starts.sum())] >= 0).all()   # the treelet cut
        np.testing.assert_array_equal(
            got.super_first.numpy(),
            np.minimum(np.arange(n_s_cap) * got.super_S, got.num_clusters))


def test_super_slots_match():
    for n_c in (1, 78, 368, 4968, 8192, 8193, 16384, 19872, 40000):
        assert pcl._super_slots(n_c) == jmk._super_slots(n_c), n_c
    assert pcl._super_slots(19872) == 32 and pcl._super_slots(4968) == 8


def test_quality_cut_supers_match(bunny):
    verts, faces = bunny
    jsoup, psoup = _soups(verts, faces)
    ref = jcuts.build_clusters_quality(jsoup)
    got = pcuts.build_clusters_quality(psoup)
    assert got.super_S == ref.super_S == 8
    _same(got.super_first, ref.super_first, "super_first")
    _same(got.perm, ref.perm, "perm")


@pytest.mark.parametrize("name", ["bunny", "small", "comb"])
def test_builders_have_no_data_dependent_op(name, bunny):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ceres_tpu_torch.ops import megakernel as pmk

    verts, faces = _mesh(name, bunny)
    C = 32 if name == "comb" else 128
    with FakeTensorMode() as mode:
        vt, ft = (mode.from_tensor(torch.as_tensor(x)) for x in (verts, faces))
        soup = pmesh.triangle_soup(vt, ft)
        T = soup.num_triangles
        bvh = plbvh.build_lbvh(soup)
        starts, cluster_of = plbvh.cluster_cut(bvh, C)
        starts2, _ = plbvh.super_cut(bvh, starts, 8)
        cs = pcl.build_clusters_treelet(soup, C)
        runs = pcl.build_clusters(soup, C)
        refit = pcl.refit_clusters(cs, soup)
        table = pmk.winner_table(soup, cs)
    assert bvh.parent.shape == (T - 1,) and bvh.leaf_parent.shape == (T,)
    assert starts.shape == cluster_of.shape == starts2.shape == (T,)
    n_c = 1 if T <= C else 2 * (-(-T // C))
    assert cs.num_clusters == refit.num_clusters == n_c
    assert runs.num_clusters == -(-T // C)
    assert table.shape == (n_c * C, 9)

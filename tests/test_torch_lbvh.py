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

Scenes (``lbvh_soups.py`` has the synthetic ones): bunny (4,968
triangles, 78 treelet blocks), a seeded random soup, a soup of at most C
triangles (the fixed-run fallback), a comb-shaped soup whose cut
overflows its budget (the fixed-run fallback inside the treelet budget,
with uniform supers), one whose fine cut fits while its super cut
overflows (the treelet cut with uniform supers), a soup on the
coordinate planes (boxes bounded by zeros of both signs) and soups of 2
and 3 triangles.

The builders have no data-dependent operation, what a CUDA graph
capture needs: they run under ``FakeTensorMode``, where an operation
whose output shape or a host value depends on the data (``nonzero``,
a boolean-mask index, ``.item()``) raises.

On the card the LBVH is built by two kernels (``accel/csrc/lbvh.cu``),
held to the plain version by ``test_torch_cuda.py``. Here: a CPU soup
takes the plain version and launches nothing, a refit whose boxes carry
gradients keeps the plain passes (gradients equal to ``jax.grad``'s),
the kernels' wrappers refuse inputs the kernels do not take before any
launch, and every C entry point of the port's CUDA sources is declared
as its source has it (``c_void_p`` for each pointer and the stream),
read from the sources without building or loading them.
"""

import re


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
from ceres_tpu_torch.utils import native

import lbvh_soups as soups

torch.set_num_threads(1)

LBVH_FIELDS = ("order", "left", "right", "range_lo", "range_hi", "parent",
               "leaf_parent", "node_lo", "node_hi", "leaf_lo", "leaf_hi")


def _mesh(name, bunny):
    if name == "bunny":
        return bunny
    if name == "comb":
        return soups.comb()
    if name == "super_comb":
        return soups.super_comb()
    if name == "planes":
        return soups.planes()
    if name in ("two", "three"):
        return soups.tiny({"two": 2, "three": 3}[name])
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


@pytest.mark.parametrize("name", ["bunny", "random", "planes", "two",
                                  "three"])
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


@pytest.mark.parametrize("name", ["bunny", "planes"])
def test_cpu_soup_takes_the_plain_version(name, bunny, monkeypatch):
    def no_library(name="walk"):
        raise AssertionError(f"a CPU build loaded the {name} library")

    monkeypatch.setattr(native, "load", no_library)
    plbvh.reset_launches()
    _, psoup = _soups(*_mesh(name, bunny))
    got = plbvh.build_lbvh(psoup)
    want = plbvh._build_lbvh_plain(psoup)
    for field in LBVH_FIELDS:
        _same(getattr(got, field), getattr(want, field), field)
    plbvh.refit(got, psoup)
    pcl.build_clusters_treelet(psoup)
    assert plbvh.launches == {"hierarchy": 0, "boxes": 0}


@pytest.mark.parametrize("name", ["random", "small"])
def test_refit_with_grad_keeps_the_plain_passes(name, bunny):
    # Boxes that carry gradients take the fmin/fmax passes, whose
    # gradients equal jax.grad's of the JAX refit (soups without tied
    # corners), and whose values equal the refit without gradients.
    verts, faces = _mesh(name, bunny)
    rng = np.random.default_rng(14)
    moved = verts + 0.01 * rng.standard_normal(verts.shape).astype(np.float32)
    jsoup, psoup = _soups(verts, faces)
    jbvh = jax.jit(jlbvh.build_lbvh)(jsoup)
    pbvh = plbvh.build_lbvh(psoup)
    T = faces.shape[0]
    weights = [rng.standard_normal((n, 3)).astype(np.float32)
               for n in (T - 1, T - 1, T, T)]

    def boxes(b):
        return b.node_lo, b.node_hi, b.leaf_lo, b.leaf_hi

    def jloss(v):
        b = jlbvh.refit(jbvh, jmesh.triangle_soup(v, jnp.asarray(faces),
                                                   with_normals=False))
        return sum((x * w).sum() for x, w in zip(boxes(b), weights))

    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(moved)))
    plbvh.reset_launches()
    v = torch.tensor(moved, requires_grad=True)
    pre = plbvh.refit(pbvh, pmesh.triangle_soup(v, torch.as_tensor(faces),
                                                with_normals=False))
    assert all(x.requires_grad for x in boxes(pre))
    sum((x * torch.as_tensor(w)).sum()
        for x, w in zip(boxes(pre), weights)).backward()
    assert plbvh.launches == {"hierarchy": 0, "boxes": 0}
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(v.grad.numpy(), jg, rtol=1e-4,
                               atol=1e-5 * np.abs(jg).max())
    with torch.no_grad():
        plain = plbvh.refit(pbvh, pmesh.triangle_soup(
            v, torch.as_tensor(faces), with_normals=False))
    for got, want in zip(boxes(pre), boxes(plain)):
        _same(got.detach(), want, "boxes")


def _refusals():
    keys = torch.arange(6, dtype=torch.int64)
    i32 = torch.zeros(6, dtype=torch.int32)
    n1 = torch.zeros(5, dtype=torch.int32)
    corners = torch.zeros(6, 3)
    return {
        "int32 keys": lambda: plbvh._hierarchy_card(keys.to(torch.int32)),
        "strided keys": lambda: plbvh._hierarchy_card(
            torch.arange(12)[::2]),
        "int64 order": lambda: plbvh._boxes_card(
            i32.long(), n1, n1, n1, i32, corners, corners, corners),
        "short parent": lambda: plbvh._boxes_card(
            i32, n1, n1, n1[:4], i32, corners, corners, corners),
        "float16 corners": lambda: plbvh._boxes_card(
            i32, n1, n1, n1, i32, *(corners.half(),) * 3),
        "mixed corners": lambda: plbvh._boxes_card(
            i32, n1, n1, n1, i32, corners, corners.double(), corners),
        "corners with grad": lambda: plbvh._boxes_card(
            i32, n1, n1, n1, i32, corners.requires_grad_(), corners, corners),
    }


@pytest.mark.parametrize("what", list(_refusals()))
def test_kernel_wrappers_refuse_before_launching(what, monkeypatch):
    def no_library(name):
        raise AssertionError(f"the launcher loaded the {name} library")

    monkeypatch.setattr(native, "load", no_library)
    with pytest.raises(ValueError, match="lbvh kernels"):
        _refusals()[what]()


_C_TYPES = {"int": native.ctypes.c_int, "const char*": native.ctypes.c_char_p}


def _entry_points(source):
    """{name: (argument types, return type)} of the ``extern "C"``
    functions that return an int or a string in a CUDA source: a
    pointer or the stream as ``c_void_p``, an int as ``c_int``."""
    with open(source) as fh:
        text = fh.read()
    out = {}
    for ret, name, params in re.findall(
            r'extern "C" (int|const char\*) (\w+)\(([^)]*)\)', text):
        args = []
        for param in params.split(","):
            param = " ".join(param.split())
            if "*" in param:
                args.append(native.ctypes.c_void_p)
            else:
                assert param.startswith("int "), (name, param)
                args.append(native.ctypes.c_int)
        out[name] = (tuple(args), _C_TYPES[ret])
    return out


@pytest.mark.parametrize("name", sorted(native.SOURCES))
def test_c_entry_points_declared_as_in_the_source(name):
    want = _entry_points(native.SOURCES[name])
    assert want, name
    got = {fn: (tuple(args), ret)
           for fn, (args, ret) in native.SIGNATURES[name].items()}
    assert got == want

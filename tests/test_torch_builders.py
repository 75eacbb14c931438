"""The port's quality builders against the JAX package, on the CPU:
SweepSAH and BinnedSAH (NumPy and the native C++ build), SBVH,
pre-splitting, reinsertion and PLOC, their cuts into ClusterSets, renders
on those cuts, and the native OBJ parser.

Seeded numpy inputs go through the JAX function and the port's
counterpart. Rules:
  * trees node for node: every ``FlatBvh`` array equal
    (``np.testing.assert_array_equal``, dtypes too); PLOC's ``order``,
    ``left``, ``right`` and ``root`` equal and its boxes bit-equal, its
    ``sah_cost`` within rtol 1e-6;
  * ClusterSets: ``perm``, ``lo``, ``hi``, ``super_first`` and
    ``super_S`` equal, and each record (``p0``, ``e1``, ``e2``, ``n``)
    the soup's row at ``perm``, exactly (the two soups' ``n`` differ in
    the last bits of XLA's cross product, ``tests/test_torch_accel.py``);
  * renders at 48 x 48 on those cuts (port against JAX, plain walks):
    rays and primary hits exactly, >= 99.9% of pixels within 1e-4 (the
    rule of ``tests/test_builder_cuts.py``).

The slow JAX builds (SBVH and reinsertion on the 2,000-triangle soup and
on the bunny's first 1,500 faces, reinsertion on ``bunny_scene()``) are
read from ``tests/fixtures/torch_port_builder_trees.npz``; the cuts the
card holds (``chip_smoke.py`` phase 18) are fingerprinted in
``tests/fixtures/torch_port_builders.json``. The JAX package makes both:
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_builders.py``
(~6 min). A test here rebuilds the fast entries with JAX and checks the
file against them.
"""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.accel import cuts as jcuts
from ceres_tpu.accel import golden_builders as jgb
from ceres_tpu.accel import native as jnative
from ceres_tpu.accel import ploc as jploc
from ceres_tpu.accel import presplit as jps
from ceres_tpu.accel import reinsertion as jri
from ceres_tpu.accel import sbvh as jsbvh
from ceres_tpu.models.mesh import subdivide as jax_subdivide
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.render import renderer as jrenderer
from ceres_tpu.render import scenes as jscenes

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel import cuts as pcuts
from ceres_tpu_torch.accel import golden_builders as pgb
from ceres_tpu_torch.accel import native as pnative
from ceres_tpu_torch.accel import ploc as pploc
from ceres_tpu_torch.accel import presplit as pps
from ceres_tpu_torch.accel import reinsertion as pri
from ceres_tpu_torch.accel import sbvh as psbvh
from ceres_tpu_torch.io import native as pio_native
from ceres_tpu_torch.io import obj as pobj
from ceres_tpu_torch.utils import convert, native

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_builders.json")
TREES = os.path.join(ROOT, "tests", "fixtures",
                     "torch_port_builder_trees.npz")
FIELDS = ("bounds", "prim_count", "first_child", "prim_indices")
# The cuts of the fixture, all rebuilt here but full-bunny SBVH, bunny
# reinsertion (tests/test_torch_accel.py) and the 4x bunny (the card).
LIVE = ("bunny/sweep", "bunny/binned", "bunny/ploc", "dragon/sweep",
        "dragon/binned", "dragon/ploc", "bunny3/binned")
NO_GXX = shutil.which("g++") is None


# -- inputs ----------------------------------------------------------------

def _random_soup(seed, T, spread=2.0, elongate=None):
    """Random triangle soup (as tests/test_builders_quality.py makes it);
    with ``elongate``, that share of the triangles long, thin slivers."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (T, 3))
    d1 = rng.normal(0, 0.3, (T, 3))
    d2 = rng.normal(0, 0.3, (T, 3))
    if elongate is not None:
        d1[:int(elongate * T)] *= 20.0
    return base, base + d1, base + d2


def _corners(name):
    """(p0, p1, p2) of a named input: the seeded soups t200 and t2000
    (20% slivers), the bunny, or its first 1,500 faces. The bunny's
    corners are taken as ``build_clusters_quality`` takes them from the
    soup (p1 = p0 - e1, p2 = e2 + p0, in float32)."""
    if name == "t200":
        return _random_soup(0, 200)
    if name == "t2000":
        return _random_soup(1, 2000, elongate=0.2)
    verts, faces = _obj("bunny")
    if name == "bunny1500":
        faces = faces[:1500]
    p0, p1, p2 = (verts[faces[:, k]] for k in range(3))
    return p0, p0 - (p0 - p1), (p2 - p0) + p0


def _boxes(p0, p1, p2):
    pts = np.stack([p0, p1, p2], 1)
    return pts.min(1), pts.max(1), pts.mean(1)


def _obj(name):
    """A mesh of ``data/`` through the Python parser."""
    with open(os.path.join(ROOT, "data", f"{name}.obj")) as fh:
        return pobj.parse_obj(fh.read())


def _mesh(name, subdivide=jax_subdivide):
    """Vertices and faces of a fixture scene: bunny, dragon, and the
    bunny subdivided 3 and then once more (bunny3, bunny4), as
    ``chip_smoke.py`` makes them."""
    if name in ("bunny", "dragon"):
        return _obj(name)
    v, f = subdivide(*_obj("bunny"), 3)
    return (v, f) if name == "bunny3" else subdivide(v, f, 1)


def _soups(verts, faces):
    return (jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                     with_normals=False),
            ct.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                             with_normals=False))


def _trees():
    with np.load(TREES) as z:
        return {k: z[k] for k in z.files}


def _jax_tree(key):
    """A FlatBvh the JAX package built, from the trees fixture."""
    z = _trees()
    return jgb.FlatBvh(**{f: z[f"{key}/{f}"] for f in FIELDS},
                       node_count=int(z[f"{key}/bounds"].shape[0]))


def _assert_same_bvh(got, ref):
    assert got.node_count == ref.node_count
    for field in FIELDS:
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, field)


def _assert_same_cut(got, ref, soup):
    """Port ClusterSet against the JAX package's (see the module's rules);
    ``soup`` the port's."""
    assert got.num_clusters == ref.num_clusters
    assert got.super_S == int(ref.super_S)
    for field in ("perm", "lo", "hi"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    if ref.super_first is None:
        assert got.super_first is None
    else:
        np.testing.assert_array_equal(got.super_first.numpy(),
                                      np.asarray(ref.super_first))
    perm = got.perm.long()
    valid = (perm >= 0)[:, None]
    for field in ("p0", "e1", "e2", "n"):
        want = torch.where(valid, getattr(soup, field)[perm.clamp(min=0)],
                           0.0).reshape(got.num_clusters, -1, 3)
        assert torch.equal(getattr(got, field), want), field


# -- flat builders -----------------------------------------------------------

@pytest.mark.parametrize("name", ["t200", "t2000", "bunny"])
@pytest.mark.parametrize("builder", ["sweep", "binned"])
def test_flat_builders_node_identical(builder, name):
    lo, hi, centers = _boxes(*_corners(name))
    build = f"build_{builder}_sah"
    ref = getattr(jgb, build)(lo, hi, centers)
    got = getattr(pgb, build)(lo, hi, centers)
    _assert_same_bvh(got, ref)
    pgb.validate(got)


@pytest.mark.parametrize("max_leaf", [4, 16])
@pytest.mark.parametrize("bins", [8, 16, 32])
def test_binned_knobs_node_identical(bins, max_leaf):
    lo, hi, centers = _boxes(*_corners("t2000"))
    kw = dict(bin_count=bins, max_leaf_size=max_leaf)
    ref = jgb.build_binned_sah(lo, hi, centers, **kw)
    _assert_same_bvh(pgb.build_binned_sah(lo, hi, centers, **kw), ref)
    if not NO_GXX:
        _assert_same_bvh(pnative.build_binned_sah_native(lo, hi, centers,
                                                         **kw), ref)


@pytest.mark.skipif(NO_GXX, reason="no g++ to build the native builders")
@pytest.mark.parametrize("name", ["t2000", "bunny"])
def test_native_binned_is_numpy_and_jax_native(name):
    lo, hi, centers = (x.astype(np.float32) for x in _boxes(*_corners(name)))
    got = pnative.build_binned_sah_native(lo, hi, centers)
    _assert_same_bvh(got, pgb.build_binned_sah(lo, hi, centers))
    _assert_same_bvh(got, jnative.build_binned_sah_native(lo, hi, centers))
    _assert_same_bvh(pnative.build_binned_sah_fast(lo, hi, centers), got)
    assert pnative.available() and pio_native.available()
    for source in (pnative.SOURCE, pio_native.SOURCE):
        # Built into the port's _build/, never beside its source.
        assert os.path.isfile(native.library_path(source))
        assert os.path.dirname(native.library_path(source)) == os.path.join(
            ROOT, "ceres_tpu_torch", "_build")
        assert not [f for f in os.listdir(os.path.dirname(source))
                    if f.endswith(".so")]


def test_fast_build_takes_numpy_only_without_gxx(monkeypatch, tmp_path):
    lo, hi, centers = _boxes(*_corners("t200"))
    monkeypatch.setattr(native, "compiler", lambda source: None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    pnative._load.cache_clear()
    try:
        assert not pnative.available()
        with pytest.raises(ImportError, match="no g\\+\\+"):
            pnative.build_binned_sah_native(lo, hi, centers)
        _assert_same_bvh(pnative.build_binned_sah_fast(lo, hi, centers),
                         jgb.build_binned_sah(lo, hi, centers))
    finally:
        pnative._load.cache_clear()


@pytest.mark.skipif(NO_GXX, reason="no g++ to fail")
def test_failed_native_build_raises(monkeypatch, tmp_path):
    # With g++ present a build that fails raises with the compiler's
    # output; it does not fall back to NumPy.
    broken = tmp_path / "bvh_build.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    pnative._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            pnative.available()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            pnative.build_binned_sah_fast(*_boxes(*_corners("t200")))
    finally:
        pnative._load.cache_clear()


def test_tree_utilities_match_jax():
    p0, p1, p2 = _corners("t200")
    lo, hi, centers = _boxes(p0, p1, p2)
    ref = jgb.build_binned_sah(lo, hi, centers)
    got = pgb.build_binned_sah(lo, hi, centers)
    assert pgb.sah_cost(got) == jgb.sah_cost(ref)
    pgb.validate(got)
    broken = convert.flat_bvh(got)
    broken.prim_indices[0] = broken.prim_indices[1]
    with pytest.raises(AssertionError):
        jgb.validate(broken)
    with pytest.raises(AssertionError):
        pgb.validate(broken)
    _assert_same_bvh(pgb.optimize_node_layout(got),
                     jgb.optimize_node_layout(ref))
    pgb.validate(pgb.optimize_node_layout(got))
    rng = np.random.default_rng(5)
    origins = rng.uniform(-4, 4, (48, 3))
    dirs = rng.normal(0, 1, (48, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    e1, e2 = p0 - p1, p2 - p0
    n = np.cross(e1, e2)
    a = pgb.traverse_closest(got, p0, e1, e2, n, origins, dirs)
    b = jgb.traverse_closest(ref, p0, e1, e2, n, origins, dirs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[4].sum() > 0


# -- SBVH, reinsertion, pre-splitting -----------------------------------------

def test_split_triangle_box_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        p0, p1, p2 = rng.normal(0, 1, (3, 3))
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        axis = int(rng.integers(3))
        for pos in (float(rng.uniform(lo[axis], hi[axis])), float(p1[axis]),
                    float(hi[axis]) + 1.0):
            got = psbvh.split_triangle_box(p0, p1, p2, axis, pos)
            ref = jsbvh.split_triangle_box(p0, p1, p2, axis, pos)
            for g, r in zip(got, ref):
                for x, y in zip(g, r):
                    assert x.dtype == y.dtype == np.float64
                    assert x.tobytes() == y.tobytes()
    # A plane past the triangle leaves one side empty.
    tri = np.eye(3)[[2, 0, 1]] * [1, 1, 0]
    (llo, lhi), (rlo, rhi) = psbvh.split_triangle_box(*tri, 0, 5.0)
    assert (llo <= lhi).all() and (rlo > rhi).any()
    # Signed zeros follow NumPy's minimum and maximum.
    z = np.asarray([[0.0, -0.0, 1.0], [-0.0, 0.0, 2.0], [0.0, 0.0, 3.0]])
    got = psbvh.split_triangle_box(*z, 2, 1.5)
    ref = jsbvh.split_triangle_box(*z, 2, 1.5)
    assert all(x.tobytes() == y.tobytes()
               for g, r in zip(got, ref) for x, y in zip(g, r))


@pytest.mark.parametrize("name", ["t200", "t2000", "bunny1500"])
def test_sbvh_node_identical(name):
    p0, p1, p2 = _corners(name)
    got = psbvh.build_sbvh(p0, p1, p2)
    ref = (jsbvh.build_sbvh(p0, p1, p2) if name == "t200"
           else _jax_tree(f"sbvh/{name}"))
    _assert_same_bvh(got, ref)
    psbvh.validate_sbvh(got, p0.shape[0])
    assert got.prim_indices.shape[0] > p0.shape[0]   # it did split


@pytest.mark.parametrize("name", ["t200", "t2000", "bunny1500"])
def test_reinsertion_node_identical(name):
    lo, hi, centers = _boxes(*_corners(name))
    sweep = pgb.build_sweep_sah(lo, hi, centers)
    assert pri.compute_parents(sweep).tolist() == jri.compute_parents(
        convert.flat_bvh(sweep)).tolist()
    got = pri.optimize_reinsertion(sweep)
    ref = (jri.optimize_reinsertion(jgb.build_sweep_sah(lo, hi, centers))
           if name == "t200" else _jax_tree(f"reinsert/{name}"))
    _assert_same_bvh(got, ref)
    pgb.validate(got)
    assert pgb.sah_cost(got) < pgb.sah_cost(sweep)


@pytest.mark.parametrize("name", ["t200", "t2000", "bunny1500"])
@pytest.mark.parametrize("builder", ["sweep", "binned"])
def test_presplit_node_identical(builder, name):
    p0, p1, p2 = _corners(name)
    refs = pps.presplit_refs(p0, p1, p2)
    for a, b in zip(refs, jps.presplit_refs(p0, p1, p2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        pps.split_priorities(*_boxes(p0, p1, p2)[:2], np.ones(p0.shape[0])),
        jps.split_priorities(*_boxes(p0, p1, p2)[:2], np.ones(p0.shape[0])))
    build = f"build_{builder}_sah"
    got = pps.build_with_presplit(getattr(pgb, build), p0, p1, p2)
    _assert_same_bvh(got, jps.build_with_presplit(getattr(jgb, build),
                                                  p0, p1, p2))
    assert refs[0].shape[0] > p0.shape[0]


# -- PLOC ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["t200", "t2000", "bunny", "dragon"])
def test_ploc_tree_identical(name):
    if name == "dragon":
        verts, faces = _obj("dragon")
    else:
        corners = np.stack(_corners(name), 1).astype(np.float32)
        verts = corners.reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    jsoup, psoup = _soups(verts, faces)
    ref = jploc.build_ploc(jsoup)
    got = pploc.build_ploc(psoup)
    for field in ("order", "left", "right"):
        x = getattr(got, field)
        assert x.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(ref,
                                                                    field)))
    assert got.root == int(ref.root)
    assert 0 < got.rounds < faces.shape[0]
    for field in ("node_lo", "node_hi", "leaf_lo", "leaf_hi"):
        assert (getattr(got, field).numpy().tobytes()
                == np.asarray(getattr(ref, field)).tobytes()), field
    np.testing.assert_allclose(float(pploc.sah_cost(got)),
                               float(jploc.sah_cost(ref)), rtol=1e-6)


def test_ploc_round_area_is_xlas_fused_form():
    """The JAX package's PLOC round is compiled by XLA, which fuses the
    union area d0*(d1+d2) + d1*d2 into fma(d1, d2, d0*(d1+d2)). On the
    dragon, sorted leaf 1462 ties leaves 1461 and 1463 under the fused
    form and prefers 1461 under the plain one, so a plain port parts
    from the JAX tree at internal node 361 (1461+1462 against
    1462+1463)."""
    import jax

    verts, faces = _obj("dragon")
    jsoup, psoup = _soups(verts, faces)
    tree = pploc.build_ploc(psoup)
    lo, hi = tree.leaf_lo, tree.leaf_hi
    from ceres_tpu_torch.utils import minmax

    def union(a, b):
        return minmax.fmin(lo[a], lo[b]), minmax.fmax(hi[a], hi[b])

    plain = [float(pploc._half_area(*union(*p))) for p in ((1461, 1462),
                                                           (1462, 1463))]
    fused = [float(pploc._round_area(*union(*p))) for p in ((1461, 1462),
                                                            (1462, 1463))]
    xla = [float(jax.jit(jploc._half_area)(*(jnp.asarray(x.numpy())
                                            for x in union(*p))))
           for p in ((1461, 1462), (1462, 1463))]
    assert fused == xla == [0.012852783314883709] * 2
    assert plain == [0.012852783314883709, 0.012852784246206284]
    # The fused tie goes to 1463 (the strict < keeps the first find), as
    # in the JAX tree; the plain areas would pair 1461 with 1462.
    ref = jploc.build_ploc(jsoup)
    assert np.asarray(ref.left)[361] == tree.left[361] == -(1462 + 1)
    assert np.asarray(ref.right)[361] == tree.right[361] == -(1463 + 1)
    # And XLA's fused form on many random boxes, bit for bit.
    rng = np.random.default_rng(1)
    blo = rng.standard_normal((200_000, 3)).astype(np.float32)
    bhi = blo + np.abs(rng.standard_normal((200_000, 3))).astype(np.float32)
    want = np.asarray(jax.jit(jploc._half_area)(blo, bhi))
    got = pploc._round_area(torch.as_tensor(blo), torch.as_tensor(bhi))
    assert got.numpy().tobytes() == want.tobytes()


def test_ploc_cut_of_a_float64_soup():
    # The JAX package's build_ploc does not run under x64, so a float64
    # soup's PLOC has no reference: the port builds it with the plain
    # area and cuts it with each cluster's exact float64 bound.
    verts, faces = _obj("bunny")
    soup = ct.triangle_soup(torch.as_tensor(verts, dtype=torch.float64),
                            torch.as_tensor(faces), with_normals=False)
    cs = pcuts.build_clusters_quality(soup, builder="ploc")
    assert cs.lo.dtype == cs.p0.dtype == torch.float64
    perm = cs.perm.numpy()
    assert np.sort(perm[perm >= 0]).tolist() == list(range(faces.shape[0]))
    member = cs.perm.reshape(cs.num_clusters, -1) >= 0
    for corner in (cs.p0, cs.p0 - cs.e1, cs.p0 + cs.e2):
        inside = ((corner >= cs.lo[:, None]) & (corner <= cs.hi[:, None]))
        assert bool(inside.all(-1)[member].all())
    f32 = pcuts.build_clusters_quality(ct.triangle_soup(
        torch.as_tensor(verts), torch.as_tensor(faces), with_normals=False),
        builder="ploc")
    assert abs(cs.num_clusters - f32.num_clusters) <= 2


# -- cuts ----------------------------------------------------------------------

_SCENE_CUTS = {}


def _scene_cuts(builder):
    """(port cut, JAX cut, port soup) on ``bunny_scene()``; the JAX
    reinsertion tree comes from the trees fixture."""
    if builder not in _SCENE_CUTS:
        sc = jscenes.bunny_scene()
        jsoup, psoup = _soups(sc.vertices, sc.faces)
        got = pcuts.build_clusters_quality(psoup, builder=builder)
        if builder == "reinsert":
            ref = jcuts.clusters_from_flatbvh(
                jsoup, _jax_tree("reinsert/bunny_scene"))
        else:
            ref = jcuts.build_clusters_quality(jsoup, builder=builder)
        _SCENE_CUTS[builder] = (got, ref, psoup)
    return _SCENE_CUTS[builder]


@pytest.mark.parametrize("builder", ["sweep", "binned", "ploc", "reinsert"])
def test_quality_clusters_match_jax(builder):
    got, ref, psoup = _scene_cuts(builder)
    _assert_same_cut(got, ref, psoup)
    if builder == "ploc":
        assert got.super_first is None
    else:
        assert got.super_S == 8 and got.super_first is not None


def _render_both(verts, faces, jcam, sun, got, ref):
    config = dict(width=48, height=48, mode="smooth", backend="megakernel")
    jimg, jst = jrenderer.render_pipeline(
        jnp.asarray(verts), jnp.asarray(faces), jcam, jnp.asarray(sun),
        jrenderer.RenderConfig(**config), clusters=ref)
    pimg, pst = ct.render_pipeline(
        torch.as_tensor(verts), torch.as_tensor(faces), convert.camera(jcam),
        torch.as_tensor(sun), ct.RenderConfig(**config), clusters=got)
    return (pimg.numpy(), {k: int(v) for k, v in pst.items()},
            np.asarray(jimg), {k: int(v) for k, v in jst.items()})


@pytest.mark.parametrize("builder", ["sweep", "binned", "sbvh", "ploc",
                                     "reinsert"])
def test_quality_cut_renders_match_jax(builder):
    sc = jscenes.bunny_scene()
    verts, faces = sc.vertices, sc.faces
    if builder == "sbvh":
        # The bunny's first 1,500 faces: the JAX tree from the fixture.
        verts, faces = _obj("bunny")
        faces = faces[:1500]
        jsoup, psoup = _soups(verts, faces)
        got = pcuts.build_clusters_quality(psoup, builder="sbvh")
        ref = jcuts.clusters_from_flatbvh(jsoup, _jax_tree("sbvh/bunny1500"))
        _assert_same_cut(got, ref, psoup)
        # Spatial splits put some triangles in two clusters.
        perm = got.perm.numpy()
        assert np.unique(perm[perm >= 0]).size == faces.shape[0] < (
            perm >= 0).sum()
    else:
        got, ref, _ = _scene_cuts(builder)
    pimg, pst, jimg, jst = _render_both(verts, faces, sc.camera, sc.sun, got,
                                        ref)
    assert pst["rays"] == jst["rays"]
    assert pst["primary_hits"] == jst["primary_hits"] > 0
    diff = np.abs(pimg - jimg).max(axis=-1)
    assert (diff <= 1e-4).mean() >= 0.999, f"{(diff > 1e-4).mean():.4%} off"


@pytest.mark.parametrize("kind", ["flatbvh", "ploc"])
def test_port_cut_of_the_jax_tree(kind, bunny):
    verts, faces = bunny
    jsoup, psoup = _soups(verts, faces)
    if kind == "ploc":
        tree = jploc.build_ploc(jsoup)
        ref = jcuts.clusters_from_ploc(jsoup, tree)
        got = pcuts.clusters_from_ploc(psoup, convert.ploc_tree(tree))
        assert pcuts.cut_record(got, convert.ploc_tree(tree)) == (
            pcuts.cut_record(convert.cluster_set(ref),
                             convert.ploc_tree(tree)))
    else:
        bvh = jgb.build_binned_sah(*_boxes(*(verts[faces[:, k]]
                                             for k in range(3))))
        ref = jcuts.clusters_from_flatbvh(jsoup, bvh)
        got = pcuts.clusters_from_flatbvh(psoup, convert.flat_bvh(bvh))
        groups, *_ = pcuts._cut_flatbvh(convert.flat_bvh(bvh), 128)
        for a, b in zip(groups, jcuts._cut_flatbvh(bvh, 128, "auto")[0]):
            np.testing.assert_array_equal(a, b)
    _assert_same_cut(got, ref, psoup)


def test_frames_sharded_on_a_quality_cut():
    # render_frames_sharded with a prebuilt binned cut against the default
    # (the treelet cut built once a batch): the same visibility, shading
    # equal up to near-tie winner flips (test_builder_cuts.py's rule).
    from ceres_tpu_torch.parallel.sharded import (render_frames_sharded,
                                                  turntable_transforms)
    from ceres_tpu_torch.render import scenes

    sc = scenes.bunny_scene()
    cfg = ct.RenderConfig(width=64, height=64, mode="smooth",
                          backend="megakernel")
    tfs = turntable_transforms(2)
    kw = dict(config=cfg, device="cpu")
    ref, ref_st = render_frames_sharded(sc.vertices, sc.faces, sc.camera,
                                        sc.sun, tfs, **kw)
    cs = pcuts.build_clusters_quality(ct.triangle_soup(
        torch.as_tensor(sc.vertices), torch.as_tensor(sc.faces),
        with_normals=False), builder="binned")
    img, st = render_frames_sharded(sc.vertices, sc.faces, sc.camera, sc.sun,
                                    tfs, clusters=cs, **kw)
    assert int(st["primary_hits"]) == int(ref_st["primary_hits"]) > 0
    diff = (img - ref).abs().amax(-1)
    assert float((diff <= 1e-4).double().mean()) >= 0.999


def test_two_level_walk_on_the_binned_cut(monkeypatch):
    # The two-level walk over the binned cut's tree supers (S = 8) against
    # the flat walk on the same rays.
    from ceres_tpu_torch.ops import megakernel as pmk
    from ceres_tpu_torch.ops import prepass

    sc = jscenes.bunny_scene()
    soup = ct.triangle_soup(torch.as_tensor(sc.vertices),
                            torch.as_tensor(sc.faces), with_normals=False)
    cs = pcuts.build_clusters_quality(soup, builder="binned")
    assert cs.super_first is not None and cs.super_S > 1
    eye = torch.as_tensor(np.asarray(sc.camera.eye))
    rng = np.random.default_rng(3)
    d = rng.standard_normal((600, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True))
    flat = pmk.closest_hit_common_origin(soup, eye, d, clusters=cs,
                                         with_counts=True)
    monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    hier = pmk.closest_hit_common_origin(soup, eye, d, clusters=cs,
                                         with_counts=True)
    assert torch.equal(flat[0].mask, hier[0].mask) and flat[0].mask.any()
    m = flat[0].mask
    assert torch.equal(flat[0].prim_id[m], hier[0].prim_id[m])
    assert int(hier[-1]["mt_block_visits"]) > 0


# -- the native OBJ parser -----------------------------------------------------

@pytest.mark.skipif(NO_GXX, reason="no g++ to build the native parser")
@pytest.mark.parametrize("name", ["bunny", "dragon"])
def test_native_obj_parser_matches_python(name):
    path = os.path.join(ROOT, "data", f"{name}.obj")
    v_n, f_n = pio_native.parse_obj_file(path)
    v_p, f_p = _obj(name)
    assert v_n.dtype == np.float32 and f_n.dtype == np.int32
    np.testing.assert_array_equal(v_n, v_p)
    np.testing.assert_array_equal(f_n, f_p)
    v_l, f_l = pobj.load_obj(path)          # paths take the native parser
    np.testing.assert_array_equal(v_l, v_p)
    np.testing.assert_array_equal(f_l, f_p)


@pytest.mark.skipif(NO_GXX, reason="no g++ to build the native parser")
def test_native_obj_quads_and_negative_indices(tmp_path):
    text = ("\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\nf -4 -3 -2\n"
            "vn 0 0 1\nvt 0 0\nf 1/1/1 2/1/1 3/1/1\n")
    path = tmp_path / "quad.obj"
    path.write_text(text)
    v_n, f_n = pio_native.parse_obj_file(str(path))
    v_p, f_p = pobj.parse_obj(text)
    np.testing.assert_array_equal(v_n, v_p)
    np.testing.assert_array_equal(f_n, f_p)
    assert f_n.shape == (4, 3)
    with pytest.raises(OSError, match="rc=1"):
        pio_native.parse_obj_file(str(tmp_path / "missing.obj"))


# -- the fixture -----------------------------------------------------------------

def _jax_record(key):
    """The fixture entry ``key`` ("scene/builder") as the JAX package
    builds it now."""
    scene, builder = key.split("/")
    jsoup, _ = _soups(*_mesh(scene))
    if builder == "ploc":
        tree = jploc.build_ploc(jsoup)
        return pcuts.cut_record(
            convert.cluster_set(jcuts.clusters_from_ploc(jsoup, tree)),
            convert.ploc_tree(tree))
    return pcuts.cut_record(convert.cluster_set(
        jcuts.build_clusters_quality(jsoup, builder=builder)))


def _port_record(key):
    from ceres_tpu_torch.models.mesh import subdivide

    scene, builder = key.split("/")
    _, psoup = _soups(*_mesh(scene, subdivide))
    if builder == "ploc":
        tree = pploc.build_ploc(psoup)
        return pcuts.cut_record(pcuts.clusters_from_ploc(psoup, tree), tree)
    return pcuts.cut_record(pcuts.build_clusters_quality(psoup,
                                                         builder=builder))


@pytest.mark.parametrize("key", LIVE)
def test_fixture_is_the_jax_cut_and_the_port_s(key):
    with open(FIXTURE) as fh:
        want = json.load(fh)[key]
    assert _jax_record(key) == want
    assert _port_record(key) == want


def _make_trees():
    """The JAX package's slow trees, into TREES."""
    trees = {}

    def keep(key, bvh):
        for f in FIELDS:
            trees[f"{key}/{f}"] = getattr(bvh, f)

    for name in ("t2000", "bunny1500"):
        p0, p1, p2 = _corners(name)
        keep(f"sbvh/{name}", jsbvh.build_sbvh(p0, p1, p2))
        keep(f"reinsert/{name}", jri.optimize_reinsertion(
            jgb.build_sweep_sah(*_boxes(p0, p1, p2))))
    # bunny_scene()'s corners as build_clusters_quality takes them from
    # the soup (p1 = p0 - e1, p2 = e2 + p0).
    sc = jscenes.bunny_scene()
    jsoup, _ = _soups(sc.vertices, sc.faces)
    p0 = np.asarray(jsoup.p0)
    keep("reinsert/bunny_scene", jri.optimize_reinsertion(jgb.build_sweep_sah(
        *_boxes(p0, p0 - np.asarray(jsoup.e1), np.asarray(jsoup.e2) + p0))))
    np.savez_compressed(TREES, **trees)
    print("wrote", TREES, flush=True)


def _make_records():
    """The JAX package's cut fingerprints, into FIXTURE."""
    import time

    keys = ["bunny/sweep", "bunny/binned", "bunny/sbvh", "bunny/ploc",
            "bunny/reinsert", "dragon/sweep", "dragon/binned", "dragon/ploc",
            "bunny3/binned", "bunny4/binned"]
    records = {}
    for key in keys:
        t0 = time.perf_counter()
        records[key] = _jax_record(key)
        print(key, records[key]["num_clusters"],
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(FIXTURE, "w") as fh:
        json.dump(records, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print("wrote", FIXTURE)


if __name__ == "__main__":
    # Regenerate both fixtures with the JAX package (CPU, ~6 min).
    import jax

    jax.config.update("jax_platforms", "cpu")
    _make_trees()
    _make_records()
    sys.exit(0)

"""Shadow-receiver regrouping (``any_hit_to_point(regroup=True)``) against
the JAX package's, on the CPU.

Regrouping re-tiles the shadow wavefront by the receiving points' morton
codes into tiles of 128 rays, skipped rays last; the walk then runs on
those tiles and the flags go back to the caller's order. Both packages
walk the same ClusterSet (the JAX package's cut, converted) from the same
seeded inputs, and the JAX walk runs in interpret mode, as its own tests
run it. Forms: flat with resident weights, flat streamed (both packages'
``_RESIDENT_W_BYTES`` set to 0) and two-level (both packages'
``_HIER_MIN_CLUSTERS`` set to 1, as ``tests/test_megakernel.py``'s
``TestShadowRegroup.test_regrouped_hier_matches`` does), on the random
soup of ``TestShadowRegroup`` and on the bunny's 64 x 64 shadow
wavefront. Rules (``tests/test_torch_hier.py``'s):
  * the ray order equals the JAX package's ``jnp.argsort`` exactly;
  * flags agree on >= 99.9% of rays, each disagreement a boundary case
    (float64 margin within 1e-6 of |det|), since the JAX walk takes its
    numerators from an XLA dot;
  * executed visits are equal when the flags all agree, else within 1%;
  * the regrouped flags equal the port's own unregrouped flags exactly
    (the same pairs are tested, only the tiles change).
And: ``exact_f64=True`` ignores ``regroup``; the walk wrappers take tiles
of 512 rays, or 128 for the shadow walk, and refuse any other width.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.accel import morton as jmorton
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import megakernel as jmk

import ceres_tpu_torch as ct
from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.ops import prepass, walk
from ceres_tpu_torch.utils import convert

from test_torch_walk import EYES, _mesh_scene, _shadow_margin

torch.set_num_threads(1)

FORMS = ["flat", "stream", "hier"]


def _random_scene():
    """``TestShadowRegroup``'s inputs: a random soup of 400 triangles, 700
    receiving points, 30% of them skipped, a far light."""
    rng = np.random.default_rng(7)
    verts = rng.standard_normal((200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, (400, 3)).astype(np.int32)
    points = rng.standard_normal((700, 3)).astype(np.float32) * 0.2
    skip = rng.random(700) < 0.3
    soup = jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                    with_normals=False)
    cs = jcl.build_clusters_treelet(soup)
    return (cs, jnp.asarray([30.0, 45.0, -20.0], jnp.float32),
            tuple(jnp.asarray(points[:, a]) for a in range(3)),
            jnp.asarray(skip))


@pytest.fixture(scope="module", params=["random", "bunny"])
def scene(request, bunny):
    """(cut, light, receiving point columns, skip), JAX arrays."""
    if request.param == "random":
        return _random_scene()
    cs, _, _, sun, points, skip = _mesh_scene(*bunny, EYES["bunny"])
    return cs, sun, points, skip


@pytest.fixture(params=FORMS)
def form(request, monkeypatch):
    if request.param == "stream":
        monkeypatch.setattr(jmk, "_RESIDENT_W_BYTES", 0)
        monkeypatch.setattr(prepass, "_RESIDENT_W_BYTES", 0)
    if request.param == "hier":
        monkeypatch.setattr(jmk, "_HIER_MIN_CLUSTERS", 1)
        monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    return request.param


def _port(x):
    if isinstance(x, tuple):
        return tuple(_port(c) for c in x)
    return convert.tensor(x)


def _jax_order(cs, points, skip):
    """The JAX package's regrouped ray order (its ``any_hit_to_point``
    body): morton codes over the scene root, skipped rays last, argsort."""
    cs = jmk._detach_f32(cs)
    root_lo, root_hi = jmk._scene_root(cs)
    code = jmorton.morton_codes(jnp.stack(points, axis=-1), root_lo, root_hi)
    code = jnp.where(skip, jnp.int32(0x7FFFFFFF), code)
    return np.asarray(jnp.argsort(code))


def _port_regrouped(cs, sun, points, skip, **kw):
    return pmk.any_hit_to_point(None, sun, points, skip=skip, clusters=cs,
                                regroup=True, with_counts=True, **kw)


def test_receiver_order_matches_jax(scene):
    cs, _, points, skip = scene
    ref = _jax_order(cs, points, skip)
    got = pmk._receiver_order(convert.cluster_set(cs), _port(points),
                              _port(skip))
    np.testing.assert_array_equal(got.numpy(), ref)
    # Skipped rays sort last, in their own order (ties kept stable).
    n_skip = int(np.asarray(skip).sum())
    assert n_skip > 0
    tail = got.numpy()[len(ref) - n_skip:]
    np.testing.assert_array_equal(tail, np.nonzero(np.asarray(skip))[0])


def test_regrouped_walk_takes_its_form(scene, form):
    # The regrouped inputs are 128-ray tiles in the form asked for, and
    # the walk on them is the 128-ray variant of that form.
    cs, sun, points, skip = scene
    pcs = convert.cluster_set(cs)
    perm = pmk._receiver_order(pcs, _port(points), _port(skip))
    args, opts = pmk._any_dest_inputs(
        pcs, _port(sun), tuple(c[perm] for c in _port(points)),
        _port(skip)[perm], tile=pmk._REGROUP_TILE)
    n_tiles = args[0].numel()
    assert pmk._REGROUP_TILE == 128
    assert n_tiles == -(-len(perm) // 128)
    assert args[2].shape == (4, n_tiles * 128) and args[4].shape == (
        n_tiles * 128,)
    assert (opts["S"] > 1) == (form == "hier")
    assert opts["stream"] == (form == "stream")
    assert walk._variant("any_dest", opts["S"], opts["stream"], 128) == (
        "walk_any_dest" + {"flat": "", "stream": "_stream",
                           "hier": "_hier"}[form] + "_t128")


def test_regrouped_matches_jax(scene, form):
    cs, sun, points, skip = scene
    ref, ref_counts = jmk.any_hit_to_point(None, sun, points, skip=skip,
                                           clusters=cs, regroup=True,
                                           with_counts=True)
    got, counts = _port_regrouped(convert.cluster_set(cs), _port(sun),
                                  _port(points), _port(skip))
    ref, got = np.asarray(ref), got.numpy()
    assert ref.sum() > 0
    differ = np.nonzero(got != ref)[0]
    assert len(differ) <= 0.001 * len(ref), len(differ)
    d = tuple(np.asarray(points[a] - sun[a]) for a in range(3))
    for ray in differ:   # boundary cases only
        assert abs(_shadow_margin(cs, sun, d, ray)) <= 1e-6
    steps, ref_steps = int(counts["traversal_steps"]), int(
        ref_counts["mt_block_visits"])
    if len(differ) == 0:
        assert steps == ref_steps
    else:
        assert abs(steps - ref_steps) <= 0.01 * ref_steps
    assert int(counts["mt_block_visits"]) == steps
    assert int(counts["mt_pairs"]) == steps * 128 * 128
    assert int(ref_counts["mt_pairs"]) == ref_steps * 128 * 128


def test_regrouped_matches_unregrouped(scene, form):
    cs, sun, points, skip = scene
    pcs = convert.cluster_set(cs)
    got, counts = _port_regrouped(pcs, _port(sun), _port(points),
                                  _port(skip))
    base, base_counts = pmk.any_hit_to_point(
        None, _port(sun), _port(points), skip=_port(skip), clusters=pcs,
        regroup=False, with_counts=True)
    assert int(base.sum()) > 0
    assert torch.equal(got, base)
    assert int(base_counts["mt_pairs"]) == (
        int(base_counts["traversal_steps"]) * 512 * 128)
    # Only the tiles change: the same flags from other visits.
    assert int(counts["traversal_steps"]) > 0


def test_regroup_default_and_false_are_off(scene):
    cs, sun, points, skip = scene
    pcs = convert.cluster_set(cs)
    args = (None, _port(sun), _port(points))
    kw = dict(skip=_port(skip), clusters=pcs, with_counts=True)
    off = pmk.any_hit_to_point(*args, **kw)
    for regroup in (None, False):
        flags, counts = pmk.any_hit_to_point(*args, regroup=regroup, **kw)
        assert torch.equal(flags, off[0])
        assert int(counts["mt_pairs"]) == int(off[1]["mt_pairs"])
    on = pmk.any_hit_to_point(*args, regroup=128, **kw)
    assert torch.equal(on[0], off[0])
    assert int(on[1]["mt_pairs"]) == int(on[1]["traversal_steps"]) * 128 * 128


def test_exact_f64_ignores_regroup(bunny):
    verts, faces = bunny
    soup = ct.triangle_soup(torch.as_tensor(verts, dtype=torch.float64),
                            torch.as_tensor(faces), with_normals=False)
    sun = torch.as_tensor([-50.0, 100.0, 0.0], dtype=torch.float64)
    points = soup.p0[:300] + 0.25 * soup.e2[:300] + 0.1 * soup.e1[:300]
    skip = torch.arange(300) % 4 == 0
    exact = pmk.any_hit_to_point(soup, sun, points, skip=skip,
                                 exact_f64=True, with_counts=True)
    grouped = pmk.any_hit_to_point(soup, sun, points, skip=skip,
                                   exact_f64=True, regroup=True,
                                   with_counts=True)
    assert torch.equal(grouped[0], exact[0]) and int(exact[0].sum()) > 0
    assert {k: int(v) for k, v in grouped[1].items()} == {
        k: int(v) for k, v in exact[1].items()}


def test_walk_refuses_other_tile_widths(scene):
    cs, sun, points, skip = scene
    pcs = convert.cluster_set(cs)
    for tile in (512, 128):
        args, opts = pmk._any_dest_inputs(pcs, _port(sun), _port(points),
                                          _port(skip), tile=tile)
        flags, visits = walk.walk_any_dest(*args, **opts)
        assert flags.shape == (args[0].numel() * tile,)
        assert visits.shape == args[0].shape
    counts, keys, rays, w, occ0 = args
    # 256 rays a tile: no kernel takes it.
    two = (counts[:1], keys[:1], rays[:, :256].contiguous(), w, occ0[:256])
    with pytest.raises(ValueError, match="tiles of 256 rays"):
        walk.walk_any_dest(*two, **opts)
    # The other modes keep 512-ray tiles.
    with pytest.raises(ValueError, match="tiles of 128 rays"):
        walk.walk_closest(counts, keys, rays, w)
    with pytest.raises(ValueError, match="tiles of 256 rays"):
        walk.resident_clusters("any_dest", 1, False, torch.device("cpu"), 256)
    with pytest.raises(ValueError, match="tiles of 128 rays"):
        walk.resident_clusters("closest", 1, False, torch.device("cpu"), 128)


def test_128_ray_variants_are_counted_apart():
    # The 512-ray names and counts are as before; the 128-ray shadow
    # variants have names of their own, and a plain run counts nothing.
    t128 = {"walk_any_dest_t128", "walk_any_dest_stream_t128",
            "walk_any_dest_hier_t128", "walk_any_dest_hier_stream_t128"}
    t512 = {walk._variant(m, S, st) for m in walk.RAY_ROWS for S in (1, 2)
            for st in (False, True)}
    assert len(t512) == 16 and "walk_any_dest" in t512
    assert set(walk.launches) == t512 | t128
    assert {walk._variant("any_dest", S, st, 128) for S in (1, 2)
            for st in (False, True)} == t128
    cs, sun, points, skip = _random_scene()
    walk.reset_launches()
    _port_regrouped(convert.cluster_set(cs), _port(sun), _port(points),
                    _port(skip))
    assert not any(walk.launches.values())

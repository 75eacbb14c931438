"""The large-scene path against the JAX package: the two-level walk's
super inputs, the walk-variant rules, the plain two-level and streamed
walks, and ``render()`` on its default (treelet) structure.

Both packages walk the same ClusterSet (the JAX package's treelet cut,
converted), so the walks see the same blocks, supers and boxes. The
two-level walk is forced on small scenes by setting both packages'
``_HIER_MIN_CLUSTERS`` to 1, as ``tests/test_megakernel.py`` does, and
the streamed form by setting ``_RESIDENT_W_BYTES`` to 0. Tolerances
(the repo's rule for near ties: compare where ids agree, check each
disagreement): the JAX walk takes its Möller-Trumbore numerators from an
XLA dot, so
  * winner ids agree on >= 99.9% of rays, and each disagreement is a near
    tie (both triangles' t in float64 within 1e-5 relative);
  * occlusion flags agree on >= 99.9% of rays, and each disagreement is a
    boundary case (float64 margin within 1e-6 of |det|);
  * executed visits are equal when ids and flags all agree; a near-tie
    winner that differs moves the prune, so then they may differ by 1%.
The super inputs (``_super_members``, ``_tile_hulls``) are bit-equal.

Also here: the JAX-made large-scene fixture the card's smoke test holds
the port to (``tests/fixtures/torch_port_bunny_subdiv4_64.npz``, the 4x
subdivided bunny, 1,271,808 triangles; regenerate with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_hier.py``).
The port's own treelet build at that size takes about 40 s on one CPU
thread, so only the card renders it.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.camera import camera_ray_columns as jax_ray_columns
from ceres_tpu.models.mesh import subdivide as jax_subdivide
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import megakernel as jmk
from ceres_tpu.render import renderer as jrenderer
from ceres_tpu.utils import tiling as jtiling

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel import clusters as pcl
from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.ops import prepass, walk
from ceres_tpu_torch.utils import convert

from test_torch_walk import _shadow_margin, _slot_t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                       "torch_port_bunny_subdiv4_64.npz")
SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)
EYE = np.asarray([0.0, 0.1, -0.3], np.float32)


def _bench_camera(verts):
    return JaxCamera.make(eye=EYE, dir=verts.mean(axis=0) - EYE, up=(0, 1, 0),
                          fov=60.0)


def _bunny_scene(verts, faces):
    cs = jax.jit(jcl.build_clusters_treelet)(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False))
    cam = _bench_camera(verts)
    dirs = tuple(jtiling.swizzle_plane(p) for p in jax_ray_columns(cam, 64, 64))
    hit = jmk.closest_hit_common_origin(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces)), cam.eye, dirs,
        clusters=cs)
    t = jnp.where(hit.mask, hit.t, 0.0)
    # Receivers a hair in front of the surface, as the renderer offsets them.
    points = tuple(cam.eye[a] + t * (1.0 - 1e-4) * dirs[a] for a in range(3))
    return cs, cam.eye, dirs, jnp.asarray(SUN), points, ~hit.mask


def _random_scene():
    rng = np.random.default_rng(12)
    verts = rng.standard_normal((200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, (400, 3)).astype(np.int32)
    cs = jax.jit(jcl.build_clusters_treelet)(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False))
    d = rng.standard_normal((3, 1000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    points = (rng.standard_normal((3, 1000)) * 0.3).astype(np.float32)
    skip = rng.random(1000) < 0.3
    return (cs, jnp.asarray([0.0, 0.0, -4.0], jnp.float32),
            tuple(jnp.asarray(c) for c in d),
            jnp.asarray([30.0, 45.0, -20.0], jnp.float32),
            tuple(jnp.asarray(c) for c in points), jnp.asarray(skip))


@pytest.fixture(scope="module", params=["random", "bunny"])
def scene(request, bunny):
    if request.param == "random":
        return _random_scene()
    return _bunny_scene(*bunny)


@pytest.fixture
def two_level(monkeypatch):
    monkeypatch.setattr(jmk, "_HIER_MIN_CLUSTERS", 1)
    monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)


def _port(x):
    if isinstance(x, tuple):
        return tuple(convert.tensor(c) for c in x)
    return convert.tensor(x)


def _check_winners(scene, ref, ref_steps, got, steps):
    cs, eye, dirs = scene[:3]
    R = dirs[0].shape[0]
    assert (ref >= 0).sum() > 0
    differ = np.nonzero(got != ref)[0]
    assert len(differ) <= 0.001 * R, len(differ)
    for ray in differ:   # near ties only
        assert got[ray] >= 0 and ref[ray] >= 0
        ta = _slot_t(cs, eye, dirs, got[ray], ray)
        tb = _slot_t(cs, eye, dirs, ref[ray], ray)
        assert abs(ta - tb) <= 1e-5 * max(abs(ta), abs(tb))
    if len(differ) == 0:
        assert steps == ref_steps
    else:                # a different near-tie winner moves the prune
        assert abs(steps - ref_steps) <= 0.01 * ref_steps


def _check_flags(scene, ref, ref_steps, got, steps):
    cs, _, _, sun, points, skip = scene
    assert (ref & ~np.asarray(skip)).sum() > 0
    differ = np.nonzero(got != ref)[0]
    assert len(differ) <= 0.001 * len(ref), len(differ)
    d = tuple(np.asarray(points[a] - sun[a]) for a in range(3))
    for ray in differ:   # boundary cases only
        assert abs(_shadow_margin(cs, sun, d, ray)) <= 1e-6
    if len(differ) == 0:
        assert steps == ref_steps
    else:
        assert abs(steps - ref_steps) <= 0.01 * ref_steps


def _jax_closest(scene):
    cs, eye, dirs = scene[:3]
    pidx, counts = jmk._closest_search(cs, eye, dirs)
    return np.asarray(pidx), int(counts["traversal_steps"])


def _port_closest(scene, **opts_override):
    cs, eye, dirs = scene[:3]
    args, opts = pmk._closest_inputs(convert.cluster_set(cs), _port(eye),
                                     _port(dirs))
    opts.update(opts_override)
    pidx, visits = walk.walk_closest(*args, **opts)
    return pidx.numpy()[:dirs[0].shape[0]], int(visits.sum()), opts


def _jax_shadow(scene):
    cs, _, _, sun, points, skip = scene
    occ, counts = jmk.any_hit_to_point(None, sun, points, skip=skip,
                                       clusters=cs, with_counts=True)
    return np.asarray(occ), int(counts["traversal_steps"])


def _port_shadow(scene, **opts_override):
    cs, _, _, sun, points, skip = scene
    args, opts = pmk._any_dest_inputs(convert.cluster_set(cs), _port(sun),
                                      _port(points), _port(skip))
    opts.update(opts_override)
    occ, visits = walk.walk_any_dest(*args, **opts)
    R = points[0].shape[0]
    return (occ.numpy()[:R] == 1) & ~np.asarray(skip), int(visits.sum()), opts


def test_super_inputs_are_bit_equal(scene):
    cs, eye = scene[0], scene[1]
    lo, hi = cs.lo - eye, cs.hi - eye
    n_c, S = cs.num_clusters, cs.super_S
    uniform = np.minimum(np.arange(-(-n_c // S)) * S, n_c).astype(np.int32)
    for first in (np.asarray(cs.super_first), uniform):
        ref = jmk._super_members(lo, hi, jnp.asarray(first), S)
        got = prepass._super_members(_port(lo), _port(hi), _port(first), S)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))
    dirs = scene[2]
    dp = tuple(jmk._pad_rays(c) for c in dirs)
    dt = tuple(c.reshape(-1, jmk.TILE) for c in dp)
    alive = (dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]) > 0.0
    ref = jmk._tile_hulls(dt, alive)
    got = prepass._tile_hulls(_port(dt), _port(alive))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))


def test_walk_variant_rules_match():
    for n_c in (61, 78, 368, 512, 513, 4968, 12288, 12289, 19872):
        assert prepass._super_factor(n_c) == jmk._super_factor(n_c), n_c
        packed = jax.ShapeDtypeStruct((n_c, 8, 4 * pcl.CLUSTER_SIZE),
                                      jnp.float32)
        assert prepass._use_stream(n_c) == jmk._use_stream(packed), n_c
    # The two large scenes: 3x subdivided bunny (4,968 treelet blocks)
    # walks flat and streamed; 4x (19,872 blocks, S = 32, weights padded
    # by S) two-level and streamed; bunny and dragon flat and resident.
    assert prepass._super_factor(4968) == 1 and prepass._use_stream(4968)
    assert prepass._super_factor(19872) == 32
    assert prepass._use_stream(19872 + 32)
    assert not prepass._use_stream(78) and not prepass._use_stream(368)


def test_hier_setup_matches(scene, two_level):
    cs, eye, dirs = scene[:3]
    dp = tuple(jmk._pad_rays(c) for c in dirs)
    dt = tuple(c.reshape(-1, jmk.TILE) for c in dp)
    alive = (dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]) > 0.0
    w = jcl.cluster_weights_common_origin_packed(cs, eye)
    ref = jmk._hier_setup(cs.lo - eye, cs.hi - eye, dt, alive, None, w, cs=cs)
    pcs = convert.cluster_set(cs)
    pw = pcl.cluster_weights_common_origin(pcs, _port(eye))
    got = prepass._hier_setup(pcs.lo - _port(eye), pcs.hi - _port(eye),
                              _port(dt), _port(alive), pw, cs=pcs)
    assert got[0] == ref[0] == cs.super_S > 1
    for a, b in zip(got[1:6], ref[1:6]):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    assert got[6].shape[0] == ref[6].shape[0] == cs.num_clusters + got[0]
    assert not got[6][cs.num_clusters:].any()


def test_two_level_closest_matches_jax(scene, two_level):
    ref, ref_steps = _jax_closest(scene)
    got, steps, opts = _port_closest(scene)
    assert opts["S"] > 1 and not opts["stream"]
    _check_winners(scene, ref, ref_steps, got, steps)


def test_two_level_any_dest_matches_jax(scene, two_level):
    ref, ref_steps = _jax_shadow(scene)
    got, steps, opts = _port_shadow(scene)
    assert opts["S"] > 1 and not opts["stream"]
    _check_flags(scene, ref, ref_steps, got, steps)


def test_streamed_walks_match_jax(scene, two_level, monkeypatch):
    monkeypatch.setattr(jmk, "_RESIDENT_W_BYTES", 0)
    monkeypatch.setattr(prepass, "_RESIDENT_W_BYTES", 0)
    ref, ref_steps = _jax_closest(scene)
    got, steps, opts = _port_closest(scene)
    assert opts["stream"]
    _check_winners(scene, ref, ref_steps, got, steps)
    ref, ref_steps = _jax_shadow(scene)
    got, steps, opts = _port_shadow(scene)
    assert opts["stream"]
    _check_flags(scene, ref, ref_steps, got, steps)


@pytest.mark.parametrize("mode", ["closest", "any_dest"])
def test_stream_flag_changes_nothing(scene, two_level, mode):
    run = _port_closest if mode == "closest" else _port_shadow
    out0, steps0, _ = run(scene, stream=False)
    out1, steps1, _ = run(scene, stream=True)
    np.testing.assert_array_equal(out0, out1)
    assert steps0 == steps1 > 0


@pytest.mark.parametrize("mode", ["closest", "any_dest"])
def test_two_level_agrees_with_flat(scene, monkeypatch, mode):
    # Same structure, walked flat and two-level by the port. Visit order
    # differs, so a near-tie winner may differ (ties go to the earlier
    # visit); occlusion is order-free.
    run = _port_closest if mode == "closest" else _port_shadow
    flat, flat_steps, opts = run(scene)
    assert opts["S"] == 1
    monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    hier, hier_steps, opts = run(scene)
    assert opts["S"] > 1 and hier_steps > 0
    if mode == "any_dest":
        np.testing.assert_array_equal(hier, flat)
        return
    np.testing.assert_array_equal(hier >= 0, flat >= 0)
    cs, eye, dirs = scene[:3]
    for ray in np.nonzero(hier != flat)[0]:
        ta = _slot_t(cs, eye, dirs, hier[ray], ray)
        tb = _slot_t(cs, eye, dirs, flat[ray], ray)
        assert abs(ta - tb) <= 1e-5 * max(abs(ta), abs(tb))


def test_wrapper_checks_two_level_inputs(scene, two_level):
    args, opts = pmk._closest_inputs(convert.cluster_set(scene[0]),
                                     _port(scene[1]), _port(scene[2]))
    S = opts["S"]
    with pytest.raises(ValueError, match="hull, bbox and first"):
        walk.walk_closest(*args, S=S)
    with pytest.raises(ValueError, match="S = 33"):
        walk.walk_closest(*args, opts["hull"], opts["bbox"], opts["first"],
                          S=33)
    with pytest.raises(ValueError, match="bbox"):
        walk.walk_closest(*args, opts["hull"], opts["bbox"][:, :7],
                          opts["first"], S=S)
    with pytest.raises(ValueError, match="two-level"):
        walk.walk_closest(args[0], args[1], args[2], args[3][:-S],
                          opts["hull"])


def test_render_default_structure_matches_jax(bunny):
    # render() without clusters: both packages build the LBVH treelet cut
    # (the port on the tensors' device) and walk it.
    verts, faces = bunny
    cam = _bench_camera(verts)
    jimg, jst = jrenderer.render(verts, faces, cam, SUN, width=64, height=64,
                                 mode="smooth", backend="megakernel",
                                 traversal_stats=True)
    pimg, pst = ct.render(verts, faces, convert.camera(cam), SUN, width=64,
                          height=64, backend="megakernel",
                          traversal_stats=True, device="cpu")
    jimg, pimg = np.asarray(jimg), pimg.numpy()
    off = np.abs(pimg - jimg).max(-1) > 1e-4
    assert off.mean() < 0.005
    for k in ("rays", "hits"):
        assert abs(int(pst[k]) - int(jst[k])) <= 0.002 * int(jst[k]), k
    # The same structure: executed visits agree (the quality cut that the
    # port built here before would differ by 14-32%).
    steps, ref_steps = int(pst["traversal_steps"]), int(jst["traversal_steps"])
    assert abs(steps - ref_steps) <= 0.01 * ref_steps, (steps, ref_steps)


def test_large_scene_fixture_is_consistent():
    with np.load(FIXTURE) as ref:
        ref = dict(ref)
    size = ref["image"].shape[0]
    assert ref["image"].shape == (size, size, 3)
    assert int(ref["triangles"]) == 4968 * 4 ** 4
    assert int(ref["rays"]) == size * size + int(ref["primary_hits"])
    assert int(ref["hits"]) == int(ref["primary_hits"]) + int(
        ref["shadow_hits"])
    assert int(ref["primary_hits"]) > 0 and ref["image"].max() > 0


def _large_fixture():
    """The JAX package's render of the 4x subdivided bunny at 64 x 64
    through ``render()`` (its own treelet cut: two-level, streamed)."""
    from ceres_tpu.io.obj import load_obj

    verts, faces = jax_subdivide(*load_obj(os.path.join(ROOT, "data",
                                                        "bunny.obj")), 4)
    image, stats = jrenderer.render(verts, faces, _bench_camera(verts), SUN,
                                    width=64, height=64, mode="smooth",
                                    backend="megakernel", traversal_stats=True)
    return dict(image=np.asarray(image), triangles=faces.shape[0],
                **{k: int(stats[k]) for k in (
                    "rays", "hits", "primary_hits", "shadow_hits",
                    "traversal_steps")})


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **_large_fixture())
    print("wrote", FIXTURE)

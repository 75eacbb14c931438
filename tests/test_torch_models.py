"""The port's mesh, camera, tiling and shading against the JAX package.

Same numpy inputs (seeded) through both packages, compared at float32
with ``atol=1e-6``: elementwise f32 math whose fusion order (and XLA's
FMA contraction) differs from torch's by a few ulps. Shading is held to
``atol=3e-6``: XLA's CPU rsqrt is not the correctly rounded 1/sqrt that
torch computes (about 1 value in 9 differs by an ulp, 1.2e-7 relative),
and the specular term raises the normalised half vector's dot to the
24th power, which multiplies that relative error by 24.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.models import camera as jcam
from ceres_tpu.models import mesh as jmesh
from ceres_tpu.models import shading as jshading
from ceres_tpu.render.scenes import data_dir
from ceres_tpu.utils import tiling as jtiling

from ceres_tpu_torch.io.obj import load_obj, parse_obj
from ceres_tpu_torch.models import camera as pcam
from ceres_tpu_torch.models import mesh as pmesh
from ceres_tpu_torch.models import shading as pshading
from ceres_tpu_torch.utils import convert
from ceres_tpu_torch.utils import tiling as ptiling

torch.set_num_threads(1)

ATOL = 1e-6
SHADING_ATOL = 3e-6


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0,
                               atol=atol)


def _random_mesh(seed, V=80, F=160):
    rng = np.random.default_rng(seed)
    verts = rng.standard_normal((V, 3)).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    return verts, faces


def test_obj_parser_matches(bunny):
    from ceres_tpu.io.obj import parse_obj as jax_parse

    text = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2//2 3/3/3 -1\n"
    for a, b in zip(parse_obj(text), jax_parse(text)):
        np.testing.assert_array_equal(a, b)
    verts, faces = load_obj(os.path.join(data_dir(), "bunny.obj"))
    np.testing.assert_array_equal(verts, bunny[0])
    np.testing.assert_array_equal(faces, bunny[1])


@pytest.mark.parametrize("source", ["random", "bunny"])
def test_triangle_soup(source, bunny):
    verts, faces = _random_mesh(1) if source == "random" else bunny
    ref = jmesh.triangle_soup(jnp.asarray(verts), jnp.asarray(faces))
    got = pmesh.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces))
    for name in ("p0", "e1", "e2"):   # gathers and one subtraction: exact
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    _close(got.n, ref.n)
    _close(got.corner_normals, ref.corner_normals)
    assert pmesh.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                               with_normals=False).corner_normals is None


def test_vertex_normals_unreferenced_vertex_is_zero():
    verts, faces = _random_mesh(2)
    verts = np.concatenate([verts, np.ones((1, 3), np.float32)])
    got = pmesh.vertex_normals(torch.as_tensor(verts), torch.as_tensor(faces))
    ref = jmesh.vertex_normals(jnp.asarray(verts), jnp.asarray(faces))
    _close(got, ref)
    assert not got[-1].any()


def _cameras():
    return [
        dict(eye=(0.0, 0.1, -0.3), dir=(-0.028, -0.006, 0.309),
             up=(0, 1, 0), fov=60.0),
        dict(eye=(1.5, -2.0, 3.0), dir=(-1.0, 0.5, -2.0), up=(0, 0, 1),
             fov=35.0),
    ]


@pytest.mark.parametrize("cam", _cameras())
def test_camera_basis(cam):
    ref = jcam.camera_basis(jcam.Camera.make(**cam), 96, 54)
    got = pcam.camera_basis(pcam.Camera.make(**cam), 96, 54)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("cam", _cameras())
def test_camera_ray_columns(cam):
    ref = jcam.camera_ray_columns(jcam.Camera.make(**cam), 70, 45)
    got = pcam.camera_ray_columns(convert.camera(jcam.Camera.make(**cam)),
                                  70, 45)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (45, 70)
        _close(g, r)


@pytest.mark.parametrize("shape", [(64, 64), (45, 70), (1080, 1920)])
def test_swizzle_roundtrip(shape):
    plane = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jtiling.swizzle_plane(jnp.asarray(plane)))
    got = ptiling.swizzle_plane(torch.as_tensor(plane))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = ptiling.unswizzle_plane(got, *shape)
    np.testing.assert_array_equal(back.numpy(), plane)


def _unit(rng, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    return x / np.linalg.norm(x, axis=0)


def test_smooth_shading_cols():
    rng = np.random.default_rng(4)
    R = 2048
    sun, view = _unit(rng, R), _unit(rng, R)
    corners = np.concatenate([_unit(rng, R) for _ in range(3)])
    u = rng.random(R, dtype=np.float32) * 0.5
    v = rng.random(R, dtype=np.float32) * 0.5
    ref = jshading.smooth_shading_cols(
        tuple(jnp.asarray(c) for c in sun),
        tuple(jnp.asarray(c) for c in corners),
        tuple(jnp.asarray(c) for c in view), jnp.asarray(u), jnp.asarray(v))
    got = pshading.smooth_shading_cols(
        tuple(torch.as_tensor(c) for c in sun),
        tuple(torch.as_tensor(c) for c in corners),
        tuple(torch.as_tensor(c) for c in view), torch.as_tensor(u),
        torch.as_tensor(v))
    for g, r in zip(got, ref):
        _close(g, r, SHADING_ATOL)


def test_smooth_shading_cols_reference_compat():
    rng = np.random.default_rng(5)
    R = 1024
    sun, view = _unit(rng, R), _unit(rng, R)
    corners = np.concatenate([_unit(rng, R) for _ in range(3)])
    u = rng.random(R, dtype=np.float32) * 0.5
    v = rng.random(R, dtype=np.float32) * 0.5
    args = []
    for compat in (False, True):
        ref = jshading.smooth_shading_cols(
            tuple(jnp.asarray(c) for c in sun),
            tuple(jnp.asarray(c) for c in corners),
            tuple(jnp.asarray(c) for c in view), jnp.asarray(u),
            jnp.asarray(v), reference_compat=compat)
        got = pshading.smooth_shading_cols(
            tuple(torch.as_tensor(c) for c in sun),
            tuple(torch.as_tensor(c) for c in corners),
            tuple(torch.as_tensor(c) for c in view), torch.as_tensor(u),
            torch.as_tensor(v), reference_compat=compat)
        for g, r in zip(got, ref):
            _close(g, r, SHADING_ATOL)
        args.append(got)
    # The two weightings differ: the reference mis-pairs (u, v).
    assert max(float((a - b).abs().max())
               for a, b in zip(args[0], args[1])) > 1e-3


@pytest.mark.parametrize("compat", [False, True])
def test_dense_shading_forms(compat):
    rng = np.random.default_rng(6)
    R = 512
    sun, view, n = (_unit(rng, R).T for _ in range(3))
    corners = np.stack([_unit(rng, R).T for _ in range(3)], axis=1)
    u = rng.random(R, dtype=np.float32) * 0.5
    v = rng.random(R, dtype=np.float32) * 0.5
    _close(pshading.lambertian(torch.as_tensor(sun), torch.as_tensor(n)),
           jshading.lambertian(jnp.asarray(sun), jnp.asarray(n)))
    _close(pshading.blinn_phong_spec(torch.as_tensor(sun), torch.as_tensor(n),
                                     torch.as_tensor(view)),
           jshading.blinn_phong_spec(jnp.asarray(sun), jnp.asarray(n),
                                     jnp.asarray(view)), SHADING_ATOL)
    _close(pshading.corner_shade(torch.as_tensor(sun), torch.as_tensor(n),
                                 torch.as_tensor(view)),
           jshading.corner_shade(jnp.asarray(sun), jnp.asarray(n),
                                 jnp.asarray(view)), SHADING_ATOL)
    _close(pshading.smooth_shading(
        torch.as_tensor(sun), torch.as_tensor(corners), torch.as_tensor(view),
        torch.as_tensor(u), torch.as_tensor(v), reference_compat=compat),
        jshading.smooth_shading(
            jnp.asarray(sun), jnp.asarray(corners), jnp.asarray(view),
            jnp.asarray(u), jnp.asarray(v), reference_compat=compat),
        SHADING_ATOL)
    big = n * 3.0
    _close(pshading.flat_shading(torch.as_tensor(big)),
           jshading.flat_shading(jnp.asarray(big)))


def test_flat_shading_cols_guard():
    rng = np.random.default_rng(7)
    n = rng.standard_normal((3, 300)).astype(np.float32)
    n[:, :20] = 0.0                       # misses: zero normals
    guard = np.ones(300, bool)
    guard[:20] = False
    got = pshading.flat_shading_cols(tuple(torch.as_tensor(c) for c in n),
                                     guard=torch.as_tensor(guard))
    ref = jshading.flat_shading_cols(tuple(jnp.asarray(c) for c in n),
                                     guard=jnp.asarray(guard))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        _close(g, r, SHADING_ATOL)


@pytest.mark.parametrize("cam", _cameras())
def test_camera_rays(cam):
    ref = jcam.camera_rays(jcam.Camera.make(**cam), 70, 45)
    got = pcam.camera_rays(convert.camera(jcam.Camera.make(**cam)), 70, 45)
    assert tuple(got.shape) == (45, 70, 3)
    _close(got, ref)
    rows = pcam.camera_rays_rows(convert.camera(jcam.Camera.make(**cam)), 70,
                                 45, 10, 7)
    _close(rows, jcam.camera_rays_rows(jcam.Camera.make(**cam), 70, 45, 10, 7))
    np.testing.assert_array_equal(rows.numpy(), got[10:17].numpy())


@pytest.mark.parametrize("axis, degrees", [(0, 90.0), (1, -145.0), (2, 33.0)])
def test_rotate_vertices_about_axis(bunny, axis, degrees):
    from ceres_tpu.models import transform as jtf
    from ceres_tpu_torch.models import transform as ptf

    verts = bunny[0]
    ref = np.asarray(jtf.rotate_vertices_about_axis(verts, axis, degrees))
    got = ptf.rotate_vertices_about_axis(verts, axis, degrees)
    assert got.dtype == torch.float32
    _close(got, ref, 2e-6 * np.abs(ref).max())


def test_transform_composition():
    from ceres_tpu.models import transform as jtf
    from ceres_tpu_torch.models import transform as ptf

    pts = np.random.default_rng(8).standard_normal((50, 3)).astype(np.float32)
    ref = (jtf.Transform.identity().rotate((1.0, 2.0, 0.5), 0.7).scale(1.5)
           .translate((0.1, -0.2, 3.0)).rotate((0.0, 0.0, 1.0), -1.1))
    got = (ptf.Transform.identity().rotate((1.0, 2.0, 0.5), 0.7).scale(1.5)
           .translate((0.1, -0.2, 3.0)).rotate((0.0, 0.0, 1.0), -1.1))
    _close(got.a, ref.a)
    _close(got.v, ref.v)
    _close(ptf.transform_mesh_vertices(got, torch.as_tensor(pts)),
           jtf.transform_mesh_vertices(ref, jnp.asarray(pts)), 1e-5)
    conv = convert.transform(ref)
    _close(conv(torch.as_tensor(pts)), ref(jnp.asarray(pts)), 1e-5)


def test_package_exports_match_jax():
    import ceres_tpu
    import ceres_tpu_torch

    assert ceres_tpu_torch.__all__ == ceres_tpu.__all__
    for name in ceres_tpu_torch.__all__:
        assert getattr(ceres_tpu_torch, name) is not None, name
    assert ceres_tpu_torch.vertex_normals is pmesh.vertex_normals
    assert ceres_tpu_torch.camera_rays is pcam.camera_rays


def test_mesh(bunny):
    verts, faces = bunny
    ref = jmesh.Mesh(vertices=jnp.asarray(verts), faces=jnp.asarray(faces))
    got = pmesh.Mesh(vertices=torch.as_tensor(verts),
                     faces=torch.as_tensor(faces))
    assert (got.num_vertices, got.num_faces) == (ref.num_vertices,
                                                 ref.num_faces)
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(ref.vertices))
    np.testing.assert_array_equal(got.faces.numpy(), np.asarray(ref.faces))


@pytest.mark.parametrize("source", ["random", "bunny"])
def test_soup_corners_bounds_centers_areas(source, bunny):
    import jax

    verts, faces = _random_mesh(9) if source == "random" else bunny
    ref = jmesh.triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                              with_normals=False)
    got = pmesh.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                              with_normals=False)
    # One addition or subtraction of exact gathers, and XLA's min/max
    # (-0 below +0): bit-equal.
    for name in ("p1", "p2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for g, r in zip(got.bounds(), ref.bounds()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # centers: bit-equal to the jitted JAX function, whose division by 3
    # XLA turns into a multiply by f32(1/3).
    jit_centers = jax.jit(lambda s: s.centers())(ref)
    np.testing.assert_array_equal(got.centers().numpy(),
                                  np.asarray(jit_centers))
    _close(got.centers(), ref.centers())
    _close(got.areas(), ref.areas())


def test_soup_from_points(bunny):
    verts, faces = bunny
    p = [verts[faces[:, k]] for k in range(3)]
    ref = jmesh.soup_from_points(*(jnp.asarray(x) for x in p))
    got = pmesh.soup_from_points(*(torch.as_tensor(x) for x in p))
    for name in ("p0", "e1", "e2"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    _close(got.n, ref.n)
    assert got.corner_normals is None and ref.corner_normals is None


def test_scene_paths_match_jax():
    from ceres_tpu.render import scenes as jscenes
    from ceres_tpu_torch.render import scenes as pscenes

    assert pscenes.DATA_DIR == jscenes.DATA_DIR == pscenes.data_dir()
    assert pscenes.bunny_path() == jscenes.bunny_path()
    assert pscenes.dragon_path() == jscenes.dragon_path()
    for path in (pscenes.bunny_path(), pscenes.dragon_path()):
        assert os.path.isfile(path)
    np.testing.assert_array_equal(load_obj(pscenes.bunny_path())[1],
                                  pscenes.bunny_scene().faces)

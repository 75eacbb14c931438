"""The port's render pipeline against the JAX package's, on the CPU.

Both packages render bunny with the bench camera and sun on the same
SweepSAH cluster cut. Tolerances:
  * ``rays`` exactly (pixels plus primary hits);
  * ``primary_hits``/``shadow_hits`` within 0.1% of the pixels: the JAX
    search takes its Möller-Trumbore numerators from an XLA dot and its
    face normals from XLA's cross product, whose roundings differ from
    the port's separate f32 products, so a silhouette sign test can flip;
  * image pixels where winner and shadow agree within 1e-5 (shading
    math in f32 with a different fusion order).

Also here: the JAX-made fixture the card's smoke test compares with
(``tests/fixtures/torch_port_bunny_128.npz``; regenerate with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_render.py``),
and the check that the port imports without JAX.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel.cuts import build_clusters_quality as jax_quality
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.camera import camera_ray_columns as jax_ray_columns
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import megakernel as jmk
from ceres_tpu.render import renderer as jrenderer
from ceres_tpu.utils import tiling as jtiling

import ceres_tpu_torch as ct
from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_bunny_128.npz")
SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)


def _bench_camera(verts):
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    return JaxCamera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                          fov=60.0)


@pytest.fixture(scope="module")
def scene(bunny):
    verts, faces = bunny
    cs = jax_quality(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                              with_normals=False))
    return verts, faces, _bench_camera(verts), cs


def _jax_render(verts, faces, cam, cs, size):
    config = jrenderer.RenderConfig(width=size, height=size, mode="smooth",
                                    backend="megakernel")
    image, stats = jrenderer.render_pipeline(
        jnp.asarray(verts), jnp.asarray(faces), cam, jnp.asarray(SUN), config,
        clusters=cs)
    return np.asarray(image), {k: int(v) for k, v in stats.items()}


def _port_render(verts, faces, cam, cs, size):
    image, stats = ct.render_pipeline(
        torch.as_tensor(verts), torch.as_tensor(faces), convert.camera(cam),
        torch.as_tensor(SUN),
        ct.RenderConfig(width=size, height=size, backend="megakernel"),
        clusters=convert.cluster_set(cs))
    return image.numpy(), {k: int(v) for k, v in stats.items()}


def _winners(verts, faces, cam, cs, size):
    """Per-pixel winning triangle ids of both packages (-1 at misses),
    raster order."""
    jsoup = jax_soup(jnp.asarray(verts), jnp.asarray(faces))
    dirs = tuple(jtiling.swizzle_plane(p)
                 for p in jax_ray_columns(cam, size, size))
    jhit = jmk.closest_hit_common_origin(jsoup, cam.eye, dirs, clusters=cs)
    phit = pmk.closest_hit_common_origin(
        convert.soup(jsoup), convert.tensor(cam.eye),
        tuple(convert.tensor(d) for d in dirs),
        clusters=convert.cluster_set(cs))

    def raster(x):
        return np.asarray(jtiling.unswizzle_plane(jnp.asarray(x), size, size))

    jid = raster(np.where(np.asarray(jhit.mask), np.asarray(jhit.prim_id), -1))
    pid = raster(torch.where(phit.mask, phit.prim_id, -1).numpy())
    return jid, pid


def test_render_matches_jax(scene):
    verts, faces, cam, cs = scene
    size = 64
    jimg, jst = _jax_render(verts, faces, cam, cs, size)
    pimg, pst = _port_render(verts, faces, cam, cs, size)
    assert pst["rays"] == jst["rays"] == size * size + jst["primary_hits"]
    budget = 0.001 * size * size
    for k in ("primary_hits", "shadow_hits"):
        assert abs(pst[k] - jst[k]) <= budget, (k, pst[k], jst[k])
    assert abs(pst["hits"] - jst["hits"]) <= 2 * budget
    jid, pid = _winners(verts, faces, cam, cs, size)
    agree = (jid == pid) & ((jimg.max(-1) > 0) == (pimg.max(-1) > 0))
    assert (~agree).sum() <= 2 * budget
    np.testing.assert_allclose(pimg[agree], jimg[agree], rtol=0, atol=1e-5)
    assert jimg.max() > 0


def test_render_entry_point_builds_its_own_cut(bunny):
    verts, faces = bunny
    cam = _bench_camera(verts)
    image, stats = ct.render(verts, faces, cam, SUN, width=32, height=32,
                             backend="megakernel", device="cpu")
    assert image.shape == (32, 32, 3) and torch.isfinite(image).all()
    assert int(stats["rays"]) == 32 * 32 + int(stats["primary_hits"])
    assert int(stats["primary_hits"]) > 0


@pytest.mark.parametrize("device", [None, "cpu"])
def test_render_runs_on_the_card_unless_asked(bunny, monkeypatch, device):
    # numpy inputs and no device: render() asks for the card, and with no
    # card it raises rather than fall back; device="cpu" renders here.
    verts, faces = bunny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(width=16, height=16, backend="megakernel", device=device)
    if device is None:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ct.render(verts, faces, _bench_camera(verts), SUN, **kw)
        return
    image, stats = ct.render(verts, faces, _bench_camera(verts), SUN, **kw)
    assert image.device.type == "cpu" and image.shape == (16, 16, 3)
    assert int(stats["primary_hits"]) > 0


@pytest.mark.parametrize("kwargs, item", [
    ({"f64_exact": True}, "M14"),
])
def test_unported_options_name_their_roadmap_item(bunny, kwargs, item):
    # Item M14 is ported: f64_exact renders float64 vertices (here the
    # same image as the float32 search, no sheet being finer than float32
    # resolution) and refuses float32 ones by their dtype.
    verts, faces = bunny
    kw = dict(width=32, height=32, backend="megakernel", device="cpu")
    with pytest.raises(ValueError, match="float64"):
        ct.render(verts, faces, _bench_camera(verts), SUN, **kw, **kwargs)
    v64 = verts.astype(np.float64)
    exact, est = ct.render(v64, faces, _bench_camera(verts), SUN, **kw,
                           **kwargs)
    fast, fst = ct.render(v64, faces, _bench_camera(verts), SUN, **kw)
    assert exact.dtype == torch.float64, item
    assert {k: int(x) for k, x in est.items()} == {k: int(x)
                                                  for k, x in fst.items()}
    torch.testing.assert_close(exact, fast, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kwargs, item", [
    ({"exact_f64": True}, "M14"),
    ({"regroup": 128}, "M13"),
    ({"regroup": True}, "M13"),
])
def test_unported_shadow_options_name_their_roadmap_item(bunny, kwargs, item):
    # any_hit_to_point takes the JAX package's exact_f64= and regroup=;
    # both items are ported. exact_f64 (item M14) refuses a float32 soup
    # by its dtype and gives a float64 soup's flags, here those of its
    # float32 search. regroup (item M13; True, or a truthy 128 as the JAX
    # tests pass it) walks 128-ray tiles regrouped by receiver and gives
    # the flags of regroup=None or False (off, the JAX default).
    verts, faces = bunny
    soup = ct.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                            with_normals=False)
    sun = torch.as_tensor(SUN)
    points = soup.p0[:64] + 0.25 * soup.e2[:64]
    base = pmk.any_hit_to_point(soup, sun, points)
    if item == "M14":
        with pytest.raises(ValueError, match="float64 soup"):
            pmk.any_hit_to_point(soup, sun, points, **kwargs)
        soup64 = ct.triangle_soup(torch.as_tensor(verts, dtype=torch.float64),
                                  torch.as_tensor(faces), with_normals=False)
        args = (soup64, sun.double(), points.double())
        assert torch.equal(pmk.any_hit_to_point(*args, **kwargs),
                           pmk.any_hit_to_point(*args))
    else:
        flags, counts = pmk.any_hit_to_point(soup, sun, points,
                                             with_counts=True, **kwargs)
        assert torch.equal(flags, base) and int(base.sum()) > 0
        assert int(counts["mt_pairs"]) == (int(counts["traversal_steps"])
                                           * 128 * 128)
    assert base.shape == (64,)
    assert torch.equal(pmk.any_hit_to_point(soup, sun, points, regroup=False,
                                            exact_f64=False), base)


@pytest.mark.parametrize("builder", ["nonsense", "lbvh"])
def test_unknown_builder_raises_as_jax(bunny, builder):
    # build_clusters_quality knows sweep, binned, sbvh, ploc and reinsert;
    # any other name is a ValueError in both packages ("lbvh" is the
    # treelet cut's name, not a quality builder).
    from ceres_tpu_torch.accel.cuts import build_clusters_quality

    verts, faces = bunny
    with pytest.raises(ValueError, match=f"unknown builder: {builder}"):
        jax_quality(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False), builder=builder)
    soup = ct.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                            with_normals=False)
    with pytest.raises(ValueError, match=f"unknown builder: {builder}"):
        build_clusters_quality(soup, builder=builder)


def test_unported_inputs_name_their_roadmap_item(bunny):
    # Items M14 and M12 are ported: float64 vertices render in float64
    # (the camera and the sun taken in their dtype), and a sphere given as
    # numpy rows is reshaped and drawn in front of the bunny.
    verts, faces = bunny
    cam = _bench_camera(verts)
    kw = dict(width=32, height=32, backend="megakernel", device="cpu")
    img64, st64 = ct.render(verts.astype(np.float64), faces, cam, SUN, **kw)
    img32, st32 = ct.render(verts, faces, cam, SUN, **kw)
    assert img64.dtype == torch.float64 and img32.dtype == torch.float32
    assert int(st64["rays"]) == int(st32["rays"])
    center = verts.mean(axis=0) + 0.3 * (np.asarray(cam.eye)
                                         - verts.mean(axis=0))
    img, st = ct.render(verts, faces, cam, SUN, spheres=(
        center.astype(np.float64), np.asarray([[0.01]])), **kw)
    assert int(st["primary_hits"]) >= int(st32["primary_hits"])
    assert int((torch.abs(img - img32).amax(-1) > 1e-3).sum()) > 0


def _fixture_render(verts, faces):
    cs = jax_quality(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                              with_normals=False))
    image, stats = _jax_render(verts, faces, _bench_camera(verts), cs, 128)
    return dict(image=image, **{k: stats[k] for k in (
        "rays", "hits", "primary_hits", "shadow_hits")})


def test_fixture_is_the_jax_render(scene):
    verts, faces, _, _ = scene
    fresh = _fixture_render(verts, faces)
    with np.load(FIXTURE) as ref:
        for k in ("rays", "hits", "primary_hits", "shadow_hits"):
            assert int(ref[k]) == fresh[k], k
        np.testing.assert_allclose(ref["image"], fresh["image"], rtol=0,
                                   atol=1e-6)


def test_port_matches_fixture(scene):
    # What the card's smoke test checks, here on the CPU: fewer than 0.5%
    # of pixels off by more than 1e-4, counts within 0.2%.
    verts, faces, cam, cs = scene
    image, stats = _port_render(verts, faces, cam, cs, 128)
    with np.load(FIXTURE) as ref:
        off = np.abs(image - ref["image"]).max(-1) > 1e-4
        assert off.mean() < 0.005
        for k in ("rays", "hits", "primary_hits", "shadow_hits"):
            assert abs(stats[k] - int(ref[k])) <= 0.002 * int(ref[k]), k


def test_port_imports_without_jax():
    code = ("import sys\n"
            "for m in ('jax', 'optax', 'orbax'): sys.modules[m] = None\n"
            "import ceres_tpu_torch, ceres_tpu_torch.render.renderer, "
            "ceres_tpu_torch.render.scenes, ceres_tpu_torch.utils.native, "
            "ceres_tpu_torch.ops.intersect, ceres_tpu_torch.ops.walk, "
            "ceres_tpu_torch.models.transform, ceres_tpu_torch.utils.convert, "
            "ceres_tpu_torch.diff, ceres_tpu_torch.cli.render, "
            "ceres_tpu_torch.cli.anim, ceres_tpu_torch.parallel, "
            "ceres_tpu_torch.parallel.sharded, ceres_tpu_torch.ops.walk_f64, "
            "ceres_tpu_torch.parallel.distributed, "
            "ceres_tpu_torch.parallel.dryrun, "
            "ceres_tpu_torch.parallel.selfcheck, "
            "ceres_tpu_torch.ops.sphere, ceres_tpu_torch.utils.image, "
            "ceres_tpu_torch.accel.ploc, ceres_tpu_torch.accel.sbvh, "
            "ceres_tpu_torch.accel.reinsertion, "
            "ceres_tpu_torch.accel.presplit, ceres_tpu_torch.accel.native, "
            "ceres_tpu_torch.io.native, "
            "ceres_tpu_torch.utils.golden\n"
            "from ceres_tpu_torch.accel import native\n"
            "from ceres_tpu_torch.io import native as io_native\n"
            "native.available(), io_native.available()\n"
            "assert not any(m.split('.')[0] in ('jax', 'optax', 'orbax') "
            "or m.startswith('ceres_tpu.')"
            " for m in sys.modules if sys.modules[m] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


if __name__ == "__main__":
    from ceres_tpu.io.obj import load_obj

    v, f = load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    np.savez_compressed(FIXTURE, **_fixture_render(v, f))
    print("wrote", FIXTURE)

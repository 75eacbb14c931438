"""Spheres in the port against the JAX package, on the CPU.

``ops.sphere`` (pairs, closest, any, normals, the column forms) takes
the same seeded float32 rays and spheres as ``ceres_tpu.ops.sphere``:
distances and normals within rtol 1e-5 where both are finite, the same
misses and winners exactly; gradients w.r.t. centres, radii, origins and
directions within rtol 1e-4, atol 1e-5 x max |g| (the quadratic's
cancellation amplifies rounding near grazing hits). Then the cases of
``tests/test_sphere_scene.py`` through ``render()`` on both backends,
each also against the JAX package's ``render(spheres=)`` under the
image rule: fewer than 0.5% of pixels off by more than 1e-4, rays
exactly, hits within 0.2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.ops import sphere as jsph
from ceres_tpu.render.renderer import render as jax_render

import ceres_tpu_torch as ct
from ceres_tpu_torch.ops import sphere as psph
from ceres_tpu_torch.utils import convert

torch.set_num_threads(1)


def _rays_and_spheres(seed, R=300, S=5):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    origins[:, 2] = -8.0
    dirs = rng.standard_normal((R, 3)).astype(np.float32) * 0.3
    dirs[:, 2] = 1.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    centers = rng.uniform(-3, 3, (S, 3)).astype(np.float32)
    radii = rng.uniform(0.5, 2.0, S).astype(np.float32)
    return origins, dirs, centers, radii


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=1e-6)


def _grads_close(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale)


def test_pairs_closest_any_and_normals_match_jax():
    o, d, c, r = _rays_and_spheres(0)
    j = [jnp.asarray(x) for x in (o, d, c, r)]
    p = [torch.as_tensor(x) for x in (o, d, c, r)]
    _close(psph.intersect_pairs(*p, tmin=1.0, tmax=12.0),
           jsph.intersect_pairs(*j, tmin=1.0, tmax=12.0))
    jh, ph = jsph.closest_hit(*j), psph.closest_hit(*p)
    assert 0 < int(np.asarray(jh.mask).sum()) < o.shape[0]
    np.testing.assert_array_equal(ph.mask.numpy(), np.asarray(jh.mask))
    np.testing.assert_array_equal(ph.sphere_id.numpy(),
                                  np.asarray(jh.sphere_id))
    _close(ph.t, jh.t)
    np.testing.assert_array_equal(psph.any_hit(*p, tmax=9.0).numpy(),
                                  np.asarray(jsph.any_hit(*j, tmax=9.0)))
    m = np.asarray(jh.mask)
    point = o + np.where(m, np.asarray(jh.t), 0.0)[:, None] * d
    np.testing.assert_allclose(
        psph.normal_at(torch.as_tensor(point), p[2], ph.sphere_id).numpy(),
        np.asarray(jsph.normal_at(jnp.asarray(point), j[2], jh.sphere_id)),
        rtol=1e-5, atol=1e-6)


def test_pair_gradients_match_jax():
    o, d, c, r = _rays_and_spheres(1)

    def jloss(o, d, c, r):
        h = jsph.closest_hit(o, d, c, r)
        t = jnp.where(h.mask, h.t, 0.0)
        return jnp.sum(t * jnp.linspace(0.5, 1.5, t.shape[0]))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (o, d, c, r)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (o, d, c, r)]
    h = psph.closest_hit(*leaves)
    t = torch.where(h.mask, h.t, 0.0)
    (t * torch.linspace(0.5, 1.5, t.shape[0])).sum().backward()
    _grads_close([x.grad for x in leaves], want)


def test_column_forms_match_jax():
    o, d, c, r = _rays_and_spheres(2)
    eye = o[0]
    jcols = tuple(jnp.asarray(d[:, a]) for a in range(3))
    pcols = tuple(torch.as_tensor(d[:, a]) for a in range(3))
    jt, jm, jid, jn = jsph.closest_hit_common_origin_cols(
        jnp.asarray(eye), jcols, jnp.asarray(c), jnp.asarray(r))
    pt, pm, pid, pn = psph.closest_hit_common_origin_cols(
        torch.as_tensor(eye), pcols, torch.as_tensor(c), torch.as_tensor(r))
    assert 0 < int(np.asarray(jm).sum()) < d.shape[0]
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jid))
    _close(pt, jt)
    for a in range(3):
        np.testing.assert_allclose(pn[a].numpy(), np.asarray(jn[a]),
                                   rtol=1e-5, atol=1e-5)
    # Per-ray segment ends, as the renderer's shadow test passes them.
    tmax = np.linspace(2.0, 12.0, d.shape[0]).astype(np.float32)
    oc = tuple(o[:, a] for a in range(3))
    np.testing.assert_array_equal(
        psph.any_hit_cols(tuple(map(torch.as_tensor, oc)), pcols,
                          torch.as_tensor(c), torch.as_tensor(r),
                          tmax=torch.as_tensor(tmax)).numpy(),
        np.asarray(jsph.any_hit_cols(tuple(map(jnp.asarray, oc)), jcols,
                                     jnp.asarray(c), jnp.asarray(r),
                                     tmax=jnp.asarray(tmax))))
    _close(psph._pairs_cols(tuple(map(torch.as_tensor, oc)), pcols,
                            torch.as_tensor(c), torch.as_tensor(r), 0.0,
                            torch.as_tensor(tmax)),
           jsph._pairs_cols(tuple(map(jnp.asarray, oc)), jcols,
                            jnp.asarray(c), jnp.asarray(r), 0.0,
                            jnp.asarray(tmax)))


def test_column_gradients_match_jax():
    o, d, c, r = _rays_and_spheres(3)
    eye = o[0]

    def jloss(eye, d, c, r):
        t, m, _, n = jsph.closest_hit_common_origin_cols(
            eye, tuple(d[:, a] for a in range(3)), c, r)
        return jnp.sum(jnp.where(m, t, 0.0)) + sum(
            jnp.sum(n[a] * (a + 1.0)) for a in range(3))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (eye, d, c, r)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (eye, d, c, r)]
    t, m, _, n = psph.closest_hit_common_origin_cols(
        leaves[0], tuple(leaves[1][:, a] for a in range(3)), *leaves[2:])
    (torch.where(m, t, 0.0).sum()
     + sum((n[a] * (a + 1.0)).sum() for a in range(3))).backward()
    _grads_close([x.grad for x in leaves], want)


def _floor_scene():
    """The floor quad of ``tests/test_sphere_scene.py``, seen from above;
    its left-handed normal points down, lifting shadow origins off it."""
    verts = np.asarray([[-10, 0, -10], [10, 0, -10], [10, 0, 10],
                        [-10, 0, 10]], np.float32)
    faces = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    cam = JaxCamera.make(eye=(0.0, 5.0, -6.0), dir=(0.0, -0.6, 1.0),
                         up=(0, 1, 0), fov=60.0)
    return verts, faces, cam, np.asarray([0.0, 50.0, 0.0], np.float32)


SPHERES = {
    "front": ([[0.0, 1.5, 0.0], [2.5, 1.0, 1.0]], [1.0, 0.75]),
    "shadow": ([[0.0, 3.0, 0.0]], [1.0]),
    "beyond_sun": ([[0.0, 80.0, 0.0]], [5.0]),
}


def _both(name, backend, mode="flat", size=64, **kw):
    """(port image, port stats, JAX image, JAX stats) of the floor scene
    with sphere set ``name`` (None: no spheres)."""
    verts, faces, cam, sun = _floor_scene()
    sph = None if name is None else tuple(
        np.asarray(x, np.float32) for x in SPHERES[name])
    opts = dict(width=size, height=size, mode=mode, backend=backend,
                spheres=sph, **kw)
    ji, js = jax_render(verts, faces, cam, sun, **opts)
    pi, ps = ct.render(verts, faces, convert.camera(cam), sun, device="cpu",
                       **opts)
    return (pi.numpy(), {k: int(v) for k, v in ps.items()}, np.asarray(ji),
            {k: int(v) for k, v in js.items()})


def _image_rule(pimg, pst, jimg, jst):
    off = np.abs(pimg - jimg).max(-1) > 1e-4
    assert off.mean() < 0.005, off.sum()
    assert pst["rays"] == jst["rays"]
    assert abs(pst["hits"] - jst["hits"]) <= 0.002 * jst["hits"]


@pytest.mark.parametrize("backend", ["bruteforce", "megakernel"])
def test_sphere_visible_and_in_front(backend):
    img, st, jimg, jst = _both("front", backend, shadows=False)
    base, bst, _, _ = _both(None, backend, shadows=False)
    _image_rule(img, st, jimg, jst)
    assert (np.abs(img - base) > 1e-3).any()
    assert st["primary_hits"] >= bst["primary_hits"]


@pytest.mark.parametrize("backend", ["bruteforce", "megakernel"])
def test_sphere_casts_shadow_on_triangles(backend):
    img, st, jimg, jst = _both("shadow", backend)
    lit, _, _, _ = _both(None, backend)
    _image_rule(img, st, jimg, jst)
    darkened = (lit.max(axis=-1) > 0.01) & (img.max(axis=-1) < 0.01)
    assert darkened.sum() > 10 and st["shadow_hits"] > 0


@pytest.mark.parametrize("backend", ["bruteforce", "megakernel"])
def test_sphere_beyond_sun_does_not_shadow(backend):
    img, st, jimg, jst = _both("beyond_sun", backend, size=48)
    lit, _, _, _ = _both(None, backend, size=48)
    _image_rule(img, st, jimg, jst)
    np.testing.assert_array_equal(img, lit)


def test_sphere_smooth_shading_backends_agree():
    img_b, sb, jimg_b, jsb = _both("front", "bruteforce", mode="smooth")
    img_m, sm, jimg_m, jsm = _both("front", "megakernel", mode="smooth")
    _image_rule(img_b, sb, jimg_b, jsb)
    _image_rule(img_m, sm, jimg_m, jsm)
    assert (np.abs(img_b - img_m).max(axis=-1) > 1e-3).mean() < 2e-3
    assert sb["primary_hits"] == sm["primary_hits"]


@pytest.mark.parametrize("compat", [False, True])
def test_sphere_on_the_bunny_matches_jax(bunny, compat):
    # A sphere between the bunny and the eye, in front of part of it, and
    # reference-exact (the sphere occludes the whole ray toward the sun).
    verts, faces = bunny
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    center = verts.mean(axis=0)
    cam = JaxCamera.make(eye=eye, dir=center - eye, up=(0, 1, 0), fov=60.0)
    sph = (np.asarray([center + [0.02, 0.02, -0.05]], np.float32),
           np.asarray([0.02], np.float32))
    opts = dict(width=48, height=48, backend="megakernel", spheres=sph,
                reference_compat=compat)
    ji, js = jax_render(verts, faces, cam, [-50.0, 100.0, 0.0], **opts)
    pi, ps = ct.render(verts, faces, convert.camera(cam), [-50.0, 100.0, 0.0],
                       device="cpu", **dict(opts, spheres=convert.spheres(
                           tuple(map(jnp.asarray, sph)))))
    base, _ = ct.render(verts, faces, convert.camera(cam),
                        [-50.0, 100.0, 0.0], device="cpu",
                        **dict(opts, spheres=None))
    _image_rule(pi.numpy(), {k: int(v) for k, v in ps.items()},
                np.asarray(ji), {k: int(v) for k, v in js.items()})
    assert (torch.abs(pi - base).amax(-1) > 1e-3).sum() > 10

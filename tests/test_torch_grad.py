"""Gradients through the port's renderer, on the CPU.

Against ``jax.grad`` of the JAX package's ``render_pipeline`` on the same
inputs (numpy, made from a seed), on both backends, with the same
cluster cut (the JAX build, converted): the quad of
``tests/test_gradients.py`` w.r.t. the vertices, ``eye``, ``dir``,
``fov`` and the sun, and the bunny preset at 48 x 48 w.r.t. the vertices
and ``eye``. The loss is a seeded weighting of the image's pixels. A
pixel whose winning triangle or whose colour (a shadow flag flipped at
a boundary) differs between the packages is taken out of the loss, and
at most 0.5% of the pixels may be; the gradients must then agree with
``rtol=1e-4`` and ``atol=1e-5 * max|g|``.

Against the port's own central finite differences, mirroring
``tests/test_gradients.py`` and ``tests/test_gradients_bunny.py``: the
quad at 24 x 16 on an interior-pixel mask, and probes of bunny vertex
coordinates at 72 x 72.

Also: no NaN in any gradient of an image with misses at a size that is
no tile multiple (padding rays), and no tensor that requires a gradient
reaches a walk.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.camera import camera_ray_columns as jax_ray_columns
from ceres_tpu.models.camera import camera_rays as jax_camera_rays
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.render import renderer as jrenderer
from ceres_tpu.render import scenes as jscenes
from ceres_tpu.utils import tiling as jtiling

import ceres_tpu_torch as ct
from ceres_tpu_torch.models.camera import camera_ray_columns, camera_rays
from ceres_tpu_torch.ops import walk
from ceres_tpu_torch.render import renderer as prenderer
from ceres_tpu_torch.utils import convert, tiling

torch.set_num_threads(1)

BACKENDS = ("bruteforce", "megakernel")
PARAMS = ("vertices", "eye", "dir", "fov", "sun")


def _quad():
    """The quad of ``tests/test_gradients.py``: two triangles at z = 2,
    wound so the reference-convention normal points away from the eye."""
    verts = np.asarray([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                       np.float32)
    faces = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    return {"vertices": verts, "faces": faces,
            "eye": np.zeros(3, np.float32),
            "dir": np.asarray([0, 0, 1], np.float32),
            "up": np.asarray([0, 1, 0], np.float32),
            "fov": np.float32(70.0),
            "sun": np.asarray([3.0, 4.0, -2.0], np.float32)}


def _bunny():
    sc = jscenes.bunny_scene()
    return {"vertices": np.asarray(sc.vertices, np.float32),
            "faces": np.asarray(sc.faces, np.int32),
            "eye": np.asarray(sc.camera.eye, np.float32),
            "dir": np.asarray(sc.camera.dir, np.float32),
            "up": np.asarray(sc.camera.up, np.float32),
            "fov": np.float32(sc.camera.fov),
            "sun": np.asarray(sc.sun, np.float32)}


SCENES = {"quad": (_quad, 24, 16, PARAMS),
          "bunny": (_bunny, 48, 48, ("vertices", "eye"))}


def _jax_cut(s):
    soup = jax_soup(jnp.asarray(s["vertices"]), jnp.asarray(s["faces"]),
                    with_normals=False)
    return jax.jit(jcl.build_clusters_treelet)(soup)


def _jax_image_fn(s, backend, w, h, cs):
    config = jrenderer.RenderConfig(width=w, height=h, mode="smooth",
                                    backend=backend)
    faces = jnp.asarray(s["faces"])

    def image(v, eye, d, fov, sun):
        cam = JaxCamera(eye=eye, dir=d, up=jnp.asarray(s["up"]), fov=fov)
        return jrenderer.render_pipeline(v, faces, cam, sun, config,
                                         clusters=cs)[0]

    return image


def _port_image(s, backend, w, h, cs, p):
    config = ct.RenderConfig(width=w, height=h, mode="smooth",
                             backend=backend)
    cam = ct.Camera(eye=p["eye"], dir=p["dir"],
                    up=torch.tensor(s["up"]), fov=p["fov"])
    return ct.render_pipeline(p["vertices"], torch.as_tensor(s["faces"]),
                              cam, p["sun"], config, clusters=cs)[0]


def _winners(s, backend, w, h, jcs):
    """Per-pixel winning triangle ids of both packages, raster order, -1
    at misses."""
    jsoup = jax_soup(jnp.asarray(s["vertices"]), jnp.asarray(s["faces"]),
                     with_normals=False)
    jcam = JaxCamera(eye=jnp.asarray(s["eye"]), dir=jnp.asarray(s["dir"]),
                     up=jnp.asarray(s["up"]), fov=jnp.asarray(s["fov"]))
    psoup = convert.soup(jsoup)
    pcam = convert.camera(jcam)
    if backend == "bruteforce":
        jhit = jrenderer._closest_primary(
            jsoup, jcam, jax_camera_rays(jcam, w, h).reshape(-1, 3), backend)
        phit = prenderer._closest_primary(
            psoup, pcam, camera_rays(pcam, w, h).reshape(-1, 3), backend)

        def raster(x):
            return np.asarray(x).reshape(h, w)
    else:
        jdirs = tuple(jtiling.swizzle_plane(c)
                      for c in jax_ray_columns(jcam, w, h))
        pdirs = tuple(tiling.swizzle_plane(c)
                      for c in camera_ray_columns(pcam, w, h))
        jhit = jrenderer._closest_primary(jsoup, jcam, jdirs, backend,
                                          clusters=jcs)
        phit = prenderer._closest_primary(psoup, pcam, pdirs, backend,
                                          clusters=convert.cluster_set(jcs))

        def raster(x):
            return np.asarray(jtiling.unswizzle_plane(jnp.asarray(x), h, w))

    jid = raster(np.where(np.asarray(jhit.mask), np.asarray(jhit.prim_id), -1))
    pid = raster(torch.where(phit.mask, phit.prim_id, -1).numpy())
    return jid, pid


def _assert_close(name, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max()
    assert scale > 0, f"{name}: the JAX gradient is zero"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(SCENES))
def test_gradients_match_jax(name, backend):
    make, w, h, wrt = SCENES[name]
    s = make()
    jcs = _jax_cut(s) if backend == "megakernel" else None
    pcs = convert.cluster_set(jcs) if jcs is not None else None
    image_fn = _jax_image_fn(s, backend, w, h, jcs)
    jargs = [jnp.asarray(s[k]) for k in PARAMS]
    jimg = np.asarray(image_fn(*jargs))
    p = {k: torch.tensor(s[k], requires_grad=k in wrt) for k in PARAMS}
    pimg = _port_image(s, backend, w, h, pcs, p)

    jid, pid = _winners(s, backend, w, h, jcs)
    agree = (jid == pid) & (np.abs(pimg.detach().numpy() - jimg).max(-1)
                            <= 1e-4)
    assert (jid >= 0).sum() > 0.1 * w * h, "the scene must fill the view"
    assert (~agree).sum() <= 0.005 * w * h, (~agree).sum()
    weights = (np.random.default_rng(7).uniform(size=(h, w, 1))
               * agree[..., None]).astype(np.float32)

    def jloss(*args):
        return jnp.sum(image_fn(*args) * weights)

    argnums = tuple(PARAMS.index(k) for k in wrt)
    jgrads = jax.jit(jax.grad(jloss, argnums=argnums))(*jargs)
    (pimg * torch.as_tensor(weights)).sum().backward()
    for k, jg in zip(wrt, jgrads):
        _assert_close(f"{name} {backend} d/d{k}", p[k].grad.numpy(), jg)


# ---------------------------------------------------------------------------
# Finite differences (the port alone)
# ---------------------------------------------------------------------------

def _interior_mask(img):
    """Pixels whose 3x3 neighbourhood is entirely lit (non-black)."""
    hit = np.asarray(img).max(axis=-1) > 0
    m = hit.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            m &= np.roll(np.roll(hit, dy, 0), dx, 1)
    m[0, :] = m[-1, :] = False
    m[:, 0] = m[:, -1] = False
    return m


def _fd_grad(f, x, eps):
    x = np.asarray(x, np.float32)
    g = np.zeros(x.shape, np.float64)
    for idx in np.ndindex(x.shape):
        xp = x.copy()
        xp[idx] += eps
        xm = x.copy()
        xm[idx] -= eps
        g[idx] = (f(xp) - f(xm)) / (2 * eps)
    return g


# (parameter, backend, eps) as in tests/test_gradients.py.
QUAD_FD = [("vertices", "bruteforce", 1e-2), ("vertices", "megakernel", 1e-2),
           ("eye", "megakernel", 5e-3), ("fov", "bruteforce", 2e-2),
           ("sun", "bruteforce", 1e-2)]


@pytest.mark.parametrize("param,backend,eps", QUAD_FD)
def test_quad_gradients_match_finite_differences(param, backend, eps):
    s = _quad()
    w, h = 24, 16
    base = {k: torch.tensor(s[k]) for k in PARAMS}
    mask = _interior_mask(_port_image(s, backend, w, h, None, base).numpy())
    assert mask.sum() > 20
    weight = torch.as_tensor(mask[:, :, None].astype(np.float32))

    def loss(x):
        p = dict(base, **{param: torch.as_tensor(x)})
        with torch.no_grad():
            return float((_port_image(s, backend, w, h, None, p)
                          * weight).sum())

    p = dict(base, **{param: torch.tensor(s[param], requires_grad=True)})
    (_port_image(s, backend, w, h, None, p) * weight).sum().backward()
    g = p[param].grad.numpy()
    g_fd = _fd_grad(loss, s[param], eps)
    np.testing.assert_allclose(g, g_fd, rtol=0.05,
                               atol=0.02 * np.abs(g_fd).max())


def test_bunny_vertex_gradients_match_finite_differences():
    s = _bunny()
    w = h = 72
    base = {k: torch.tensor(s[k]) for k in PARAMS}
    mask = _interior_mask(_port_image(s, "megakernel", w, h, None,
                                      base).numpy())
    assert mask.sum() > 80
    weight = torch.as_tensor(mask[:, :, None].astype(np.float32))

    def loss(v):
        with torch.no_grad():
            img = _port_image(s, "megakernel", w, h, None,
                              dict(base, vertices=torch.as_tensor(v)))
            return float((img * weight).sum())

    p = dict(base, vertices=torch.tensor(s["vertices"], requires_grad=True))
    (_port_image(s, "megakernel", w, h, None, p) * weight).sum().backward()
    g = p["vertices"].grad.numpy()
    assert np.isfinite(g).all()
    # Probes on the largest |g| coordinates (a strong signal for the f32
    # quotient) and a few seeded others.
    flat = np.abs(g).ravel()
    idxs = list(np.argsort(flat)[-6:])
    idxs += list(np.random.default_rng(0).choice(
        np.nonzero(flat > 0.01 * flat.max())[0], 4, replace=False))
    v0 = s["vertices"]
    eps = 2e-4
    checked = 0
    for idx in idxs:
        ij = np.unravel_index(idx, v0.shape)
        vp = v0.copy()
        vp[ij] += eps
        vm = v0.copy()
        vm[ij] -= eps
        fd = (loss(vp) - loss(vm)) / (2 * eps)
        # A probe that flips a silhouette pixel leaves the analytic scale:
        # its quotient measures visibility, which is detached.
        if abs(fd) < 1e-6 or abs(fd) > 5 * abs(g[ij]) + 1.0:
            continue
        np.testing.assert_allclose(g[ij], fd, rtol=0.15, atol=0.05 * abs(fd))
        checked += 1
    assert checked >= 5, f"only {checked} usable probes"


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_nan_gradients_at_misses_and_padding(backend):
    """The quad fills part of a 37 x 23 view: misses, and padding rays
    past the last 32 x 32 block on the megakernel backend."""
    s = _quad()
    w, h = 37, 23
    p = {k: torch.tensor(s[k], requires_grad=True) for k in PARAMS}
    img = _port_image(s, backend, w, h, None, p)
    hit = img.detach().max(-1).values > 0
    assert 0 < int(hit.sum()) < w * h
    (img ** 2).mean().backward()
    for k in PARAMS:
        assert torch.isfinite(p[k].grad).all(), k
    assert float(p["vertices"].grad.abs().max()) > 0


def test_walk_refuses_tensors_that_require_grad():
    s = _quad()
    soup = ct.triangle_soup(torch.as_tensor(s["vertices"]),
                            torch.as_tensor(s["faces"]))
    from ceres_tpu_torch.ops import megakernel as mk

    dirs = tuple(torch.tensor([0.1, 0.0, 1.0]).repeat(3, 1).t())
    args, opts = mk._closest_inputs(mk._treelet(soup, None),
                                    torch.zeros(3), dirs)
    rays = args[2].clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        walk.walk_closest(args[0], args[1], rays, args[3], **opts)

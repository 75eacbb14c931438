"""The port's training path against the JAX package's, on the CPU.

  * ``accel.clusters.refit_clusters`` bit for bit against the jitted JAX
    function on bunny vertices moved by seeded noise (records, boxes with
    the empty boxes of padding clusters, ``perm`` and supers kept), and a
    walk over the refitted set against the brute-force oracle on the
    moved mesh, ray by ray;
  * ``accel.lbvh.refit`` and ``sah_cost`` against the JAX functions, the
    gradient of the cost w.r.t. the vertices included;
  * ``diff.fit_vertices``: its first 3 losses against the JAX
    ``fit_vertices`` (``rtol=1e-4``) on the quad (brute force) and the
    bunny at 32 x 32 (megakernel, the treelet cut refitted every step);
    and one train step from a JAX mid-fit state carried across by
    ``utils.convert.train_state`` (parameters within ``atol=1e-6``);
  * checkpoints: a resumed fit equals the uninterrupted one, and a fit
    whose steps are all restored runs none, mirroring
    ``tests/test_checkpoint.py``;
  * ``mesh=``: on a mesh of one rank the step and the fit render through
    ``render_sharded`` (brute force: the fit equals the one without a
    mesh bit for bit), and a ``clusters0`` is refitted there (several
    ranks: ``tests/test_torch_distributed.py``); numpy inputs with no
    card raise unless ``device="cpu"``.

The JAX side runs as its own tests run it: jitted, the megakernel in
Pallas interpret mode.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.accel import lbvh as jlbvh
from ceres_tpu.diff import inverse as jinv
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.render import renderer as jrenderer
from ceres_tpu.render import scenes as jscenes

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel import clusters as pcl
from ceres_tpu_torch.accel import lbvh as plbvh
from ceres_tpu_torch.diff import inverse as pinv
from ceres_tpu_torch.ops import intersect as pmt
from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.utils import convert

torch.set_num_threads(1)

LBVH_FIELDS = ("order", "left", "right", "range_lo", "range_hi", "parent",
               "leaf_parent", "node_lo", "node_hi", "leaf_lo", "leaf_hi")


def _bits(x):
    """Float arrays as int32 bit patterns (signed zeros and infinities
    compared exactly), integer arrays as they are."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


def _moved_bunny(bunny, sigma=0.01, seed=11):
    verts, faces = bunny
    rng = np.random.default_rng(seed)
    scale = float(np.abs(verts - verts.mean(0)).max())
    moved = verts + (sigma * scale) * rng.standard_normal(
        verts.shape).astype(np.float32)
    return verts, moved.astype(np.float32), faces


@pytest.fixture(scope="module")
def refitted(bunny):
    verts, moved, faces = _moved_bunny(bunny)
    soup0 = jax_soup(jnp.asarray(verts), jnp.asarray(faces))
    soup1 = jax_soup(jnp.asarray(moved), jnp.asarray(faces))
    cs0 = jax.jit(jcl.build_clusters_treelet)(soup0)
    jcs = jax.jit(jcl.refit_clusters)(cs0, soup1)
    pcs = pcl.refit_clusters(convert.cluster_set(cs0), convert.soup(soup1))
    return cs0, jcs, pcs, soup1, moved, faces


def test_refit_clusters_bit_equal_to_jax(refitted):
    cs0, jcs, pcs, *_ = refitted
    for name in ("p0", "e1", "e2", "n", "lo", "hi", "perm", "super_first"):
        np.testing.assert_array_equal(_bits(getattr(pcs, name).numpy()),
                                      _bits(getattr(jcs, name)), err_msg=name)
    assert pcs.super_S == jcs.super_S
    np.testing.assert_array_equal(pcs.perm.numpy(), np.asarray(cs0.perm))
    np.testing.assert_array_equal(pcs.super_first.numpy(),
                                  np.asarray(cs0.super_first))
    # The fixture holds what the refit must keep: padding slots with zero
    # records and empty clusters with the box (+inf, -inf).
    perm = pcs.perm.numpy().reshape(pcs.num_clusters, -1)
    empty = (perm < 0).all(1)
    assert (perm < 0).any() and empty.any() and not empty.all()
    assert np.isposinf(pcs.lo.numpy()[empty]).all()
    assert np.isneginf(pcs.hi.numpy()[empty]).all()
    assert (pcs.p0.numpy()[perm < 0] == 0).all()
    # The boxes moved with the vertices.
    assert not np.array_equal(_bits(pcs.lo.numpy()), _bits(cs0.lo))


def test_refit_keeps_records_differentiable(bunny):
    verts, moved, faces = _moved_bunny(bunny)
    v = torch.tensor(moved, requires_grad=True)
    soup = ct.triangle_soup(v, torch.as_tensor(faces), with_normals=False)
    cs0 = pcl.build_clusters_treelet(
        ct.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                         with_normals=False))
    cs = pcl.refit_clusters(cs0, soup)
    assert not cs.lo.requires_grad and not cs.hi.requires_grad
    cs.p0.sum().backward()
    # Every vertex is a p0 corner of some face, each counted once per face.
    counts = np.bincount(faces[:, 0], minlength=len(verts))
    np.testing.assert_array_equal(v.grad.numpy()[:, 0], counts)


def test_walk_over_refit_equals_bruteforce(refitted):
    """The refitted boxes bound their moved triangles, so the walk finds
    the oracle's nearest hit; where the winners differ, both t agree to
    f32 resolution (a near tie) and both hit."""
    _, _, pcs, soup1, moved, _ = refitted
    psoup = convert.soup(soup1)
    eye = torch.tensor([0.0, 0.1, -0.3])
    cam = ct.Camera.make(eye=eye, dir=torch.as_tensor(moved.mean(0)) - eye,
                         up=(0, 1, 0), fov=60.0)
    dirs = ct.camera_rays(cam, 96, 96).reshape(-1, 3)
    walk = pmk.closest_hit_common_origin(psoup, cam.eye, dirs, clusters=pcs)
    brute = pmt.closest_hit_bruteforce(
        pmt.ray_features_common_origin(dirs),
        pmt.triangle_weights_common_origin(psoup, cam.eye))
    assert int(brute.mask.sum()) > 1000
    assert torch.equal(walk.mask, brute.mask)
    off = (walk.prim_id != brute.prim_id) & brute.mask
    assert int(off.sum()) <= 0.001 * dirs.shape[0]
    for i in torch.nonzero(off).flatten().tolist():
        t_w, t_b = float(walk.t[i]), float(brute.t[i])
        assert abs(t_w - t_b) <= 1e-5 * t_b, (i, t_w, t_b)
    hit = brute.mask & ~off
    torch.testing.assert_close(walk.t[hit], brute.t[hit], rtol=1e-6, atol=0)


def test_lbvh_refit_and_sah_cost_equal_jax(bunny):
    verts, moved, faces = _moved_bunny(bunny, sigma=0.03)
    soup0 = jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                     with_normals=False)
    soup1 = jax_soup(jnp.asarray(moved), jnp.asarray(faces),
                     with_normals=False)
    jbvh = jax.jit(jlbvh.build_lbvh)(soup0)
    jre = jax.jit(jlbvh.refit)(jbvh, soup1)
    pbvh = plbvh.build_lbvh(convert.soup(soup0))
    pre = plbvh.refit(pbvh, convert.soup(soup1))
    for name in LBVH_FIELDS:
        np.testing.assert_array_equal(_bits(getattr(pre, name).numpy()),
                                      _bits(getattr(jre, name)), err_msg=name)
    assert not np.array_equal(_bits(pre.node_lo.numpy()), _bits(jbvh.node_lo))
    for bvh_p, bvh_j in ((pbvh, jbvh), (pre, jre)):
        for cost in (1.0, 1.2):
            np.testing.assert_allclose(
                float(plbvh.sah_cost(bvh_p, cost)),
                float(jax.jit(jlbvh.sah_cost, static_argnums=1)(bvh_j, cost)),
                rtol=1e-6)


def test_sah_cost_gradient_through_refit_equals_jax(bunny):
    """Gradients reach the vertices through the refitted boxes, split at
    ties as ``jnp.minimum`` splits them."""
    verts, moved, faces = _moved_bunny(bunny, sigma=0.03)
    jbvh = jax.jit(jlbvh.build_lbvh)(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False))

    def jcost(v):
        return jlbvh.sah_cost(jlbvh.refit(
            jbvh, jax_soup(v, jnp.asarray(faces), with_normals=False)))

    jg = np.asarray(jax.jit(jax.grad(jcost))(jnp.asarray(moved)))
    pbvh = plbvh.build_lbvh(ct.triangle_soup(
        torch.as_tensor(verts), torch.as_tensor(faces), with_normals=False))
    v = torch.tensor(moved, requires_grad=True)
    cost = plbvh.sah_cost(plbvh.refit(pbvh, ct.triangle_soup(
        v, torch.as_tensor(faces), with_normals=False)))
    cost.backward()
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(v.grad.numpy(), jg, rtol=1e-4,
                               atol=1e-5 * np.abs(jg).max())


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------

def _quad_fit():
    """The quad fit of ``tests/test_gradients.py``."""
    verts = np.asarray([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                       np.float32)
    faces = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
    cam = JaxCamera.make(eye=(0, 0, 0), dir=(0, 0, 1), up=(0, 1, 0), fov=70.0)
    sun = np.asarray([3.0, 4.0, -2.0], np.float32)
    noisy = verts + 0.05 * np.random.default_rng(1).standard_normal(
        verts.shape).astype(np.float32)
    return verts, noisy, faces, cam, sun, 32, 24, "bruteforce", 2e-3


def _bunny_fit():
    """The bunny fit of ``tests/test_gradients_bunny.py`` at 32 x 32."""
    sc = jscenes.bunny_scene()
    v0 = np.asarray(sc.vertices, np.float32)
    scale = float(np.abs(v0 - v0.mean(0)).max())
    noisy = v0 + (0.02 * scale) * np.random.default_rng(3).standard_normal(
        v0.shape).astype(np.float32)
    return (v0, noisy, np.asarray(sc.faces), sc.camera, sc.sun, 32, 32,
            "megakernel", 2e-4)


FITS = {"quad": _quad_fit, "bunny": _bunny_fit}


@pytest.fixture(scope="module", params=list(FITS))
def fit_case(request):
    verts, noisy, faces, cam, sun, w, h, backend, lr = FITS[request.param]()
    jcfg = jrenderer.RenderConfig(width=w, height=h, mode="smooth",
                                  backend=backend)
    target = np.asarray(jrenderer.render_pipeline(
        jnp.asarray(verts), jnp.asarray(faces), cam, jnp.asarray(sun),
        jcfg)[0])
    assert target.max() > 0
    pcfg = ct.RenderConfig(width=w, height=h, mode="smooth", backend=backend)
    return dict(name=request.param, noisy=noisy, faces=faces, cam=cam,
                sun=sun, jcfg=jcfg, pcfg=pcfg, target=target, lr=lr)


def test_fit_losses_match_jax(fit_case):
    c = fit_case
    _, jhist = jinv.fit_vertices(c["noisy"], c["faces"], c["cam"], c["sun"],
                                 c["target"], config=c["jcfg"], steps=3,
                                 learning_rate=c["lr"])
    _, phist = pinv.fit_vertices(c["noisy"], c["faces"],
                                 convert.camera(c["cam"]), c["sun"],
                                 c["target"], config=c["pcfg"], steps=3,
                                 learning_rate=c["lr"], device="cpu")
    assert len(phist) == 3
    np.testing.assert_allclose(phist, jhist, rtol=1e-4)


def test_step_from_carried_jax_state_matches_jax(fit_case):
    """Two JAX steps, then one more in each package from that state."""
    c = fit_case
    faces = jnp.asarray(c["faces"])
    opt = optax.adam(c["lr"])
    clusters0 = None
    if c["jcfg"].backend == "megakernel":
        clusters0 = jax.jit(jcl.build_clusters_treelet)(jax_soup(
            jnp.asarray(c["noisy"]), faces, with_normals=False))
    jstep = jinv.make_train_step(faces, c["cam"], jnp.asarray(c["sun"]),
                                 c["jcfg"], opt, clusters0=clusters0)
    params = {"vertices": jnp.asarray(c["noisy"])}
    jstate = jinv.TrainState(params, opt.init(params))
    target = jnp.asarray(c["target"])
    for _ in range(2):
        jstate, _ = jstep(jstate, target)
    mid = convert.train_state({k: np.asarray(v)
                               for k, v in jstate.params.items()},
                              jstate.opt_state[0])
    assert float(mid.opt_state["vertices"]["step"]) == 2.0
    jstate, jloss = jstep(jstate, target)

    faces_t = torch.as_tensor(c["faces"])
    pstep = pinv.make_train_step(
        faces_t, convert.camera(c["cam"]), torch.as_tensor(c["sun"]),
        c["pcfg"], torch.optim.Adam(mid.params.values(), lr=c["lr"]),
        clusters0=None if clusters0 is None else convert.cluster_set(
            clusters0))
    before = mid.params["vertices"].detach().clone()
    state, ploss = pstep(mid, torch.as_tensor(c["target"]))
    assert float(state.opt_state["vertices"]["step"]) == 3.0
    moved = state.params["vertices"].detach().numpy()
    assert not np.array_equal(moved, before.numpy())
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(moved, np.asarray(jstate.params["vertices"]),
                               rtol=0, atol=1e-6)
    for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = np.asarray(getattr(jstate.opt_state[0], jkey)["vertices"])
        np.testing.assert_allclose(
            state.opt_state["vertices"][key].numpy(), want, rtol=1e-3,
            atol=1e-3 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Checkpoints and refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_scene():
    """Two triangles facing the camera (``tests/test_checkpoint.py``)."""
    vertices = np.asarray([
        [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0],
        [-0.6, 0.2, 1.5], [0.4, 0.6, 1.5], [0.0, -0.6, 1.5],
    ], np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    camera = ct.Camera.make(eye=(0, 0, -1), dir=(0, 0, 1), up=(0, 1, 0),
                            fov=60)
    sun = np.asarray([2.0, 3.0, -2.0], np.float32)
    config = ct.RenderConfig(width=24, height=24, mode="flat",
                             backend="bruteforce")
    target, _ = ct.render_pipeline(torch.as_tensor(vertices),
                                   torch.as_tensor(faces), camera,
                                   torch.as_tensor(sun), config)
    return vertices, faces, camera, sun, target.numpy(), config


def _fit(scene, **kw):
    vertices, faces, camera, sun, target, config = scene
    return pinv.fit_vertices(vertices + 0.05, faces, camera, sun, target,
                             config=config, learning_rate=1e-2, device="cpu",
                             **kw)


def test_checkpoint_and_resume(tiny_scene, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, hist1 = _fit(tiny_scene, steps=4, checkpoint_dir=ckpt,
                    checkpoint_every=2)
    assert len(hist1) == 4
    assert sorted(os.listdir(ckpt)) == ["2.pt", "4.pt"]
    # Asking for 7 steps in all runs only the 3 left.
    params2, hist2 = _fit(tiny_scene, steps=7, checkpoint_dir=ckpt,
                          checkpoint_every=2)
    assert len(hist2) == 3
    assert sorted(os.listdir(ckpt)) == ["6.pt", "7.pt"]
    params_ref, hist_ref = _fit(tiny_scene, steps=7)
    torch.testing.assert_close(params2["vertices"], params_ref["vertices"],
                               rtol=0, atol=0)
    np.testing.assert_allclose(hist1 + hist2, hist_ref, rtol=0)


def test_checkpoint_noop_when_done(tiny_scene, tmp_path):
    ckpt = str(tmp_path / "ckpt2")
    _, hist = _fit(tiny_scene, steps=2, checkpoint_dir=ckpt,
                   checkpoint_every=1)
    assert len(hist) == 2
    _, hist2 = _fit(tiny_scene, steps=2, checkpoint_dir=ckpt,
                    checkpoint_every=1)
    assert hist2 == []


def test_checkpoint_and_resume_with_camera_and_refit(tmp_path, bunny):
    """The megakernel fit with the camera optimised: the refitted cut is
    built from the initial vertices on resume too."""
    sc = jscenes.bunny_scene()
    v0 = np.asarray(sc.vertices, np.float32)
    cam = convert.camera(sc.camera)
    cfg = ct.RenderConfig(width=16, height=16, backend="megakernel")
    target = ct.render_pipeline(torch.as_tensor(v0),
                                torch.as_tensor(sc.faces), cam,
                                torch.as_tensor(sc.sun), cfg)[0].numpy()
    noisy = v0 + 1e-3 * np.random.default_rng(5).standard_normal(
        v0.shape).astype(np.float32)
    kw = dict(config=cfg, learning_rate=2e-4, optimize_camera=True,
              device="cpu")
    ckpt = str(tmp_path / "ckpt3")
    pinv.fit_vertices(noisy, sc.faces, cam, sc.sun, target, steps=2,
                      checkpoint_dir=ckpt, checkpoint_every=2, **kw)
    params, hist = pinv.fit_vertices(noisy, sc.faces, cam, sc.sun, target,
                                     steps=3, checkpoint_dir=ckpt, **kw)
    ref, hist_ref = pinv.fit_vertices(noisy, sc.faces, cam, sc.sun, target,
                                      steps=3, **kw)
    assert set(params) == {"vertices", "eye", "dir"}
    assert len(hist) == 1 and hist == hist_ref[-1:]
    for k in params:
        torch.testing.assert_close(params[k], ref[k], rtol=0, atol=0)
    assert not torch.equal(params["eye"], cam.eye)


def test_mesh_is_refused_naming_m16(tiny_scene):
    # The train step over a mesh (ROADMAP item M16, once refused): on one
    # rank its loss is render_sharded's, with a prebuilt cut refitted too,
    # and the fit equals the fit without a mesh.
    import dataclasses

    from ceres_tpu_torch.models.mesh import triangle_soup
    from ceres_tpu_torch.parallel import sharded as psh

    vertices, faces, camera, sun, target, config = tiny_scene
    mesh = psh.device_mesh(devices=["cpu"])
    start = torch.tensor(vertices + 0.05, requires_grad=True)
    step = pinv.make_train_step(torch.as_tensor(faces), camera,
                                torch.as_tensor(sun), config,
                                torch.optim.Adam([start], lr=1e-2),
                                mesh=mesh)
    _, loss = step(pinv.TrainState({"vertices": start}, {"vertices": {}}),
                   torch.as_tensor(target))
    image, _ = psh.render_sharded(torch.as_tensor(vertices + 0.05), faces,
                                  camera, sun, config, mesh=mesh)
    assert float(loss) == float(pinv.image_loss(image,
                                                torch.as_tensor(target)))
    # Megakernel: the cut of the start vertices, refitted in the step.
    mk = dataclasses.replace(config, backend="megakernel")
    v0 = torch.tensor(vertices + 0.05)
    cs0 = pcl.build_clusters_treelet(triangle_soup(
        v0, torch.as_tensor(faces), with_normals=False))
    start = v0.clone().requires_grad_()
    step = pinv.make_train_step(torch.as_tensor(faces), camera,
                                torch.as_tensor(sun), mk,
                                torch.optim.Adam([start], lr=1e-2),
                                mesh=mesh, clusters0=cs0)
    _, loss = step(pinv.TrainState({"vertices": start}, {"vertices": {}}),
                   torch.as_tensor(target))
    image, _ = psh.render_sharded(v0, faces, camera, sun, mk, mesh=mesh,
                                  clusters=cs0)
    assert float(loss) == float(pinv.image_loss(image,
                                                torch.as_tensor(target)))
    params, hist = pinv.fit_vertices(vertices + 0.05, faces, camera, sun,
                                     target, config=config, steps=3,
                                     learning_rate=1e-2, mesh=mesh)
    ref, hist_ref = _fit(tiny_scene, steps=3)
    assert hist == hist_ref and len(hist) == 3
    torch.testing.assert_close(params["vertices"], ref["vertices"], rtol=0,
                               atol=0)


def test_fit_without_card_needs_device_cpu(tiny_scene, monkeypatch):
    vertices, faces, camera, sun, target, config = tiny_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pinv.fit_vertices(vertices, faces, camera, sun, target,
                          config=config, steps=1)
    # Tensor inputs keep their device; the caller's tensor is not changed.
    v = torch.as_tensor(vertices + 0.05)
    before = v.clone()
    params, hist = pinv.fit_vertices(v, faces, camera, sun, target,
                                     config=config, steps=1,
                                     learning_rate=1e-2)
    assert len(hist) == 1 and torch.equal(v, before)
    assert not torch.equal(params["vertices"], before)


def test_step_refuses_an_optimizer_over_other_tensors(tiny_scene):
    vertices, faces, camera, sun, target, config = tiny_scene
    params = {"vertices": torch.tensor(vertices, requires_grad=True)}
    other = torch.optim.Adam([torch.tensor(vertices, requires_grad=True)])
    step = pinv.make_train_step(torch.as_tensor(faces), camera,
                                torch.as_tensor(sun), config, other)
    with pytest.raises(ValueError, match="leaf tensors"):
        step(pinv.TrainState(params, {"vertices": {}}),
             torch.as_tensor(target))

"""The captured frame and train step (``render.renderer.render_graph``,
``diff.inverse.make_train_step``, ``utils.graphs``) on the CPU.

  * ``FrameGraph`` on ``device="cpu"`` runs ``render_pipeline`` eagerly
    on its own buffers: the bunny at 64 x 64 (megakernel, smooth,
    shadows, the SweepSAH cut, the winner table) over 4 calls with the
    sun moved ``i * 1e-3`` and one with the eye moved, each bit-equal to
    a fresh ``render_pipeline`` of the same camera and sun (a buffer the
    call did not refresh shows), and each against the JAX package's
    ``render_pipeline`` under ``jax.jit`` (Pallas in interpret mode) on
    the same cut: under 0.5% of the pixels off by more than 1e-4, rays
    and hits within 0.2% (``chip_smoke.py``'s rule against the JAX
    fixtures);
  * a deforming scene's frame: ``render_graph`` without a prebuilt cut
    or winner table builds both in the frame, and called with vertices
    moved by seeded noise equals a fresh ``render_pipeline`` that
    builds its cut, bit for bit, and the JAX package's jitted
    ``render()`` on the same vertices by the rule above; a graph with a
    prebuilt cut or table refuses moved vertices, as does one given
    vertices of another shape;
  * the counts of ``utils.graphs``: a capture leaves the walk launches,
    and every other counter of ``utils.spans``' registry, where the
    warm-up call put them, and each replay adds the captured rise (the
    CUDA calls stood in for by fakes here);
  * the float64-exact frame (``f64_exact=True``, float64 vertices):
    ``render_graph`` with the float64 cut and winner table built before
    it, and without them (built in the frame), called with moved suns
    and moved vertices, bit-equal to ``render()`` of the same inputs
    (image, rays, hits and executed visits), and to the all-float64
    oracle (``backend="bruteforce"``): images within 1e-9, rays and hits
    equal;
  * what is refused: the oracle backend (with ``f64_exact`` too),
    ``f64_exact`` on float32 vertices, CPU tensors handed to a capture,
    and on the card a refitted or rebuilt train step with a
    non-capturable optimizer (the device check patched);
  * which steps are captured on the card: refitted and rebuilt, not over
    a mesh, on the oracle or with ``f64_exact``; the rebuilt step run through
    the capture with the CUDA calls faked (its first call's loss and
    gradients those of the eager step), and ``fit_vertices`` building a
    capturable Adam with and without the refit;
  * how the captured step takes a carried optimizer state
    (``_load_state``).

On the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 22.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel.cuts import build_clusters_quality as jax_quality
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.render import renderer as jrenderer

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel.clusters import build_clusters_treelet
from ceres_tpu_torch.diff import inverse as pinv
from ceres_tpu_torch.ops import walk
from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                             render_graph)
from ceres_tpu_torch.utils import convert, graphs, spans

torch.set_num_threads(1)

SIZE = 64
SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)
EYE = np.asarray([0.0, 0.1, -0.3], np.float32)
MOVED_EYE = np.asarray([0.01, 0.12, -0.31], np.float32)
CONFIG = dict(width=SIZE, height=SIZE, mode="smooth", backend="megakernel")


def _cameras(verts):
    target = verts.mean(axis=0)
    return [JaxCamera.make(eye=e, dir=target - e, up=(0, 1, 0), fov=60.0)
            for e in (EYE, MOVED_EYE)]


@pytest.fixture(scope="module")
def scene(bunny):
    verts, faces = bunny
    jcs = jax_quality(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                               with_normals=False))
    cs = convert.cluster_set(jcs)
    config = ct.RenderConfig(**CONFIG)
    vt, ft = torch.as_tensor(verts), torch.as_tensor(faces)
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    return verts, faces, jcs, cs, table, config


def _frames(verts):
    """(camera, sun) of each call: the sun moved i * 1e-3, then the eye
    moved."""
    cam, moved = _cameras(verts)
    return [(cam, SUN + i * 1e-3) for i in range(4)] + [(moved, SUN + 3e-3)]


@functools.partial(jax.jit, static_argnames=("config",))
def _jax_frame(verts, faces, cam, sun, config, clusters, table):
    return jrenderer.render_pipeline(verts, faces, cam, sun, config,
                                     clusters=clusters, table_cols=table)


@pytest.fixture(scope="module")
def graph_frames(scene):
    """The FrameGraph's (image, stats) of each call, and a fresh
    render_pipeline's."""
    verts, faces, _, cs, table, config = scene
    frames = _frames(verts)
    cam0, sun0 = frames[0]
    fg = render_graph(verts, faces, convert.camera(cam0), sun0, config, cs,
                      table, device="cpu")
    assert fg.launches == {}
    out = []
    for i, (cam, sun) in enumerate(frames):
        got = fg(sun_position=torch.as_tensor(sun),
                 camera=convert.camera(cam) if i == len(frames) - 1
                 else None)
        fresh = ct.render_pipeline(
            torch.as_tensor(verts), torch.as_tensor(faces),
            convert.camera(cam), torch.as_tensor(sun), config, clusters=cs,
            table_cols=table)
        out.append((got, fresh))
    return out


def test_frame_graph_on_cpu_equals_a_fresh_frame(graph_frames):
    for (img, st), (img_f, st_f) in graph_frames:
        assert img.shape == (SIZE, SIZE, 3)
        assert torch.equal(img, img_f)
        assert st.keys() == st_f.keys()
        assert all(torch.equal(st[k], st_f[k]) for k in st)
    # Each call saw its own sun and camera.
    images = [img for (img, _), _ in graph_frames]
    assert not torch.equal(images[0], images[3])
    assert not torch.equal(images[3], images[4])


def test_frame_graph_matches_the_jitted_jax_frame(scene, graph_frames):
    verts, faces, jcs, _, _, _ = scene
    jconfig = jrenderer.RenderConfig(**CONFIG)
    jtable = jrenderer.prepare_winner_table(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces)), jcs, jconfig)
    for (cam, sun), ((img, st), _) in zip(_frames(verts), graph_frames):
        jimg, jst = _jax_frame(jnp.asarray(verts), jnp.asarray(faces), cam,
                               jnp.asarray(sun), jconfig, jcs, jtable)
        off = (np.abs(img.numpy() - np.asarray(jimg)).max(-1) > 1e-4).mean()
        assert off < 0.005
        for k in ("rays", "hits"):
            assert abs(int(st[k]) - int(jst[k])) <= 0.002 * int(jst[k]), k
        assert int(st["primary_hits"]) > 0


@pytest.mark.parametrize("kwargs, match", [
    ({"backend": "bruteforce"}, "oracle"),
    ({"f64_exact": True}, "float64"),
    ({"backend": "bruteforce", "f64_exact": True}, "oracle"),
])
def test_render_graph_refuses_uncaptured_paths(scene, kwargs, match):
    verts, faces, _, cs, table, config = scene
    config = ct.RenderConfig(**dict(CONFIG, **kwargs))
    with pytest.raises(ValueError, match=match):
        render_graph(verts, faces, convert.camera(_cameras(verts)[0]), SUN,
                     config, cs, table, device="cpu")


F64_SIZE = 40
F64_CONFIG = dict(width=F64_SIZE, height=F64_SIZE, mode="smooth",
                  backend="megakernel", f64_exact=True,
                  traversal_stats=True)


@pytest.fixture(scope="module")
def f64_scene(bunny):
    """The bunny in float64, moved by seeded noise (1e-3 of its extent),
    its float64 treelet cut and winner table, and the camera."""
    verts, faces = bunny
    v64 = verts.astype(np.float64)
    scale = np.abs(v64 - v64.mean(0)).max()
    v64 = v64 + 1e-3 * scale * np.random.default_rng(41).standard_normal(
        v64.shape)
    vt, ft = torch.as_tensor(v64), torch.as_tensor(faces)
    config = ct.RenderConfig(**F64_CONFIG)
    cs = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    eye = EYE.astype(np.float64)
    cam = ct.Camera.make(eye=eye, dir=v64.mean(0) - eye, up=(0, 1, 0),
                         fov=60.0, dtype=torch.float64)
    return vt, ft, cam, config, cs, table


F64_SUNS = [SUN.astype(np.float64),
            SUN.astype(np.float64) + np.asarray([7.0, -30.0, 21.0])]


@pytest.mark.parametrize("prebuilt", [True, False])
def test_f64_graph_frame_equals_render(f64_scene, prebuilt):
    vt, ft, cam, config, cs, table = f64_scene
    cut = (cs, table) if prebuilt else (None, None)
    fg = render_graph(vt, ft, cam, torch.as_tensor(F64_SUNS[0]), config,
                      *cut, device="cpu")
    moved = vt + 1e-4 * torch.as_tensor(
        np.random.default_rng(42).standard_normal(tuple(vt.shape)))
    calls = [dict(sun_position=torch.as_tensor(F64_SUNS[1]))]
    if not prebuilt:
        calls.append(dict(vertices=moved))
    images = []
    for kw in calls:
        img, st = fg(**kw)
        v = kw.get("vertices", vt)
        sun = kw.get("sun_position", torch.as_tensor(F64_SUNS[1]))
        ref, st_ref = ct.render(v, ft, cam, sun, config=config,
                                clusters=cs if prebuilt else None)
        assert img.dtype == torch.float64
        assert torch.equal(img, ref)
        for k in ("rays", "hits", "traversal_steps"):
            assert int(st[k]) == int(st_ref[k]), k
        assert int(st["shadow_hits"]) > 0
        images.append(img)
    assert not prebuilt or not torch.equal(images[0], ct.render(
        vt, ft, cam, torch.as_tensor(F64_SUNS[0]), config=config,
        clusters=cs)[0])


def test_f64_graph_frame_matches_the_f64_oracle(f64_scene):
    vt, ft, cam, config, cs, table = f64_scene
    fg = render_graph(vt, ft, cam, torch.as_tensor(F64_SUNS[0]), config, cs,
                      table, device="cpu")
    for sun in F64_SUNS:
        img, st = fg(sun_position=torch.as_tensor(sun))
        ref, st_ref = ct.render(vt, ft, cam, torch.as_tensor(sun),
                                width=F64_SIZE, height=F64_SIZE,
                                backend="bruteforce")
        assert int(st["primary_hits"]) > 100
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-9)
        for k in ("rays", "hits"):
            assert int(st[k]) == int(st_ref[k]), k


NOISE = 1e-3   # of the bunny's extent: the deforming frames' vertices


def _moved(verts, i):
    """The bunny's vertices moved by seeded noise (frame i)."""
    scale = np.abs(verts - verts.mean(0)).max()
    noise = np.random.default_rng(30 + i).standard_normal(verts.shape)
    return (verts + NOISE * scale * noise).astype(np.float32)


@pytest.fixture(scope="module")
def deforming_frames(scene):
    """A FrameGraph that builds its cut and winner table, called with
    moved vertices: (vertices, its (image, stats), a fresh
    render_pipeline's without a cut) of each call."""
    verts, faces, _, _, _, config = scene
    cam = convert.camera(_cameras(verts)[0])
    fg = render_graph(verts, faces, cam, SUN, config, device="cpu")
    out = []
    for i in range(3):
        moved = _moved(verts, i)
        got = fg(vertices=torch.as_tensor(moved))
        fresh = ct.render_pipeline(torch.as_tensor(moved),
                                   torch.as_tensor(faces), cam,
                                   torch.as_tensor(SUN), config)
        out.append((moved, got, fresh))
    return out


def test_deforming_frame_graph_equals_a_fresh_frame(deforming_frames):
    for _, (img, st), (img_f, st_f) in deforming_frames:
        assert torch.equal(img, img_f)
        assert st.keys() == st_f.keys()
        assert all(torch.equal(st[k], st_f[k]) for k in st)
    images = [img for _, (img, _), _ in deforming_frames]
    assert not torch.equal(images[0], images[1])


def test_deforming_frame_graph_matches_the_jitted_jax_render(
        scene, deforming_frames):
    verts, faces, _, _, _, _ = scene
    cam = _cameras(verts)[0]
    for moved, (img, st), _ in deforming_frames:
        jimg, jst = jrenderer.render(moved, faces, cam, SUN, **CONFIG)
        off = (np.abs(img.numpy() - np.asarray(jimg)).max(-1) > 1e-4).mean()
        assert off < 0.005
        for k in ("rays", "hits"):
            assert abs(int(st[k]) - int(jst[k])) <= 0.002 * int(jst[k]), k
        assert int(st["primary_hits"]) > 0


@pytest.mark.parametrize("prebuilt, shape", [
    ("clusters", None), ("table_cols", None), (None, (10, 3))])
def test_frame_graph_refuses_moved_vertices(scene, prebuilt, shape):
    verts, faces, _, cs, table, config = scene
    kw = {"clusters": cs, "table_cols": table}
    fg = render_graph(verts, faces, convert.camera(_cameras(verts)[0]), SUN,
                      config, device="cpu",
                      **({prebuilt: kw[prebuilt]} if prebuilt else {}))
    moved = torch.as_tensor(_moved(verts, 0) if shape is None
                            else np.zeros(shape, np.float32))
    with pytest.raises(ValueError, match=r"stale" if prebuilt
                       else r"vertices \(10, 3\)"):
        fg(vertices=moved)


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: counts replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's streams and graph capture as no-ops on the CPU."""
    import contextlib

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())


def test_capture_counts_launches_per_replay(fake_cuda, monkeypatch):
    fresh = dict.fromkeys(walk.launches, 0)
    monkeypatch.setattr(walk, "launches", fresh)
    monkeypatch.setitem(spans.counters, "walk.launches", fresh)

    def frame():
        # A frame that launches K1 and K2 once each.
        walk.launches["walk_closest"] += 1
        walk.launches["walk_any_dest"] += 1
        return "out"

    g = graphs.capture(frame)
    assert g.launches == {"walk_closest": 1, "walk_any_dest": 1}
    assert g.first == g.outputs == "out"
    # The warm-up launched; the capture did not.
    assert walk.launches["walk_closest"] == 1
    walk.reset_launches()
    for _ in range(3):
        assert g.replay() == "out"
    assert g._graph.replays == 3
    assert {k: n for k, n in walk.launches.items() if n} == {
        "walk_closest": 3, "walk_any_dest": 3}


def test_replay_adds_every_counters_capture_rise(fake_cuda, monkeypatch):
    # Every counter of utils.spans' registry, not only the walk launches:
    # the capture puts each back where the warm-up left it and records
    # its rise, which each replay adds.
    fresh = dict.fromkeys(walk.launches, 0)
    monkeypatch.setattr(walk, "launches", fresh)
    monkeypatch.setitem(spans.counters, "walk.launches", fresh)
    monkeypatch.setitem(spans.counters, "test.rows", {"in": 0, "out": 5})

    def frame():
        walk.launches["walk_closest"] += 1
        spans.counters["test.rows"]["in"] += 7
        return "out"

    g = graphs.capture(frame)
    assert g.counts == {"walk.launches": {"walk_closest": 1},
                        "test.rows": {"in": 7}}
    assert g.launches == {"walk_closest": 1}
    assert spans.counters["test.rows"] == {"in": 7, "out": 5}
    assert g.record is None
    for _ in range(2):
        g.replay()
    assert spans.counters["test.rows"] == {"in": 21, "out": 5}
    assert walk.launches["walk_closest"] == 3
    walk.reset_launches()
    assert not any(walk.launches.values())
    assert spans.counters["walk.launches"] is walk.launches


def test_capture_refuses_cpu_tensors(fake_cuda):
    with pytest.raises(ValueError, match="inputs"):
        graphs.capture(lambda: None, (torch.zeros(3),))
    with pytest.raises(ValueError, match="outputs"):
        graphs.capture(lambda: {"image": torch.zeros(3)})


@pytest.fixture(scope="module")
def quad():
    verts = np.asarray([[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0]],
                       np.float32)
    faces = np.asarray([[0, 1, 2]], np.int32)
    vt, ft = torch.as_tensor(verts), torch.as_tensor(faces)
    cs = build_clusters_treelet(
        ct.triangle_soup(vt, ft, with_normals=False))
    cam = ct.Camera.make(eye=(0, 0, -1), dir=(0, 0, 1), up=(0, 1, 0), fov=60)
    return vt, ft, cam, cs


def _make_step(quad, monkeypatch, capturable, mesh, refit, **config):
    """make_train_step on the card (the device check patched): the step,
    or "captured" where it goes to _captured_step."""
    vt, ft, cam, cs = quad
    monkeypatch.setattr(pinv, "_on_card", lambda device: True)
    monkeypatch.setattr(pinv, "_captured_step", lambda *a: "captured")
    params = {"vertices": vt.clone().requires_grad_()}
    # capturable=True on CPU parameters is refused by Adam's step, not
    # its constructor: only the flag is read here.
    opt = torch.optim.Adam(params.values(), lr=1e-3, capturable=capturable)
    config = ct.RenderConfig(**{"width": 8, "height": 8,
                                "backend": "megakernel", **config})
    return pinv.make_train_step(ft, cam, torch.as_tensor(SUN), config, opt,
                                mesh=object() if mesh else None,
                                clusters0=cs if refit else None)


@pytest.mark.parametrize("capturable, mesh, refit, raises", [
    (False, False, True, True),
    (True, False, True, False),
    (False, False, False, True),    # the rebuilt step is captured too
    (True, False, False, False),
    (False, True, True, False),     # the step over a mesh is not
])
def test_train_step_on_card_needs_a_capturable_optimizer(
        quad, monkeypatch, capturable, mesh, refit, raises):
    if raises:
        with pytest.raises(ValueError, match=(
                f"{'refitted' if refit else 'rebuilt'} step.*"
                f"capturable=True")):
            _make_step(quad, monkeypatch, capturable, mesh, refit)
        return
    step = _make_step(quad, monkeypatch, capturable, mesh, refit)
    assert (step == "captured") == (not mesh)


@pytest.mark.parametrize("config", [{"backend": "bruteforce"},
                                    {"f64_exact": True}])
@pytest.mark.parametrize("refit", [True, False])
def test_oracle_and_f64_steps_stay_eager(quad, monkeypatch, refit, config):
    step = _make_step(quad, monkeypatch, False, False, refit, **config)
    assert step != "captured"


def test_rebuilt_step_goes_through_the_capture(bunny, fake_cuda,
                                               monkeypatch):
    # The step without clusters0 as the card runs it, with the CUDA calls
    # faked: make_train_step captures it (the fake capture runs the body
    # once more), and its first call's loss and gradients are the eager
    # step's, each building the cut from the same vertices; a second
    # call replays.
    import torch.optim.adam as adam

    verts, faces = bunny
    monkeypatch.setattr(pinv, "_on_card", lambda device: True)
    monkeypatch.setattr(graphs, "_on_card", lambda x, what: None)
    supported = adam._get_capturable_supported_devices
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*supported(*a, **k), "cpu"])
    captures = []
    capture = graphs.capture
    monkeypatch.setattr(graphs, "capture",
                        lambda fn, inputs=(): captures.append(fn) or capture(
                            fn, inputs))
    config = ct.RenderConfig(width=16, height=16, backend="megakernel")
    cam = convert.camera(_cameras(verts)[0])
    ft, sun = torch.as_tensor(faces), torch.as_tensor(SUN)
    target = torch.zeros((16, 16, 3))
    runs = {}
    for name, make in (("graph", pinv.make_train_step),
                       ("eager", pinv._make_eager_step)):
        params = {"vertices": torch.as_tensor(_moved(verts, 0))
                  .requires_grad_()}
        opt = torch.optim.Adam(params.values(), lr=1e-5, capturable=True)
        step = make(ft, cam, sun, config, opt)
        state, loss = step(pinv.TrainState(params, {"vertices": {}}), target)
        runs[name] = (step, state, float(loss),
                      params["vertices"].grad.clone())
    assert len(captures) == 1
    (g_step, g_state, g_loss, g_grad), (_, _, e_loss, e_grad) = (
        runs["graph"], runs["eager"])
    assert g_loss == e_loss > 0
    assert torch.equal(g_grad, e_grad) and bool(g_grad.abs().sum() > 0)
    g_step(g_state, target)
    assert len(captures) == 1


@pytest.mark.parametrize("refit", [True, False])
def test_fit_vertices_builds_a_capturable_adam(quad, monkeypatch, refit):
    vt, ft, cam, _ = quad
    monkeypatch.setattr(pinv, "_on_card", lambda device: True)
    built = []

    def make_train_step(faces, camera, sun, config, optimizer, mesh=None,
                        clusters0=None):
        built.append((optimizer, clusters0))
        return lambda state, target: (state, torch.zeros(()))

    monkeypatch.setattr(pinv, "make_train_step", make_train_step)
    config = ct.RenderConfig(width=8, height=8, backend="megakernel")
    pinv.fit_vertices(vt, ft, cam, SUN, torch.zeros((8, 8, 3)),
                      config=config, steps=1, refit=refit, device="cpu")
    (opt, clusters0), = built
    assert (clusters0 is not None) == refit
    assert all(g["capturable"] for g in opt.param_groups)


def test_captured_step_takes_a_carried_state():
    static = {"step": torch.tensor(3.0), "exp_avg": torch.ones(4),
              "exp_avg_sq": torch.full((4,), 2.0)}
    ids = {k: id(v) for k, v in static.items()}
    given = {"step": torch.tensor(7.0), "exp_avg": torch.arange(4.0),
             "exp_avg_sq": static["exp_avg_sq"]}
    pinv._load_state(static, given)
    assert {k: id(v) for k, v in static.items()} == ids
    assert float(static["step"]) == 7.0
    assert torch.equal(static["exp_avg"], torch.arange(4.0))
    assert torch.equal(static["exp_avg_sq"], torch.full((4,), 2.0))
    pinv._load_state(static, static)
    pinv._load_state(static, {})           # Adam afresh
    assert all(not bool(v.any()) for v in static.values())
    with pytest.raises(ValueError, match="opt_state"):
        pinv._load_state(static, {"step": torch.tensor(1.0)})

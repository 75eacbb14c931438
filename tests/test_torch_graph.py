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
  * the launch counts of ``utils.graphs``: a capture leaves the walk
    counts where the warm-up call put them, and each replay adds the
    captured launches (the CUDA calls stood in for by fakes here);
  * what is refused: the oracle backend, ``f64_exact``, a frame without
    its prebuilt cut or table, CPU tensors handed to a capture, and on
    the card a refitted train step with a non-capturable optimizer (the
    device check patched);
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
from ceres_tpu_torch.utils import convert, graphs

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
])
def test_render_graph_refuses_uncaptured_paths(scene, kwargs, match):
    verts, faces, _, cs, table, config = scene
    config = ct.RenderConfig(**dict(CONFIG, **kwargs))
    with pytest.raises(ValueError, match=match):
        render_graph(verts, faces, convert.camera(_cameras(verts)[0]), SUN,
                     config, cs, table, device="cpu")


@pytest.mark.parametrize("missing", ["clusters", "table_cols"])
def test_render_graph_needs_the_prebuilt_scene(scene, missing):
    verts, faces, _, cs, table, config = scene
    kw = {"clusters": cs, "table_cols": table, missing: None}
    with pytest.raises(ValueError, match="prebuilt"):
        render_graph(verts, faces, convert.camera(_cameras(verts)[0]), SUN,
                     config, device="cpu", **kw)


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
    monkeypatch.setattr(walk, "launches", dict.fromkeys(walk.launches, 0))

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


@pytest.mark.parametrize("capturable, mesh, refit, raises", [
    (False, False, True, True),
    (True, False, True, False),
    (False, False, False, False),   # the rebuilt step stays eager
    (False, True, True, False),     # so does the step over a mesh
])
def test_train_step_on_card_needs_a_capturable_optimizer(
        quad, monkeypatch, capturable, mesh, refit, raises):
    vt, ft, cam, cs = quad
    monkeypatch.setattr(pinv, "_on_card", lambda device: True)
    captured = []
    monkeypatch.setattr(pinv, "_captured_step",
                        lambda *a: captured.append(a) or "captured")
    params = {"vertices": vt.clone().requires_grad_()}
    # capturable=True on CPU parameters is refused by Adam's step, not
    # its constructor: only the flag is read here.
    opt = torch.optim.Adam(params.values(), lr=1e-3, capturable=capturable)
    config = ct.RenderConfig(width=8, height=8, backend="megakernel")
    kw = dict(mesh=object() if mesh else None,
              clusters0=cs if refit else None)
    if raises:
        with pytest.raises(ValueError, match="capturable=True"):
            pinv.make_train_step(ft, cam, torch.as_tensor(SUN), config, opt,
                                 **kw)
        return
    step = pinv.make_train_step(ft, cam, torch.as_tensor(SUN), config, opt,
                                **kw)
    assert (step == "captured") == (refit and not mesh)
    assert len(captured) == int(refit and not mesh)


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

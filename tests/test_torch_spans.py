"""The port's spans and counters (``ceres_tpu_torch.utils.spans``) on the
CPU, where a record's stamps are the host clock:

  * with spans off, ``span``, ``host`` and ``recording`` are one shared
    no-op context, and a frame or step leaves no record;
  * an eager ``render_pipeline`` of the bunny preset with spans on
    records ``frame`` and under it ``primary``, ``closest.prep``, two
    ``walk``s, ``closest.gather``, ``shadow.prep`` and ``shade``, with
    ``build`` (the treelet cut and the winner table) only when no cut is
    given, and the float32 prepass inside each prep: ``prepass.flat``
    where the walk is flat (resident or streamed weights),
    ``prepass.hier`` where it is two-level; the same names show as
    ``ceres.<name>`` host spans in a profiler trace;
  * self time is the total less the union of the children's intervals;
  * ``FrameGraph`` on the CPU and the eager train step give their last
    call's spans (``span_ms()``), the step's five ``step.*`` spans with
    the frame under ``step.forward``;
  * a float64-exact frame (``f64_exact=True``) records ``prepass.f64``
    and ``walk.f64`` in place of each walk's prep and ``walk`` spans, as
    a ``FrameGraph`` on the CPU too, and counts no ``walk_f64.launches``
    or ``prepass_f64.launches`` on the CPU (the plain loop and passes),
    nor any float32 walk.

The counters a replay adds: ``tests/test_torch_graph.py``; the stamps on
the card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel.clusters import build_clusters_treelet
from ceres_tpu_torch.diff import TrainState, inverse
from ceres_tpu_torch.render import scenes
from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                             render_graph)
from ceres_tpu_torch.utils import spans

torch.set_num_threads(1)

SIZE = 32
FRAME_KIDS = ["primary", "closest.prep", "walk", "closest.gather", "shade",
              "shadow.prep", "walk", "shade", "shade"]
PREPS = ("closest.prep", "shadow.prep")


def _frame_tree(kids, prepass="prepass.flat"):
    """The expected [(name, parent name)] of a frame whose children are
    ``kids``: each prep holds the float32 prepass span ``prepass``."""
    tree = [("frame", None)]
    for k in kids:
        tree.append((k, "frame"))
        if k in PREPS:
            tree.append((prepass, k))
    return tree


@pytest.fixture
def spans_on():
    spans.enable(True)
    try:
        yield
    finally:
        spans.enable(False)


@pytest.fixture(scope="module")
def preset():
    sc = scenes.bunny_scene()
    vt, ft = torch.as_tensor(sc.vertices), torch.as_tensor(sc.faces)
    cam = ct.Camera.make(sc.camera.eye, sc.camera.dir, sc.camera.up,
                         sc.camera.fov)
    sun = torch.as_tensor(np.asarray(sc.sun, np.float32))
    config = ct.RenderConfig(width=SIZE, height=SIZE, backend="megakernel")
    cs = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    return vt, ft, cam, sun, config, cs, table


def _tree(record):
    """[(name, parent name)] of a record's spans, in order."""
    names = [s[0] for s in record.spans]
    return [(name, None if parent < 0 else names[parent])
            for name, parent, _, _ in record.spans]


def test_spans_off_record_nothing(preset):
    vt, ft, cam, sun, config, cs, table = preset
    assert not spans.enabled()
    assert spans.span("frame") is spans._NULL
    assert spans.host("frame.replay") is spans._NULL
    assert spans.recording("cpu") is spans._NULL
    with spans.recording("cpu") as record:
        ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs,
                           table_cols=table)
    assert record is None
    fg = render_graph(vt, ft, cam, sun, config, cs, table, device="cpu")
    fg(sun_position=sun)
    assert fg.span_ms() is None


@pytest.mark.parametrize("prebuilt", [True, False])
def test_frame_spans_nest(preset, spans_on, prebuilt):
    vt, ft, cam, sun, config, cs, table = preset
    cut = dict(clusters=cs, table_cols=table) if prebuilt else {}
    with spans.recording("cpu") as record:
        image, _ = ct.render_pipeline(vt, ft, cam, sun, config, **cut)
    want = FRAME_KIDS if prebuilt else (
        FRAME_KIDS[:1] + ["build"] + FRAME_KIDS[1:3] + ["build"]
        + FRAME_KIDS[3:])
    assert _tree(record) == _frame_tree(want)
    assert record.stamps == 2 * len(record.spans)
    ms = record.span_ms()
    assert ("build" in ms) == (not prebuilt)
    assert all(row["total"] >= row["self"] >= 0 for row in ms.values())
    # The children of the frame are disjoint: the union is their sum.
    kids = sum(row["total"] for name, row in ms.items()
               if name not in ("frame", "prepass.flat"))
    assert ms["frame"]["self"] == pytest.approx(ms["frame"]["total"] - kids)
    assert float(image.max()) > 0


@pytest.mark.parametrize("form", ["resident", "streamed", "two-level"])
def test_prepass_span_names_the_walks_form(preset, spans_on, monkeypatch,
                                           form):
    from ceres_tpu_torch.ops import megakernel, prepass

    vt, ft, cam, sun, config, cs, table = preset
    if form == "streamed":
        monkeypatch.setattr(prepass, "_RESIDENT_W_BYTES", 64 << 10)
    if form == "two-level":
        monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 32)
    seen = []
    for name in ("walk_closest", "walk_any_dest"):
        real = getattr(megakernel.walk, name)

        def recorded(*args, _real=real, **opts):
            seen.append((opts["S"], opts["stream"]))
            return _real(*args, **opts)

        monkeypatch.setattr(megakernel.walk, name, recorded)
    with spans.recording("cpu") as record:
        image, _ = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs,
                                      table_cols=table)
    flat = form != "two-level"
    assert [(S == 1, stream) for S, stream in seen] == [
        (flat, form == "streamed")] * 2
    name = "prepass.flat" if flat else "prepass.hier"
    assert _tree(record) == _frame_tree(FRAME_KIDS, name)
    ms = record.span_ms()
    assert 0 < ms[name]["total"] < (ms["closest.prep"]["total"]
                                    + ms["shadow.prep"]["total"])
    assert float(image.max()) > 0


def test_self_time_is_total_less_the_childrens_union():
    # a: 0-100 with children b (10-40, itself holding c 20-30) and d
    # (50-60); e a second root (200-260); times in ns.
    rows = [["a", -1, 0, 1], ["b", 0, 2, 3], ["c", 1, 4, 5],
            ["d", 0, 6, 7], ["e", -1, 8, 9], ["d", 4, 10, 11]]
    stamps = [0, 100e6, 10e6, 40e6, 20e6, 30e6, 50e6, 60e6, 200e6, 260e6,
              210e6, 250e6]
    ms = spans.span_ms(rows, stamps)
    assert ms["a"] == {"total": 100.0, "self": 60.0}
    assert ms["b"] == {"total": 30.0, "self": 20.0}
    assert ms["c"] == {"total": 10.0, "self": 10.0}
    assert ms["d"] == {"total": 50.0, "self": 50.0}
    assert ms["e"] == {"total": 60.0, "self": 20.0}


def test_spans_show_as_host_spans(preset, spans_on):
    vt, ft, cam, sun, config, cs, table = preset
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs,
                           table_cols=table)
    names = {e.name for e in prof.events() if e.name.startswith("ceres.")}
    assert names == {f"ceres.{k}" for k in ["frame", *FRAME_KIDS,
                                             "prepass.flat"]}


def test_frame_graph_gives_the_last_calls_spans(preset, spans_on):
    vt, ft, cam, sun, config, cs, table = preset
    fg = render_graph(vt, ft, cam, sun, config, cs, table, device="cpu")
    fg(sun_position=sun)
    first = fg.record
    fg(sun_position=sun + 1e-3)
    assert fg.record is not first
    ms = fg.span_ms()
    assert set(ms) == {"frame", *FRAME_KIDS, "prepass.flat"}
    assert ms["walk"]["total"] > 0


@pytest.mark.parametrize("refit", [True, False])
def test_eager_step_spans(preset, spans_on, refit):
    vt, ft, cam, sun, config, cs, _ = preset
    target = torch.zeros((SIZE, SIZE, 3))
    params = {"vertices": (vt + 1e-4).requires_grad_()}
    opt = torch.optim.Adam(params.values(), lr=1e-5)
    step = inverse._make_eager_step(ft, cam, sun, config, opt,
                                    clusters0=cs if refit else None)
    assert step.span_ms() is None
    # The step's record joins the one open here.
    with spans.recording("cpu") as record:
        step(TrainState(params, {"vertices": {}}), target)
    ms = step.span_ms()
    assert step.record is record and ms == record.span_ms()
    steps = {"step.forward", "step.loss", "step.backward", "step.optim"}
    assert {k for k in ms if k.startswith("step.")} == (
        steps | {"step.refit"} if refit else steps)
    # The winner table is built in every step; the cut only unrefitted.
    builds = [name for name, _ in _tree(record) if name == "build"]
    assert len(builds) == (1 if refit else 2)
    tree = dict(_tree(record))
    assert tree["frame"] == "step.forward"
    assert tree["step.forward"] is None and tree["step.backward"] is None


F64_KIDS = ["primary", "prepass.f64", "walk.f64", "closest.gather", "shade",
            "prepass.f64", "walk.f64", "shade", "shade"]


def test_f64_frame_spans_and_launches(preset, spans_on):
    from ceres_tpu_torch.ops import walk, walk_f64

    vt, ft, cam, sun, config, _, _ = preset
    vt = vt.double()
    cam = ct.Camera.make(cam.eye, cam.dir, cam.up, cam.fov,
                         dtype=torch.float64)
    sun = sun.double()
    config = ct.RenderConfig(width=SIZE, height=SIZE, backend="megakernel",
                             f64_exact=True)
    cs = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    assert set(spans.counters["walk_f64.launches"]) == {"closest", "any",
                                                        "any_dest"}
    assert set(spans.counters["prepass_f64.launches"]) == {"closest", "any",
                                                           "any_dest"}
    assert set(spans.counters["walk_f64.clustered"]) == {"closest", "any",
                                                         "any_dest"}
    before = spans.snapshot()
    with spans.recording("cpu") as record:
        image, _ = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs,
                                      table_cols=table)
    assert _tree(record) == [("frame", None)] + [(k, "frame")
                                                 for k in F64_KIDS]
    ms = record.span_ms()
    assert ms["walk.f64"]["total"] > 0 and ms["prepass.f64"]["total"] > 0
    assert "walk" not in ms and "closest.prep" not in ms
    fg = render_graph(vt, ft, cam, sun, config, cs, table, device="cpu")
    fg(sun_position=sun)
    assert set(fg.span_ms()) == {"frame", *F64_KIDS}
    assert spans.snapshot() == before
    assert walk_f64.launches is spans.counters["walk_f64.launches"]
    assert (walk_f64.prepass_launches
            is spans.counters["prepass_f64.launches"])
    assert walk_f64.clustered is spans.counters["walk_f64.clustered"]
    assert not any(walk.launches.values())
    assert float(image.max()) > 0

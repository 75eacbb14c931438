"""The benchmark's cells of the flat streamed path (``bunny3x-1080p.static``)
and of the train step that rebuilds its cut (``bunny-1080p.fit-rebuild``),
on the CPU:

  * the port's frame of a mesh whose treelet cut walks flat with streamed
    weights (the bunny subdivided twice: 1,242 blocks, past the resident
    budget and under the two-level threshold, as the 3x bunny's 4,968)
    equals ``raybench/reference.py`` on a seeded sun at 64 x 48: the rays,
    and every pixel within 1e-4 but for a few shadow rays that graze the
    terminator and flip in float32; the frozen pair count
    (``raybench/walkcount.py``) reads the port's plain walks' visits and
    pairs on those streamed walks' recorded inputs;
  * the 3x configuration makes the mesh it declares, and its cut takes
    that path;
  * both cells run as files through ``harness.run_cell`` at a tiny size
    (the benchmark's own CPU fixture, ``raybench/tests/conftest.py``):
    the frame cell correct with its end-to-end metrics, the rebuilt fit's
    held steps read as the refitted fit's on the same seed;
  * the ``fit_rebuild`` loop's step has no ``clusters0``: with spans on,
    each step builds the cut and the winner table and refits nothing; its
    mix is named ``fit`` once set up, and its span reader refuses a loop
    of another kind;
  * the prepass readers read their own spans and nothing on a checkout
    whose port has none.

The spans themselves (``prepass.flat``, ``prepass.hier``):
``tests/test_torch_spans.py``.
"""

import importlib.util
import os
import time
import types

import pytest
import torch

import ceres_tpu_torch as ct
from raybench import harness, loops, manifest, reference, scene, walkcount

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**33 + 19
FRAMES = "bunny3x-1080p.static"
REBUILT = "bunny-1080p.fit-rebuild"
CFG = {"mesh": "raybench/scenes/bunny.obj", "eye": [0.0, 0.1, -0.3],
       "look_at": "centroid", "up": [0, 1, 0], "fov": 60.0,
       "sun": [-50.0, 100.0, 0.0]}


def _bench_conftest():
    path = os.path.join(ROOT, "raybench", "tests", "conftest.py")
    spec = importlib.util.spec_from_file_location("raybench_tests_conftest",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _bench_conftest().make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def streamed():
    """The bunny subdivided twice at 64 x 48 on a seeded sun of the static
    mix: (port image, stats, reference image, stats, recorded walks)."""
    from ceres_tpu_torch.ops import walk

    cfg = dict(CFG, subdivide=2)
    v, f = scene.mesh(cfg, ROOT)
    cam = scene.camera(cfg, v)
    vt, ft = torch.as_tensor(v), torch.as_tensor(f)
    traffic = manifest.cell(ROOT, FRAMES)["traffic"]
    sun = scene.sun_path(cfg, traffic, SEED, "cpu")[7]
    camera = ct.Camera.make(cam["eye"], cam["dir"], cam["up"], cam["fov"])
    config = ct.RenderConfig(width=64, height=48, backend="megakernel")
    seen = []
    real = {n: getattr(walk, n) for n in ("walk_closest", "walk_any_dest")}

    def recorder(name):
        def call(*args, **opts):
            seen.append((name, args, opts))
            return real[name](*args, **opts)
        return call

    try:
        for name in real:
            setattr(walk, name, recorder(name))
        img, st = ct.render_pipeline(vt, ft, camera, sun, config)
    finally:
        for name, fn in real.items():
            setattr(walk, name, fn)
    ref_img, ref_st = reference.frame(vt, ft.long(),
                                      torch.as_tensor(cam["eye"]), cam, sun,
                                      64, 48)
    return img, st, ref_img, ref_st, seen


def test_streamed_flat_frame_equals_the_reference(streamed):
    img, st, ref_img, ref_st, seen = streamed
    assert [name for name, _, _ in seen] == ["walk_closest", "walk_any_dest"]
    for _, args, opts in seen:
        assert opts["S"] == 1 and opts["stream"]
        assert args[3].shape[0] == 1242     # the cut's blocks of weights
    # Every primary ray agrees. A shadow ray that grazes the terminator
    # may flip between two float32 searches (the cells' sound gaps,
    # PERF.md section 2): each flip moves one hit and one pixel.
    assert int(st["rays"]) == ref_st["rays"] and ref_st["hits"] > 500
    flips = abs(int(st["hits"]) - ref_st["hits"])
    off = int(((img - ref_img).abs().amax(-1) > 1e-4).sum())
    assert flips <= 4 and off <= 4


def test_walkcount_counts_the_streamed_flat_walks(streamed):
    from ceres_tpu_torch.ops import walk

    for name, args, opts in streamed[4]:
        if name == "walk_closest":
            visits, pairs = walkcount.closest(*args[:4], opts)
            _, want = walk._walk_closest_plain(*args, **opts)
            want_pairs = int(want.sum()) * 512 * 128
        else:
            visits, pairs = walkcount.occlusion("any_dest", *args[:5], opts)
            _, want, want_pairs = walk._occlusion_plain(
                "any_dest", *args, None, None, None, 1)
        assert torch.equal(visits, want)
        assert pairs == int(want_pairs) > 0


def test_the_3x_configuration_takes_the_flat_streamed_path():
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.ops import prepass

    cfg = manifest.cell(ROOT, FRAMES)["config"]
    v, f = scene.mesh(cfg, ROOT)
    assert (len(f), len(v)) == (cfg["triangles"], cfg["vertices"])
    assert cfg["cut"] == "treelet" and cfg["reduced"] == []
    cs = build_clusters_treelet(ct.triangle_soup(
        torch.as_tensor(v), torch.as_tensor(f), with_normals=False))
    n_c = cs.lo.shape[0]
    assert n_c == 4968
    assert prepass._super_factor(n_c) == 1 and prepass._use_stream(n_c)


def _run(root, cell):
    return harness.run_cell(root, cell, SEED, 0.2, False, "cpu",
                            time.perf_counter())


def _values(out):
    return {k: row["value"] for k, row in out["compared"].items()}


def test_the_frame_cell_runs_as_files(tiny_root):
    out = _run(tiny_root, FRAMES)
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"rays_per_s", "frame_ms_p95", "setup_s"}
    assert out["device"]["platform"] == "cpu"


def test_the_rebuilt_fit_runs_as_files(tiny_root):
    spec = manifest.cell(tiny_root, REBUILT)
    assert spec["traffic"]["kind"] == "fit_rebuild"
    out = _run(tiny_root, REBUILT)
    assert set(out["metrics"]) == {"step_ms", "setup_s"}
    assert out["failed"] == 0 and out["attempted"] >= 1
    # The rebuilt step renders what the refitted one does: its held steps
    # read as the fit cell's against plain Adam on the same seed.
    refitted = _values(_run(tiny_root, "bunny-1080p.fit"))
    assert _values(out) == pytest.approx(refitted, rel=1e-5, abs=1e-9)
    assert refitted["change_gap"] < 0.3 and refitted["last_grad_gap"] < 0.05


def test_the_rebuilt_fit_builds_its_cut_in_every_step(tiny_root):
    from ceres_tpu_torch.utils import spans

    spec = manifest.cell(tiny_root, REBUILT)
    spans.enable(True)
    try:
        loop = loops.make(spec["config"], spec["traffic"], SEED, tiny_root,
                          torch.device("cpu"), lambda label: None)
        loop.call(spec["traffic"]["held_steps"])
    finally:
        spans.enable(False)
    assert spec["traffic"]["kind"] == "fit"
    assert loop.kind == "fit_rebuild" and loop.graph is loop.step
    assert loop.cs0 is None
    record = loop.step.record
    names = [s[0] for s in record.spans]
    # The cut and the winner table, built in the step; no refit.
    assert names.count("build") == 2 and "step.refit" not in names
    assert loop.step.span_ms()["build"]["total"] > 0
    # The forward (bwd_fwd.fit's) renders the step's frame, cut built.
    assert float(loop.forward()) == pytest.approx(float(loop.call(0)),
                                                  rel=1e-6)


def _ctx(kind, loop, rows, traffic_kind):
    cache = {"spans": {"span_ms": rows, "nodes": [0] * len(rows),
                       "latency_ms": [1.0] * len(rows),
                       "latency_off_ms": [1.0] * len(rows)}}
    return types.SimpleNamespace(
        root=ROOT, cell={"traffic": {"kind": traffic_kind,
                                     "geometry": "static"}},
        cache=cache, dev=torch.device("cuda"), loop=loop,
        trace=types.SimpleNamespace(device=True, calls=len(rows)),
        note=lambda *a: None)


def _read(name, ctx):
    return manifest.metric(ROOT, name).read(ctx)


def test_the_rebuilt_step_reader_refuses_another_kinds_loop():
    rows = [{"build": {"total": t, "self": t},
             "step.forward": {"total": 6.0, "self": 1.0}}
            for t in (0.6, 0.8, 0.7)]
    refitted = _ctx("fit", types.SimpleNamespace(returns="fit"), rows, "fit")
    with pytest.raises(ValueError, match="fit_rebuild"):
        _read("build_span_ms.fit", refitted)
    rebuilt = _ctx("fit", types.SimpleNamespace(kind="fit_rebuild"), rows,
                   "fit")
    assert _read("build_span_ms.fit", rebuilt) == pytest.approx(0.7)
    assert rebuilt.cell["traffic"]["kind"] == "fit"
    assert _read("build_span_ms.fit", _ctx(
        "frames", None, rows, "frames")) is None


@pytest.mark.parametrize("form", ["flat", "hier"])
def test_prepass_readers_read_their_own_spans(form):
    other = "hier" if form == "flat" else "flat"
    rows = [{"frame": {"total": 30.0, "self": 1.0},
             f"prepass.{form}": {"total": t, "self": t},
             "closest.prep": {"total": t + 1.0, "self": 1.0}}
            for t in (4.0, 5.0, 4.5)]
    ctx = _ctx("frames", None, rows, "frames")
    assert _read(f"prepass_ms.{form}", ctx) == pytest.approx(4.5)
    # A port whose frames have no such span (the parent of the spans, or
    # the other form) reads nothing; so does a fit.
    assert _read(f"prepass_ms.{other}", ctx) is None
    assert _read(f"prepass_ms.{form}", _ctx("fit", None, rows, "fit")) is None

"""The float64-exact cell (``bunny4x-1080p-f64.static``: the kind
``kinds/frames_f64.py``, the float64 reference ``reference_f64.py``, the
frozen float64 pair count ``walkcount_f64.py``) on the CPU, at a tiny
size:

  * the float64 reference against the port's float64-exact frame of the
    same inputs: every pixel within the kind's PX_TOL, rays and hits
    equal; and against an all-pairs float64 search of the same rays;
  * the cell run as files (its kind found by name, its frame captured by
    ``render_graph(f64_exact=True)``), correct, untraced and traced, its
    mix named ``frames`` for the frame readers once set up;
  * ``correct`` false for an altered frame and for the float32 control
    (the reference in float32 in the port's place);
  * the frozen pair count against the port's float64 walks on the inputs
    recorded from an eager frame: the same visits, and pairs within what
    every live ray against every visited block would test;
  * the float64 readers raise on a loop of another kind, and
    ``build_span_ms.bunny`` reads what ``build_span_ms.deform`` reads;
  * the reference loads nothing of the port.
"""

from __future__ import annotations

import importlib.util
import os
import time
import types

import pytest
import torch

from conftest import HOME, ROOT
from raybench import compare, control, harness, loops, manifest
from raybench import reference, reference_f64, scene, walkcount_f64

CELL = "bunny4x-1080p-f64.static"
SEED = 2**33 + 7
CFG = {"mesh": "raybench/scenes/bunny.obj", "eye": [0.0, 0.1, -0.3],
       "look_at": "centroid", "up": [0, 1, 0], "fov": 60.0}


def _kind():
    return loops.kind(ROOT, "frames_f64")


def _port_frame(width, height, sun, exact=True):
    import ceres_tpu_torch as ct

    v, f = scene.mesh(CFG, ROOT)
    cam = scene.camera(CFG, v)
    vt, ft = torch.as_tensor(v).double(), torch.as_tensor(f)
    camera = ct.Camera.make(cam["eye"], cam["dir"], cam["up"], cam["fov"],
                            dtype=torch.float64)
    config = ct.RenderConfig(width=width, height=height, backend="megakernel",
                             f64_exact=exact)
    img, st = ct.render_pipeline(vt, ft, camera, sun, config)
    return vt, ft, cam, img, st


def test_reference_f64_matches_the_port():
    sun = torch.tensor([-50.0, 100.0, 0.0], dtype=torch.float64) + 0.003
    vt, ft, cam, img, st = _port_frame(96, 64, sun)
    ref_img, ref_st = reference_f64.frame(vt, ft.long(),
                                          torch.as_tensor(cam["eye"]), cam,
                                          sun, 96, 64)
    assert ref_img.dtype == torch.float64
    got = _kind().frame_numbers(img, st, ref_img, ref_st)
    assert got == {"px_off_pct": 0.0, "rays_gap": 0.0, "hits_gap": 0.0}
    assert ref_st["hits"] > 1000
    # In float32 the reference is off by more than PX_TOL on the lit
    # pixels.
    f32 = reference_f64.frame(vt, ft.long(), torch.as_tensor(cam["eye"]),
                              cam, sun, 96, 64, torch.float32)
    assert _kind().frame_numbers(*f32, ref_img, ref_st)["px_off_pct"] > 1.0


def test_reference_f64_closest_is_the_all_pairs_winner():
    v, f = scene.mesh(CFG, ROOT)
    cam = scene.camera(CFG, v)
    vt, ft = torch.as_tensor(v).double(), torch.as_tensor(f).long()
    eye = torch.as_tensor(cam["eye"]).double()
    dirs = reference_f64.camera_dirs(cam, 48, 32, torch.float64, "cpu")
    got = reference_f64.closest(eye, dirs, vt, ft)
    p0, e1, e2 = reference._records(vt, ft)
    t, _, _, ok = reference._mt(eye, dirs[:, None, :], p0[None], e1[None],
                                e2[None])
    t = torch.where(ok & (t >= 0), t, torch.inf)
    best = t.amin(dim=1)
    ids = torch.arange(ft.shape[0]).expand_as(t)
    want = torch.where(t == best[:, None], ids, ft.shape[0]).amin(dim=1)
    want = torch.where(torch.isfinite(best), want, -1)
    assert int((want >= 0).sum()) > 200
    assert torch.equal(got, want)


def _run(root, traced=False):
    return harness.run_cell(root, CELL, SEED, 0.3, traced, "cpu",
                            time.perf_counter())


def test_the_f64_cell_runs_as_files(tiny_root):
    spec = manifest.cell(tiny_root, CELL)
    assert spec["traffic"]["kind"] == "frames_f64"
    for traced in (False, True):
        out = _run(tiny_root, traced)
        assert out["correct"], out["compared"]
        assert out["attempted"] >= 1
        if not traced:
            assert set(out["metrics"]) == {"rays_per_s", "frame_ms_p95",
                                           "setup_s"}
    loop = loops.make(spec["config"], spec["traffic"], SEED, tiny_root,
                      torch.device("cpu"))
    assert spec["traffic"]["kind"] == "frames"
    image, stats = loop.call(0)
    assert image.dtype == torch.float64 and int(stats["hits"]) > 0


def test_an_altered_f64_frame_is_not_correct(tiny_root, monkeypatch):
    from ceres_tpu_torch.render import renderer

    real = renderer.render_pipeline

    def altered(*args, **kwargs):
        image, stats = real(*args, **kwargs)
        image = image.clone()
        image[:2, :2] = image[:2, :2] + 1e-6
        return image, stats

    monkeypatch.setattr(renderer, "render_pipeline", altered)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["compared"]["px_off_pct"]["value"] > 0


def test_the_f64_control_is_not_correct(tiny_root):
    limits = manifest.cell(tiny_root, CELL)["cell"]["limits"]
    readings = control.readings(tiny_root, CELL, SEED, "cpu")
    ok, _ = compare.judge(readings["control"], limits)
    assert not ok, readings
    assert set(readings) == {"control", "d_search"}


def _reader_ctx(kind, loop, rows=(), geometry="static"):
    traffic = {"kind": kind, "geometry": geometry}
    cache = {"spans": {"span_ms": list(rows), "nodes": [0] * len(rows),
                       "latency_ms": [1.0] * len(rows),
                       "latency_off_ms": [1.0] * len(rows)}}
    return types.SimpleNamespace(
        root=ROOT, cell={"traffic": traffic, "config": {"f64_exact": True}},
        cache=cache, dev=torch.device("cuda"), loop=loop,
        trace=types.SimpleNamespace(device=True), note=lambda *a: None)


@pytest.mark.parametrize("name", ["walk_ms.f64", "prepass_ms.f64",
                                  "walk_roofline.f64"])
def test_f64_readers_refuse_another_kinds_loop(name):
    # A float64 configuration under the built-in frame loop (the mix's
    # own name, ``frames``, never renamed by this kind) reads nothing
    # as a float64-exact frame: the reader raises.
    rows = [{"walk.f64": {"total": 2.0, "self": 2.0},
             "prepass.f64": {"total": 3.0, "self": 3.0}}]
    ctx = _reader_ctx("frames", types.SimpleNamespace(returns="frames"),
                      rows)
    with pytest.raises(ValueError, match="frames_f64"):
        manifest.metric(ROOT, name).read(ctx)
    ctx.loop.kind = "frames_f64"
    if name != "walk_roofline.f64":
        want = rows[0][name.replace("_ms", "").replace("_", ".")]["total"]
        assert manifest.metric(ROOT, name).read(ctx) == want


def test_build_span_ms_bunny_reads_the_build_spans():
    rows = [{"frame": {"total": t + 4.0, "self": 1.0},
             "build": {"total": t, "self": t}} for t in (0.5, 0.7, 0.6)]
    deform = _reader_ctx("frames", None, rows, geometry="deforming")
    static = _reader_ctx("frames", None, rows)
    bunny = manifest.metric(ROOT, "build_span_ms.bunny")
    assert bunny.MOVES == "rays_per_s.bunny"
    assert bunny.read(deform) == pytest.approx(0.6)
    assert bunny.read(deform) == manifest.metric(
        ROOT, "build_span_ms.deform").read(deform)
    assert bunny.read(static) is None


def _recorder():
    path = os.path.join(HOME, "metrics", "walk_roofline.f64.py")
    spec = importlib.util.spec_from_file_location("walk_roofline_f64", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_walkcount_f64_counts_the_ports_walks(monkeypatch):
    from ceres_tpu_torch.ops import walk_f64

    sun = torch.tensor([-50.0, 100.0, 0.0], dtype=torch.float64)
    steps = []
    real = walk_f64._walk

    def kept(*args, **opts):
        out, n = real(*args, **opts)
        steps.append(int(n))
        return out, n

    monkeypatch.setattr(walk_f64, "_walk", kept)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    seen = _recorder().recorded_walks(lambda: _port_frame(64, 48, sun))
    assert [m for m, _ in seen] == ["closest", "any_dest"]
    for (mode, inputs), want in zip(seen, steps):
        cs = inputs.pop("cs")
        visits, pairs = walkcount_f64.count(cs.e1, cs.e2, mode=mode,
                                            **inputs)
        assert int(visits.sum()) == want > 0
        live = int(inputs["alive"].sum())
        assert 0 < pairs <= want * live * cs.cluster_size
        t, by = walkcount_f64.bound(mode, inputs, want, pairs)
        assert t > 0 and by in ("operations", "bytes")


def test_the_f64_reference_loads_nothing_of_the_port():
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import torch
        from raybench import reference_f64, scene, walkcount_f64
        cfg = {CFG!r}
        v, f = scene.mesh(cfg, {ROOT!r})
        reference_f64.frame(torch.as_tensor(v), torch.as_tensor(f).long(),
                            torch.tensor([0, .1, -.3]), scene.camera(cfg, v),
                            torch.tensor([-50.0, 100.0, 0.0]), 32, 24)
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"ceres_tpu_torch", "ceres_tpu", "jax", "jaxlib",
                        "flax"}}))
        """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"

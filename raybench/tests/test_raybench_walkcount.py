"""The frozen pair count (``walkcount.py``) equals the port's plain walks
on the walk inputs of a frame: visits tile by tile and pairs."""

from __future__ import annotations

import importlib.util
import os

import torch

from conftest import HOME, ROOT
from raybench import scene, walkcount


def _recorder_module():
    path = os.path.join(HOME, "metrics", "walk_roofline.frame.py")
    spec = importlib.util.spec_from_file_location("walk_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _walks(levels):
    import ceres_tpu_torch as ct

    cfg = {"mesh": "raybench/scenes/bunny.obj", "subdivide": levels,
           "eye": [0.0, 0.1, -0.3], "look_at": "centroid", "up": [0, 1, 0],
           "fov": 60.0}
    v, f = scene.mesh(cfg, ROOT)
    cam = scene.camera(cfg, v)
    vt, ft = torch.as_tensor(v), torch.as_tensor(f)
    camera = ct.Camera.make(cam["eye"], cam["dir"], cam["up"], cam["fov"])
    config = ct.RenderConfig(width=96, height=64, backend="megakernel")
    sun = torch.tensor([-50.0, 100.0, 0.0])
    rec = _recorder_module()
    real_sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a: None
    try:
        return rec.recorded_walks(lambda: ct.render_pipeline(
            vt, ft, camera, sun, config))
    finally:
        torch.cuda.synchronize = real_sync


def _check(seen):
    from ceres_tpu_torch.ops import walk

    assert [m for m, _, _ in seen] == ["closest", "any_dest"]
    for mode, args, opts in seen:
        if mode == "closest":
            visits, pairs = walkcount.closest(*args[:4], opts)
            _, want = walk._walk_closest_plain(*args, **opts)
            want_pairs = int(want.sum()) * 512 * 128
        else:
            visits, pairs = walkcount.occlusion(mode, *args[:5], opts)
            _, want, want_pairs = walk._occlusion_plain(
                mode, *args, *(opts.get(k) for k in ("hull", "bbox",
                                                      "first")), opts["S"])
        assert torch.equal(visits, want)
        assert pairs == int(want_pairs) and pairs > 0


def test_flat_walks():
    _check(_walks(0))


def test_two_level_walks(monkeypatch):
    from ceres_tpu_torch.ops import prepass

    # Two-level from a few hundred blocks up, so that a small scene walks
    # the two-level form (the 4x bunny's 19,872 blocks do so as built).
    monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 256)
    seen = _walks(2)
    assert all(opts["S"] > 1 for _, _, opts in seen)
    _check(seen)

"""The plain reference renderer against an all-pairs search in float64
on tiny scenes, and against the port's frame at 64 x 48."""

from __future__ import annotations

import numpy as np
import torch

from conftest import ROOT
from raybench import reference, scene


def _brute(origin, dirs, tri, tmax):
    """Closest t and triangle (float64, all pairs), -1 where none."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(dirs, np.float64)[:, None, :]
    p0, p1, p2 = (np.asarray(tri, np.float64)[None, :, k] for k in range(3))
    e1, e2 = p0 - p1, p2 - p0
    n = np.cross(e1, e2)
    c = p0 - o
    r = np.cross(d, c)
    det = (n * d).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (r * e2).sum(-1) / det
        v = (r * e1).sum(-1) / det
        t = (n * c).sum(-1) / det
    ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0) & \
        (t <= tmax)
    t = np.where(ok, t, np.inf)
    best = t.argmin(1)
    return np.where(np.isfinite(t.min(1)), best, -1), ok.any(1)


def _scene(seed=0, n=40):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (n, 3)) * [1, 1, 0.5] + [0, 0, 4]
    tri = centers[:, None, :] + rng.normal(0, 0.4, (n, 3, 3))
    v = tri.reshape(-1, 3).astype(np.float32)
    f = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    return v, f


def test_closest_matches_all_pairs():
    v, f = _scene()
    rng = np.random.default_rng(1)
    dirs = rng.normal(0, 0.25, (4000, 3)) * [1, 1, 0] + [0, 0, 1]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    got = reference.closest(torch.zeros(3), torch.as_tensor(dirs,
                                                            dtype=torch.float32),
                            torch.as_tensor(v), torch.as_tensor(f)).numpy()
    want, _ = _brute(np.zeros(3), dirs, v[f], np.inf)
    assert (got >= 0).sum() > 500
    assert (got != want).mean() < 2e-3


def test_occluded_matches_all_pairs():
    v, f = _scene(2)
    rng = np.random.default_rng(3)
    sun = np.array([0.3, -0.2, -20.0], np.float32)
    points = rng.uniform(-1.5, 1.5, (4000, 3)).astype(np.float32) + [0, 0, 6]
    live = torch.as_tensor(rng.uniform(size=4000) < 0.8)
    got = reference.occluded(torch.as_tensor(sun), torch.as_tensor(points),
                             live, torch.as_tensor(v),
                             torch.as_tensor(f)).numpy()
    _, want = _brute(sun, points - sun, v[f], reference.SEGMENT_END)
    want &= live.numpy()
    assert want.sum() > 300
    assert (got != want).mean() < 2e-3


def test_frame_matches_the_port_at_64x48():
    import ceres_tpu_torch as ct

    cfg = {"mesh": "raybench/scenes/bunny.obj", "eye": [0.0, 0.1, -0.3],
           "look_at": "centroid", "up": [0, 1, 0], "fov": 60.0}
    v, f = scene.mesh(cfg, ROOT)
    cam = scene.camera(cfg, v)
    vt, ft = torch.as_tensor(v), torch.as_tensor(f)
    sun = torch.tensor([-50.0, 100.0, 0.0])
    camera = ct.Camera.make(cam["eye"], cam["dir"], cam["up"], cam["fov"])
    config = ct.RenderConfig(width=64, height=48, backend="megakernel")
    img, st = ct.render_pipeline(vt, ft, camera, sun, config)
    ref_img, ref_st = reference.frame(vt, ft.long(),
                                      torch.as_tensor(cam["eye"]), cam, sun,
                                      64, 48)
    assert ref_st == {"rays": int(st["rays"]), "hits": int(st["hits"])}
    assert float((img - ref_img).abs().max()) < 1e-4


def test_gradients_follow_the_port():
    """The reference's loss gradients w.r.t. vertices and eye equal the
    port's autograd gradients of the same frame."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.diff import inverse

    cfg = {"mesh": "raybench/scenes/bunny.obj", "eye": [0.0, 0.1, -0.3],
           "look_at": "centroid", "up": [0, 1, 0], "fov": 60.0}
    v, f = scene.mesh(cfg, ROOT)
    cam = scene.camera(cfg, v)
    vt, ft = torch.as_tensor(v), torch.as_tensor(f)
    sun = torch.tensor([-50.0, 100.0, 0.0])
    target = reference.frame(vt, ft.long(), torch.as_tensor(cam["eye"]), cam,
                             sun, 48, 40)[0]
    moved = scene.noise_pool(vt, 0.002, 1, 9)[0]
    grads = []
    for side in ("port", "reference"):
        p = {"vertices": moved.clone().requires_grad_(),
             "eye": torch.as_tensor(cam["eye"]).clone().requires_grad_()}
        if side == "port":
            camera = ct.Camera.make(cam["eye"], cam["dir"], cam["up"],
                                    cam["fov"])
            camera = ct.Camera(eye=p["eye"], dir=camera.dir, up=camera.up,
                               fov=camera.fov)
            config = ct.RenderConfig(width=48, height=40,
                                     backend="megakernel")
            img, _ = ct.render_pipeline(p["vertices"], ft, camera, sun,
                                        config)
            loss = inverse.image_loss(img, target)
        else:
            img, _ = reference.frame(p["vertices"], ft.long(), p["eye"],
                                     cam, sun, 48, 40)
            loss = reference.loss(img, target)
        loss.backward()
        grads.append({k: x.grad for k, x in p.items()})
    for k in grads[0]:
        a, b = grads[0][k], grads[1][k]
        assert float(b.norm()) > 0
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())

"""Frame batches on one device (``parallel.sharded``) against the JAX
package and against the port's own single-frame render, on the CPU.

  * ``turntable_transforms``: the stacked track within rtol 1e-6 of the
    JAX package's (float32 and float64), frames sliced alike;
  * ``tiling.pad_hw``/``swizzle``/``unswizzle``: equal to the JAX
    package's;
  * a frame batch: frame k equals ``render_pipeline`` with frame k's
    camera and sun under the image rule (fewer than 0.5% of pixels off by
    more than 1e-4: the batch's rows normalise their rays by a division,
    the column pipeline by rsqrt) with rays and hits exactly, and equals
    the JAX package's batch on a one-device mesh under the same rule;
  * ``render_sharded`` equals ``render()`` on both backends;
  * ``render_deforming_frames``: the refitted cut renders the rebuilt
    cut's frames, and the JAX package's;
  * the soup, cut and winner table are built once a batch; the cut is
    built once and refitted for deforming frames;
  * a process drives one device: several are refused, naming the way
    to more (a rank per device); primitive sharding renders on one rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.parallel import sharded as jsh
from ceres_tpu.utils import tiling as jtiling

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel import clusters as pcl
from ceres_tpu_torch.models.transform import Transform
from ceres_tpu_torch.parallel import sharded as psh
from ceres_tpu_torch.utils import convert, tiling

torch.set_num_threads(1)
SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)
W, H = 40, 48            # neither a multiple of the 32 x 32 pixel block
CONFIG = dict(width=W, height=H, backend="megakernel")


def _camera(verts):
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    return JaxCamera.make(eye=eye, dir=verts.mean(0) - eye, up=(0, 1, 0),
                          fov=60.0)


def _image_rule(got, want, got_stats, want_stats, exact_counts=True):
    got, want = np.asarray(got), np.asarray(want)
    off = np.abs(got - want).max(-1) > 1e-4
    assert off.mean() < 0.005, off.sum()
    keys = ("rays", "hits", "primary_hits", "shadow_hits")
    g = {k: int(got_stats[k]) for k in keys}
    w = {k: int(want_stats[k]) for k in keys}
    if exact_counts:
        assert g == w
    else:
        assert g["rays"] == w["rays"]
        assert abs(g["hits"] - w["hits"]) <= 0.002 * w["hits"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_turntable_transforms_match_jax(dtype):
    with jax.enable_x64(dtype == "float64"):
        ref = jsh.turntable_transforms(7, axis=(0.3, 1.0, 0.2),
                                       dtype=getattr(jnp, dtype))
        ref = jax.tree.map(np.asarray, ref)
    got = psh.turntable_transforms(7, axis=(0.3, 1.0, 0.2),
                                   dtype=getattr(torch, dtype))
    assert got.num_frames == 7 and got.a.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.a.numpy(), ref.a, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.v.numpy(), ref.v, rtol=1e-6, atol=1e-7)
    conv = convert.transform(ref)
    assert conv.num_frames == 7
    sl = conv.frame(slice(2, 5))
    np.testing.assert_array_equal(sl.a.numpy(), ref.a[2:5])
    # A stack applies frame by frame, each frame as one transform does.
    p = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (5, 3)), dtype=getattr(torch, dtype))
    out = got(p)
    assert out.shape == (7, 5, 3)
    for k in (0, 3, 6):
        torch.testing.assert_close(out[k], got.frame(k)(p), rtol=0, atol=0)


def test_tiling_row_forms_match_jax():
    x = np.random.default_rng(1).standard_normal((45, 70, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tiling.pad_hw(torch.as_tensor(x)).numpy(),
                                  np.asarray(jtiling.pad_hw(jnp.asarray(x))))
    sw = tiling.swizzle(torch.as_tensor(x))
    np.testing.assert_array_equal(sw.numpy(),
                                  np.asarray(jtiling.swizzle(jnp.asarray(x))))
    np.testing.assert_array_equal(tiling.unswizzle(sw, 45, 70).numpy(), x)


@pytest.fixture(scope="module")
def batch(bunny):
    """Three turntable frames of the bunny through the port's batch and
    the JAX package's on a one-device mesh."""
    verts, faces = bunny
    cam = _camera(verts)
    tracks = psh.turntable_transforms(3)
    frames, stats = psh.render_frames_sharded(
        verts, faces, convert.camera(cam), SUN, tracks, device="cpu",
        **CONFIG)
    jframes, jstats = jsh.render_frames_sharded(
        verts, faces, cam, SUN, jsh.turntable_transforms(3),
        mesh=jsh.device_mesh(devices=jax.devices()[:1]), **CONFIG)
    return verts, faces, cam, tracks, frames, stats, np.asarray(jframes), \
        jstats


def test_frame_batch_frames_equal_render_pipeline(batch):
    verts, faces, cam, tracks, frames, stats, _, _ = batch
    assert frames.shape == (3, H, W, 3)
    config = ct.RenderConfig(**CONFIG)
    total = {}
    for k in range(3):
        tf = tracks.frame(k)
        c = convert.camera(cam)
        cam_k = ct.Camera(eye=tf(c.eye), dir=tf.a @ c.dir, up=c.up, fov=c.fov)
        img, st = ct.render_pipeline(torch.as_tensor(verts),
                                     torch.as_tensor(faces), cam_k,
                                     tf(torch.as_tensor(SUN)), config)
        one, one_st = psh.render_frames_sharded(
            verts, faces, convert.camera(cam), SUN, tracks.frame(slice(k,
                                                                      k + 1)),
            device="cpu", **CONFIG)
        torch.testing.assert_close(one[0], frames[k], rtol=0, atol=0)
        _image_rule(frames[k], img, one_st, st)
        total = {key: total.get(key, 0) + int(v) for key, v in st.items()}
    assert {k: int(v) for k, v in stats.items()} == total
    assert float(frames[1].max()) > 0


def test_frame_batch_equals_jax(batch):
    _, _, _, _, frames, stats, jframes, jstats = batch
    for k in range(3):
        assert (np.abs(frames[k].numpy() - jframes[k]).max(-1)
                > 1e-4).mean() < 0.005
    _image_rule(frames[0], jframes[0], stats, jstats, exact_counts=False)


def test_render_sharded_equals_render(bunny):
    verts, faces = bunny
    cam = _camera(verts)
    img, st = psh.render_sharded(verts, faces, convert.camera(cam), SUN,
                                 device="cpu", **CONFIG)
    ref, rst = ct.render(verts, faces, convert.camera(cam), SUN, device="cpu",
                         **CONFIG)
    assert img.shape == (H, W, 3)
    _image_rule(img, ref, st, rst)
    bimg, bst = psh.render_sharded(verts, faces, convert.camera(cam), SUN,
                                   mesh=psh.device_mesh(devices=["cpu"]),
                                   **dict(CONFIG, backend="bruteforce"))
    _image_rule(bimg, ref, bst, rst, exact_counts=False)


def _wobble(verts, n):
    """n frames of the bunny with a seeded vertex wobble growing by frame."""
    rng = np.random.default_rng(4)
    scale = float(np.abs(verts - verts.mean(0)).max())
    return np.stack([verts + (0.01 * k * scale * rng.standard_normal(
        verts.shape)).astype(np.float32) for k in range(n)])


def test_deforming_frames_refit_equals_rebuild(bunny):
    verts, faces = bunny
    cam = _camera(verts)
    vf = _wobble(verts, 3)
    refit, rst = psh.render_deforming_frames(vf, faces, convert.camera(cam),
                                             SUN, device="cpu", **CONFIG)
    rebuilt, bst = psh.render_deforming_frames(
        vf, faces, convert.camera(cam), SUN, refit=False, device="cpu",
        **CONFIG)
    assert refit.shape == (3, H, W, 3)
    for k in range(3):
        assert (torch.abs(refit[k] - rebuilt[k]).amax(-1)
                > 1e-4).float().mean() < 0.005
    assert int(rst["rays"]) == int(bst["rays"])
    jframes, jst = jsh.render_deforming_frames(
        vf, faces, cam, SUN, mesh=jsh.device_mesh(devices=jax.devices()[:1]),
        **CONFIG)
    jframes = np.asarray(jframes)
    for k in range(3):
        assert (np.abs(refit[k].numpy() - jframes[k]).max(-1)
                > 1e-4).mean() < 0.005
    assert int(rst["rays"]) == int(jst["rays"])
    with pytest.raises(ValueError, match="megakernel"):
        psh.render_deforming_frames(vf, faces, convert.camera(cam), SUN,
                                    device="cpu",
                                    **dict(CONFIG, backend="bruteforce"))


def test_cut_built_once_a_batch(bunny, monkeypatch):
    verts, faces = bunny
    cam = convert.camera(_camera(verts))
    calls = {"build": 0, "refit": 0, "table": 0}
    for name, mod, key in (("build_clusters_treelet", pcl, "build"),
                           ("refit_clusters", pcl, "refit"),
                           ("prepare_winner_table", psh, "table")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    small = dict(CONFIG, width=16, height=16)
    psh.render_frames_sharded(verts, faces, cam, SUN,
                              psh.turntable_transforms(3), device="cpu",
                              **small)
    assert calls == {"build": 1, "refit": 0, "table": 1}
    psh.render_deforming_frames(_wobble(verts, 3), faces, cam, SUN,
                                device="cpu", **small)
    assert calls == {"build": 2, "refit": 3, "table": 1}


def test_multi_device_names_its_roadmap_item(bunny):
    # Several devices in one process are refused, with the way to more:
    # one rank per device (tests/test_torch_distributed.py runs them).
    # Primitive sharding renders on one rank, as the JAX package's does
    # on one device, within the primitive-sharding rule of
    # tests/test_primitive_sharded.py.
    verts, faces = bunny
    with pytest.raises(ValueError, match="one rank per device"):
        psh.device_mesh(devices=["cpu", "cpu"])
    cam = convert.camera(_camera(verts))
    img, st = psh.render_primitive_sharded(verts, faces, cam, SUN,
                                           device="cpu", **CONFIG)
    ref, rst = ct.render(verts, faces, cam, SUN, device="cpu", **CONFIG)
    assert (torch.abs(img - ref).amax(-1) > 2e-3).float().mean() <= 0.01
    assert abs(int(st["primary_hits"]) - int(rst["primary_hits"])) \
        <= 0.01 * W * H
    assert int(st["rays"]) == int(rst["rays"]) and float(img.max()) > 0
    mesh = psh.device_mesh(devices=["cpu"])
    assert mesh.shape == {"frames": 1, "rays": 1}
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="divisible"):
        psh.device_mesh(num_frames_axis=2, devices=["cpu"])


def test_transform_single_frame_unchanged():
    # One transform applies as a @ p + v; a one-frame stack is F = 1.
    t = Transform.identity().rotate((0.0, 1.0, 0.0), 0.5).translate(
        (1.0, 2.0, 3.0))
    p = torch.as_tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 2.0]])
    assert t.num_frames is None
    torch.testing.assert_close(t(p), p @ t.a.T + t.v, rtol=0, atol=0)
    stack = Transform(a=t.a[None], v=t.v[None])
    torch.testing.assert_close(stack(p)[0], t(p), rtol=0, atol=0)

"""The reference-exact path against the C++ reference and the JAX package:
``reference_compat``, the brute-force oracle (``ops.intersect``,
``backend="bruteforce"``), the flat/normal modes and the scene presets.

  * Against the C++ reference binary: the port's compat renders of
    ``bunny_scene()`` and ``dragon_scene()`` at 64 x 64, on both
    backends, against ``tests/fixtures/bunny_64_smooth_ref.ppm`` and
    ``dragon_64_static_ref.ppm``: >= 99.5% of pixels within 2.5/255 (u8
    quantisation plus f32 rounding), and the rays/hits the binary
    printed (4645/804, 4415/492) exactly.
  * Against the JAX package: compat and flat/normal renders on the same
    structure, by the per-ray rule of ``tests/test_torch_render.py``
    (winners and shadows agree on all but 0.1% of the pixels, and where
    they agree the colours within 1e-5; the scene centre of the generic
    shadow rays is a mean that torch and XLA sum in different orders).
  * ``ops.intersect`` against the JAX package's at float32 (matrix
    products in another summation order: 1e-6 relative), winners where
    both hit.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel.cuts import build_clusters_quality as jax_quality
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import intersect as jmt
from ceres_tpu.render import renderer as jrenderer
from ceres_tpu.render import scenes as jscenes

import ceres_tpu_torch as ct
from ceres_tpu_torch.ops import intersect as pmt
from ceres_tpu_torch.render import renderer as prenderer
from ceres_tpu_torch.render import scenes as pscenes
from ceres_tpu_torch.utils import convert

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
# Rays and hits the C++ reference printed for each fixture.
CPP = {"bunny": ("bunny_64_smooth_ref.ppm", 4645, 804),
       "dragon": ("dragon_64_static_ref.ppm", 4415, 492)}


def _read_ppm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        assert f.readline().strip() == b"255"
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(h, w, 3)


def _scene(name):
    return pscenes.bunny_scene() if name == "bunny" else pscenes.dragon_scene()


@pytest.mark.parametrize("backend", ["megakernel", "bruteforce"])
@pytest.mark.parametrize("name", ["bunny", "dragon"])
def test_compat_matches_cpp_reference(name, backend):
    ppm, rays, hits = CPP[name]
    ref = _read_ppm(os.path.join(FIXTURES, ppm)).astype(np.float64) / 255.0
    sc = _scene(name)
    img, stats = ct.render(sc.vertices, sc.faces, sc.camera, sc.sun, width=64,
                           height=64, backend=backend, reference_compat=True,
                           device="cpu")
    diff = np.abs(img.numpy() - ref).max(axis=-1)
    assert (diff <= 2.5 / 255.0).mean() >= 0.995, (
        f"max diff {diff.max():.4f}, "
        f"{(diff > 2.5 / 255.0).mean():.4%} pixels off")
    assert int(stats["rays"]) == rays
    assert int(stats["hits"]) == hits


def test_scene_presets_match_jax():
    for name in ("bunny", "dragon"):
        got = _scene(name)
        ref = (jscenes.bunny_scene() if name == "bunny"
               else jscenes.dragon_scene())
        np.testing.assert_array_equal(got.faces, ref.faces)
        # A rotation: cos/sin and a 3-term product, to f32 rounding.
        np.testing.assert_allclose(got.vertices, ref.vertices, rtol=0,
                                   atol=2e-6 * np.abs(ref.vertices).max())
        for f in ("eye", "dir", "up", "fov"):
            np.testing.assert_allclose(getattr(got.camera, f).numpy(),
                                       np.asarray(getattr(ref.camera, f)),
                                       rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got.sun, ref.sun)


def test_default_backend_is_the_oracle():
    assert ct.RenderConfig().backend == jrenderer.RenderConfig().backend
    assert ct.RenderConfig().backend == "bruteforce"
    with pytest.raises(ValueError, match="backend"):
        prenderer._check_config(ct.RenderConfig(backend="wat"))
    with pytest.raises(ValueError, match="shading mode"):
        prenderer._check_config(ct.RenderConfig(mode="wat"))


def _jax_render(sc, cs, **cfg):
    config = jrenderer.RenderConfig(width=48, height=48, **cfg)
    img, st = jrenderer.render_pipeline(
        jnp.asarray(sc.vertices), jnp.asarray(sc.faces),
        jscenes.Camera.make(*(np.asarray(getattr(sc.camera, f)) for f in
                              ("eye", "dir", "up", "fov"))),
        jnp.asarray(sc.sun), config, clusters=cs)
    return np.asarray(img), {k: int(v) for k, v in st.items()}


def _port_render(sc, cs, **cfg):
    img, st = ct.render_pipeline(
        torch.as_tensor(sc.vertices), torch.as_tensor(sc.faces), sc.camera,
        torch.as_tensor(sc.sun), ct.RenderConfig(width=48, height=48, **cfg),
        clusters=None if cs is None else convert.cluster_set(cs))
    return img.numpy(), {k: int(v) for k, v in st.items()}


@pytest.fixture(scope="module")
def bunny_compat():
    """The bunny preset with the JAX package's SweepSAH cut of it."""
    sc = pscenes.bunny_scene()
    cs = jax_quality(jax_soup(jnp.asarray(sc.vertices), jnp.asarray(sc.faces),
                              with_normals=False))
    return sc, cs


@pytest.mark.parametrize("cfg", [
    dict(backend="megakernel", reference_compat=True),
    dict(backend="bruteforce", reference_compat=True),
    dict(backend="megakernel", mode="flat"),
    dict(backend="bruteforce", mode="flat"),
    dict(backend="megakernel", mode="normal", reference_compat=True),
    dict(backend="bruteforce", mode="normal"),
], ids=lambda c: "-".join(str(v) for v in c.values()))
def test_render_matches_jax(bunny_compat, cfg):
    sc, cs = bunny_compat
    cs = cs if cfg["backend"] == "megakernel" else None
    jimg, jst = _jax_render(sc, cs, traversal_stats=True, **cfg)
    pimg, pst = _port_render(sc, cs, traversal_stats=True, **cfg)
    budget = 0.001 * 48 * 48
    assert pst["rays"] == pst["primary_hits"] + 48 * 48
    for k in ("primary_hits", "shadow_hits"):
        assert abs(pst[k] - jst[k]) <= budget, (k, pst[k], jst[k])
    if cfg["backend"] == "bruteforce":
        assert pst["traversal_steps"] == 0
        assert pst["intersections"] == jst["intersections"]
    else:
        assert abs(pst["traversal_steps"] - jst["traversal_steps"]) <= (
            0.01 * jst["traversal_steps"])
    off = np.abs(pimg - jimg).max(-1) > 1e-5
    assert off.sum() <= 2 * budget, off.sum()
    assert jimg.max() > 0
    if cfg.get("mode") == "normal":
        assert pst["shadow_hits"] == 0


def test_flat_modes_ignore_compat_without_shadows():
    # With flat shading and no shadows, neither the hit point nor the
    # Gouraud weights are used: compat and default agree exactly.
    sc = pscenes.bunny_scene()
    imgs = [ct.render(sc.vertices, sc.faces, sc.camera, sc.sun, width=32,
                      height=32, mode="flat", shadows=False,
                      reference_compat=compat, device="cpu")[0]
            for compat in (False, True)]
    assert torch.equal(imgs[0], imgs[1]) and imgs[0].max() > 0


# ---------------------------------------------------------------------------
# ops.intersect
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(41)
    verts = rng.standard_normal((120, 3)).astype(np.float32)
    faces = rng.integers(0, 120, (300, 3)).astype(np.int32)
    R = 700
    o = (rng.standard_normal((R, 3)) * 0.2
         + np.asarray([0.0, 0.0, -3.0])).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = rng.uniform(0.0, 2.0, R).astype(np.float32)
    tmax = tmin + rng.uniform(0.5, 4.0, R).astype(np.float32)
    jsoup = jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                     with_normals=False)
    psoup = ct.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                             with_normals=False)
    shift = np.asarray(verts.mean(axis=0), np.float32)
    return dict(jsoup=jsoup, psoup=psoup, o=o, d=d, tmin=tmin, tmax=tmax,
                shift=shift, eye=np.asarray([0.0, 0.0, -3.0], np.float32))


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_features_and_weights_match_jax(pairs):
    p = pairs
    _close(pmt.ray_features(torch.as_tensor(p["o"]), torch.as_tensor(p["d"])),
           jmt.ray_features(jnp.asarray(p["o"]), jnp.asarray(p["d"])))
    _close(pmt.ray_features_common_origin(torch.as_tensor(p["d"])),
           jmt.ray_features_common_origin(jnp.asarray(p["d"])))
    _close(pmt.triangle_weights(p["psoup"], torch.as_tensor(p["shift"])),
           jmt.triangle_weights(p["jsoup"], jnp.asarray(p["shift"])))
    _close(pmt.triangle_weights(p["psoup"]), jmt.triangle_weights(p["jsoup"]))
    _close(pmt.triangle_weights_common_origin(p["psoup"],
                                              torch.as_tensor(p["eye"])),
           jmt.triangle_weights_common_origin(p["jsoup"],
                                              jnp.asarray(p["eye"])))


def test_numerators_and_decode_match_jax(pairs):
    p = pairs
    w = pmt.triangle_weights(p["psoup"], torch.as_tensor(p["shift"]))
    f = pmt.ray_features(torch.as_tensor(p["o"] - p["shift"]),
                         torch.as_tensor(p["d"]))
    num = pmt.mt_numerators(f, w)
    jnum = jmt.mt_numerators(
        jmt.ray_features(jnp.asarray(p["o"] - p["shift"]), jnp.asarray(p["d"])),
        jmt.triangle_weights(p["jsoup"], jnp.asarray(p["shift"])))
    assert tuple(num.shape) == (700, 300, 4)
    scale = np.abs(np.asarray(jnum)).max()
    _close(num, jnum, rtol=0, atol=1e-6 * scale)
    # decode on the same numerators: elementwise, exact up to the divide.
    t, u, v, acc = pmt.decode_hits(torch.as_tensor(np.array(jnum)), 0.0,
                                   float("inf"))
    jt, ju, jv, jacc = jmt.decode_hits(jnum, 0.0, jnp.inf)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    for a, b in ((t, jt), (u, ju), (v, jv)):
        _close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk", [2048, 96])
def test_bruteforce_matches_jax(pairs, chunk):
    p = pairs
    pw = pmt.triangle_weights_common_origin(p["psoup"],
                                            torch.as_tensor(p["eye"]))
    jw = jmt.triangle_weights_common_origin(p["jsoup"], jnp.asarray(p["eye"]))
    pf = pmt.ray_features_common_origin(torch.as_tensor(p["d"]))
    jf = jmt.ray_features_common_origin(jnp.asarray(p["d"]))
    for win in ({}, {"tmin": p["tmin"], "tmax": p["tmax"]}):
        got = pmt.closest_hit_bruteforce(
            pf, pw, chunk=chunk, **{k: torch.as_tensor(x)
                                    for k, x in win.items()})
        ref = jmt.closest_hit_bruteforce(
            jf, jw, **{k: jnp.asarray(x)[:, None] for k, x in win.items()})
        mask, jmask = got.mask.numpy(), np.asarray(ref.mask)
        assert mask.sum() > 50
        assert (mask == jmask).mean() >= 0.995
        both = mask & jmask
        assert (got.prim_id.numpy()[both]
                == np.asarray(ref.prim_id)[both]).mean() >= 0.99
        _close(got.t.numpy()[both], np.asarray(ref.t)[both], rtol=1e-5,
               atol=1e-6)
        assert np.isinf(got.t.numpy()[~mask]).all()
    pg = pmt.ray_features(torch.as_tensor(p["o"] - p["shift"]),
                          torch.as_tensor(p["d"]))
    jg = jmt.ray_features(jnp.asarray(p["o"] - p["shift"]), jnp.asarray(p["d"]))
    occ = pmt.any_hit_bruteforce(
        pg, pmt.triangle_weights(p["psoup"], torch.as_tensor(p["shift"])),
        chunk=chunk).numpy()
    jocc = np.asarray(jmt.any_hit_bruteforce(
        jg, jmt.triangle_weights(p["jsoup"], jnp.asarray(p["shift"]))))
    assert 0 < occ.sum() < len(occ)
    assert (occ == jocc).mean() >= 0.995


def test_bruteforce_runs_in_full_float32(pairs, monkeypatch):
    # The caller's matmul precision must not reach the oracle's product
    # (TF32 on the card, bf16 passes on the CPU), and is restored after.
    seen = []
    matmul = torch.matmul

    def spy(*args):
        seen.append(torch.get_float32_matmul_precision())
        return matmul(*args)

    monkeypatch.setattr(torch, "matmul", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        p = pairs
        pmt.any_hit_bruteforce(
            pmt.ray_features(torch.as_tensor(p["o"]), torch.as_tensor(p["d"])),
            pmt.triangle_weights(p["psoup"]))
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}

"""The port over several processes (``parallel.distributed``,
``parallel.sharded`` on a mesh of ranks, the train step and the CLIs
over ranks) against the JAX package on a slice of the 8 virtual devices,
on the CPU.

Ranks are gloo processes spawned by ``distributed.run_ranks``, once per
module for 2 ranks and once for 4: each spawn runs every path
(``parallel.selfcheck.run``), and the cases below compare what it
returned. The JAX side runs jitted on the same seeded inputs (numpy).
Tolerances, those of ROADMAP's comparison rules:

  * images: fewer than 0.5% of pixels off by more than 1e-4; stats
    exactly;
  * primitive sharding: at most 1% of pixels off by more than 2e-3 and
    primary hits within 1% (``tests/test_primitive_sharded.py``);
  * gradients: pixels whose colour differs between the packages leave
    the loss (at most 0.5%), then rtol 1e-4, atol 1e-5 of the largest
    |g|; fit losses rtol 1e-4 (``tests/test_torch_train.py``);
  * across ranks, and a resumed fit against one run straight through:
    bit-equal.

Two counts of the JAX package exceed its single-device render, and the
port counts each pixel once instead (ROADMAP queue 3): rows past the
image when the rows do not divide over "rays", and every frame index of
a ("frames", "rays") mesh in ``render_sharded``. Those cases hold the
port to the JAX single-device stats and assert the JAX excess.
"""

import concurrent.futures
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.diff import inverse as jinv
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.parallel import sharded as jsh
from ceres_tpu.render import renderer as jrenderer

from ceres_tpu_torch.cli import anim, render
from ceres_tpu_torch.parallel import distributed, dryrun, selfcheck
from ceres_tpu_torch.parallel import sharded as psh
from ceres_tpu_torch.render.renderer import RenderConfig
from ceres_tpu_torch.utils import convert

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(ROOT, "data", "bunny.obj")
W, H = 40, 48
EYE = np.asarray([0.0, 0.1, -0.3], np.float32)
SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)
SPAWN_TIMEOUT = 600.0
# render_sharded cases: name -> (config fields, ranks, frames axis).
SHARDED = {
    "bf-smooth": (dict(backend="bruteforce"), 2, 1),
    "bf-flat": (dict(backend="bruteforce", mode="flat"), 2, 1),
    "mk-smooth": (dict(backend="megakernel"), 2, 1),
    "mk-flat": (dict(backend="megakernel", mode="flat"), 2, 1),
    # 50 rows over 4 ranks: 13 each, the last renders 11.
    "rows-past": (dict(backend="megakernel", height=50), 4, 1),
    # Frames 2 x rays 2: two frame indices render each row.
    "frames-axis": (dict(backend="megakernel"), 4, 2),
    # 9 rows over 4 ranks: 3 each, so the last has none.
    "empty-rank": (dict(backend="bruteforce", width=16, height=9), 4, 1),
    # The scene's spheres, replicated: they take rays from the bunny,
    # lose others to it, and shadow it.
    "bf-spheres": (dict(backend="bruteforce", spheres=True), 2, 1),
    "mk-spheres": (dict(backend="megakernel", spheres=True), 2, 1),
    "mk-normal": (dict(backend="megakernel", mode="normal"), 2, 1),
}
PRIMITIVE = {
    "bf-smooth": (dict(backend="bruteforce"), 2),
    "mk-smooth": (dict(backend="megakernel"), 2),
    "bf-flat-noshadow": (dict(backend="bruteforce", mode="flat",
                              shadows=False), 2),
    "mk-smooth-4": (dict(backend="megakernel"), 4),
    "bf-spheres": (dict(backend="bruteforce", spheres=True), 2),
    "mk-spheres": (dict(backend="megakernel", spheres=True), 2),
    "mk-normal": (dict(backend="megakernel", mode="normal"), 2),
}
SMALL = ["--width", "48", "--height", "32"]
ANIM = ["--frames", "3", "--width", "32", "--height", "48"]
CLI = {"render-sharded": (render, ["--sharded"], ".png"),
       "render-primitive": (render, ["--primitive-sharded"], ".ppm"),
       "anim": (anim, [], ".gif")}


def _cli_argv(name, out_dir):
    app, flags, ext = CLI[name]
    if app is anim:
        return [BUNNY, "-o", os.path.join(out_dir, f"{name}{ext}"), *ANIM,
                "--save-frames", os.path.join(out_dir, "frames")]
    return [BUNNY, "-o", os.path.join(out_dir, f"{name}{ext}"), *SMALL,
            *flags]


def _config(fields):
    """RenderConfig fields of a case (``spheres`` is the scene's)."""
    return {"width": W, "height": H,
            **{k: v for k, v in fields.items() if k != "spheres"}}


def _spheres(s, fields, wrap=jnp.asarray):
    """The scene's spheres where the case asks for them, else None."""
    if not fields.get("spheres"):
        return None
    return tuple(wrap(x) for x in s["numpy"]["spheres"])


def _jax_mesh(n, nf=1):
    return jsh.device_mesh(nf, devices=jax.devices()[:n])


def _image_rule(got, want, tol=1e-4, share=0.005):
    off = np.abs(np.asarray(got) - np.asarray(want)).max(-1) > tol
    assert off.mean() < share, int(off.sum())


def _stats(st):
    return {k: int(st[k]) for k in ("rays", "hits", "primary_hits",
                                    "shadow_hits")}


def _grad_rule(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-5 * scale)


@pytest.fixture(scope="module")
def scene(bunny):
    verts, faces = bunny
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    jcam = JaxCamera.make(eye=EYE, dir=verts.mean(0) - EYE, up=(0, 1, 0),
                          fov=60.0)
    rng = np.random.default_rng(10)
    scale = float(np.abs(verts - verts.mean(0)).max())
    # Three spheres about the bunny: one in front of it, one toward the
    # sun that shadows it, one mostly behind it.
    c = verts.mean(0)
    to_sun = (SUN - c) / np.linalg.norm(SUN - c)
    spheres = (np.stack([c + [-0.03, 0.0, -0.06], c + 0.08 * to_sun,
                         c + [0.05, -0.02, 0.03]]).astype(np.float32),
               np.asarray([0.025, 0.02, 0.04], np.float32))
    return {"vertices": verts, "faces": faces, "jcam": jcam,
            "cam": convert.camera(jcam),
            "numpy": dict(vertices=verts, faces=faces, eye=EYE,
                          dir=np.asarray(jcam.dir), up=np.asarray(jcam.up),
                          fov=float(jcam.fov), sun=SUN, spheres=spheres),
            "weights": rng.uniform(size=(H, W, 3)).astype(np.float32),
            "wobble": np.stack([verts, verts + (0.01 * scale) * rng.normal(
                size=verts.shape).astype(np.float32)]),
            "noisy": verts + (0.02 * scale) * rng.normal(
                size=verts.shape).astype(np.float32)}


def _jax_sharded_fn(s, fields, mesh):
    cfg = jrenderer.RenderConfig(**_config(fields))
    faces = jnp.asarray(s["faces"])
    spheres = _spheres(s, fields)

    def image(v, eye):
        cam = JaxCamera(eye=eye, dir=s["jcam"].dir, up=s["jcam"].up,
                        fov=s["jcam"].fov)
        return jsh._render_sharded_jit(v, faces, cam, jnp.asarray(SUN), cfg,
                                       mesh, spheres)

    return image


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """The 2- and 4-rank spawns, started together in the background, and
    the JAX references computed meanwhile: {"jax": ..., "one": port one
    rank, 2: rank results, 4: rank results, "dirs": CLI outputs}."""
    s = scene
    jax_ref, one = {}, {}
    # The gradient cases first: their loss leaves out the pixels whose
    # colour differs between the packages, which the spawns need.
    masks = {}
    for n, nf in ((2, 1), (4, 2)):
        fn = jax.jit(_jax_sharded_fn(s, dict(backend="megakernel"),
                                     _jax_mesh(n, nf)))
        jimg = np.asarray(fn(jnp.asarray(s["vertices"]),
                             jnp.asarray(EYE))[0])
        pimg, _ = psh.render_sharded(s["vertices"], s["faces"], s["cam"],
                                     SUN, RenderConfig(**_config(dict(
                                         backend="megakernel"))),
                                     device="cpu")
        agree = np.abs(jimg - pimg.numpy()).max(-1) <= 1e-4
        assert agree.mean() >= 0.995
        masks[n] = (s["weights"] * agree[..., None]).astype(np.float32)

        def jloss(v, eye, fn=_jax_sharded_fn(s, dict(backend="megakernel"),
                                             _jax_mesh(n, nf)),
                  w=masks[n]):
            return jnp.sum(fn(v, eye)[0] * w)

        jl, (gv, ge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            jnp.asarray(s["vertices"]), jnp.asarray(EYE))
        jax_ref[f"grads/{n}"] = {"loss": float(jl), "vertices": np.asarray(gv),
                                 "eye": np.asarray(ge)}

    target, _ = psh.render_sharded(s["vertices"], s["faces"], s["cam"], SUN,
                                   RenderConfig(**_config(dict(
                                       backend="megakernel"))), device="cpu")
    target = target.numpy()
    # The train step's target: the wobbled mesh's frame, so that the
    # step starts off it.
    moved, _ = psh.render_sharded(s["wobble"][1], s["faces"], s["cam"], SUN,
                                  RenderConfig(**_config(dict(
                                      backend="megakernel"))), device="cpu")
    moved = moved.numpy()
    dirs = {n: str(tmp_path_factory.mktemp(f"ranks{n}")) for n in (1, 2)}
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    base = dict(scene=s["numpy"], width=W, height=H)
    cases = {
        2: dict(base,
                sharded=[(k, nf, f) for k, (f, n, nf) in SHARDED.items()
                         if n == 2],
                frames=(1, 4), deforming=(1, s["wobble"]),
                primitive=[(k, f) for k, (f, n) in PRIMITIVE.items()
                           if n == 2],
                grads={"2": (1, _config(dict(backend="megakernel")),
                             masks[2])},
                train=(1, moved), fit=(s["noisy"], target, ckpt),
                cli={k: _cli_argv(k, dirs[2]) for k in CLI}),
        4: dict(base,
                sharded=[(k, nf, f) for k, (f, n, nf) in SHARDED.items()
                         if n == 4],
                frames=(2, 4), deforming=(2, s["wobble"]),
                primitive=[(k, f) for k, (f, n) in PRIMITIVE.items()
                           if n == 4],
                grads={"4": (2, _config(dict(backend="megakernel")),
                             masks[4])},
                train=(2, moved)),
    }
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(distributed.run_ranks, selfcheck.run, n,
                                  case, device="cpu", timeout=SPAWN_TIMEOUT)
                   for n, case in cases.items()}
        for k, (fields, n, nf) in SHARDED.items():
            fn = jax.jit(_jax_sharded_fn(s, fields, _jax_mesh(n, nf)))
            img, st = fn(jnp.asarray(s["vertices"]), jnp.asarray(EYE))
            jax_ref[f"sharded/{k}"] = (np.asarray(img), _stats(st))
            cfg = _config(fields)
            img1, st1 = jrenderer.render_pipeline(
                jnp.asarray(s["vertices"]), jnp.asarray(s["faces"]),
                s["jcam"], jnp.asarray(SUN), jrenderer.RenderConfig(**cfg),
                spheres=_spheres(s, fields))
            jax_ref[f"single/{k}"] = (np.asarray(img1), _stats(st1))
            pimg, pst = psh.render_sharded(
                s["vertices"], s["faces"], s["cam"], SUN,
                RenderConfig(**cfg), device="cpu",
                spheres=_spheres(s, fields, torch.as_tensor))
            one[f"sharded/{k}"] = (pimg.numpy(), _stats(pst))
        cfg = jrenderer.RenderConfig(**_config(dict(backend="megakernel")))
        img, st = jsh.render_frames_sharded(
            s["vertices"], s["faces"], s["jcam"], SUN,
            jsh.turntable_transforms(4), config=cfg, mesh=_jax_mesh(4, 2))
        jax_ref["frames"] = (np.asarray(img), _stats(st))
        img, st = jsh.render_deforming_frames(
            s["wobble"], s["faces"], s["jcam"], SUN, config=cfg,
            mesh=_jax_mesh(2))
        jax_ref["deforming"] = (np.asarray(img), _stats(st))
        for k, (fields, n) in PRIMITIVE.items():
            img, st = jsh.render_primitive_sharded(
                s["vertices"], s["faces"], s["jcam"], SUN,
                config=jrenderer.RenderConfig(**_config(fields)),
                mesh=_jax_mesh(n), spheres=_spheres(s, fields))
            jax_ref[f"primitive/{k}"] = (np.asarray(img), _stats(st))
        _, jax_ref["fit"] = jinv.fit_vertices(
            s["noisy"], s["faces"], s["jcam"], SUN, target, config=cfg,
            steps=3, learning_rate=2e-4, mesh=_jax_mesh(2))
        one["train"] = selfcheck._np(selfcheck._train_step(
            torch.as_tensor(s["vertices"]), torch.as_tensor(s["faces"]),
            s["cam"], torch.as_tensor(SUN),
            RenderConfig(**_config(dict(backend="megakernel"))),
            psh.device_mesh(devices=["cpu"]), moved))
        jimg, _ = jax.jit(_jax_sharded_fn(s, dict(backend="megakernel"),
                                          _jax_mesh(2)))(
            jnp.asarray(s["vertices"]), jnp.asarray(EYE))
        jax_ref["train_loss"] = float(jinv.image_loss(jimg,
                                                      jnp.asarray(moved)))
        for name in CLI:
            app = CLI[name][0]
            assert app.main(_cli_argv(name, dirs[1]), device="cpu") == 0
        ranks = {n: f.result() for n, f in futures.items()}
    return {"jax": jax_ref, "one": one, 2: ranks[2], 4: ranks[4],
            "dirs": dirs, "masks": masks, "target": target}


def _each_rank(results, key):
    """``key``'s result on every rank, after checking the ranks agree
    bit for bit; the first rank's."""
    first = results[0][key]
    for other in results[1:]:
        a, b = first, other[key]
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]))
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    return first


@pytest.mark.parametrize("case", [k for k, (_, n, nf) in SHARDED.items()
                                  if (n, nf) == (2, 1)])
def test_render_sharded_matches_jax(runs, case):
    n = SHARDED[case][1]
    got = _each_rank(runs[n], f"sharded/{case}")
    jimg, jst = runs["jax"][f"sharded/{case}"]
    _image_rule(got["image"], jimg)
    assert _stats(got["stats"]) == jst
    assert float(got["image"].max()) > 0


@pytest.mark.parametrize("case", list(SHARDED))
def test_render_sharded_equals_one_rank(runs, case):
    n = SHARDED[case][1]
    got = _each_rank(runs[n], f"sharded/{case}")
    img, st = runs["one"][f"sharded/{case}"]
    assert got["image"].shape == img.shape
    _image_rule(got["image"], img)
    assert _stats(got["stats"]) == st


def test_rows_past_the_image_counted_once(runs):
    # The port counts only the image's rays; the JAX package also counts
    # the 2 rows past the 50 that its last shard renders.
    got = _each_rank(runs[4], "sharded/rows-past")
    jimg, jst = runs["jax"]["sharded/rows-past"]
    simg, sst = runs["jax"]["single/rows-past"]
    _image_rule(got["image"], jimg)
    _image_rule(got["image"], simg)
    assert _stats(got["stats"]) == sst
    assert jst["rays"] >= sst["rays"] + 2 * W


def test_frames_axis_counts_each_row_once(runs):
    # On frames 2 x rays 2 each row is rendered by both frame indices:
    # the JAX package sums both into its stats, the port one.
    got = _each_rank(runs[4], "sharded/frames-axis")
    jimg, jst = runs["jax"]["sharded/frames-axis"]
    _, sst = runs["jax"]["single/frames-axis"]
    _image_rule(got["image"], jimg)
    assert _stats(got["stats"]) == sst
    assert jst == {k: 2 * v for k, v in sst.items()}


def test_frames_sharded_matches_jax(runs):
    # 4 turntable frames over frames 2 x rays 2, and over 2 ranks.
    jimg, jst = runs["jax"]["frames"]
    for n in (2, 4):
        got = _each_rank(runs[n], "frames")
        assert got["image"].shape == (4, H, W, 3)
        for k in range(4):
            _image_rule(got["image"][k], jimg[k])
        assert _stats(got["stats"]) == jst


def test_deforming_frames_match_jax(runs):
    jimg, jst = runs["jax"]["deforming"]
    for n in (2, 4):
        got = _each_rank(runs[n], "deforming")
        for k in range(2):
            _image_rule(got["image"][k], jimg[k])
        assert _stats(got["stats"]) == jst


@pytest.mark.parametrize("case", list(PRIMITIVE))
def test_primitive_sharded_matches_jax(runs, case):
    fields, n = PRIMITIVE[case]
    got = _each_rank(runs[n], f"primitive/{case}")
    jimg, jst = runs["jax"][f"primitive/{case}"]
    assert got["image"].shape == jimg.shape
    _image_rule(got["image"], jimg, tol=2e-3, share=0.01 + 1e-9)
    st = _stats(got["stats"])
    assert abs(st["primary_hits"] - jst["primary_hits"]) <= 0.01 * W * H
    assert st["rays"] == W * H + st["primary_hits"]
    if not fields.get("shadows", True):
        assert st["shadow_hits"] == 0


@pytest.mark.parametrize("n", [2, 4])
def test_gradients_match_jax(runs, n):
    got = _each_rank(runs[n], f"grads/{n}")
    want = runs["jax"][f"grads/{n}"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-4)
    for k in ("vertices", "eye"):
        _grad_rule(got[k], want[k])


@pytest.mark.parametrize("n", [2, 4])
def test_train_step_equal_across_ranks(runs, scene, n):
    # Parameters after the Adam step, loss and gradients: bit-equal on
    # every rank (frames 1 x rays 2, frames 2 x rays 2).
    got = _each_rank(runs[n], "train")
    assert np.isfinite(got["loss"]) and got["loss"] > 0
    assert np.abs(got["grad_vertices"]).max() > 0
    assert not np.array_equal(got["vertices"], scene["vertices"])
    assert not np.array_equal(got["eye"], EYE)


@pytest.mark.parametrize("n", [2, 4])
def test_train_step_matches_one_rank(runs, n):
    # The step's loss against one rank's and the JAX sharded loss, its
    # gradients against one rank's step.
    got, one = runs[n][0]["train"], runs["one"]["train"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["loss"], runs["jax"]["train_loss"],
                               rtol=1e-4)
    for k in ("grad_vertices", "grad_eye"):
        _grad_rule(got[k], one[k])


def test_fit_vertices_over_ranks(runs):
    got = _each_rank(runs[2], "fit")
    # Rank 0 wrote a checkpoint each step, newest two kept; the resumed
    # fit ran its third step and equals the straight one bit for bit.
    assert list(got["files"]) == ["2.pt", "3.pt"]
    assert len(got["tail"]) == 1 and len(got["history"]) == 3
    np.testing.assert_array_equal(got["resumed"], got["straight"])
    assert got["tail"][0] == got["history"][2]
    np.testing.assert_allclose(got["history"], runs["jax"]["fit"], rtol=1e-4)


@pytest.mark.parametrize("name", list(CLI))
def test_cli_on_two_ranks_writes_the_one_rank_files(runs, name):
    assert all(r[f"cli/{name}"] == 0 for r in runs[2])
    ext = CLI[name][2]
    one, two = (os.path.join(runs["dirs"][n], f"{name}{ext}") for n in (1, 2))
    with open(one, "rb") as a, open(two, "rb") as b:
        assert a.read() == b.read()
    if name == "anim":
        for k in range(3):
            paths = [os.path.join(runs["dirs"][n], "frames",
                                  f"frame_{k:04d}.png") for n in (1, 2)]
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read()


def test_dryrun_multichip():
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert [r["mesh"] for r in out] == [{"frames": 2, "rays": 1}] * 2
    assert out[0]["loss"] == out[1]["loss"] and np.isfinite(out[0]["loss"])
    assert out[0]["hits"] == out[1]["hits"] > 0
    torch.testing.assert_close(out[0]["vertices"], out[1]["vertices"],
                               rtol=0, atol=0)
    # The JAX package's loss of the same first step: the quad at 128 x 32
    # against a black target.
    verts = jnp.asarray([[-1.0, -1.0, 2.0], [1.0, -1.0, 2.0],
                         [1.0, 1.0, 2.0], [-1.0, 1.0, 2.0]])
    faces = jnp.asarray([[0, 2, 1], [0, 3, 2]], jnp.int32)
    cam = JaxCamera.make(eye=(0, 0, 0), dir=(0, 0, 1), up=(0, 1, 0),
                         fov=70.0)
    cfg = jrenderer.RenderConfig(width=128, height=32, mode="smooth",
                                 backend="megakernel")
    img, _ = jrenderer.render_pipeline(verts, faces, cam,
                                       jnp.asarray([3.0, 4.0, -2.0]), cfg)
    np.testing.assert_allclose(out[0]["loss"], float(jnp.mean(img ** 2)),
                               rtol=1e-4)


def test_launcher_raises_when_a_rank_fails():
    # Rank 1 raises; rank 0 waits in a collective it never completes and
    # is killed: the launcher raises with rank 1's traceback at once.
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        distributed.run_ranks(selfcheck.fail_on, 2, 1, device="cpu",
                              timeout=120)
    assert time.monotonic() - t0 < 60


def test_launcher_times_out():
    # Ranks that outlast the launcher's time limit are killed.
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        distributed.run_ranks(time.sleep, 2, 300, device="cpu", timeout=15)
    assert time.monotonic() - t0 < 120


@pytest.mark.parametrize("launch", ["run_ranks", "dryrun_multichip"])
def test_launchers_default_to_the_card(monkeypatch, launch):
    # Without device= the ranks go to the card: with none, the launchers
    # raise before they spawn anything, and do not fall back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if launch == "run_ranks":
            distributed.run_ranks(time.sleep, 2, 0, timeout=15)
        else:
            dryrun.dryrun_multichip(2)


def test_backend_rule(monkeypatch):
    choose = distributed.choose_backend
    assert choose(True, 4, 0) == ("gloo", torch.device("cpu"))
    assert choose(True, 4, 0, backend="mpi")[0] == "mpi"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for cards, ranks, want in ((1, 2, "gloo"), (2, 2, "nccl"),
                               (4, 2, "nccl"), (2, 4, "gloo")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        backend, dev = choose(False, ranks, ranks - 1)
        assert backend == want
        assert dev == torch.device("cuda", (ranks - 1) % cards)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    # 4 ranks over 2 hosts of 2 cards: NCCL, this rank on card 1.
    assert choose(False, 4, 3) == ("nccl",
                                               torch.device("cuda", 1))
    assert choose(False, 4, 3, backend="gloo")[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu=True"):
        choose(False, 2, 0)
    assert distributed._init_method("localhost:1234") == "tcp://localhost:1234"
    assert distributed._init_method("file:///x/y") == "file:///x/y"


def test_one_rank_without_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.process_info() == (0, 1, 1, 1)
    assert distributed.is_leader()
    assert distributed.initialize_from_env() is None
    mesh = psh.device_mesh(devices=["cpu"])
    assert (mesh.shape, mesh.rank, mesh.group, mesh.coords) == (
        {"frames": 1, "rays": 1}, 0, None, (0, 0))


def test_entry_forward_step(scene):
    # The bunny preview of __graft_entry__.entry: 512 x 512, megakernel,
    # smooth, shadows; the same frame as render_sharded's at that size.
    fn, (verts, cam, sun) = dryrun.entry(device="cpu")
    np.testing.assert_array_equal(verts.numpy(), scene["vertices"])
    image = fn(verts, cam, sun)
    ref, _ = psh.render_sharded(verts, scene["faces"], cam, sun,
                                width=512, height=512, backend="megakernel")
    assert image.shape == (512, 512, 3) and float(image.max()) > 0
    _image_rule(image, ref)

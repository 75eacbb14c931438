"""The port's command-line apps against the JAX package's, on the CPU.

``ceres_tpu_torch.cli.render.main`` and ``cli.anim.main`` run with
``device="cpu"`` on the bunny at a few dozen pixels. Held to the JAX
CLIs run with the same flags:

  * the printed ``Rays:`` exactly and ``Hits:`` within 0.2%;
  * the written images decoded: fewer than 0.5% of pixels more than one
    level of 255 apart (the image rule after quantisation);
  * ``utils/image.py``'s files byte-equal to the JAX package's writer on
    the same array (PPM, PNG; float32 and float64 input).

Also: ``-d``, ``--d-exact``, ``--sphere``, ``--sharded``,
``--primitive-sharded`` on one rank, ``.ppm``, ``.png``, ``.gif`` and
``.mp4`` outputs, resume from ``--save-frames``, and the builders.
"""

import os
import re

import imageio.v3 as iio
import jax
import numpy as np
import pytest
import torch

from ceres_tpu.cli import anim as jax_anim
from ceres_tpu.cli import render as jax_render
from ceres_tpu.utils import image as jax_image

from ceres_tpu_torch.cli import anim, render
from ceres_tpu_torch.io.obj import load_obj
from ceres_tpu_torch.utils import image

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(ROOT, "data", "bunny.obj")
SMALL = ["--width", "48", "--height", "32"]


def _counts(out):
    return {k: int(v) for k, v in re.findall(r"^(Rays|Hits): (\d+)$", out,
                                             re.M)}


def _read(path):
    if path.endswith(".ppm"):
        with open(path, "rb") as fh:
            fh.readline()
            return np.frombuffer(fh.read(), np.uint8)
    return np.asarray(iio.imread(path))


def _jax_main(main, argv):
    try:
        return main(argv)
    finally:
        # The JAX CLIs switch x64 on for -d; later tests trace in float32.
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("flags, ext", [
    ([], ".png"),
    (["-d"], ".ppm"),
    (["--d-exact"], ".png"),
    (["--sphere", "0", "0.1", "0.05", "0.04", "--mode", "flat"], ".png"),
    (["--sharded", "--no-shadows"], ".ppm"),
    (["--builder", "sweep", "--rotate", "y", "-145"], ".png"),
])
def test_render_cli_matches_jax(tmp_path, capsys, flags, ext):
    port_out = str(tmp_path / f"port{ext}")
    jax_out = str(tmp_path / f"jax{ext}")
    assert render.main([BUNNY, "-o", port_out, *SMALL, *flags],
                       device="cpu") == 0
    port = capsys.readouterr().out
    # The JAX CLI's --sharded renders the same image as without it, over
    # eight virtual devices eagerly (minutes here): it runs without.
    assert _jax_main(jax_render.main, [BUNNY, "-o", jax_out, *SMALL, *(
        f for f in flags if f != "--sharded")]) == 0
    ref = capsys.readouterr().out
    assert f"Wrote {port_out}" in port and "Render (" in port
    got, want = _counts(port), _counts(ref)
    assert got["Rays"] == want["Rays"]
    assert abs(got["Hits"] - want["Hits"]) <= 0.002 * want["Hits"]
    a = _read(port_out).astype(int)
    b = _read(jax_out).astype(int)
    assert a.shape == b.shape and b.max() > 0
    assert (np.abs(a - b).reshape(-1, 3).max(-1) > 1).mean() < 0.005


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_image_files_byte_equal_jax(tmp_path, dtype):
    img = np.random.default_rng(6).uniform(-0.2, 1.2, (17, 23, 3)).astype(
        dtype)
    for ext in (".ppm", ".png"):
        ours, theirs = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
        image.write_image(str(ours), img)
        jax_image.write_image(str(theirs), img)
        assert ours.read_bytes() == theirs.read_bytes()
    image.write_png(str(tmp_path / "c.png"), img, flip=False)
    jax_image.write_png(str(tmp_path / "d.png"), img, flip=False)
    assert ((tmp_path / "c.png").read_bytes()
            == (tmp_path / "d.png").read_bytes())
    np.testing.assert_array_equal(image.to_uint8(img), jax_image.to_uint8(img))
    with pytest.raises(ValueError, match="unsupported"):
        image.write_image(str(tmp_path / "e.jpg"), img)


ANIM = ["--frames", "3", "--width", "32", "--height", "48"]


@pytest.mark.parametrize("flags", [[], ["-d", "--batch", "2"]])
def test_anim_cli_matches_jax(tmp_path, capsys, flags):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert anim.main([BUNNY, "-o", str(tmp_path / "p.gif"), *ANIM, *flags,
                      "--save-frames", str(port_dir)], device="cpu") == 0
    port = capsys.readouterr().out
    assert _jax_main(jax_anim.main, [BUNNY, "-o", str(tmp_path / "j.gif"),
                                     *ANIM, *flags, "--save-frames",
                                     str(jax_dir)]) == 0
    ref = capsys.readouterr().out
    rays = [int(re.search(r"Total Rays: (\d+)", s).group(1))
            for s in (port, ref)]
    assert rays[0] == rays[1] > 3 * 32 * 48
    for k in range(3):
        a = _read(str(port_dir / f"frame_{k:04d}.png")).astype(int)
        b = _read(str(jax_dir / f"frame_{k:04d}.png")).astype(int)
        assert (np.abs(a - b).reshape(-1, 3).max(-1) > 1).mean() < 0.005
    gif = iio.imread(str(tmp_path / "p.gif"), index=None)
    assert gif.shape[:3] == (3, 48, 32)


def test_anim_cli_resumes_and_writes_mp4(tmp_path, capsys):
    frames = tmp_path / "frames"
    argv = [BUNNY, *ANIM, "--batch", "2", "--save-frames", str(frames)]
    assert anim.main(argv + ["-o", str(tmp_path / "a.gif")],
                     device="cpu") == 0
    first = {k: (frames / f"frame_{k:04d}.png").read_bytes() for k in range(3)}
    capsys.readouterr()
    os.remove(frames / "frame_0002.png")   # the last batch is lost
    assert anim.main(argv + ["-o", str(tmp_path / "a.mp4")],
                     device="cpu") == 0
    out = capsys.readouterr().out
    assert "Resumed: 2 frame(s)" in out and "frames 2..2 done" in out
    assert "frames 0..1 done" not in out
    for k in range(3):
        assert (frames / f"frame_{k:04d}.png").read_bytes() == first[k]
    assert (tmp_path / "a.mp4").stat().st_size > 0
    # The frame loop alone: uint8 frames flipped like the PPM, None where
    # a batch was on disk.
    args = anim.build_parser().parse_args(argv)
    u8, rays, seconds = anim.render_frames(args, device="cpu")
    assert all(f is None for f in u8) and rays == 0 and seconds >= 0
    os.remove(frames / "frame_0000.png")
    u8, rays, _ = anim.render_frames(args, device="cpu")
    assert u8[0].dtype == np.uint8 and u8[0].shape == (48, 32, 3)
    assert u8[2] is None and rays > 2 * 32 * 48
    np.testing.assert_array_equal(
        u8[1], _read(str(frames / "frame_0001.png"))[..., :3])


def test_cli_flags_not_ported_name_their_items(tmp_path, capsys):
    # --primitive-sharded renders on one rank, as the JAX CLI does on one
    # device (several ranks: tests/test_torch_distributed.py), within the
    # primitive-sharding rule against the plain frame: at most 1% of
    # pixels more than one level apart, primary hits within 1%. The
    # quality builders (item M9) run: --builder sbvh on a small mesh (the
    # bunny's first 300 faces) and --builder ploc in the anim app.
    out = str(tmp_path / "x.png")
    prim, plain = str(tmp_path / "p.ppm"), str(tmp_path / "q.ppm")
    assert render.main([BUNNY, "-o", prim, *SMALL, "--primitive-sharded"],
                       device="cpu") == 0
    rays_prim = _counts(capsys.readouterr().out)["Rays"]
    assert render.main([BUNNY, "-o", plain, *SMALL], device="cpu") == 0
    rays = _counts(capsys.readouterr().out)["Rays"]
    assert abs(rays_prim - rays) <= 0.01 * 48 * 32
    a, b = (_read(p).reshape(-1, 3).astype(int) for p in (prim, plain))
    assert (np.abs(a - b).max(-1) > 1).mean() <= 0.01 and a.max() > 0
    verts, faces = load_obj(BUNNY)
    small = tmp_path / "small.obj"
    small.write_text("".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in
                             verts.tolist())
                     + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in
                               faces[:300].tolist()))
    capsys.readouterr()
    assert render.main([str(small), "-o", out, *SMALL, "--builder", "sbvh"],
                       device="cpu") == 0
    text = capsys.readouterr().out
    assert "Built sbvh clusters" in text and os.path.exists(out)
    assert int(re.search(r"^Rays: (\d+)$", text, re.M).group(1)) > 0
    gif = str(tmp_path / "x.gif")
    args = anim.build_parser().parse_args(
        [BUNNY, "-o", gif, *ANIM, "--builder", "ploc"])
    u8, rays, _ = anim.render_frames(args, device="cpu")
    assert "Built ploc clusters" in capsys.readouterr().out
    assert rays > 0 and all(f is not None and f.max() > 0 for f in u8)


def test_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    # With no card and no device, both CLIs raise rather than fall back.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render.main([BUNNY, "-o", str(tmp_path / "x.png"), *SMALL])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        anim.main([BUNNY, "-o", str(tmp_path / "x.gif"), *ANIM])


def test_cli_empty_scene(tmp_path, capsys):
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\n")
    assert render.main([str(empty), "-o", str(tmp_path / "x.png")],
                       device="cpu") == 1
    assert anim.main([str(empty), "-o", str(tmp_path / "x.gif")],
                     device="cpu") == 1
    assert capsys.readouterr().err.count("scene has no triangles") == 2

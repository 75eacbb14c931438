"""Turntable animation CLI (counterpart of ``ceres_tpu/cli/anim.py``, with
its flags).

Frame i rotates the camera and the sun by i * 360 / N degrees about the
axis. Frames are rendered in batches through ``render_frames_sharded``,
which builds the scene's cut once a batch, and the video is written with
imageio (.gif) or OpenCV (.mp4), both imported only to write it.
``--save-frames DIR`` writes each frame to DIR/frame_NNNN.png as it is
rendered; a rerun skips the batches already on disk and reads them back
for the video.

Usage, on the card:
    python -m ceres_tpu_torch.cli.anim data/bunny.obj -o render.mp4 --frames 60

It runs on the card and raises where there is none; from Python,
``main([...], device="cpu")`` renders on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceres-torch-anim",
        description="Turntable animation of an OBJ mesh on an NVIDIA GPU.")
    p.add_argument("input", help="OBJ mesh path")
    p.add_argument("-o", "--output", default="render.mp4",
                   help="output video (.mp4 or .gif) [render.mp4]")
    p.add_argument("--frames", type=int, default=60,
                   help="number of turntable frames [60]")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--eye", nargs=3, type=float, default=None,
                   metavar=("X", "Y", "Z"),
                   help="camera position (default: auto-framed)")
    p.add_argument("--up", nargs=3, type=float, default=[0.0, 1.0, 0.0],
                   metavar=("X", "Y", "Z"))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--sun", nargs=3, type=float, default=[-50.0, 100.0, 0.0],
                   metavar=("X", "Y", "Z"))
    p.add_argument("--axis", nargs=3, type=float, default=[0.0, 1.0, 0.0],
                   help="turntable rotation axis [0 1 0]")
    p.add_argument("--width", type=int, default=621)   # the reference's
    p.add_argument("--height", type=int, default=1344)
    p.add_argument("--mode", choices=["smooth", "flat", "normal"],
                   default="smooth")
    p.add_argument("--backend", choices=["megakernel", "bruteforce"],
                   default="megakernel")
    p.add_argument("--builder",
                   choices=["lbvh", "sweep", "binned", "sbvh", "ploc",
                            "reinsert"],
                   default="lbvh",
                   help="acceleration-structure builder: lbvh (the treelet "
                        "cut built on the device, default), or a quality "
                        "build cut into the same structure once before "
                        "the frames: sweep, binned (native C++), sbvh, "
                        "ploc (on the device) or reinsert")
    p.add_argument("--batch", type=int, default=None,
                   help="frames rendered a batch, each batch building the "
                        "cut once [4]")
    p.add_argument("-d", "--double", action="store_true",
                   help="render in float64. On the megakernel backend the "
                        "search runs in float32 and every value is "
                        "recomputed in float64 at the winners; use "
                        "--backend bruteforce for the all-float64 oracle")
    p.add_argument("--save-frames", metavar="DIR", default=None,
                   help="write each frame to DIR/frame_NNNN.png as soon as "
                        "it is rendered; on restart, batches already "
                        "written are skipped")
    return p


def _write_video(path: str, frames_u8, fps: int) -> None:
    if path.endswith(".gif"):
        import imageio

        imageio.mimsave(path, list(frames_u8), duration=1000.0 / fps, loop=0)
    elif path.endswith(".mp4"):
        import cv2

        h, w = frames_u8[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        for f in frames_u8:
            vw.write(f[:, :, ::-1])  # RGB -> BGR
        vw.release()
    else:
        raise ValueError(f"unsupported video format: {path}")


def frame_path(args, k: int) -> str:
    return os.path.join(args.save_frames, f"frame_{k:04d}.png")


def render_frames(args, device=None):
    """The frame loop of ``args`` (parsed by ``build_parser``) on
    ``device`` (default: the card) -> (uint8 frames, flipped like the
    PPM, None where a batch was already on disk; total rays; seconds).
    Writes the frames with ``--save-frames``."""
    import numpy as np
    import torch

    from ceres_tpu_torch.accel.cuts import build_clusters_quality
    from ceres_tpu_torch.io.obj import load_obj
    from ceres_tpu_torch.models.camera import Camera
    from ceres_tpu_torch.models.mesh import triangle_soup
    from ceres_tpu_torch.parallel.sharded import (
        device_mesh, render_frames_sharded, turntable_transforms)
    from ceres_tpu_torch.render.renderer import resolve_device
    from ceres_tpu_torch.utils.image import to_uint8, write_png

    mesh = device_mesh(devices=[resolve_device(None, device,
                                               "ceres-torch-anim")])
    vertices, faces = load_obj(args.input)
    if faces.shape[0] == 0:
        raise ValueError("scene has no triangles")
    scalar = np.float64 if args.double else np.float32
    dtype = torch.float64 if args.double else torch.float32
    vertices = vertices.astype(scalar)
    print(f"Loaded {vertices.shape[0]} vertices / {faces.shape[0]} faces")

    center = vertices.mean(axis=0)
    if args.eye is not None:
        eye = np.asarray(args.eye, scalar)
    else:
        # Auto-frame: back off along -z by 2.5x the bounding radius.
        radius = float(np.linalg.norm(vertices - center, axis=1).max())
        eye = center + np.asarray([0, 0, -2.5 * radius], scalar)
    camera = Camera.make(eye=eye, dir=center - eye, up=args.up, fov=args.fov,
                         dtype=dtype)
    sun = np.asarray(args.sun, scalar)
    tracks = turntable_transforms(args.frames, axis=args.axis, dtype=dtype)

    if args.save_frames:
        os.makedirs(args.save_frames, exist_ok=True)

    clusters = None
    if args.builder != "lbvh" and args.backend == "megakernel":
        tb = time.perf_counter()
        clusters = build_clusters_quality(
            triangle_soup(torch.as_tensor(vertices, device=mesh.device),
                          torch.as_tensor(faces, device=mesh.device),
                          with_normals=False),
            builder=args.builder)
        print(f"Built {args.builder} clusters "
              f"({time.perf_counter() - tb:.3f}s)")

    batch = args.batch or min(args.frames, 4)
    total_rays = 0
    frames_u8 = [None] * args.frames
    t1 = time.perf_counter()
    for start in range(0, args.frames, batch):
        stop = min(start + batch, args.frames)
        if args.save_frames and all(
                os.path.exists(frame_path(args, k))
                for k in range(start, stop)):
            continue  # resume: this batch is already on disk
        frames, stats = render_frames_sharded(
            vertices, faces, camera, sun, tracks.frame(slice(start, stop)),
            mesh=mesh, clusters=clusters, width=args.width,
            height=args.height, mode=args.mode, backend=args.backend)
        frames = frames.cpu().numpy()
        total_rays += int(stats["rays"])
        for k in range(frames.shape[0]):
            frames_u8[start + k] = to_uint8(frames[k])[::-1]  # flip like PPM
            if args.save_frames:
                write_png(frame_path(args, start + k), frames[k])
        print(f"frames {start}..{stop - 1} done "
              f"({time.perf_counter() - t1:.2f}s elapsed)")
    return frames_u8, total_rays, time.perf_counter() - t1


def run(args, device=None) -> int:
    import numpy as np

    try:
        frames_u8, total_rays, dt = render_frames(args, device)
    except ValueError as e:   # "scene has no triangles"
        print(f"Error: {e}", file=sys.stderr)
        return 1
    skipped = [k for k, f in enumerate(frames_u8) if f is None]
    if skipped:
        print(f"Resumed: {len(skipped)} frame(s) already in "
              f"{args.save_frames}")
        import imageio.v3 as iio

        for k in skipped:
            frames_u8[k] = np.asarray(iio.imread(frame_path(args, k)))[..., :3]
    print(f"Total Rays: {total_rays}")
    print(f"Total render: {dt:.2f}s on 1 device(s) "
          f"({total_rays / dt / 1e6:.1f} Mrays/s)")
    _write_video(args.output, frames_u8, args.fps)
    print(f"Wrote {args.output} ({args.frames} frames)")
    return 0


def main(argv=None, device=None) -> int:
    """The command line ``argv`` (default: ``sys.argv``), rendered on
    ``device`` (default: the card; ``device="cpu"`` for the CPU)."""
    return run(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    raise SystemExit(main())

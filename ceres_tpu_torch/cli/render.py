"""Single-frame render CLI (counterpart of ``ceres_tpu/cli/render.py``,
with its flags).

Usage, on the card:
    python -m ceres_tpu_torch.cli.render data/bunny.obj -o out.png \
        --eye 0 .1 -.3 --rotate y -145 --width 512 --height 512 --mode flat

It runs on the card and raises where there is none; from Python,
``main([...], device="cpu")`` renders on the CPU.

Several ranks, one a card (gloo ranks share a card where there are
fewer cards than ranks):
    torchrun --nproc-per-node 2 -m ceres_tpu_torch.cli.render \
        data/bunny.obj -o out.png --sharded      # rows over the ranks
    torchrun --nproc-per-node 2 -m ceres_tpu_torch.cli.render \
        data/bunny.obj -o out.png --primitive-sharded   # triangles
Each rank joins the group that ``torchrun`` describes (``WORLD_SIZE``);
rank 0 alone prints and writes the image. Without ``torchrun`` the CLI
runs as one rank.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceres-torch-render",
        description="Single-frame ray-traced render of an OBJ mesh on an "
                    "NVIDIA GPU.")
    p.add_argument("input", help="OBJ mesh path")
    p.add_argument("-o", "--output", default="render.png",
                   help="output image (.png or .ppm) [render.png]")
    p.add_argument("--eye", nargs=3, type=float, default=[0.0, 0.1, -0.3],
                   metavar=("X", "Y", "Z"), help="camera position")
    p.add_argument("--dir", dest="direction", nargs=3, type=float,
                   default=None, metavar=("X", "Y", "Z"),
                   help="view direction (default: at mesh centroid)")
    p.add_argument("--up", nargs=3, type=float, default=[0.0, 1.0, 0.0],
                   metavar=("X", "Y", "Z"), help="camera up vector")
    p.add_argument("--fov", type=float, default=60.0,
                   help="horizontal field of view, degrees [60]")
    p.add_argument("--rotate", nargs=2, default=None,
                   metavar=("AXIS", "DEG"),
                   help="pre-rotate the mesh about x|y|z by DEG degrees")
    p.add_argument("--sun", nargs=3, type=float, default=[-50.0, 100.0, 0.0],
                   metavar=("X", "Y", "Z"), help="point-light position")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--mode", choices=["smooth", "flat", "normal"],
                   default="smooth", help="shading mode [smooth]")
    p.add_argument("--backend", choices=["megakernel", "bruteforce"],
                   default="megakernel")
    p.add_argument("--builder",
                   choices=["lbvh", "sweep", "binned", "sbvh", "ploc",
                            "reinsert"],
                   default="lbvh",
                   help="acceleration-structure builder (megakernel "
                        "backend). lbvh = the treelet cut built on the "
                        "device (default). sweep, binned (native C++), "
                        "sbvh, ploc (on the device) and reinsert = a "
                        "quality build cut into the same structure, "
                        "slower to build and fewer visits a frame")
    p.add_argument("--no-shadows", action="store_true",
                   help="skip shadow rays")
    p.add_argument("--sphere", action="append", nargs=4, type=float,
                   default=None, metavar=("X", "Y", "Z", "R"),
                   help="add a sphere primitive at (X, Y, Z) with radius "
                        "R; repeatable")
    p.add_argument("--sharded", action="store_true",
                   help="shard image rows across the ranks (torchrun; one "
                        "rank without it)")
    p.add_argument("--primitive-sharded", action="store_true",
                   help="shard the triangles across the ranks (torchrun; "
                        "one rank without it)")
    p.add_argument("-d", "--double", action="store_true",
                   help="render in float64. On the megakernel backend the "
                        "search runs in float32 and every value is "
                        "recomputed in float64 at the winners; use "
                        "--backend bruteforce for the all-float64 oracle")
    p.add_argument("--d-exact", action="store_true",
                   help="implies -d; the megakernel search also runs in "
                        "float64 (the plain float64 cluster walk), for "
                        "scenes beyond float32 resolution. Slower than -d")
    return p


def run(args, device=None) -> int:
    """Render ``args`` (parsed by ``build_parser``) on ``device`` (default:
    the card). Under ``torchrun`` it joins the ranks' group first and
    leaves it at the end."""
    from ceres_tpu_torch.parallel import distributed

    if args.d_exact:
        args.double = True
    with distributed.joined_from_env(device) as joined:
        return _run(args, distributed.cli_device(device, "ceres-torch-render"),
                    joined)


def _run(args, device, joined) -> int:
    import numpy as np
    import torch

    from ceres_tpu_torch.io.obj import load_obj
    from ceres_tpu_torch.models.camera import Camera
    from ceres_tpu_torch.models.mesh import triangle_soup
    from ceres_tpu_torch.models.transform import rotate_vertices_about_axis
    from ceres_tpu_torch.parallel import distributed
    from ceres_tpu_torch.render.renderer import render
    from ceres_tpu_torch.utils.image import write_image

    say = distributed.leader_print()
    if joined:
        say(f"Ranks: {distributed.process_info()[1]} ({joined})")
    t0 = time.perf_counter()
    vertices, faces = load_obj(args.input)
    if faces.shape[0] == 0:
        say("Error: scene has no triangles", file=sys.stderr)
        return 1
    say(f"Loaded {vertices.shape[0]} vertices / {faces.shape[0]} faces "
        f"({time.perf_counter() - t0:.3f}s)")

    if args.rotate is not None:
        axis = {"x": 0, "y": 1, "z": 2}[args.rotate[0].lower()]
        vertices = rotate_vertices_about_axis(
            vertices, axis, float(args.rotate[1])).numpy()

    scalar = np.float64 if args.double else np.float32
    dtype = torch.float64 if args.double else torch.float32
    vertices = np.asarray(vertices, scalar)
    eye = np.asarray(args.eye, scalar)
    direction = (np.asarray(args.direction, scalar)
                 if args.direction is not None
                 else vertices.mean(axis=0) - eye)
    camera = Camera.make(eye=eye, dir=direction, up=args.up, fov=args.fov,
                         dtype=dtype)
    sun = np.asarray(args.sun, scalar)
    spheres = None
    if args.sphere:
        sp = np.asarray(args.sphere, scalar)           # (S, 4)
        spheres = (sp[:, :3], sp[:, 3])
    options = dict(width=args.width, height=args.height, mode=args.mode,
                   backend=args.backend, shadows=not args.no_shadows,
                   spheres=spheres, device=device)

    t1 = time.perf_counter()
    if args.primitive_sharded or args.sharded:
        from ceres_tpu_torch.parallel.sharded import (
            device_mesh, render_primitive_sharded, render_sharded)

        mesh = device_mesh(devices=[options.pop("device")])
        if args.primitive_sharded:
            image, stats = render_primitive_sharded(
                vertices, faces, camera, sun, mesh=mesh, **options)
        else:
            image, stats = render_sharded(vertices, faces, camera, sun,
                                          mesh=mesh, f64_exact=args.d_exact,
                                          **options)
    else:
        clusters = None
        if args.builder != "lbvh" and args.backend == "megakernel":
            from ceres_tpu_torch.accel.cuts import build_clusters_quality

            tb = time.perf_counter()
            clusters = build_clusters_quality(
                triangle_soup(torch.as_tensor(vertices, device=device),
                              torch.as_tensor(faces, device=device),
                              with_normals=False),
                builder=args.builder)
            say(f"Built {args.builder} clusters "
                f"({time.perf_counter() - tb:.3f}s)")
        image, stats = render(vertices, faces, camera, sun, clusters=clusters,
                              f64_exact=args.d_exact, **options)
    image = image.cpu().numpy()
    dt = time.perf_counter() - t1

    # The stats the reference prints a frame.
    rays, hits = int(stats["rays"]), int(stats["hits"])
    say(f"Rays: {rays}")
    say(f"Hits: {hits}")
    say(f"Render (incl. compile): {dt:.3f}s  ({rays / dt / 1e6:.1f} "
        f"Mrays/s)")

    if distributed.is_leader():
        write_image(args.output, image)
    say(f"Wrote {args.output}")
    return 0


def main(argv=None, device=None) -> int:
    """The command line ``argv`` (default: ``sys.argv``), rendered on
    ``device`` (default: the card; ``device="cpu"`` for the CPU)."""
    return run(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    raise SystemExit(main())

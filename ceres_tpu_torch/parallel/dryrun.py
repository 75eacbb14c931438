"""A forward step to compile-check and a dry run over several ranks
(counterpart of ``__graft_entry__.py``: ``entry``, ``dryrun_multichip``).

    python -m ceres_tpu_torch.parallel.dryrun            # entry() on the card
    python -m ceres_tpu_torch.parallel.dryrun multichip 2 [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): the bunny preview's forward render step on the
    main path (megakernel backend, 512 x 512, smooth shading, shadows);
    ``fn(vertices, camera, sun)`` -> (H, W, 3) image. On ``device``
    (default: the card; it raises without one)."""
    from ceres_tpu_torch.io.obj import load_obj
    from ceres_tpu_torch.models.camera import Camera
    from ceres_tpu_torch.render.renderer import (RenderConfig,
                                                 render_pipeline,
                                                 resolve_device)
    from ceres_tpu_torch.render.scenes import bunny_path

    device = resolve_device(None, device, "entry")
    verts, faces = load_obj(bunny_path())
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    camera = Camera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0, device=device)
    sun = torch.as_tensor([-50.0, 100.0, 0.0], device=device)
    config = RenderConfig(width=512, height=512, mode="smooth",
                          backend="megakernel")
    faces = torch.as_tensor(faces, device=device)

    def fn(vertices, camera, sun_position):
        image, _ = render_pipeline(vertices, faces, camera, sun_position,
                                   config)
        return image

    return fn, (torch.as_tensor(verts, device=device), camera, sun)


def _quad(device):
    """The dry run's scene: a two-triangle quad in front of the camera."""
    from ceres_tpu_torch.models.camera import Camera

    verts = torch.as_tensor([[-1.0, -1.0, 2.0], [1.0, -1.0, 2.0],
                             [1.0, 1.0, 2.0], [-1.0, 1.0, 2.0]],
                            device=device)
    faces = torch.as_tensor([[0, 2, 1], [0, 3, 2]], dtype=torch.int32,
                            device=device)
    camera = Camera.make(eye=(0, 0, 0), dir=(0, 0, 1), up=(0, 1, 0),
                         fov=70.0, device=device)
    return verts, faces, camera, torch.as_tensor([3.0, 4.0, -2.0],
                                                 device=device)


def _dryrun_rank(num_frames_axis: int) -> dict:
    """One rank of the dry run: a train step over the frames x rays mesh
    and a primitive-sharded render; raises on a non-finite loss or a
    render without hits."""
    from ceres_tpu_torch.diff import TrainState, make_train_step
    from ceres_tpu_torch.parallel import distributed
    from ceres_tpu_torch.parallel.sharded import render_primitive_sharded
    from ceres_tpu_torch.render.renderer import RenderConfig

    mesh = distributed.global_mesh(num_frames_axis)
    verts, faces, camera, sun = _quad(mesh.device)
    config = RenderConfig(width=128, height=32, mode="smooth",
                          backend="megakernel")
    params = {"vertices": verts.clone().requires_grad_(),
              "eye": camera.eye.clone().requires_grad_()}
    optimizer = torch.optim.Adam(params.values(), lr=1e-3)
    step = make_train_step(faces, camera, sun, config, optimizer, mesh=mesh)
    target = torch.zeros((config.height, config.width, 3),
                         device=mesh.device)
    state, loss = step(TrainState(params, {k: {} for k in params}), target)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"rank {mesh.rank}: non-finite loss {loss}")
    _, stats = render_primitive_sharded(verts, faces, camera, sun,
                                        config=config, mesh=mesh)
    hits = int(stats["primary_hits"])
    if hits <= 0:
        raise RuntimeError(f"rank {mesh.rank}: the primitive-sharded render "
                           "missed")
    return {"mesh": mesh.shape, "loss": float(loss), "hits": hits,
            "vertices": state.params["vertices"].detach().cpu()}


def dryrun_multichip(n_devices: int, device=None) -> list:
    """One train step and one primitive-sharded render over ``n_devices``
    ranks on this host, on a ("frames", "rays") mesh with frames 2 when
    ``n_devices`` is even. Ranks run on ``device`` ("cpu", or "cuda",
    the default, which raises without a card: ranks beyond the cards
    share them). Returns each rank's record; raises if any rank fails."""
    from ceres_tpu_torch.parallel.distributed import run_ranks

    nf = 2 if n_devices % 2 == 0 else 1
    out = run_ranks(_dryrun_rank, n_devices, nf, device=device)
    print(f"dryrun_multichip({n_devices}): mesh={out[0]['mesh']} "
          f"loss={out[0]['loss']:.6f} prim_sharded_hits={out[0]['hits']} OK")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "multichip":
        n = int(argv[1]) if len(argv) > 1 else 2
        dryrun_multichip(n, device="cpu" if "--cpu" in argv else None)
    else:
        fn, args = entry()
        out = fn(*args)
        torch.cuda.synchronize()
        print("entry OK:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

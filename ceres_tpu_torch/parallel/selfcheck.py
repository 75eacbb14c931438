"""Every mesh path of the port, run on one rank of a group: the program
``distributed.run_ranks`` spawns on CPU ranks to hold the group to one
rank and to the JAX package (``tests/test_torch_distributed.py``).

``run(case)`` takes numpy inputs (a scene and what each path needs) and
returns numpy results by path, so that the spawning process compares
them; every rank returns its own, so that equality across ranks is
checked too. ``fail_on(rank)`` raises on one rank while the others wait
in a collective, for the launcher's failure handling.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _scene(case, device):
    from ceres_tpu_torch.models.camera import Camera

    s = case["scene"]
    cam = Camera.make(s["eye"], s["dir"], s["up"], s["fov"], device=device)
    spheres = s.get("spheres")
    if spheres is not None:
        spheres = tuple(torch.as_tensor(x, device=device) for x in spheres)
    return (torch.as_tensor(s["vertices"], device=device),
            torch.as_tensor(s["faces"], device=device), cam,
            torch.as_tensor(s["sun"], device=device), spheres)


def _with_spheres(fields, spheres):
    """(config fields, spheres): the scene's spheres where ``fields``
    asks for them with ``spheres=True``, else None."""
    fields = dict(fields)
    return fields, spheres if fields.pop("spheres", False) else None


def _grads(verts, faces, cam, sun, config, mesh, weights):
    """(image, loss, d/dvertices, d/deye) of sum(weights * image) through
    ``render_sharded`` over ``mesh``."""
    from ceres_tpu_torch.models.camera import Camera
    from ceres_tpu_torch.parallel.sharded import render_sharded

    v = verts.clone().requires_grad_()
    eye = cam.eye.clone().requires_grad_()
    image, _ = render_sharded(v, faces, Camera(eye=eye, dir=cam.dir,
                                               up=cam.up, fov=cam.fov),
                              sun, config, mesh=mesh)
    loss = (image * torch.as_tensor(weights, device=image.device)).sum()
    loss.backward()
    return {"image": image, "loss": loss, "vertices": v.grad,
            "eye": eye.grad}


def _train_step(verts, faces, cam, sun, config, mesh, target):
    """One Adam step of ``make_train_step`` over ``mesh`` w.r.t. the
    vertices and the eye: the loss, the gradients and the parameters
    after it."""
    from ceres_tpu_torch.diff import TrainState, make_train_step

    params = {"vertices": verts.clone().requires_grad_(),
              "eye": cam.eye.clone().requires_grad_()}
    step = make_train_step(faces, cam, sun, config,
                           torch.optim.Adam(params.values(), lr=1e-3),
                           mesh=mesh)
    state, loss = step(TrainState(params, {k: {} for k in params}),
                       torch.as_tensor(target, device=mesh.device))
    return {"loss": loss,
            **{f"grad_{k}": p.grad for k, p in state.params.items()},
            **{k: p for k, p in state.params.items()}}


def run(case: dict) -> dict:
    """The paths of ``case`` on this rank (module docstring). Keys of
    ``case``: ``scene`` (vertices, faces, eye, dir, up, fov, sun, and
    optionally spheres: (centers, radii)), ``width``/``height``, and
    optionally ``sharded`` (a list of (name, frames axis, config
    fields)), ``frames`` (turntable frames), ``deforming`` ((F, V, 3)
    vertices), ``primitive`` (a list of (name, config fields)); config
    fields with ``spheres=True`` render the scene's spheres too, ``grads`` (weights (H, W, 3)), ``train`` (target),
    ``fit`` (noisy vertices, target, checkpoint directory), ``cli``
    (argument lists by name, run through ``cli.render`` or
    ``cli.anim``)."""
    from ceres_tpu_torch.diff import fit_vertices
    from ceres_tpu_torch.parallel import distributed
    from ceres_tpu_torch.parallel.sharded import (
        render_deforming_frames, render_frames_sharded,
        render_primitive_sharded, render_sharded, turntable_transforms)
    from ceres_tpu_torch.render.renderer import RenderConfig

    out = {}
    device = distributed.rank_device()
    verts, faces, cam, sun, spheres = _scene(case, device)
    size = dict(width=case["width"], height=case["height"])

    def config(**fields):
        return RenderConfig(**{**size, **fields})

    for name, nf, fields in case.get("sharded", ()):
        fields, sph = _with_spheres(fields, spheres)
        image, stats = render_sharded(verts, faces, cam, sun,
                                      config(**fields),
                                      mesh=distributed.global_mesh(nf),
                                      spheres=sph)
        out[f"sharded/{name}"] = _np({"image": image, "stats": stats})
    if "frames" in case:
        nf, count = case["frames"]
        frames, stats = render_frames_sharded(
            verts, faces, cam, sun, turntable_transforms(count),
            config(backend="megakernel"), mesh=distributed.global_mesh(nf))
        out["frames"] = _np({"image": frames, "stats": stats})
    if "deforming" in case:
        nf, vf = case["deforming"]
        frames, stats = render_deforming_frames(
            vf, faces, cam, sun, config(backend="megakernel"),
            mesh=distributed.global_mesh(nf))
        out["deforming"] = _np({"image": frames, "stats": stats})
    for name, fields in case.get("primitive", ()):
        fields, sph = _with_spheres(fields, spheres)
        image, stats = render_primitive_sharded(
            verts, faces, cam, sun, config(**fields),
            mesh=distributed.global_mesh(), spheres=sph)
        out[f"primitive/{name}"] = _np({"image": image, "stats": stats})
    for name, (nf, fields, weights) in case.get("grads", {}).items():
        out[f"grads/{name}"] = _np(_grads(
            verts, faces, cam, sun, RenderConfig(**fields),
            distributed.global_mesh(nf), weights))
    if "train" in case:
        nf, target = case["train"]
        out["train"] = _np(_train_step(verts, faces, cam, sun,
                                       config(backend="megakernel"),
                                       distributed.global_mesh(nf), target))
    if "fit" in case:
        noisy, target, ckpt = case["fit"]
        fit = dict(config=config(backend="megakernel"), learning_rate=2e-4,
                   mesh=distributed.global_mesh())
        # Two steps with checkpoints, then resumed to three; and three
        # straight through.
        fit_vertices(noisy, faces, cam, sun, target, steps=2,
                     checkpoint_dir=ckpt, checkpoint_every=1, **fit)
        resumed, tail = fit_vertices(noisy, faces, cam, sun, target, steps=3,
                                     checkpoint_dir=ckpt,
                                     checkpoint_every=1, **fit)
        straight, history = fit_vertices(noisy, faces, cam, sun, target,
                                         steps=3, **fit)
        out["fit"] = _np({"resumed": resumed["vertices"], "tail": tail,
                          "straight": straight["vertices"],
                          "history": history,
                          "files": sorted(os.listdir(ckpt))})
    for name, argv in case.get("cli", {}).items():
        from ceres_tpu_torch.cli import anim, render

        app = anim if name.startswith("anim") else render
        out[f"cli/{name}"] = app.main(argv, device=device)
    return out


def fail_on(rank: int) -> None:
    """Raise on ``rank``; every other rank waits in an all_reduce that
    the failing rank never joins."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    x = torch.zeros(1)
    dist.all_reduce(x)

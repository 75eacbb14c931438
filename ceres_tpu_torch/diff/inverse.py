"""Inverse rendering: fit scene parameters to a target image (counterpart
of ``ceres_tpu/diff/inverse.py``: ``TrainState``, ``image_loss``,
``_camera_with``, ``make_train_step``, ``fit_vertices``).

BASELINE config 4: gradients w.r.t. vertex positions and camera pose,
and an inverse-rendering fit on the bunny. A train step renders, takes
the photometric loss, runs ``backward`` and steps Adam. The gradients
are autograd's over plain torch ops: the walk kernels return integers
computed on detached float32 copies, and every value a pixel depends on
is recomputed at the winners (``ops.megakernel``), so there is no custom
autograd function. ``torch.optim.Adam`` takes the place of
``optax.adam``: the same update lr * m_hat / (sqrt(v_hat) + eps) with
b1, b2, eps = 0.9, 0.999, 1e-8, rounded in another order.

Over a mesh of ranks (``mesh=``, ``parallel.sharded``) every rank renders
its rows through ``render_sharded``, takes the loss over the whole image,
and receives the gradients already summed over the ranks; Adam then
steps alike on every rank. Each rank refits the cut as one device does
(the JAX package builds it in the step there: the same image up to
exact-distance ties). Rank 0 alone writes checkpoints, which every rank
restores. Without a mesh the step renders through ``render_pipeline``,
the JAX package's unsharded path: its column-form rays round in another
order than ``render_sharded``'s row form, so a pixel's last bits differ
between the two, and each fit keeps the path of its JAX counterpart.

On the card the step without a mesh, on the cluster walk, is captured
as a CUDA graph (``utils.graphs``), the counterpart of the JAX package's
jitted step: refitted, or building its cut inside the step as the JAX
package's rebuilt step does.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Optional

import torch

from ceres_tpu_torch.accel.clusters import (build_clusters_treelet,
                                            refit_clusters)
from ceres_tpu_torch.models.camera import Camera
from ceres_tpu_torch.models.mesh import triangle_soup
from ceres_tpu_torch.parallel.sharded import render_sharded
from ceres_tpu_torch.render.renderer import (RenderConfig, render_pipeline,
                                             resolve_device)

# Checkpoints kept in ``checkpoint_dir``, newest first (orbax's
# ``max_to_keep=2`` in the JAX package).
_KEEP = 2
_CKPT = re.compile(r"^(\d+)\.pt$")


class TrainState(NamedTuple):
    """Parameters and optimizer state of a fit.

    ``params``: {"vertices": (V, 3) [, "eye", "dir"]}, leaf tensors that
    require gradients. ``opt_state``: per parameter name, Adam's state
    as ``torch.optim.Adam`` keeps it ({"step", "exp_avg", "exp_avg_sq"};
    an empty dict before the first step).
    """

    params: dict
    opt_state: dict


def image_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared photometric error."""
    return torch.mean((rendered - target) ** 2)


def _camera_with(camera: Camera, params: dict) -> Camera:
    return Camera(eye=params.get("eye", camera.eye),
                  dir=params.get("dir", camera.dir),
                  up=camera.up, fov=params.get("fov", camera.fov))


def make_train_step(faces, camera: Camera, sun, config: RenderConfig,
                    optimizer: torch.optim.Optimizer, mesh=None,
                    clusters0=None):
    """A train step ``(state, target) -> (state, loss)``.

    ``optimizer`` is built over the leaf tensors of the ``params`` the
    step is given (``torch.optim.Adam(params.values(), lr=...)``). The
    step hands it ``state.opt_state``, zeroes the gradients, renders,
    takes ``image_loss`` against ``target``, runs ``backward`` and steps
    the optimizer. Parameters and Adam's state change in place, as
    ``torch.optim`` changes them; the returned state holds the same
    tensors, and the loss is detached.

    With ``clusters0`` (a ClusterSet built from the initial vertices)
    each step refits it to the current vertices, detached, instead of
    building the treelet cut anew: a gather and a segmented min/max in
    place of the LBVH build. Without it the megakernel backend builds
    the cut inside every step.

    On the card the step without a mesh, with ``backend="megakernel"``
    and without ``f64_exact``, is one CUDA graph (the counterpart of the
    JAX package's jitted step): the first call runs the step eagerly on
    a side stream and captures it, and every call after replays the
    refit or the build of the cut, render, loss, ``backward`` and the
    optimizer step at once. The optimizer must then be capturable
    (``torch.optim.Adam(..., capturable=True)``), or this raises. Its
    hyperparameters are those of the capture. A ``target``, and an
    ``opt_state`` whose tensors are not the optimizer's own (a restored
    checkpoint, a carried optax state; empty dicts start Adam afresh),
    are copied into the graph's tensors before the replay. The step over
    a mesh, any step off the card, the oracle backend and ``f64_exact``
    run eagerly.

    With ``mesh`` (``parallel.sharded.Mesh``) the image is rendered by
    ``render_sharded`` over the mesh's ranks, the loss is taken on every
    rank over the whole image, and the gradients arrive summed over the
    ranks.
    """
    device = optimizer.param_groups[0]["params"][0].device
    if not _captured(config, mesh, device):
        return _make_eager_step(faces, camera, sun, config, optimizer,
                                mesh=mesh, clusters0=clusters0)
    if not all(g.get("capturable", False) for g in optimizer.param_groups):
        raise ValueError(f"make_train_step: the "
                         f"{'rebuilt' if clusters0 is None else 'refitted'}"
                         f" step on the card is captured as a CUDA graph, "
                         f"which needs a capturable optimizer: build it with "
                         f"capturable=True, as in torch.optim.Adam("
                         f"params.values(), lr=..., capturable=True)")
    return _captured_step(_loss_fn(faces, camera, sun, config, None,
                                   clusters0), optimizer)


def _on_card(device) -> bool:
    """Whether ``device`` is the card's."""
    return torch.device(device).type == "cuda"


def _captured(config: RenderConfig, mesh, device) -> bool:
    """Whether ``make_train_step`` captures the step: on the card, without
    a mesh, on the cluster walk in float32."""
    return (mesh is None and _on_card(device)
            and config.backend == "megakernel" and not config.f64_exact)


def _loss_fn(faces, camera, sun, config, mesh, clusters0):
    """``loss(params, target)``: render the parameters and take
    ``image_loss``."""

    def loss_fn(params, target):
        cam = _camera_with(camera, params)
        clusters = None
        if clusters0 is not None:
            soup = triangle_soup(params["vertices"].detach(), faces,
                                 with_normals=False)
            clusters = refit_clusters(clusters0, soup)
        if mesh is not None:
            image, _ = render_sharded(params["vertices"], faces, cam, sun,
                                      config, mesh=mesh, clusters=clusters)
        else:
            image, _ = render_pipeline(params["vertices"], faces, cam, sun,
                                       config, clusters=clusters)
        return image_loss(image, target)

    return loss_fn


def _check_leaves(optimizer, state: TrainState) -> None:
    leaves = [p for g in optimizer.param_groups for p in g["params"]]
    params = list(state.params.values())
    if len(leaves) != len(params) or any(
            a is not b for a, b in zip(leaves, params)):
        raise ValueError("the optimizer must be built over the leaf "
                         "tensors of state.params, in their order")


def _make_eager_step(faces, camera: Camera, sun, config: RenderConfig,
                     optimizer: torch.optim.Optimizer, mesh=None,
                     clusters0=None):
    """:func:`make_train_step`'s step run op by op: the step over a
    mesh, any step off the card, the oracle backend and ``f64_exact``,
    and the reference the captured step is held to."""
    loss_fn = _loss_fn(faces, camera, sun, config, mesh, clusters0)

    def step(state: TrainState, target) -> tuple[TrainState, torch.Tensor]:
        _check_leaves(optimizer, state)
        for name, p in state.params.items():
            optimizer.state[p] = state.opt_state[name]
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, target)
        loss.backward()
        optimizer.step()
        return (TrainState(state.params,
                           {name: optimizer.state[p]
                            for name, p in state.params.items()}),
                loss.detach())

    return step


def _captured_step(loss_fn, optimizer: torch.optim.Optimizer):
    """The step as one CUDA graph (``utils.graphs``), captured at the
    first call after that call's eager step."""
    from ceres_tpu_torch.utils import graphs

    held = {}   # the graph and its target buffer, once captured

    def body(params, target):
        # The capture's backward fills new gradient tensors of its own;
        # the previous call's (the warm-up's) are copied into them.
        held["grads"] = [p.grad for p in params.values()]
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def step(state: TrainState, target) -> tuple[TrainState, torch.Tensor]:
        _check_leaves(optimizer, state)
        if "graph" not in held:
            for name, p in state.params.items():
                # Adam keeps a restored "step" on the CPU; a capturable
                # one keeps it beside the parameter.
                optimizer.state[p] = {k: v.to(p.device) for k, v in
                                      state.opt_state[name].items()}
            held["target"] = torch.as_tensor(target).detach().clone()
            held["graph"] = graphs.capture(
                lambda: body(state.params, held["target"]),
                (state.params, held["target"]))
            for p, g in zip(state.params.values(), held.pop("grads")):
                if g is not None:
                    p.grad.copy_(g)
            loss = held["graph"].first
        else:
            for name, p in state.params.items():
                _load_state(optimizer.state[p], state.opt_state[name])
            if tuple(target.shape) != tuple(held["target"].shape):
                raise ValueError(f"target: the step was captured at "
                                 f"{tuple(held['target'].shape)}, got "
                                 f"{tuple(target.shape)}")
            held["target"].copy_(target)
            loss = held["graph"].replay().clone()
        return (TrainState(state.params,
                           {name: optimizer.state[p]
                            for name, p in state.params.items()}), loss)

    return step


def _load_state(static: dict, given: dict) -> None:
    """Copy a parameter's optimizer state ``given`` into the captured
    step's ``static`` tensors; an empty ``given`` zeroes them, Adam's
    start."""
    if given is static:
        return
    if given and set(given) != set(static):
        raise ValueError(f"opt_state holds {sorted(given)}, the captured "
                         f"step {sorted(static)}")
    for k, x in static.items():
        if not given:
            x.zero_()
        elif given[k] is not x:
            x.copy_(given[k])


def _latest(checkpoint_dir: str) -> Optional[int]:
    steps = [int(m.group(1)) for m in map(_CKPT.match,
                                          os.listdir(checkpoint_dir)) if m]
    return max(steps, default=None)


def _save(checkpoint_dir: str, step: int, state: TrainState) -> None:
    """Write the checkpoint of ``step`` (parameters, Adam's state, step)
    atomically and keep the newest ``_KEEP``."""
    payload = {
        "step": step,
        "params": {k: v.detach().cpu() for k, v in state.params.items()},
        "opt_state": {k: {kk: vv.detach().cpu() for kk, vv in s.items()}
                      for k, s in state.opt_state.items()},
    }
    path = os.path.join(checkpoint_dir, f"{step}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    steps = sorted(int(m.group(1)) for m in map(
        _CKPT.match, os.listdir(checkpoint_dir)) if m)
    for old in steps[:-_KEEP]:
        os.remove(os.path.join(checkpoint_dir, f"{old}.pt"))


def _restore(checkpoint_dir: str, step: int, device) -> TrainState:
    ck = torch.load(os.path.join(checkpoint_dir, f"{step}.pt"),
                    map_location="cpu", weights_only=True)
    params = {k: v.to(device).requires_grad_()
              for k, v in ck["params"].items()}
    # Adam keeps "step" on the CPU unless it is capturable or fused.
    opt_state = {k: {kk: vv if kk == "step" else vv.to(device)
                     for kk, vv in s.items()}
                 for k, s in ck["opt_state"].items()}
    return TrainState(params, opt_state)


def fit_vertices(
    vertices,
    faces,
    camera: Camera,
    sun,
    target,
    config: Optional[RenderConfig] = None,
    steps: int = 100,
    learning_rate: float = 1e-3,
    optimize_camera: bool = False,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    refit: bool = True,
    device=None,
):
    """Gradient-descend vertex positions (and, with ``optimize_camera``,
    the camera's eye and direction) with Adam to match ``target``.
    Returns (final params dict, loss history list).

    Runs on ``device``: by default the device of ``vertices`` if it is a
    tensor, else the card, and it raises without one (``device="cpu"``
    fits on the CPU), as ``render()`` does; over a ``mesh`` of ranks, on
    the mesh's device, each rank rendering its rows. The caller's arrays
    are not changed.

    With ``checkpoint_dir``, parameters, Adam's state and the step are
    saved (``torch.save``) every ``checkpoint_every`` steps and at the
    last step, keeping the newest two, and the fit resumes from the
    newest one; ``steps`` counts the restored steps too. Over a mesh rank
    0 writes them and every rank restores rank 0's newest.

    ``refit=True`` on the megakernel backend builds the treelet cut once
    from the initial vertices and refits it every step (``clusters0`` of
    :func:`make_train_step`), on every rank of a mesh alike; with
    ``refit=False`` every step builds it anew. Without a mesh the step
    runs on the card as a CUDA graph, refitted or rebuilt, with a
    capturable Adam.
    """
    device = (mesh.device if mesh is not None
              else resolve_device(vertices, device, "fit_vertices"))
    config = config or RenderConfig(width=target.shape[1],
                                    height=target.shape[0])
    faces = torch.as_tensor(faces, device=device)
    sun = torch.as_tensor(sun, dtype=torch.float32, device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    camera = Camera.make(camera.eye, camera.dir, camera.up, camera.fov,
                         device=device)
    v0 = torch.as_tensor(vertices, device=device).detach()
    params = {"vertices": v0.clone()}
    if optimize_camera:
        params["eye"] = camera.eye.clone()
        params["dir"] = camera.dir.clone()
    state = TrainState({k: v.requires_grad_() for k, v in params.items()},
                       {k: {} for k in params})
    writer = mesh is None or mesh.rank == 0
    start = 0
    if checkpoint_dir is not None:
        if writer:
            os.makedirs(checkpoint_dir, exist_ok=True)
        latest = _agreed(_latest(checkpoint_dir) if writer else None, mesh)
        if latest is not None:
            state = _restore(checkpoint_dir, latest, device)
            start = latest

    # From the initial vertices also on resume, so a resumed fit walks
    # the same cut as an uninterrupted one.
    clusters0 = None
    if refit and config.backend == "megakernel":
        clusters0 = build_clusters_treelet(
            triangle_soup(v0, faces, with_normals=False))
    optimizer = torch.optim.Adam(state.params.values(), lr=learning_rate,
                                 capturable=_captured(config, mesh, device))
    step = make_train_step(faces, camera, sun, config, optimizer, mesh=mesh,
                           clusters0=clusters0)
    history = []
    for i in range(start, steps):
        state, loss = step(state, target)
        history.append(float(loss))
        if checkpoint_dir is not None and (
                (i + 1) % checkpoint_every == 0 or i + 1 == steps):
            if writer:
                _save(checkpoint_dir, i + 1, state)
            # Every rank leaves the fit once rank 0's checkpoint is down.
            _agreed(None, mesh)
    return {k: v.detach() for k, v in state.params.items()}, history


def _agreed(step: Optional[int], mesh) -> Optional[int]:
    """Rank 0's ``step`` (None: no checkpoint) on every rank of ``mesh``,
    by a broadcast that also makes the ranks wait for rank 0; ``step``
    itself without a mesh or its process group."""
    if mesh is None or mesh.group is None:
        return step
    import torch.distributed as dist

    x = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                     device=mesh.device)
    dist.broadcast(x, src=0, group=mesh.group)
    return None if int(x) < 0 else int(x)

"""The one generator of the benchmark's traffic: it reads a traffic
mix's parameters and drives the port (``ceres_tpu_torch``) through its
public entry points. Every loop is closed: one frame or step in flight,
each synchronised before the next, as a frame loop or a fit issues them.

Traffic kinds (the ``kind`` of a traffic file):

  * ``frames`` with ``geometry`` ``static``: the scene's cut and winner
    table are built in set-up (``cut`` of the configuration: ``sweep``,
    the host SweepSAH cut, or ``treelet``, the device LBVH cut) and the
    frame is captured by ``render_graph(..., clusters, table_cols)``;
    frame i hands the graph sun i of ``scene.sun_path``: ``bench.py``'s
    path of ``sun_path`` suns ``sun_step`` apart, in a seeded order.
  * ``frames`` with ``geometry`` ``deforming``: ``render_graph`` without a
    cut, so that the treelet cut and winner table are built in each
    frame; frame i hands it mesh i mod ``pool`` of a pool of moved meshes
    made on the card in set-up (seeded normal noise of ``noise`` times
    the mesh's extent).
  * ``fit``: ``make_train_step`` with ``clusters0`` (the treelet cut of
    the unmoved mesh, refitted in each step) and a capturable
    ``torch.optim.Adam`` at ``lr`` over the vertices and the eye, from
    the mesh moved by seeded noise of ``noise`` times its extent,
    against the reference's frame of the unmoved mesh. The first
    ``held_steps`` steps are taken in set-up through the same step (its
    first call captures it); the loss is read after every step.

Any other kind is a file of its own, ``raybench/kinds/<kind>.py``, whose
``Loop`` the harness finds by the name (``kind``); such a loop may also
name what its calls return (``returns``), check its own outputs
(``check``) and run over several ranks (``ranks``), as ``harness.py``
says.

The inputs (mesh, camera, suns, moved meshes, target) are the
harness's own (``scene.py``, ``reference.py``) and the same are handed
to the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from raybench import manifest, reference, scene


def _port():
    import ceres_tpu_torch as ct

    return ct


class Scene:
    """The configuration's mesh, camera and sun, as the harness makes
    them, on the host and on ``dev``."""

    def __init__(self, cfg: dict, root: str, dev):
        self.v, self.f = scene.mesh(cfg, root)
        self.cam = scene.camera(cfg, self.v)
        self.width, self.height = cfg["width"], cfg["height"]
        self.vt = torch.as_tensor(self.v, device=dev)
        self.ft = torch.as_tensor(self.f, device=dev)
        ct = _port()
        self.camera = ct.Camera.make(self.cam["eye"], self.cam["dir"],
                                     self.cam["up"], self.cam["fov"],
                                     device=dev)
        self.sun_t = torch.as_tensor(np.asarray(cfg["sun"], np.float32),
                                     device=dev)
        self.config = ct.RenderConfig(width=self.width, height=self.height,
                                      mode=cfg["mode"], shadows=True,
                                      backend="megakernel")


def _cut(kind: str, soup):
    if kind == "sweep":
        from ceres_tpu_torch.accel.cuts import build_clusters_quality

        return build_clusters_quality(soup, builder="sweep")
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet

    return build_clusters_treelet(soup)


class Frames:
    """A frame loop (``kind`` ``frames``). ``call(i)`` replays frame i
    and returns the graph's (image, stats); ``inputs(i)`` is what the
    reference takes for frame i: (vertices, sun)."""

    reference_s = 0.0

    def __init__(self, cfg: dict, traffic: dict, seed: int, root: str, dev,
                 mark=print):
        from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                     render_graph)

        ct = _port()
        sc = self.scene = Scene(cfg, root, dev)
        mark("mesh and camera")
        self.static = traffic["geometry"] == "static"
        if self.static:
            self.cs = _cut(cfg["cut"],
                           ct.triangle_soup(sc.vt, sc.ft, with_normals=False))
            self.table = prepare_winner_table(ct.triangle_soup(sc.vt, sc.ft),
                                              self.cs, sc.config)
            self.suns = scene.sun_path(cfg, traffic, seed, dev)
            mark(f"{cfg['cut']} cut and winner table")
            self.graph = render_graph(sc.vt, sc.ft, sc.camera, sc.sun_t,
                                      sc.config, self.cs, self.table)
        else:
            self.pool = scene.noise_pool(sc.vt, traffic["noise"],
                                         traffic["pool"], seed)
            mark("moved meshes")
            self.graph = render_graph(sc.vt, sc.ft, sc.camera, sc.sun_t,
                                      sc.config)
        mark("frame captured (its warm-up frame included)")

    def call(self, i: int):
        if self.static:
            return self.graph(sun_position=self.suns[i % len(self.suns)])
        return self.graph(vertices=self.pool[i % len(self.pool)])

    launch = call

    def eager(self, i: int):
        """Frame i through ``render_pipeline``, op by op."""
        ct, sc = _port(), self.scene
        if self.static:
            return ct.render_pipeline(sc.vt, sc.ft, sc.camera,
                                      self.suns[i % len(self.suns)],
                                      sc.config, clusters=self.cs,
                                      table_cols=self.table)
        return ct.render_pipeline(self.pool[i % len(self.pool)], sc.ft,
                                  sc.camera, sc.sun_t, sc.config)

    def inputs(self, i: int):
        if self.static:
            return self.scene.vt, self.suns[i % len(self.suns)]
        return self.pool[i % len(self.pool)], self.scene.sun_t

    def free(self):
        for name in ("graph", "cs", "table"):
            self.__dict__.pop(name, None)


class Fit:
    """The inverse-rendering fit (``kind`` ``fit``). ``call(i)`` takes a
    step and returns its loss, read on the host; ``held`` holds what the
    first ``held_steps`` steps left: their losses, the first gradient
    as Adam got it (its first moment after one step over 1 - beta1), the
    last step's gradient, which a replay computed ((m_n - beta1 m_(n-1))
    / (1 - beta1) of the first moments after the last two steps), and
    the parameters after the last of them. ``reference_s``: the seconds
    that the reference's target frame took in set-up, which ``setup_s``
    leaves out."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, root: str, dev,
                 mark=print):
        from ceres_tpu_torch.accel.clusters import build_clusters_treelet
        from ceres_tpu_torch.diff import TrainState, inverse

        ct = _port()
        sc = self.scene = Scene(cfg, root, dev)
        mark("mesh and camera")
        self.lr = traffic["lr"]
        self.betas = (0.9, 0.999)
        t0 = time.perf_counter()
        self.target = reference.frame(
            sc.vt, sc.ft.long(), sc.vt.new_tensor(sc.cam["eye"]), sc.cam,
            sc.sun_t, sc.width, sc.height)[0].detach()
        mark("the reference's target frame")
        self.reference_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.start = {"vertices": scene.noise_pool(sc.vt, traffic["noise"],
                                                   1, seed)[0],
                      "eye": sc.camera.eye.detach().clone()}
        self.cs0 = build_clusters_treelet(
            ct.triangle_soup(sc.vt, sc.ft, with_normals=False))
        params = {k: x.clone().requires_grad_() for k, x in self.start.items()}
        opt = torch.optim.Adam(params.values(), lr=self.lr, betas=self.betas,
                               capturable=dev.type == "cuda")
        self.step = inverse.make_train_step(sc.ft, sc.camera, sc.sun_t,
                                            sc.config, opt,
                                            clusters0=self.cs0)
        self.state = TrainState(params, {k: {} for k in params})
        mark("treelet cut and the step")
        losses, moments = [], []
        for i in range(traffic["held_steps"]):
            losses.append(self.call(i))
            mark(f"step {i + 1}" + (" (captured)" if i == 0 else ""))
            moments.append({k: st["exp_avg"].detach().clone()
                            if "exp_avg" in st else torch.zeros_like(params[k])
                            for k, st in self.state.opt_state.items()})
        b1 = self.betas[0]
        before = ({k: torch.zeros_like(m) for k, m in moments[0].items()},
                  *moments)[-2]
        first = {k: m / (1 - b1) for k, m in moments[0].items()}
        last = {k: (m - b1 * before[k]) / (1 - b1)
                for k, m in moments[-1].items()}
        self.held = {"losses": losses, "first": first, "last": last,
                     "params": {k: x.detach().clone()
                                for k, x in self.state.params.items()}}

    def call(self, i: int) -> float:
        return float(self.launch(i))

    def launch(self, i: int):
        """A step, its loss left on the card."""
        self.state, loss = self.step(self.state, self.target)
        return loss

    def forward(self):
        """The step's frame and loss under ``torch.no_grad()``: the
        refitted cut, ``render_pipeline`` and ``image_loss``."""
        from ceres_tpu_torch.accel.clusters import refit_clusters
        from ceres_tpu_torch.diff import inverse

        ct, sc = _port(), self.scene
        p = self.state.params
        with torch.no_grad():
            cam = ct.Camera(eye=p["eye"], dir=sc.camera.dir, up=sc.camera.up,
                            fov=sc.camera.fov)
            cs = refit_clusters(self.cs0, ct.triangle_soup(
                p["vertices"], sc.ft, with_normals=False))
            image, _ = ct.render_pipeline(p["vertices"], sc.ft, cam,
                                          sc.sun_t, sc.config, clusters=cs)
            return inverse.image_loss(image, self.target)

    def free(self):
        for name in ("step", "state", "cs0"):
            self.__dict__.pop(name, None)


KINDS = {"frames": Frames, "fit": Fit}


def kind(root: str, name: str):
    """The module of the traffic kind ``name`` found by file,
    ``raybench/kinds/<name>.py`` under ``root``: its loop class is
    ``Loop``."""
    return manifest.module(root, "kinds", name)


def make(cfg: dict, traffic: dict, seed: int, root: str, dev, mark=print,
         chips: int = 1):
    """The loop of ``traffic``'s kind, set up; ``mark(label)`` is called
    as each part of the set-up ends. A kind that is not in KINDS is
    found by file (``kind``) and its loop also takes the cell's
    ``chips``."""
    name = traffic["kind"]
    if name in KINDS:
        return KINDS[name](cfg, traffic, seed, root, dev, mark)
    return kind(root, name).Loop(cfg, traffic, seed, root, dev, mark,
                                 chips=chips)

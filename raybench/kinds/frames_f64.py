"""Traffic kind ``frames_f64``: a static scene's float64-exact frames, the
upstream renderer's ``-d`` guarantee (``include/anim.cpp`` with ``Scalar =
double``: the search and the shading in float64), as the port keeps it
with ``RenderConfig(f64_exact=True)`` (the render CLI's ``--d-exact``).

The mix of ``static`` (``loops.Frames``): the configuration's mesh,
camera and sun taken to float64 (the benchmark makes them in float32, so
both sides get the same values), the device treelet cut and winner table
built in float64 once in set-up, and the frame captured by
``render_graph(..., f64_exact=True)`` alone, with no eager fallback (a
port that cannot capture it fails the set-up at once); frame i on sun i
of ``scene.sun_path`` (taken to float64) in a seeded order, one frame in
flight.

The harness's frame readers (``rays_per_s``, ``frame_ms_p95``,
``device_idle_pct.frame``) read a cell only where its traffic's ``kind``
is the built-in ``frames``. This loop is such a frame loop in all they
read (the window's rays and latencies, ``launch``), so once its graph is
captured it names the cell's mix ``frames`` (``FRAMES``); the span
readers of this kind name it back while ``raybench/spans.py`` makes its
second loop (``span_ms``), which must be this kind's. Every float64
reader first asks ``own(ctx)``, which raises unless the cell's loop is
this kind's, so the renamed mix is never read as another kind's.

``check(window)`` frees the port's state and holds the compared frames
(one drawn from the seed among the window's first ``draw_from`` and the
last) to the float64 reference (``reference_f64.frame``): ``px_off_pct``
(pixels whose colour is off by more than PX_TOL in a channel, %),
``rays_gap`` and ``hits_gap``, the worst of the frames. ``control(spec,
seed, root, dev)`` gives ``control.py`` the readings of two controls on
the frame a run draws first: the reference computed in float32 in the
port's place (``control``), and the port's own ``-d`` search, float32
with the winners recomputed in float64 (``d_search``).
"""

from __future__ import annotations

import random

import torch

from raybench import loops, reference_f64, scene
from raybench import spans as bench_spans

KIND = "frames_f64"
FRAMES = "frames"
# A float64 frame's colours agree with the reference's to ~1e-14 where
# both find the same surfaces (4.4e-15 at most on the bunny at 128 x 96 on
# the CPU); float32 rounds them by ~1e-7.
PX_TOL = 1e-9


def _f64_config(cfg, exact=True):
    import ceres_tpu_torch as ct

    return ct.RenderConfig(width=cfg["width"], height=cfg["height"],
                           mode=cfg["mode"], shadows=cfg["shadows"],
                           backend=cfg["backend"], f64_exact=exact)


def _f64_scene(sc, cut: str):
    """The scene ``sc`` (a ``loops.Scene``) in float64: (vertices,
    camera, its ``cut`` built in float64)."""
    import ceres_tpu_torch as ct

    v64, c = sc.vt.to(torch.float64), sc.cam
    camera = ct.Camera.make(c["eye"], c["dir"], c["up"], c["fov"],
                            dtype=torch.float64, device=sc.vt.device)
    return v64, camera, loops._cut(cut, ct.triangle_soup(
        v64, sc.ft, with_normals=False))


class Loop(loops.Frames):
    """The float64-exact frame loop. ``call(i)`` replays frame i and
    returns the graph's (image, stats); ``inputs(i)`` is what the
    reference takes for frame i: (float64 vertices, float64 sun)."""

    returns = "frames"
    kind = KIND

    def __init__(self, cfg: dict, traffic: dict, seed: int, root: str, dev,
                 mark=print, chips: int = 1):
        import ceres_tpu_torch as ct
        from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                     render_graph)

        if cfg.get("precision") != "float64" or not cfg.get("f64_exact"):
            raise ValueError(f"{KIND}: the configuration must ask for "
                             f"float64 and f64_exact")
        sc = self.scene = loops.Scene(cfg, root, dev)
        mark("mesh and camera")
        self.static = True
        self.config = _f64_config(cfg)
        self.v64, self.camera, self.cs = _f64_scene(sc, cfg["cut"])
        self.table = prepare_winner_table(ct.triangle_soup(self.v64, sc.ft),
                                          self.cs, self.config)
        self.suns = scene.sun_path(cfg, traffic, seed, dev).to(torch.float64)
        mark(f"float64 {cfg['cut']} cut and winner table")
        self.graph = render_graph(self.v64, sc.ft, self.camera,
                                  self.suns[0], self.config, self.cs,
                                  self.table)
        mark("float64-exact frame captured (its warm-up frame included)")
        traffic["kind"] = FRAMES

    def eager(self, i: int):
        """Frame i through ``render_pipeline``, op by op."""
        import ceres_tpu_torch as ct

        return ct.render_pipeline(self.v64, self.scene.ft, self.camera,
                                  self.suns[i % len(self.suns)], self.config,
                                  clusters=self.cs, table_cols=self.table)

    def inputs(self, i: int):
        return self.v64, self.suns[i % len(self.suns)]

    def check(self, window) -> dict:
        kept = [(img, st, *self.inputs(window["first"] + i))
                for i, (img, st) in sorted(window.pop("kept").items())]
        sc = self.scene
        self.free()
        if sc.vt.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        return numbers(kept, sc)


def frame_numbers(image, stats, ref_image, ref_stats) -> dict:
    """``compare.frame_numbers`` with PX_TOL."""
    d = (image.double() - ref_image.double()).abs().amax(-1)
    return {"px_off_pct": 100.0 * float((d > PX_TOL).double().mean()),
            "rays_gap": abs(int(stats["rays"]) - ref_stats["rays"])
            / ref_stats["rays"],
            "hits_gap": abs(int(stats["hits"]) - ref_stats["hits"])
            / max(ref_stats["hits"], 1)}


def numbers(kept, sc) -> dict:
    """The worst of ``frame_numbers`` over ``kept`` [(image, stats,
    vertices, sun)] against the float64 reference."""
    faces = torch.as_tensor(sc.f, device=sc.vt.device).long()
    eye = torch.as_tensor(sc.cam["eye"], device=sc.vt.device)
    out = {}
    for image, stats, vertices, sun in kept:
        ref_image, ref_stats = reference_f64.frame(
            vertices, faces, eye, sc.cam, sun, sc.width, sc.height)
        for k, x in frame_numbers(image, stats, ref_image,
                                  ref_stats).items():
            out[k] = max(out.get(k, x), x)
        del ref_image
    return out


def control(spec, seed, root, dev) -> dict:
    """The controls' readings on the frame a run of ``seed`` draws first:
    the float32 reference in the port's place, and the port's ``-d``
    search (float32, winners recomputed in float64) on the same float64
    cut and winner table."""
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.render.renderer import prepare_winner_table

    cfg, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    sc = loops.Scene(cfg, root, dev)
    k = random.Random(seed).randrange(cell["draw_from"])
    v64 = sc.vt.to(torch.float64)
    sun = scene.sun_path(cfg, traffic, seed, dev).to(torch.float64)[k]
    faces = torch.as_tensor(sc.f, device=dev).long()
    eye = torch.as_tensor(sc.cam["eye"], device=dev)
    out = {}
    ref = reference_f64.frame(v64, faces, eye, sc.cam, sun, sc.width,
                              sc.height)
    f32 = reference_f64.frame(v64, faces, eye, sc.cam, sun, sc.width,
                              sc.height, torch.float32)
    out["control"] = frame_numbers(*f32, *ref)
    del f32
    v64, camera, cs = _f64_scene(sc, cfg["cut"])
    config = _f64_config(cfg, exact=False)
    table = prepare_winner_table(ct.triangle_soup(v64, sc.ft), cs, config)
    image, stats = ct.render_pipeline(v64, sc.ft, camera, sun, config,
                                      clusters=cs, table_cols=table)
    out["d_search"] = frame_numbers(image, stats, *ref)
    return out


def own(ctx) -> None:
    """Raise unless ``ctx``'s loop is this kind's, its mix renamed
    ``frames`` by it."""
    kind = getattr(ctx.loop, "kind", None)
    if kind != KIND or ctx.cell["traffic"]["kind"] != FRAMES:
        raise ValueError(f"{KIND}: a float64 reader on a {kind!r} loop of "
                         f"the mix {ctx.cell['traffic']['kind']!r}")


def span_ms(ctx, name: str):
    """The median over the spanned frames of the spans ``name`` a frame
    (``raybench/spans.py``), with this kind's loop as the second loop;
    None where a frame has none."""
    own(ctx)
    traffic = ctx.cell["traffic"]
    was = traffic["kind"]
    traffic["kind"] = KIND
    try:
        return bench_spans.median_of(
            ctx, lambda ms: ms[name]["total"] if name in ms else None)
    finally:
        traffic["kind"] = was

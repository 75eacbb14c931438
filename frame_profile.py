"""Where one frame's, or one train step's, device time goes, on one
NVIDIA card.

    python3 frame_profile.py [--scene bunny4] [--compat] [--frames 3]
    python3 frame_profile.py --step [--frames 3]
    python3 frame_profile.py --regrouped [--scene bunny4] [--frames 3]
    python3 frame_profile.py --graph [--scene bunny] [--frames 3]
    python3 frame_profile.py --graph --step [--rebuild] [--frames 3]
    python3 frame_profile.py --spans [--scene bunny4] [--step] [--frames 3]

Renders ``chip_smoke.py``'s frame of the scene (``bunny``: bunny.obj on
the SweepSAH cut; ``bunny3``/``bunny4``: the 3x/4x subdivided bunny on
the device treelet cut; 1920 x 1080, the sun and camera of ``bench.py``;
``--compat``: reference-exact) through ``render_pipeline`` with a
prebuilt cut and winner table, as a frame loop would. ``--step`` runs
``chip_smoke.py``'s train steps instead: phase 12's bunny frame's
forward and backward pass (config 4b: gradients w.r.t. the vertices and
the eye), with the treelet cut built inside the step, then refitted;
after one untraced step of each and before their traces, phase 13's
``fit_vertices`` call, the process's first fit, under ``cProfile`` (its host seconds, those of a second call, and the
functions that took the first call's time); then the step of that fit
(bunny preset at 512 x 512, refitted cut, an Adam step and the loss
read). ``--regrouped`` traces the scene's shadow wavefront regrouped by
receiver instead (``chip_smoke.py`` phase 20's call,
``any_hit_to_point(regroup=True)`` on the frame's receiving points), the
whole call and then its walk alone on the call's inputs: the split
walk's kernels (its first segments, then, where a key row is longer than
a segment, the list of tiles with later ones and those, and the replay;
on the bunny, K2-128). ``--graph`` traces the scene's frame eagerly and
then replayed as a CUDA graph (``render_graph``, ``chip_smoke.py`` phase
22's), then config 4b's refitted train step eagerly and replayed
(``make_train_step`` on the card; phase 22's ``refit_steps``);
``--graph --step`` traces only the steps, and with ``--rebuild`` the
step that builds its cut (phase 23's), after the treelet build alone,
eager and replayed (``build_clusters_treelet`` of the bunny in a CUDA
graph), which gives the build's share of the replayed step.
``--spans`` is the operator's view of the port's spans
(``ceres_tpu_torch.utils.spans``): the scene's static frame (or with
``--step`` config 4b's refitted train step) captured as a CUDA graph
with spans on, replayed and traced; it prints the last replay's device
ms by span from the stamps (total and self), the trace's idle gaps, each
named by the innermost ``ceres.*`` host span over it, and the offset
between each stamp's global-timer value and the start of its stamp
kernel in the trace, which stays within 5 us over a replay when the
stamps and the trace read one clock.
Prints the card's name
and power limit, ms/frame (median of CUDA events over the frames), then
from a ``torch.profiler`` trace of the same number of frames: device
time per frame (the sum of the kernels', copies' and fills' durations),
device operations per frame, the busy share (the union of their
intervals over the traced span), and the largest kernels by device time
per frame, the walk kernels among them. For the default frame also the
CUDA-event time of building each walk's inputs (weights, root-exit caps
and the culling prepass: slab tests of every tile against every block or
super, and the key sort), the layer under the kernels.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from raybench.trace import record as trace_record  # noqa: E402
from raybench.trace import union as _union  # noqa: E402

STAMP_KERNEL = "ceres_span_stamp_kernel"
# Most a stamp's offset from its kernel's start in the trace may move over
# a replay, in us, for the two to read one clock.
ONE_CLOCK_US = 5.0


def walk_input_times(vt, ft, cam, cs, sun):
    """CUDA-event ms of building the closest and the shadow walk's inputs
    of the default frame, as ``render_pipeline`` builds them."""
    import chip_smoke as smoke
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.models.camera import camera_ray_columns
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.render import renderer
    from ceres_tpu_torch.utils import tiling

    soup = ct.triangle_soup(vt, ft, with_normals=True)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, smoke.W, smoke.H))
    hit, pay = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                            normal_cols=True)
    points = renderer._hit_points(cam.eye, dirs, hit, pay)
    return (smoke.cuda_ms(lambda: mk._closest_inputs(cs, cam.eye, dirs), 5),
            smoke.cuda_ms(lambda: mk._any_dest_inputs(cs, sun, points,
                                                      ~hit.mask), 5))


def profile(frame, n, label, card, top=8):
    """ms/frame of n calls of frame(i), then a trace of n more: device
    time, operations, busy share and the largest kernels, per frame."""
    import chip_smoke as smoke

    times, _ = smoke.frame_times(frame, n)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            frame(i)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in ops]
    device_ms = sum(b - a for a, b in spans) / 1e3 / n
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    by_name = collections.Counter()
    for e in ops:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / n
    walk_ms = sum(t for k, t in by_name.items()
                  if "walk_" in k or "split_" in k)
    print(card, flush=True)
    print(f"{label}: ms/frame median {statistics.median(times):.3f} (min "
          f"{min(times):.3f} max {max(times):.3f}); device {device_ms:.3f} "
          f"ms/frame in {len(ops) / n:.0f} operations, busy "
          f"{_union(spans) / 1e3 / span_ms:.1%} of {span_ms / n:.3f} ms per "
          f"traced frame; walk kernels {walk_ms:.3f} ms "
          f"({walk_ms / device_ms:.1%}) [{card}]", flush=True)
    for name, t in by_name.most_common(top):
        print(f"  {t:9.3f} ms/frame  {name[:110]}", flush=True)


def first_fit(dev, card, top=15):
    """Host seconds of ``chip_smoke.py`` phase 13's ``fit_vertices`` call,
    the first in the process and again, and the functions that took the
    first call's time (cumulative, from ``cProfile``)."""
    import cProfile
    import io
    import pstats
    import time

    import chip_smoke as smoke
    from ceres_tpu_torch.diff import fit_vertices

    sc, config, target, noisy = smoke.fit_problem(dev)
    prof, walls = cProfile.Profile(), []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            prof.enable()
        fit_vertices(noisy, sc.faces, sc.camera, sc.sun, target,
                     config=config, steps=smoke.FIT_STEPS, learning_rate=2e-4,
                     refit=True, device=dev)
        torch.cuda.synchronize()
        prof.disable()
        walls.append(time.perf_counter() - t0)
    print(f"fit_vertices, bunny preset {smoke.FIT_SIZE}x{smoke.FIT_SIZE}, "
          f"{smoke.FIT_STEPS} steps: first call {walls[0]:.3f} s (under "
          f"cProfile), second {walls[1]:.3f} s [{card}]", flush=True)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(top)
    for line in out.getvalue().splitlines():
        if line.strip():
            print(f"  {line[:160]}", flush=True)


def regrouped(vt, ft, cam, cs, args, card):
    """Trace the scene's regrouped shadow call and its walk alone."""
    import chip_smoke as smoke
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.ops import megakernel as mk
    from ceres_tpu_torch.ops import walk

    soup = ct.triangle_soup(vt, ft, with_normals=False)
    _, sun, points, skip = smoke.shadow_wavefront(vt, ft, cam, cs, smoke.W,
                                                  smoke.H)
    label = f"{args.scene} {smoke.W}x{smoke.H} regrouped shadow call"
    profile(lambda i: mk.any_hit_to_point(soup, sun, points, skip=skip,
                                          clusters=cs, regroup=True),
            args.frames, label, card)
    wargs, opts = smoke.regrouped_inputs(cs, sun, points, skip)
    name = walk._variant("any_dest", opts["S"], opts["stream"], 128)
    profile(lambda i: walk.walk_any_dest(*wargs, **opts), args.frames,
            f"{label}: its walk alone ({name})", card)


def graphs(vt, ft, cam, cs, sun, args, card):
    """Trace the frame and the config 4b refitted step, each eager and
    replayed as a CUDA graph."""
    import chip_smoke as smoke
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                 render_graph)

    config = ct.RenderConfig(width=smoke.W, height=smoke.H,
                             backend="megakernel")
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    fg = render_graph(vt, ft, cam, sun, config, cs, table)
    label = f"{args.scene} {smoke.W}x{smoke.H}"
    profile(lambda i: ct.render_pipeline(vt, ft, cam, sun + i * 1e-3, config,
                                         clusters=cs, table_cols=table),
            args.frames, f"{label} frame, eager", card)
    profile(lambda i: fg(sun_position=sun + i * 1e-3), args.frames,
            f"{label} frame, CUDA graph replayed", card)
    del fg
    graph_steps(vt.device, args, card)


def graph_steps(dev, args, card):
    """Trace config 4b's train step (refitted, or with ``--rebuild`` its
    cut built in the step, after the build alone), eager and replayed as
    a CUDA graph."""
    import chip_smoke as smoke
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.utils.graphs import capture

    v, f = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    cam = smoke.camera(v, smoke.EYE, dev)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    soup = ct.triangle_soup(vt, ft, with_normals=False)
    cs0 = None
    if args.rebuild:
        g = capture(lambda: build_clusters_treelet(soup), (vt,))
        for name, fn in (("eager", lambda i: build_clusters_treelet(soup)),
                         ("CUDA graph replayed", lambda i: g.replay())):
            profile(fn, args.frames, f"bunny treelet build ({ft.shape[0]} "
                    f"triangles), {name}", card, top=12)
        del g
    else:
        cs0 = build_clusters_treelet(soup)
    steps, _ = smoke.refit_steps(vt, ft, cam, cs0, eye=True)
    cut = "rebuilt" if args.rebuild else "refitted"
    for name, (one, _) in steps.items():
        profile(one, args.frames, f"bunny {smoke.W}x{smoke.H} config 4b "
                f"{cut} train step, "
                f"{'eager' if name == 'eager' else 'CUDA graph replayed'}",
                card, top=16)


def span_view(run, n, label, card, spanned):
    """Replay ``run(i)`` n times, trace n more (``raybench.trace``), and
    print the last replay's spans from its stamps (``spanned.record``:
    the span record of a frame graph or a train step, captured with
    spans on), the trace's idle gaps
    named by the innermost ``ceres.*`` host span, and each stamp's clock
    offset from its kernel's start in the trace."""
    for i in range(n):
        run(i)
    torch.cuda.synchronize()
    tr = trace_record(run, n)
    rec = spanned.record
    print(f"{label}: device ms of the last replay by span, from its "
          f"{rec.stamps} stamps [{card}]", flush=True)
    for name, row in rec.span_ms().items():
        print(f"  {name:16s} total {row['total']:10.4f}  self "
              f"{row['self']:10.4f}", flush=True)
    named = dataclasses.replace(
        tr, host=[h for h in tr.host if h[0].startswith("ceres.")])
    print(f"{label}: idle gaps of {n} traced replays (busy "
          f"{tr.busy_s / tr.window_s:.1%} of {tr.window_s * 1e3:.3f} ms), "
          f"by the innermost ceres.* host span", flush=True)
    for name, s in named.idle_gaps():
        print(f"  {s * 1e3:9.4f} ms  {name}", flush=True)
    starts = sorted(a for name, a, _ in tr.device if STAMP_KERNEL in name)
    times = rec.times_ns()
    if len(starts) < len(times):
        print(f"{label}: the trace shows {len(starts)} stamp kernels, "
              f"fewer than a replay's {len(times)}", flush=True)
        return
    offsets = [t / 1e3 - a for t, a in zip(times, starts[-len(times):])]
    spread = max(offsets) - min(offsets)
    print(f"{label}: stamp clock - its kernel's start in the trace "
          f"{min(offsets):.3f} .. {max(offsets):.3f} us over {len(offsets)} "
          f"stamps, spread {spread:.3f} us: "
          f"{'one clock' if spread <= ONE_CLOCK_US else 'NOT one clock'} "
          f"(limit {ONE_CLOCK_US} us)", flush=True)


def span_step(dev, n, card):
    """Config 4b's refitted train step at 1080p (the bunny, its treelet
    cut refitted, a capturable Adam over the vertices and the eye, the
    unmoved frame as target) captured with spans on, in ``span_view``."""
    import chip_smoke as smoke
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.diff import TrainState, inverse

    v, f = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    cam = smoke.camera(v, smoke.EYE, dev)
    vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
    sun = torch.as_tensor(smoke.SUN, device=dev)
    config = ct.RenderConfig(width=smoke.W, height=smoke.H,
                             backend="megakernel")
    cs0 = build_clusters_treelet(ct.triangle_soup(vt, ft,
                                                  with_normals=False))
    target, _ = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs0)
    params = {"vertices": (vt + 1e-4).requires_grad_(),
              "eye": cam.eye.detach().clone().requires_grad_()}
    opt = torch.optim.Adam(params.values(), lr=1e-5, capturable=True)
    step = inverse.make_train_step(ft, cam, sun, config, opt, clusters0=cs0)
    state = [TrainState(params, {k: {} for k in params})]

    def one(i):
        state[0], loss = step(state[0], target)
        return loss

    one(0)
    span_view(one, n, f"bunny {smoke.W}x{smoke.H} config 4b refitted train "
              f"step, replayed", card, step)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="bunny4",
                    choices=["bunny", "bunny3", "bunny4"])
    ap.add_argument("--compat", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--regrouped", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--rebuild", action="store_true")
    ap.add_argument("--spans", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    if args.rebuild and not (args.graph and args.step):
        ap.error("--rebuild traces the rebuilt step: with --graph --step")
    if not torch.cuda.is_available():
        sys.exit("frame_profile needs an NVIDIA card")
    import chip_smoke as smoke
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.models.mesh import subdivide
    from ceres_tpu_torch.render.renderer import prepare_winner_table

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    sun = torch.as_tensor(smoke.SUN, device=dev)
    if args.spans:
        from ceres_tpu_torch.utils import spans

        spans.enable(True)
    if args.spans and args.step:
        span_step(dev, args.frames, card)
        return
    if args.graph and args.step:
        graph_steps(dev, args, card)
        return
    if args.step:
        v, f = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
        cam = smoke.camera(v, smoke.EYE, dev)
        vt, ft = (torch.as_tensor(v, device=dev),
                  torch.as_tensor(f, device=dev))
        config = ct.RenderConfig(width=smoke.W, height=smoke.H,
                                 backend="megakernel")
        target, _ = ct.render_pipeline(vt, ft, cam, sun, config)
        clusters0 = build_clusters_treelet(
            ct.triangle_soup(vt, ft, with_normals=False))
        steps = {cut: smoke.grad_step(vt, ft, cam, sun, config, target,
                                      cs0)[0]
                 for cut, cs0 in (("built", None), ("refitted", clusters0))}
        # As in chip_smoke.py: config 4b's steps, then the first fit. The
        # fit goes before any trace, as torch.profiler imports modules
        # that the process's first optimizer would otherwise import.
        for step in steps.values():
            step(1)
        first_fit(dev, card)
        for cut, step in steps.items():
            profile(step, args.frames, f"bunny {smoke.W}x{smoke.H} train "
                    f"step (config 4b: forward + backward, treelet cut "
                    f"{cut} in the step)", card, top=16)
        sc, config, target, noisy = smoke.fit_problem(dev)
        step, _, _ = smoke.fit_step(dev, sc, config, target, noisy)
        profile(step, args.frames, f"bunny preset {smoke.FIT_SIZE}x"
                f"{smoke.FIT_SIZE} fit step (config 4: forward + backward, "
                f"refitted cut, Adam)", card, top=16)
        return
    if args.scene == "bunny":
        vt, ft, cam, cs = smoke.scene("bunny", dev)
    else:
        v, f = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
        v, f = subdivide(v, f, int(args.scene[-1]))
        cam = smoke.camera(v, smoke.EYE, dev)
        vt, ft = (torch.as_tensor(v, device=dev),
                  torch.as_tensor(f, device=dev))
        cs = build_clusters_treelet(ct.triangle_soup(vt, ft,
                                                     with_normals=False))
    if args.regrouped:
        regrouped(vt, ft, cam, cs, args, card)
        return
    if args.spans:
        from ceres_tpu_torch.render.renderer import render_graph

        config = ct.RenderConfig(width=smoke.W, height=smoke.H,
                                 backend="megakernel")
        table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
        fg = render_graph(vt, ft, cam, sun, config, cs, table)
        span_view(lambda i: fg(sun_position=sun + i * 1e-3), args.frames,
                  f"{args.scene} {smoke.W}x{smoke.H} frame, CUDA graph "
                  f"replayed", card, fg)
        return
    if args.graph:
        graphs(vt, ft, cam, cs, sun, args, card)
        return
    config = ct.RenderConfig(width=smoke.W, height=smoke.H,
                             backend="megakernel",
                             reference_compat=args.compat)
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)

    def frame(i):
        return ct.render_pipeline(vt, ft, cam, sun + i * 1e-3, config,
                                  clusters=cs, table_cols=table)

    label = (f"{args.scene}{' reference-exact' if args.compat else ''} "
             f"{smoke.W}x{smoke.H}")
    profile(frame, args.frames, label, card)
    if not args.compat:
        closest_ms, shadow_ms = walk_input_times(vt, ft, cam, cs, sun)
        print(f"{label}: walk inputs (weights, caps, prepass keys and sort) "
              f"closest {closest_ms:.3f} ms, shadow {shadow_ms:.3f} ms "
              f"[{card}]", flush=True)


if __name__ == "__main__":
    main()

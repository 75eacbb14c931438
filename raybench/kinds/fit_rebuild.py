"""Traffic kind ``fit_rebuild``: the inverse-rendering fit of the built-in
kind ``fit`` (``loops.Fit``) with the cut built in every step.

The mix, the held steps and the check against plain Adam are the fit's;
only the step differs: ``make_train_step`` without ``clusters0``, so every
replay builds the LBVH treelet cut and the winner table of the current
vertices inside the captured step, where ``fit`` refits a cut made in
set-up. ``loops.Fit`` makes its step with ``clusters0``, so this loop
runs that set-up whole with the argument dropped, and its held steps are
the rebuilt step's own.

The harness's fit readers (``step_ms``, ``device_idle_pct.fit``,
``bwd_fwd.fit``), its held steps and ``compare.fit_numbers`` take a cell
only where the traffic's ``kind`` is ``fit``. So once set up this loop
names the cell's mix ``fit``, as ``kinds/frames_f64.py`` names its own
``frames``; its span reader (``span_ms``, for ``build_span_ms.fit``)
names it back while ``raybench/spans.py`` makes its second loop, which
must be a rebuilt step too. Each reader of this kind first asks
``own(ctx)``, which raises unless the cell's loop is this kind's, so a
refitted fit is never read as a rebuilt one.
"""

from __future__ import annotations

import torch

from raybench import loops
from raybench import spans as bench_spans

KIND = "fit_rebuild"
FIT = "fit"


class Loop(loops.Fit):
    """The fit with its cut built in every step. ``call(i)`` takes a step
    and returns its loss, read on the host; ``held``, ``start`` and
    ``target`` as ``loops.Fit``."""

    returns = "fit"
    kind = KIND

    def __init__(self, cfg: dict, traffic: dict, seed: int, root: str, dev,
                 mark=print, chips: int = 1):
        from ceres_tpu_torch.diff import inverse

        make = inverse.make_train_step

        def rebuilt(*args, clusters0, **opts):
            return make(*args, **opts)

        inverse.make_train_step = rebuilt
        try:
            super().__init__(cfg, traffic, seed, root, dev, mark)
        finally:
            inverse.make_train_step = make
        self.cs0 = None
        traffic["kind"] = FIT

    @property
    def graph(self):
        """The step, by the name under which ``raybench/spans.py`` reads
        a loop's span milliseconds (``graph.span_ms()``)."""
        return self.step

    def forward(self):
        """The step's frame and loss under ``torch.no_grad()``: the
        treelet cut and winner table built, ``render_pipeline`` and
        ``image_loss``."""
        import ceres_tpu_torch as ct
        from ceres_tpu_torch.diff import inverse

        sc, p = self.scene, self.state.params
        with torch.no_grad():
            cam = ct.Camera(eye=p["eye"], dir=sc.camera.dir, up=sc.camera.up,
                            fov=sc.camera.fov)
            image, _ = ct.render_pipeline(p["vertices"], sc.ft, cam,
                                          sc.sun_t, sc.config)
            return inverse.image_loss(image, self.target)


def control(spec, seed, root, dev) -> dict:
    """The fit's control readings on ``seed`` (``control.fit_readings``)."""
    from raybench import control as bench_control

    return bench_control.fit_readings(spec, seed, root, dev)


def own(ctx) -> None:
    """Raise unless ``ctx``'s loop is this kind's, its mix renamed ``fit``
    by it."""
    kind = getattr(ctx.loop, "kind", None)
    if kind != KIND or ctx.cell["traffic"]["kind"] != FIT:
        raise ValueError(f"{KIND}: a rebuilt-step reader on a {kind!r} loop "
                         f"of the mix {ctx.cell['traffic']['kind']!r}")


def span_ms(ctx, name: str):
    """The median over the spanned steps of the spans ``name`` a step
    (``raybench/spans.py``), with this kind's loop as the second loop;
    None where a step has none."""
    own(ctx)
    traffic = ctx.cell["traffic"]
    was = traffic["kind"]
    traffic["kind"] = KIND
    try:
        return bench_spans.median_of(
            ctx, lambda ms: ms[name]["total"] if name in ms else None)
    finally:
        traffic["kind"] = was

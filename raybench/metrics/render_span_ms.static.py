"""render_span_ms.static: device milliseconds a frame in the port's
``frame`` span less its ``walk`` and ``build`` spans (the column math,
prepass, gathers and shading, with the gaps between their kernels), the
median over as many spanned frames as the trace took
(``raybench/spans.py``). Layer: the renderer and its hit search. Moves
rays_per_s."""

from raybench import spans

UNIT = "ms"
LAYER = "renderer and hit search"
MOVES = "rays_per_s"


def read(ctx):
    if ctx.cell["traffic"]["kind"] != "frames":
        return None
    return spans.median_of(ctx, lambda ms: (
        spans.total(ms, "frame") - spans.total(ms, "walk")
        - spans.total(ms, "build")) if "frame" in ms else None)

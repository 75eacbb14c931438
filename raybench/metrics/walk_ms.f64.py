"""walk_ms.f64: device milliseconds a frame in the port's ``walk.f64``
spans (stamped inside the replayed graph around each float64-exact
search's walk: the float64 walk kernel), the median over as many
spanned frames as the trace took (``raybench/spans.py``, its second loop
this cell's own kind, ``kinds/frames_f64.py``). None where the port has
no such span. Layer: the kernels. Moves rays_per_s."""

from raybench import loops

UNIT = "ms"
LAYER = "kernels"
MOVES = "rays_per_s"


def read(ctx):
    if not ctx.cell["config"].get("f64_exact"):
        return None
    return loops.kind(ctx.root, "frames_f64").span_ms(ctx, "walk.f64")

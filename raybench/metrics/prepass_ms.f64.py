"""prepass_ms.f64: device milliseconds a frame in the port's
``prepass.f64`` spans (stamped inside the replayed graph around each
float64-exact search's prepass: the float64 slab test of every tile
against every block, the stable sort of each tile's entries, the rays'
caps and the weight planes), the median over as many spanned frames as
the trace took (``raybench/spans.py``, its second loop this cell's own
kind, ``kinds/frames_f64.py``). None where the port has no such span.
Layer: the renderer and its hit search. Moves rays_per_s."""

from raybench import loops

UNIT = "ms"
LAYER = "renderer and hit search"
MOVES = "rays_per_s"


def read(ctx):
    if not ctx.cell["config"].get("f64_exact"):
        return None
    return loops.kind(ctx.root, "frames_f64").span_ms(ctx, "prepass.f64")

"""prepass_ms.flat: device milliseconds a frame in the port's
``prepass.flat`` spans (stamped inside the replayed graph around each
float32 search's prepass where the walk is flat: the slab test of every
tile against every block, the candidate keys, their sort in each tile
and the counts), the median over as many spanned frames as the trace
took (``raybench/spans.py``). None where the port has no such span.
Layer: the renderer and its hit search. Moves rays_per_s."""

from raybench import spans

UNIT = "ms"
LAYER = "renderer and hit search"
MOVES = "rays_per_s"


def prepass_ms(ctx, name: str):
    """The median over the spanned frames of the spans ``name`` a frame,
    or None (not a frame loop, or a frame without them)."""
    if ctx.cell["traffic"]["kind"] != "frames":
        return None
    return spans.median_of(
        ctx, lambda ms: ms[name]["total"] if name in ms else None)


def read(ctx):
    return prepass_ms(ctx, "prepass.flat")

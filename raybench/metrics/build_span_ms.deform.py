"""build_span_ms.deform: device milliseconds a frame in the port's
``build`` spans (the LBVH treelet cut and the winner table, built inside
the replayed frame), the median over as many spanned frames as the trace
took (``raybench/spans.py``). Layer: accel (device). Moves rays_per_s."""

from raybench import spans

UNIT = "ms"
LAYER = "accel (device)"
MOVES = "rays_per_s"


def read(ctx):
    traffic = ctx.cell["traffic"]
    if traffic["kind"] != "frames" or traffic["geometry"] == "static":
        return None
    return spans.median_of(ctx, lambda ms: ms["build"]["total"]
                           if "build" in ms else None)

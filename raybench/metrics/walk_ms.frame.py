"""walk_ms.frame: device milliseconds a frame in the port's ``walk``
spans (stamped inside the replayed graph around each walk entry point's
kernel), the median over as many spanned frames as the trace took
(``raybench/spans.py``). Layer: the kernels. Moves rays_per_s."""

from raybench import spans

UNIT = "ms"
LAYER = "kernels"
MOVES = "rays_per_s"


def read(ctx):
    if ctx.cell["traffic"]["kind"] != "frames":
        return None
    return spans.median_of(ctx, lambda ms: spans.total(ms, "walk"))

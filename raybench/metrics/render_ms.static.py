"""render_ms.static: device milliseconds a frame outside the walk
kernels (the column math, prepass, gathers, shading, copies and
fills), from the trace of the cell's frames. Layer: the renderer and
its hit search. Moves rays_per_s."""

from raybench import manifest

UNIT = "ms"
LAYER = "renderer and hit search"
MOVES = "rays_per_s"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    walks = manifest.metric(ctx.root, "walk_roofline.frame").WALK_KERNELS
    return tr.device_ms_per_call(
        lambda name: not any(k in name for k in walks))

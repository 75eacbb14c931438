"""render_span_ms.bunny: ``render_span_ms.static`` in the cells that
report ``rays_per_s.bunny``, which it moves. Layer: the renderer and its
hit search."""

from raybench import manifest

UNIT = "ms"
LAYER = "renderer and hit search"
MOVES = "rays_per_s.bunny"


def read(ctx):
    return manifest.metric(ctx.root, "render_span_ms.static").read(ctx)

"""prepass_ms.hier: ``prepass_ms.flat`` of the port's ``prepass.hier``
spans (each float32 search's prepass where the walk is two-level: the
super boxes and member table, the tiles' hulls, the slab test of every
tile against every super, the keys, their sort and the counts). None
where the port has no such span. Layer: the renderer and its hit search.
Moves rays_per_s."""

from raybench import manifest

UNIT = "ms"
LAYER = "renderer and hit search"
MOVES = "rays_per_s"


def read(ctx):
    return manifest.metric(ctx.root, "prepass_ms.flat").prepass_ms(
        ctx, "prepass.hier")

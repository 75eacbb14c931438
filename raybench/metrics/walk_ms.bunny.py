"""walk_ms.bunny: ``walk_ms.frame`` in the cells that report
``rays_per_s.bunny``, which it moves. Layer: the kernels."""

from raybench import manifest

UNIT = "ms"
LAYER = "kernels"
MOVES = "rays_per_s.bunny"


def read(ctx):
    return manifest.metric(ctx.root, "walk_ms.frame").read(ctx)

"""build_span_ms.bunny: ``build_span_ms.deform`` (the ``build`` spans of
the replayed frame: the LBVH treelet cut and the winner table built in
it) in the cells that report ``rays_per_s.bunny``, which it moves.
Layer: accel (device)."""

from raybench import manifest

UNIT = "ms"
LAYER = "accel (device)"
MOVES = "rays_per_s.bunny"


def read(ctx):
    return manifest.metric(ctx.root, "build_span_ms.deform").read(ctx)

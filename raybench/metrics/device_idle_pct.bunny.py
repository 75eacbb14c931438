"""device_idle_pct.bunny: ``device_idle_pct.frame`` in the cells that
report ``rays_per_s.bunny``, which it moves. Layer: the device."""

from raybench import manifest

UNIT = "%"
LAYER = "device"
MOVES = "rays_per_s.bunny"


def read(ctx):
    return manifest.metric(ctx.root, "device_idle_pct.frame").read(ctx)

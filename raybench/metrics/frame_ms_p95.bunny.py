"""frame_ms_p95.bunny: ``frame_ms_p95`` of the bunny's static frames,
under a bound of its own, for the reason ``rays_per_s.bunny`` gives."""

from raybench import manifest

UNIT = "ms"


def read(ctx):
    return manifest.metric(ctx.root, "frame_ms_p95").read(ctx)

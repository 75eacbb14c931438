"""rays_per_s.bunny: ``rays_per_s`` of the bunny's static frames, under a
bound of its own. Its frame is ~1,390 short kernels in ~6 ms, so the
card's slow launch mode (``harness.FAST_US_PER_NODE``), which a run
that does not leave it within ``harness.MODE_WAIT_S`` still shows, moves
it ~8%, against 1.5-3.5% in the 4x bunny's frames: its spread would set
their bound otherwise."""

from raybench import manifest

UNIT = "rays/s"


def read(ctx):
    return manifest.metric(ctx.root, "rays_per_s").read(ctx)

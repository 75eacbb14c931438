"""batch_ms_p95.frames4: the 95th percentile of every batch's latency in
the window: host clock, from the call that hands rank 0 the batch (after
the other ranks were told of it) to the end of the synchronise that
makes rank 0's assembled batch and its summed stats ready. Nearest
rank. The batch's end-to-end tail, kept without a bound: slow seconds of
the host, which come in some runs and not in others, set it, and its
spread over runs (6.7% and 31.3% in two sets of 6) is wider than any
bound of at most 25% holds. So it stands among the per-layer metrics,
read in the ``--trace 1`` run from its untraced window, under the layer
"whole batch (unbounded)": all of ``render_frames_sharded`` on every
rank as rank 0 sees it, not a part of it. Moves rays_per_s.frames4."""

import math

UNIT = "ms"
LAYER = "whole batch (unbounded)"
MOVES = "rays_per_s.frames4"


def read(ctx):
    lat = sorted(ctx.window["latencies"])
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]

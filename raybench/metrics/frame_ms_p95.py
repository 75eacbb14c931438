"""frame_ms_p95: the 95th percentile of every frame's latency in the
window: host clock, from the call that hands the frame its sun or its
moved vertices to the end of the synchronise that makes its image
ready. Nearest rank."""

import math

UNIT = "ms"


def read(ctx):
    if ctx.cell["traffic"]["kind"] != "frames":
        return None
    lat = sorted(ctx.window["latencies"])
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]

"""device_idle_pct.fit: the share, in %, of a step's latency in which the
card does not work on it, as ``device_idle_pct.frame``: the CUDA-event
span around the step's replay against the host clock from the call to
the end of the synchronise that makes its loss readable, the median
over as many untraced steps as the trace took. Layer: the device. Moves
step_ms."""

from raybench import trace

UNIT = "%"
LAYER = "device"
MOVES = "step_ms"


def read(ctx):
    if (ctx.trace is None or ctx.dev.type != "cuda"
            or ctx.cell["traffic"]["kind"] != "fit"):
        return None
    return 100.0 * trace.host_share(ctx.loop.launch, ctx.trace.calls)

"""device_idle_pct.frame: the share, in %, of a frame's latency in which
the card does not work on it: 100 (1 - events / latency), the median
over as many untraced frames of the cell's loop as the trace took, with
events the CUDA-event span around the frame's call (the sun or mesh copy
and the graph's replay) and latency the host clock from the call to the
end of its synchronise (``trace.host_share``). The time the card waits on
the host's launch and synchronise, which the graph replay exists to cut.
A ``torch.profiler`` trace cannot give it: the profiler lengthens each
graph launch by milliseconds and the gaps between its kernels too.
Layer: the device, and the graph replay above it. Moves rays_per_s."""

from raybench import trace

UNIT = "%"
LAYER = "device"
MOVES = "rays_per_s"


def read(ctx):
    if (ctx.trace is None or ctx.dev.type != "cuda"
            or ctx.cell["traffic"]["kind"] != "frames"):
        return None
    first = ctx.next_call
    return 100.0 * trace.host_share(lambda i: ctx.loop.launch(first + i),
                                    ctx.trace.calls)

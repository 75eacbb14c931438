"""device_idle_pct.frames4: the share, in %, of the traced batches in
which rank 0's card runs none of the renderer's operations: 100 (1 -
busy / window), both from the ``--trace 1`` run's trace, busy the union
of the intervals of its device operations but NCCL's, window the traced
window (the same batches). The card waits on the host's eager launches
there, its own or, inside an NCCL kernel, the slowest rank's: the
collectives are left out of busy because they spend most of their time
waiting for the slowest band (their ~1 ms transfer of a 99.5 MB batch
too); ``collective_ms.frames4`` gives their part. The trace's own
window: the profiler lengthens each eager launch, so the share reads
higher than in the untraced window. Graphs of the sharded path would
cut it. Layer: the device. Moves rays_per_s.frames4."""

from raybench import trace

UNIT = "%"
LAYER = "device"
MOVES = "rays_per_s.frames4"


def read(ctx):
    if ctx.trace is None or ctx.dev.type != "cuda":
        return None
    busy = trace.union([(a, b) for name, a, b in ctx.trace.clipped_named()
                        if "nccl" not in name.lower()])
    return 100.0 * (1.0 - busy / (ctx.trace.end - ctx.trace.start))

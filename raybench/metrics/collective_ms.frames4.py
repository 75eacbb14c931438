"""collective_ms.frames4: rank 0's device milliseconds a batch in NCCL
kernels, in the ``--trace 1`` run's trace: the union of the intervals of
every device operation whose name holds "nccl" (the kernels, and the
profiler's annotation of each collective on the device's timeline,
which spans its kernel): the all-reduce that assembles the batch's whole
image on every rank, and the one of its stats; each includes the wait
for the slowest rank's rows. None where the trace holds no NCCL kernel
(gloo ranks, one rank, the CPU). Layer: the ranks. Moves
rays_per_s.frames4."""

from raybench import trace

UNIT = "ms"
LAYER = "ranks"
MOVES = "rays_per_s.frames4"


def read(ctx):
    if ctx.trace is None or ctx.dev.type != "cuda":
        return None
    nccl = [(a, b) for name, a, b in ctx.trace.clipped_named()
            if "nccl" in name.lower()]
    ms = trace.union(nccl) / 1e3 / ctx.trace.calls
    return ms if ms > 0 else None

"""scaling_eff.frames4: the window's rays per second over the cell's
ranks times the rays per second of rank 0 alone, rendering the same
batches through the same call (``render_frames_sharded``) at a mesh of
one, while the other ranks wait: 1 where N cards render N times as fast
as one. Rank 0 alone is timed in the ``--trace 1`` run, after the trace,
on the host clock: one untimed batch (its first at the whole frame's
sizes), then whole turns of the turntable (every batch the same number
of times, as in the window), at least as many batches as the trace
took, each synchronised. Layer: the ranks. Moves rays_per_s.frames4."""

import math
import time

import torch

UNIT = "ratio"
LAYER = "ranks"
MOVES = "rays_per_s.frames4"


def read(ctx):
    loop = ctx.loop
    chips = ctx.cell["entry"]["chips"]
    if ctx.trace is None or chips < 2:
        return None
    turn = loop.traffic["frames"] // loop.traffic["batch"]
    n = turn * math.ceil(ctx.trace.calls / turn)
    first = ctx.next_call
    loop.alone(first)
    _sync(ctx.dev)
    rays = torch.zeros((), dtype=torch.int64, device=ctx.dev)
    t0 = time.perf_counter()
    for k in range(n):
        _, stats = loop.alone(first + 1 + k)
        rays += stats["rays"]
        _sync(ctx.dev)
    alone = int(rays) / (time.perf_counter() - t0)
    ctx.note(f"scaling: rank 0 alone {n} batches, {alone!r} rays/s")
    window = ctx.window["rays"] / ctx.window["seconds"]
    return window / (chips * alone)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()

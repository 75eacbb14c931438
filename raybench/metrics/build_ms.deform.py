"""build_ms.deform: CUDA-event milliseconds of the LBVH treelet build
alone (``build_clusters_treelet`` of the moved mesh's soup), captured
as a CUDA graph and replayed on the cell's moved meshes in turn: the
median of REPLAYS replays after one. Layer: accel (device). Moves
rays_per_s."""

import statistics

UNIT = "ms"
LAYER = "accel (device)"
MOVES = "rays_per_s"
REPLAYS = 10


def read(ctx):
    loop = ctx.loop
    if (ctx.dev.type != "cuda" or ctx.cell["traffic"]["kind"] != "frames"
            or loop.static):
        return None
    import torch
    import ceres_tpu_torch as ct
    from ceres_tpu_torch.accel.clusters import build_clusters_treelet
    from ceres_tpu_torch.utils.graphs import capture

    ft, pool = loop.scene.ft, loop.pool
    buf = pool[0].clone()
    graph = capture(lambda: build_clusters_treelet(
        ct.triangle_soup(buf, ft, with_normals=False)), (buf,))
    graph.replay()
    times = []
    for i in range(REPLAYS):
        buf.copy_(pool[i % len(pool)])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ctx.note(f"build_ms.deform: {REPLAYS} replays, ms min {min(times):.6f} "
             f"median {statistics.median(times):.6f} max {max(times):.6f}")
    del graph
    return statistics.median(times)

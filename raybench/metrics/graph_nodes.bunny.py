"""graph_nodes.bunny: the nodes a frame's CUDA graph runs (kernels,
copies, fills and any other, less the span stamps), by the port's
counter ``graph.nodes``, which each replay of a graph captured with
spans on raises by its count (``raybench/spans.py``), the median over
the spanned frames. Layer: the CUDA graphs. Moves rays_per_s.bunny."""

import statistics

from raybench import spans

UNIT = "nodes"
LAYER = "CUDA graphs"
MOVES = "rays_per_s.bunny"


def read(ctx):
    got = spans.read(ctx)
    if (got is None or ctx.cell["traffic"]["kind"] != "frames"
            or not any(got["nodes"])):
        return None
    return statistics.median(got["nodes"])

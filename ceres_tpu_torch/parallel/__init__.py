"""Renders over a mesh of ranks: rows, frames or triangles split over
processes joined by ``torch.distributed`` (one device each)."""

from ceres_tpu_torch.parallel import distributed
from ceres_tpu_torch.parallel.sharded import (
    device_mesh,
    render_frames_sharded,
    render_primitive_sharded,
    render_sharded,
)

__all__ = ["device_mesh", "render_sharded", "render_frames_sharded",
           "render_primitive_sharded", "distributed"]

"""Frame batches and row renders on a device mesh (one device so far)."""

from ceres_tpu_torch.parallel.sharded import (
    device_mesh,
    render_frames_sharded,
    render_sharded,
)

__all__ = ["device_mesh", "render_sharded", "render_frames_sharded"]

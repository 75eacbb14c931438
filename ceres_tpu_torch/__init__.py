"""ceres_tpu_torch — the ray tracer on PyTorch and CUDA (NVIDIA H100).

The port of the JAX package ``ceres_tpu``, which stays beside it as the
reference each ported part is tested against. Same sub-packages and
module names; this package imports ``torch`` and never ``jax``.

Layers on the ported paths (bunny 1080p on a SweepSAH cut; the
subdivided bunny up to 1.27M triangles on the device treelet cut):
  scene I/O   ceres_tpu_torch.io (OBJ), .models (soup, camera, shading,
              subdivision)
  accel       ceres_tpu_torch.accel (device morton/LBVH treelet cut, host
              SweepSAH build and quality cut)
  kernels     ceres_tpu_torch.ops (culling prepass, CUDA walk kernels:
              flat or two-level, weights staged or streamed; the plain
              float64 walk; spheres)
  renderer    ceres_tpu_torch.render
  frames      ceres_tpu_torch.parallel (frame batches on one device)
  apps        ceres_tpu_torch.cli (render, anim)

``__all__`` is the JAX package's list; ``render_pipeline``, the frame
loop's entry point, is importable from here too.
"""

from ceres_tpu_torch.io.obj import load_obj
from ceres_tpu_torch.models.camera import Camera, camera_rays
from ceres_tpu_torch.models.mesh import (Mesh, TriangleSoup, triangle_soup,
                                         vertex_normals)
from ceres_tpu_torch.models.transform import Transform
from ceres_tpu_torch.render.renderer import (RenderConfig, render,
                                             render_pipeline)

__all__ = [
    "Camera",
    "camera_rays",
    "Mesh",
    "TriangleSoup",
    "triangle_soup",
    "vertex_normals",
    "Transform",
    "load_obj",
    "render",
    "RenderConfig",
]

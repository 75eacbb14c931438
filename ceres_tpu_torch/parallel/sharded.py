"""Frame batches and row renders on a device mesh (counterpart of
``ceres_tpu/parallel/sharded.py``: ``device_mesh``, ``_as_spheres``,
``_render_rows``, ``render_sharded``, ``render_frames_sharded``,
``render_deforming_frames``, ``turntable_transforms``,
``render_primitive_sharded``).

The JAX package splits a ("frames", "rays") mesh of devices: rows of the
image over "rays", animation frames over "frames". The port runs one
device, a frames 1 x rays 1 mesh, so each entry point renders every
row of every frame on that device, with the JAX package's per-frame
semantics:

  * a frame batch over static geometry builds the soup, the cut (the
    caller's ``clusters``, or the LBVH treelet cut) and the winner table
    once, and each frame's transform moves the camera and the sun;
  * deforming geometry builds the treelet cut on frame 0 and refits it
    to each later frame (``refit=False`` rebuilds it);
  * stats are summed over the frames.

A mesh of more than one device, and geometry split over devices
(``render_primitive_sharded``), wait for ROADMAP item M16b.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ceres_tpu_torch.accel import clusters as cl
from ceres_tpu_torch.models.camera import Camera, camera_rays_rows
from ceres_tpu_torch.models.mesh import triangle_soup
from ceres_tpu_torch.models.transform import Transform
from ceres_tpu_torch.ops.intersect import full_fp32_matmul
from ceres_tpu_torch.ops.megakernel import _detached
from ceres_tpu_torch.render.renderer import (RenderConfig, _as_spheres,
                                             prepare_winner_table,
                                             render_wavefront,
                                             resolve_device)
from ceres_tpu_torch.utils import tiling

_MULTI_DEVICE = ("a mesh of more than one device is not ported yet (ROADMAP "
                 "item M16b)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("frames", "rays") mesh of one device."""

    device: torch.device

    @property
    def shape(self) -> dict:
        return {"frames": 1, "rays": 1}


def device_mesh(num_frames_axis: int = 1, devices=None) -> Mesh:
    """The ("frames", "rays") mesh of ``devices`` (default: the card;
    without one it raises, and ``devices=["cpu"]`` meshes the CPU). One
    device only: more name ROADMAP item M16b."""
    devices = list(devices) if devices is not None else [
        resolve_device(None, None, "device_mesh")]
    if len(devices) > 1:
        raise NotImplementedError(_MULTI_DEVICE)
    if len(devices) % num_frames_axis:
        raise ValueError(f"{len(devices)} devices not divisible by frames "
                         f"axis {num_frames_axis}")
    return Mesh(torch.device(devices[0]))


def _mesh_device(mesh, vertices, device, caller) -> torch.device:
    """The device an entry point runs on: the mesh's if given."""
    if mesh is not None:
        return mesh.device
    return resolve_device(vertices, device, caller)


def _inputs(vertices, faces, camera, sun_position, spheres, device):
    """Tensors on ``device`` in the vertices' dtype."""
    vertices = torch.as_tensor(vertices, device=device)
    dtype = vertices.dtype
    camera = Camera.make(camera.eye, camera.dir, camera.up, camera.fov,
                         dtype=dtype, device=device)
    return (vertices, torch.as_tensor(faces, device=device), camera,
            torch.as_tensor(sun_position, dtype=dtype, device=device),
            _as_spheres(spheres, dtype, device))


def _render_rows(verts, faces, camera, sun, row0, h_local, config,
                 soup=None, clusters=None, spheres=None, table_cols=None):
    """Render ``h_local`` image rows from row ``row0`` -> ((h_local, W, 3)
    image, stats)."""
    if soup is None:
        soup = triangle_soup(verts, faces,
                             with_normals=config.mode == "smooth")
    dirs_hw = camera_rays_rows(camera, config.width, config.height, row0,
                               h_local)
    if config.backend == "megakernel":
        # Pixel-block ray order, so that a walk tile is a compact block.
        dirs = tiling.swizzle(dirs_hw)
        color, stats = render_wavefront(soup, camera, sun, dirs, config,
                                        clusters=clusters, spheres=spheres,
                                        table_cols=table_cols)
        color = tiling.unswizzle(color, h_local, config.width)
        stats["rays"] = stats["rays"] - (dirs.shape[0]
                                         - h_local * config.width)
        return color, stats
    color, stats = render_wavefront(soup, camera, sun,
                                    dirs_hw.reshape(-1, 3), config,
                                    clusters=clusters, spheres=spheres)
    return color.reshape(h_local, config.width, 3), stats


def render_sharded(vertices, faces, camera: Camera, sun_position,
                   config: Optional[RenderConfig] = None,
                   mesh: Optional[Mesh] = None, spheres=None, device=None,
                   **kwargs):
    """Rows of the image over the mesh's "rays" axis: on one device, the
    whole image, equal to ``render()``'s with row-form rays. kwargs
    override RenderConfig fields. Runs on the mesh's device (default:
    ``render()``'s device rule)."""
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    device = _mesh_device(mesh, vertices, device, "render_sharded")
    vertices, faces, camera, sun, spheres = _inputs(
        vertices, faces, camera, sun_position, spheres, device)
    return _render_rows(vertices, faces, camera, sun, 0, config.height,
                        config, spheres=spheres)


def _sum_stats(per_frame):
    return {k: sum(s[k] for s in per_frame) for k in per_frame[0]}


def render_frames_sharded(vertices, faces, camera: Camera, sun_position,
                          frame_transforms: Transform,
                          config: Optional[RenderConfig] = None,
                          mesh: Optional[Mesh] = None, spheres=None,
                          clusters=None, device=None, **kwargs):
    """A batch of frames of static geometry -> ((F, H, W, 3), stats
    summed over the frames).

    ``frame_transforms`` is a stacked Transform (``turntable_transforms``):
    frame k moves the camera (eye and view direction) and the sun by its
    transform k. The soup, the cut (``clusters``, else the LBVH treelet
    cut) and the winner table are built once for the batch.
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    device = _mesh_device(mesh, vertices, device, "render_frames_sharded")
    vertices, faces, camera, sun, spheres = _inputs(
        vertices, faces, camera, sun_position, spheres, device)
    soup = triangle_soup(vertices, faces, with_normals=config.mode == "smooth")
    table = None
    if config.backend == "megakernel":
        if clusters is None:
            clusters = cl.build_clusters_treelet(_detached(soup))
        table = prepare_winner_table(soup, clusters, config)
    tracks = Transform(a=frame_transforms.a.to(device, vertices.dtype),
                       v=frame_transforms.v.to(device, vertices.dtype))
    frames, stats = [], []
    for k in range(tracks.num_frames):
        tf = tracks.frame(k)
        with full_fp32_matmul():
            cam_f = Camera(eye=tf(camera.eye), dir=tf.a @ camera.dir,
                           up=camera.up, fov=camera.fov)
        color, st = _render_rows(vertices, faces, cam_f, tf(sun), 0,
                                 config.height, config, soup=soup,
                                 clusters=clusters, spheres=spheres,
                                 table_cols=table)
        frames.append(color)
        stats.append(st)
    return torch.stack(frames), _sum_stats(stats)


def render_deforming_frames(vertices_frames, faces, camera: Camera,
                            sun_position,
                            config: Optional[RenderConfig] = None,
                            mesh: Optional[Mesh] = None, refit: bool = True,
                            spheres=None, device=None, **kwargs):
    """Frames of deforming geometry, (F, V, 3) vertices -> ((F, H, W, 3),
    stats summed over the frames).

    The treelet cut is built on frame 0 and refitted to each frame's
    vertices (``refit_clusters``: the boxes stay exact bounds, only their
    tightness degrades); ``refit=False`` rebuilds it every frame. The
    megakernel backend only, as in the JAX package.
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    if config.backend != "megakernel":
        raise ValueError("render_deforming_frames requires the megakernel "
                         "backend (the refit path refits its clusters)")
    device = _mesh_device(mesh, vertices_frames, device,
                          "render_deforming_frames")
    vertices_frames, faces, camera, sun, spheres = _inputs(
        vertices_frames, faces, camera, sun_position, spheres, device)
    smooth = config.mode == "smooth"
    cs0 = cl.build_clusters_treelet(_detached(triangle_soup(
        vertices_frames[0], faces, with_normals=smooth)))
    frames, stats = [], []
    for verts in vertices_frames:
        soup = triangle_soup(verts, faces, with_normals=smooth)
        cs = (cl.refit_clusters(cs0, _detached(soup)) if refit
              else cl.build_clusters_treelet(_detached(soup)))
        color, st = _render_rows(verts, faces, camera, sun, 0, config.height,
                                 config, soup=soup, clusters=cs,
                                 spheres=spheres)
        frames.append(color)
        stats.append(st)
    return torch.stack(frames), _sum_stats(stats)


def turntable_transforms(num_frames: int, axis=(0.0, 1.0, 0.0),
                         dtype=torch.float32, device=None) -> Transform:
    """The anim app's camera path as a stacked Transform: frame i rotates
    by i * 360 / N degrees about ``axis``."""
    angles = (torch.arange(num_frames, dtype=dtype, device=device)
              * (2.0 * math.pi / num_frames))
    frames = [Transform.identity(dtype, device).rotate(axis, angle)
              for angle in angles]
    return Transform(a=torch.stack([f.a for f in frames]),
                     v=torch.stack([f.v for f in frames]))


def render_primitive_sharded(*args, **kwargs):
    """Geometry split over the mesh's devices: ROADMAP item M16b."""
    raise NotImplementedError("primitive sharding is not ported yet "
                              "(ROADMAP item M16b)")

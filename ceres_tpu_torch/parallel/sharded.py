"""Renders split over a mesh of ranks (counterpart of
``ceres_tpu/parallel/sharded.py``: ``device_mesh``, ``_as_spheres``,
``_render_rows``, ``render_sharded``, ``render_frames_sharded``,
``render_deforming_frames``, ``turntable_transforms``,
``render_primitive_sharded``).

The JAX package splits a ("frames", "rays") mesh of devices in one
process with ``shard_map``. The port's mesh is a grid of ranks, one
process and one device each, joined by ``torch.distributed``
(``parallel.distributed``); rank k sits at frame index k // rays and ray
index k % rays. A mesh of one rank (no process group) renders everything
on its device, as before. On a mesh of ranks:

  * rows of the image go over "rays": ray index r renders
    ceil(H / rays) rows from r * ceil(H / rays), clipped to the image
    (the JAX package also renders the rows past it and counts them in
    its stats: ROADMAP queue 3);
  * a frame batch splits its frames over "frames" (``num_frames`` a
    multiple of the axis), and so do deforming frames; a single image
    is rendered by every frame index alike and owned by frame index 0
    (the JAX package sums the stats of every frame index: ROADMAP
    queue 3);
  * every rank assembles the whole image: each writes its block into a
    zero buffer and the buffers are summed (``all_reduce``), exact since
    each pixel has one writer; stats are summed the same way;
  * gradients: the replicated inputs (vertices, camera, sun, spheres)
    pass through ``_Replicated``, whose backward sums their gradients
    over the ranks, and the assembled image's backward hands each rank
    its own block of the incoming gradient, the transpose of
    ``shard_map`` with replicated inputs. A loss taken on every rank
    over the whole image gives every rank the whole gradient.

Per batch each rank builds the soup, the cut (the caller's ``clusters``,
or the LBVH treelet cut) and the winner table once; deforming geometry
builds the treelet cut on frame 0 and refits it to each frame
(``refit=False`` rebuilds it).

``render_primitive_sharded`` splits the triangles instead: every rank
walks the whole wavefront against its share, and the ranks agree on each
ray's nearest hit by an all-reduce MIN of the distance, then of the rank
(ties to the lowest), before the winning rank's normal and shading are
summed in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ceres_tpu_torch.accel import clusters as cl
from ceres_tpu_torch.models import shading as shading_mod
from ceres_tpu_torch.models.camera import (Camera, camera_rays,
                                           camera_rays_rows)
from ceres_tpu_torch.models.mesh import (TriangleSoup, cross, triangle_soup,
                                         vertex_normals)
from ceres_tpu_torch.models.transform import Transform
from ceres_tpu_torch.ops import sphere as sphere_ops
from ceres_tpu_torch.ops.intersect import full_fp32_matmul
from ceres_tpu_torch.ops.megakernel import _detached
from ceres_tpu_torch.render.renderer import (SELF_INTERSECT_OFFSET,
                                             RenderConfig, _any_shadow,
                                             _as_spheres, _check_config,
                                             _closest_primary, _normalize,
                                             prepare_winner_table,
                                             render_wavefront,
                                             resolve_device)
from ceres_tpu_torch.utils import tiling


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("frames", "rays") grid of ranks as this rank sees it: its
    device, the grid's shape, its rank and the process group (None: one
    rank and no collectives)."""

    device: torch.device
    frames: int = 1
    rays: int = 1
    rank: int = 0
    group: Any = None

    @property
    def shape(self) -> dict:
        return {"frames": self.frames, "rays": self.rays}

    @property
    def size(self) -> int:
        return self.frames * self.rays

    @property
    def coords(self) -> tuple[int, int]:
        """(frame index, ray index) of this rank."""
        return divmod(self.rank, self.rays)


def device_mesh(num_frames_axis: int = 1, devices=None) -> Mesh:
    """The ("frames", "rays") mesh: over every rank of the process group
    when one is joined (``parallel.distributed``), with ``devices[0]``,
    else ``distributed.rank_device()``, as this rank's device; without a
    group, the one device ``devices[0]`` (default: the card; without one
    it raises, and ``devices=["cpu"]`` meshes the CPU). A process drives
    one device: start one rank per device for more."""
    devices = None if devices is None else list(devices)
    if devices is not None and len(devices) != 1:
        raise ValueError(
            f"{len(devices)} devices for one process: a rank drives one "
            "device, so start one rank per device (torchrun "
            "--nproc-per-node N, or parallel.distributed.run_ranks) and "
            "mesh them with distributed.global_mesh()")
    if dist.is_initialized():
        from ceres_tpu_torch.parallel import distributed

        n, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
        device = (torch.device(devices[0]) if devices
                  else distributed.rank_device())
    else:
        n, rank, group = 1, 0, None
        device = torch.device(devices[0] if devices else resolve_device(
            None, None, "device_mesh"))
    if n % num_frames_axis:
        raise ValueError(f"{n} ranks not divisible by frames axis "
                         f"{num_frames_axis}")
    return Mesh(device, num_frames_axis, n // num_frames_axis, rank, group)


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


# ---------------------------------------------------------------------------
# Collectives: all_reduce (SUM, MIN) only
# ---------------------------------------------------------------------------

def _all_reduce(x, mesh, op=dist.ReduceOp.SUM):
    """``x`` reduced over the mesh's ranks (a new tensor; ``x`` itself on
    one rank). Not differentiable."""
    if mesh.group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=mesh.group)
    return y


class _Replicated(torch.autograd.Function):
    """Inputs every rank holds alike. Forward: the identity. Backward:
    each gradient summed over the ranks (all_reduce SUM), so that every
    rank steps with the gradient of the whole image."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _Assemble(torch.autograd.Function):
    """The whole of a tensor that the ranks render in blocks. Forward:
    this rank's block (``owner``) written into a zero buffer of
    ``full_shape`` at ``index``, summed over the ranks (all_reduce SUM):
    exact, since each element has one writer. Backward: this rank's block
    of the incoming gradient (zero where it owns none), no collective."""

    @staticmethod
    def forward(ctx, block, full_shape, index, owner, group):
        ctx.index, ctx.owner, ctx.block_shape = index, owner, block.shape
        full = block.new_zeros(full_shape)
        if owner:
            full[index] = block
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        # A zero gradient, not None, where the rank owns nothing: its
        # render's graph, and _Replicated's collective, run all the same.
        g = (grad[ctx.index] if ctx.owner
             else grad.new_zeros(ctx.block_shape))
        return g, None, None, None, None


def _replicated(mesh, xs):
    """``xs`` (tensors or None) through ``_Replicated``: those that
    require gradients, in one node; the others, and all on one rank, as
    they are."""
    idx = [i for i, x in enumerate(xs)
           if isinstance(x, torch.Tensor) and x.requires_grad]
    if mesh.group is None or not idx:
        return list(xs)
    outs = _Replicated.apply(mesh.group, *(xs[i] for i in idx))
    xs = list(xs)
    for i, y in zip(idx, outs):
        xs[i] = y
    return xs


def _replicate_inputs(mesh, vertices, camera, sun, spheres):
    """The replicated inputs of a render, through ``_replicated``."""
    sph = list(spheres) if spheres is not None else [None, None]
    v, eye, d, up, fov, sun, c, r = _replicated(
        mesh, [vertices, camera.eye, camera.dir, camera.up, camera.fov, sun,
               *sph])
    return (v, Camera(eye=eye, dir=d, up=up, fov=fov), sun,
            None if spheres is None else (c, r))


def _assemble(block, full_shape, index, owner, mesh):
    """The whole tensor (``_Assemble``); on one rank the block itself."""
    if mesh.group is None:
        return block
    return _Assemble.apply(block, tuple(full_shape), index, owner, mesh.group)


def _reduce_stats(stats, mesh, owner=True):
    """Stats summed over the ranks, each rank's counted where it owns
    what it rendered; one all_reduce for all of them."""
    if mesh.group is None:
        return stats
    keys = list(stats)
    vals = torch.stack([torch.as_tensor(stats[k], dtype=torch.int64,
                                        device=mesh.device) for k in keys])
    if not owner:
        vals = torch.zeros_like(vals)
    vals = _all_reduce(vals, mesh)
    return dict(zip(keys, vals.unbind(0)))


def _sum_stats(per_frame):
    return {k: sum(s[k] for s in per_frame) for k in per_frame[0]}


def _pad_rows(height: int, n_shards: int) -> int:
    return -(-height // n_shards)


def _row_block(height, mesh):
    """(row0, rows, real) of this rank's rows: ceil(H / rays) rows from
    ray index x ceil(H / rays), clipped to the image. A rank left with
    none renders the last row, and ``real`` is False, so that its work
    and its collectives are those of the others."""
    h_local = _pad_rows(height, mesh.rays)
    row0 = mesh.coords[1] * h_local
    rows = min(h_local, height - row0)
    if rows <= 0:
        return height - 1, 1, False
    return row0, rows, True


def _frame_block(num_frames, mesh):
    """(first, count) of this rank's frames of a batch split over
    "frames"."""
    if num_frames % mesh.frames:
        raise ValueError(f"{num_frames} frames not divisible by mesh "
                         f"frames axis {mesh.frames}")
    per = num_frames // mesh.frames
    return mesh.coords[0] * per, per


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
                   mesh: Optional[Mesh] = None, spheres=None, clusters=None,
                   device=None, **kwargs):
    """Rows of the image over the mesh's "rays" axis -> ((H, W, 3) image,
    stats), the whole image and the whole frame's stats on every rank:
    equal to ``render()``'s with row-form rays. Differentiable; gradients
    of the replicated inputs arrive summed over the ranks. ``clusters``
    is a prebuilt cut of this mesh (megakernel backend; default: the
    treelet cut, built in the call). kwargs override RenderConfig
    fields. Runs on the mesh's device (default: ``render()``'s device
    rule)."""
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    device = _mesh_device(mesh, vertices, device, "render_sharded")
    mesh = mesh or Mesh(device)
    vertices, faces, camera, sun, spheres = _inputs(
        vertices, faces, camera, sun_position, spheres, device)
    vertices, camera, sun, spheres = _replicate_inputs(mesh, vertices, camera,
                                                       sun, spheres)
    H, W = config.height, config.width
    row0, rows, real = _row_block(H, mesh)
    owner = real and mesh.coords[0] == 0
    color, stats = _render_rows(vertices, faces, camera, sun, row0, rows,
                                config, clusters=clusters, spheres=spheres)
    image = _assemble(color, (H, W, 3), (slice(row0, row0 + rows),), owner,
                      mesh)
    return image, _reduce_stats(stats, mesh, owner)


def render_frames_sharded(vertices, faces, camera: Camera, sun_position,
                          frame_transforms: Transform,
                          config: Optional[RenderConfig] = None,
                          mesh: Optional[Mesh] = None, spheres=None,
                          clusters=None, device=None, **kwargs):
    """A batch of frames of static geometry -> ((F, H, W, 3), stats
    summed over the frames), frames over "frames" and rows over "rays".

    ``frame_transforms`` is a stacked Transform (``turntable_transforms``):
    frame k moves the camera (eye and view direction) and the sun by its
    transform k. The soup, the cut (``clusters``, else the LBVH treelet
    cut) and the winner table are built once for the batch on each rank.
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    device = _mesh_device(mesh, vertices, device, "render_frames_sharded")
    mesh = mesh or Mesh(device)
    vertices, faces, camera, sun, spheres = _inputs(
        vertices, faces, camera, sun_position, spheres, device)
    vertices, camera, sun, spheres = _replicate_inputs(mesh, vertices, camera,
                                                       sun, spheres)
    tracks = Transform(a=frame_transforms.a.to(device, vertices.dtype),
                       v=frame_transforms.v.to(device, vertices.dtype))
    num_frames = tracks.num_frames
    first, count = _frame_block(num_frames, mesh)
    row0, rows, real = _row_block(config.height, mesh)
    soup = triangle_soup(vertices, faces, with_normals=config.mode == "smooth")
    table = None
    if config.backend == "megakernel":
        if clusters is None:
            clusters = cl.build_clusters_treelet(_detached(soup))
        table = prepare_winner_table(soup, clusters, config)
    frames, stats = [], []
    for k in range(first, first + count):
        tf = tracks.frame(k)
        with full_fp32_matmul():
            cam_f = Camera(eye=tf(camera.eye), dir=tf.a @ camera.dir,
                           up=camera.up, fov=camera.fov)
        color, st = _render_rows(vertices, faces, cam_f, tf(sun), row0, rows,
                                 config, soup=soup, clusters=clusters,
                                 spheres=spheres, table_cols=table)
        frames.append(color)
        stats.append(st)
    full = (num_frames, config.height, config.width, 3)
    image = _assemble(torch.stack(frames), full,
                      (slice(first, first + count), slice(row0, row0 + rows)),
                      real, mesh)
    return image, _reduce_stats(_sum_stats(stats), mesh, real)


def render_deforming_frames(vertices_frames, faces, camera: Camera,
                            sun_position,
                            config: Optional[RenderConfig] = None,
                            mesh: Optional[Mesh] = None, refit: bool = True,
                            spheres=None, device=None, **kwargs):
    """Frames of deforming geometry, (F, V, 3) vertices -> ((F, H, W, 3),
    stats summed over the frames), frames over "frames" and rows over
    "rays".

    Each rank builds the treelet cut on frame 0 and refits it to each of
    its frames' vertices (``refit_clusters``: the boxes stay exact
    bounds, only their tightness degrades); ``refit=False`` rebuilds it
    every frame. The megakernel backend only, as in the JAX package.
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    if config.backend != "megakernel":
        raise ValueError("render_deforming_frames requires the megakernel "
                         "backend (the refit path refits its clusters)")
    device = _mesh_device(mesh, vertices_frames, device,
                          "render_deforming_frames")
    mesh = mesh or Mesh(device)
    vertices_frames, faces, camera, sun, spheres = _inputs(
        vertices_frames, faces, camera, sun_position, spheres, device)
    vertices_frames, camera, sun, spheres = _replicate_inputs(
        mesh, vertices_frames, camera, sun, spheres)
    num_frames = vertices_frames.shape[0]
    first, count = _frame_block(num_frames, mesh)
    row0, rows, real = _row_block(config.height, mesh)
    smooth = config.mode == "smooth"
    cs0 = cl.build_clusters_treelet(_detached(triangle_soup(
        vertices_frames[0], faces, with_normals=smooth)))
    frames, stats = [], []
    for verts in vertices_frames[first:first + count]:
        soup = triangle_soup(verts, faces, with_normals=smooth)
        cs = (cl.refit_clusters(cs0, _detached(soup)) if refit
              else cl.build_clusters_treelet(_detached(soup)))
        color, st = _render_rows(verts, faces, camera, sun, row0, rows,
                                 config, soup=soup, clusters=cs,
                                 spheres=spheres)
        frames.append(color)
        stats.append(st)
    full = (num_frames, config.height, config.width, 3)
    image = _assemble(torch.stack(frames), full,
                      (slice(first, first + count), slice(row0, row0 + rows)),
                      real, mesh)
    return image, _reduce_stats(_sum_stats(stats), mesh, real)


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


# ---------------------------------------------------------------------------
# Primitive sharding: the triangles split over the ranks
# ---------------------------------------------------------------------------

def _shard_soup(vertices, faces, vn, mesh):
    """This rank's contiguous share of the faces, padded to a multiple of
    the ranks with zero faces (degenerate: the accept rejects them), as a
    soup whose corner normals come from the whole mesh's ``vn``."""
    n = mesh.size
    faces_p = F.pad(faces, (0, 0, 0, (-faces.shape[0]) % n))
    per = faces_p.shape[0] // n
    f = faces_p[mesh.rank * per:(mesh.rank + 1) * per].long()
    p0, p1, p2 = vertices[f[:, 0]], vertices[f[:, 1]], vertices[f[:, 2]]
    e1, e2 = p0 - p1, p2 - p0
    return TriangleSoup(p0=p0, e1=e1, e2=e2, n=cross(e1, e2),
                        corner_normals=vn[f])


def _render_primitive(vertices, faces, camera, sun, config, mesh, spheres):
    R_img = config.height * config.width
    vn = vertex_normals(vertices, faces)
    soup = _shard_soup(vertices, faces, vn, mesh)
    dirs_hw = camera_rays(camera, config.width, config.height)
    mega = config.backend == "megakernel"
    dirs = tiling.swizzle(dirs_hw) if mega else dirs_hw.reshape(-1, 3)
    R = dirs.shape[0]
    # The shard's own cut, built once for both of its walks.
    clusters = cl.build_clusters_treelet(_detached(soup)) if mega else None

    hit = _closest_primary(soup, camera, dirs, config.backend, clusters)
    t_local = torch.where(hit.mask, hit.t, torch.inf)
    t_min = _all_reduce(t_local, mesh, dist.ReduceOp.MIN)
    hit_tri = torch.isfinite(t_min)
    hit_any = hit_tri
    # The winning rank of each ray: its t is the least, ties to the
    # lowest rank, so that each ray is shaded exactly once.
    mine = hit.mask & (t_local == t_min)
    rank = torch.full_like(t_local, mesh.rank, dtype=torch.int32)
    win = _all_reduce(torch.where(mine, rank, mesh.size), mesh,
                      dist.ReduceOp.MIN)
    winner = mine & (win == mesh.rank)

    sph_win = torch.zeros(R, dtype=torch.bool, device=dirs.device)
    if spheres is not None:
        # Replicated: every rank finds the same sphere hits; a sphere in
        # front of the nearest triangle takes the ray from its winner.
        centers, radii = spheres
        s_hit = sphere_ops.closest_hit(camera.eye.expand(dirs.shape), dirs,
                                       centers, radii)
        sph_win = s_hit.mask & (s_hit.t < t_min)
        hit_any = hit_tri | s_hit.mask
        winner = winner & ~sph_win

    prim = torch.where(winner, hit.prim_id, 0).long()
    n_glob = _all_reduce(torch.where(winner[:, None], soup.n[prim], 0.0),
                         mesh)
    tri_pt = hit_tri & ~sph_win
    point = camera.eye + torch.where(tri_pt, t_min, 0.0)[:, None] * dirs
    point = point + SELF_INTERSECT_OFFSET * _normalize(
        torch.where(tri_pt[:, None], n_glob, 1.0))
    if spheres is not None:
        st_safe = torch.where(sph_win, s_hit.t, 0.0)
        s_point = camera.eye + st_safe[:, None] * dirs
        s_nrm = sphere_ops.normal_at(s_point, centers, s_hit.sphere_id)
        point = torch.where(sph_win[:, None],
                            s_point - SELF_INTERSECT_OFFSET * s_nrm, point)
    sun_line = _normalize(sun[None, :] - point)

    if config.shadows:
        occ_local = _any_shadow(soup, point, sun_line, config.backend,
                                skip=~hit_any, clusters=clusters)
        occluded = _all_reduce(occ_local.to(torch.int32), mesh) > 0
        if spheres is not None:
            dist_s = torch.linalg.vector_norm(sun[None, :] - point, dim=-1)
            occ_s = sphere_ops.any_hit(point, sun_line, centers, radii,
                                       tmax=(dist_s * (1.0 - 1e-4))[:, None])
            occluded = occluded | (occ_s & hit_any)
    else:
        occluded = torch.zeros(R, dtype=torch.bool, device=dirs.device)

    if config.mode == "smooth":
        shade_l = shading_mod.smooth_shading(
            sun_line, soup.corner_normals[prim], dirs, hit.u, hit.v)
    else:
        shade_l = shading_mod.flat_shading(soup.n[prim])
        if config.mode == "normal":
            occluded = torch.zeros_like(occluded)
    # Masked before the sum: the winner's shading plus zeros, exact.
    shade = _all_reduce(torch.where(winner[:, None], shade_l, 0.0), mesh)
    if spheres is not None:
        if config.mode == "smooth":
            zero = torch.zeros(R, dtype=dirs.dtype, device=dirs.device)
            shade_s = shading_mod.smooth_shading(
                sun_line, s_nrm[:, None, :].expand(R, 3, 3), dirs, zero,
                zero)
        else:
            shade_s = shading_mod.flat_shading(s_nrm)
        shade = torch.where(sph_win[:, None], shade_s, shade)

    lit = hit_any & ~occluded
    color = torch.where(lit[:, None], shade, 0.0)
    primary_hits = hit_any.sum()
    shadow_hits = (hit_any & occluded).sum()
    stats = {"rays": R + primary_hits - (R - R_img),
             "hits": primary_hits + shadow_hits,
             "primary_hits": primary_hits,
             "shadow_hits": shadow_hits}
    if mega:
        return tiling.unswizzle(color, config.height, config.width), stats
    return color.reshape(config.height, config.width, 3), stats


def render_primitive_sharded(vertices, faces, camera: Camera, sun_position,
                             config: Optional[RenderConfig] = None,
                             mesh: Optional[Mesh] = None, spheres=None,
                             device=None, **kwargs):
    """The triangles split over the mesh's ranks, the rays replicated ->
    ((H, W, 3) image, stats) on every rank.

    Each rank holds a contiguous 1/n of the faces (padded with
    degenerate zero faces), walks every ray against its share on its own
    treelet cut (megakernel backend), and the ranks combine: the nearest
    hit by an all-reduce MIN of t, its rank by a MIN over the ranks that
    reach it (ties to the lowest), the winner's normal and masked shading
    by a SUM, occlusion by a SUM > 0. Vertex normals come from the whole
    mesh; ``spheres`` are replicated. Shadow rays run from the hit point
    toward the sun with no upper bound, as in the JAX package. The same
    image as ``render()`` up to exact-distance ties; a forward render
    only (the image carries no gradient). Stats count the swizzled
    wavefront's rays less its padding, as the JAX package does.
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    _check_config(config)
    if torch.as_tensor(faces).shape[0] == 0:
        raise ValueError("scene has no triangles")
    device = _mesh_device(mesh, vertices, device, "render_primitive_sharded")
    mesh = mesh or Mesh(device)
    vertices, faces, camera, sun, spheres = _inputs(
        vertices, faces, camera, sun_position, spheres, device)
    with torch.no_grad():
        return _render_primitive(vertices, faces, camera, sun, config, mesh,
                                 spheres)

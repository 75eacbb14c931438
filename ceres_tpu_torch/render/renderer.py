"""The render pipeline (counterpart of ``ceres_tpu/render/renderer.py``:
``RenderConfig``, ``_payload_cols``, ``prepare_winner_table``,
``render_wavefront_cols``, ``_wavefront_stats``, ``render_pipeline``,
``render``).

  1. Pinhole camera rays for every pixel, in 32 x 32 pixel-block order.
  2. Closest hit through the cluster walk (``ops.megakernel``).
  3. Miss -> black. Hit -> hit point eye + t * dir, offset by
     -1e-5 * normalize(face normal) against self-intersection.
  4. Shadow segment from the hit point to the sun, cast as one
     common-origin wavefront from the sun; any occluder -> black.
  5. Otherwise Gouraud smooth shading from the corner vertex normals.

Stats: "rays" counts traversals (one per pixel plus one shadow ray per
primary hit), "hits" counts primary hits plus occluded shadow rays, the
reference renderer's counting.

The port covers the JAX package's megakernel backend with smooth shading
in float32. Not ported yet: ``backend="bruteforce"``, ``reference_compat``
and the flat/normal modes (ROADMAP M8), spheres (M12), float64 (M14).
The port's ``RenderConfig.backend`` therefore defaults to "megakernel"
(the JAX package's defaults to "bruteforce").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ceres_tpu_torch.models import shading as shading_mod
from ceres_tpu_torch.models.camera import Camera, camera_ray_columns
from ceres_tpu_torch.models.mesh import TriangleSoup, triangle_soup
from ceres_tpu_torch.ops import megakernel
from ceres_tpu_torch.utils import tiling

SELF_INTERSECT_OFFSET = -1e-5


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings, field for field the JAX package's."""

    width: int = 1920
    height: int = 1080
    mode: str = "smooth"          # only "smooth" is ported
    backend: str = "megakernel"   # only "megakernel" is ported
    shadows: bool = True
    # Also report the measured traversal counters (executed cluster
    # visits and Möller-Trumbore pairs of both wavefronts).
    traversal_stats: bool = False
    reference_compat: bool = False  # ROADMAP M8
    f64_exact: bool = False         # ROADMAP M14


def _check_config(config: RenderConfig) -> None:
    if config.backend != "megakernel":
        raise NotImplementedError(
            f"backend {config.backend!r} is not ported yet (ROADMAP item "
            "M8); the port renders with backend='megakernel'")
    if config.mode != "smooth":
        raise NotImplementedError(
            f"mode {config.mode!r} is not ported yet (ROADMAP item M8)")
    if config.reference_compat:
        raise NotImplementedError(
            "reference_compat is not ported yet (ROADMAP item M8)")
    if config.f64_exact:
        raise NotImplementedError(
            "f64_exact is not ported yet (ROADMAP item M14)")


def _payload_cols(soup: TriangleSoup):
    """The per-triangle shading payload columns of smooth shading: the
    nine corner-normal columns [n0 | n1 | n2]."""
    if soup.corner_normals is None:
        raise ValueError("smooth shading requires corner_normals")
    cn = soup.corner_normals
    return [cn[:, k, a] for k in range(3) for a in range(3)]


def prepare_winner_table(soup: TriangleSoup, clusters,
                         config: RenderConfig):
    """Loop-invariant winner table for static-geometry frame loops; pass
    it to render_pipeline(..., table_cols=...)."""
    _check_config(config)
    return megakernel.winner_table(soup, clusters, _payload_cols(soup))


def _hit_points(eye, dir_cols, hit, n):
    """Shadow-ray origins: eye + t * dir, pushed off the surface by
    SELF_INTERSECT_OFFSET along the normalised face normal ``n`` (3
    columns, zero at misses)."""
    # Guard the normalise at misses, where n is zero.
    nsq = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    n_inv = torch.rsqrt(torch.where(hit.mask, nsq, 1.0))
    t_safe = torch.where(hit.mask, hit.t, 0.0)
    return tuple(eye[a] + t_safe * dir_cols[a]
                 + SELF_INTERSECT_OFFSET * n[a] * n_inv for a in range(3))


def render_wavefront_cols(soup: TriangleSoup, camera: Camera, sun_position,
                          dir_cols, config: RenderConfig, clusters=None,
                          table_cols=None):
    """Column-form wavefront render -> (3-tuple of (R,) colours, stats).

    ``dir_cols`` is a 3-tuple of (R,) normalised primary directions from
    ``camera.eye``; ``clusters`` the prebuilt ClusterSet of ``soup`` (None:
    the treelet cut is built once for both wavefronts).
    """
    _check_config(config)
    clusters = megakernel._treelet(soup, clusters)
    want_counts = config.traversal_stats
    res = megakernel.closest_hit_common_origin(
        soup, camera.eye, dir_cols, clusters=clusters,
        payload=_payload_cols(soup),
        with_counts=want_counts, normal_cols=True, table_cols=table_cols)
    (hit, pay), counts1 = (res[:2], res[2]) if want_counts else (res, None)
    mask = hit.mask
    point = _hit_points(camera.eye, dir_cols, hit, pay[0:3])
    sl = tuple(sun_position[a] - point[a] for a in range(3))
    sl_inv = torch.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
    sun_line = tuple(c * sl_inv for c in sl)

    counts2 = None
    if config.shadows:
        res2 = megakernel.any_hit_to_point(
            soup, sun_position, point, skip=~mask, clusters=clusters,
            with_counts=want_counts)
        occluded, counts2 = res2 if want_counts else (res2, None)
    else:
        occluded = torch.zeros_like(mask)

    shade = shading_mod.smooth_shading_cols(sun_line, pay[3:12], dir_cols,
                                            hit.u, hit.v)
    lit = mask & ~occluded
    color = tuple(torch.where(lit, s, 0.0) for s in shade)
    stats = _wavefront_stats(mask, occluded, dir_cols[0].shape[0], config,
                             counts1, counts2)
    return color, stats


def _wavefront_stats(mask, occluded, R, config, counts1, counts2):
    """rays/hits counts, and the measured traversal counters when
    ``config.traversal_stats`` is set. Values are 0-dim int64 tensors."""
    primary_hits = mask.sum()
    shadow_hits = (mask & occluded).sum()
    stats = {
        "rays": R + primary_hits,
        "hits": primary_hits + shadow_hits,
        "primary_hits": primary_hits,
        "shadow_hits": shadow_hits,
    }
    if config.traversal_stats:
        c2 = counts2 or {k: 0 for k in counts1}
        stats["traversal_steps"] = (counts1["traversal_steps"]
                                    + c2["traversal_steps"])
        stats["intersections"] = counts1["mt_pairs"] + c2["mt_pairs"]
        stats["mt_block_visits"] = (counts1["mt_block_visits"]
                                    + c2["mt_block_visits"])
    return stats


def render_pipeline(vertices: torch.Tensor, faces: torch.Tensor,
                    camera: Camera, sun_position: torch.Tensor,
                    config: RenderConfig, clusters=None, spheres=None,
                    table_cols=None):
    """Full pipeline from an indexed mesh -> ((H, W, 3) image, stats).

    ``clusters`` is the prebuilt ClusterSet of this mesh (built once
    before a frame loop, like the reference's BVH); ``table_cols`` the
    prebuilt winner table (prepare_winner_table). Runs on the device of
    ``vertices``.
    """
    if faces.shape[0] == 0:
        raise ValueError("scene has no triangles")
    if spheres is not None:
        raise NotImplementedError("spheres are not ported yet (ROADMAP "
                                  "item M12)")
    if vertices.dtype != torch.float32:
        raise NotImplementedError(
            f"{vertices.dtype} vertices: only float32 is ported; float64 "
            "is ROADMAP item M14")
    soup = triangle_soup(vertices, faces, with_normals=True)
    planes = camera_ray_columns(camera, config.width, config.height)
    dir_cols = tuple(tiling.swizzle_plane(p) for p in planes)
    color, stats = render_wavefront_cols(
        soup, camera, sun_position, dir_cols, config, clusters=clusters,
        table_cols=table_cols)
    image = torch.stack([tiling.unswizzle_plane(c, config.height, config.width)
                         for c in color], dim=-1)
    # Padding rays are inert; drop them from the ray count.
    stats["rays"] = stats["rays"] - (dir_cols[0].shape[0]
                                     - config.height * config.width)
    return image, stats


def render(vertices, faces, camera: Camera, sun_position,
           config: Optional[RenderConfig] = None, spheres=None, clusters=None,
           device=None, **kwargs):
    """User-facing render call; kwargs override RenderConfig fields.

    Inputs may be numpy arrays or tensors; everything runs on ``device``
    (default: the device of ``vertices`` if it is a tensor, else the
    CPU). Without ``clusters`` the LBVH treelet cut is built on the
    device first, as the JAX package's ``render`` does. For frame loops,
    build the structure once (accel.clusters.build_clusters_treelet, or
    the host quality cut accel.cuts.build_clusters_quality) and call
    render_pipeline.
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    if device is None:
        device = (vertices.device if isinstance(vertices, torch.Tensor)
                  else torch.device("cpu"))
    vertices = torch.as_tensor(vertices, device=device)
    faces = torch.as_tensor(faces, device=device)
    sun_position = torch.as_tensor(sun_position, dtype=torch.float32,
                                   device=device)
    camera = Camera.make(camera.eye, camera.dir, camera.up, camera.fov,
                         device=device)
    return render_pipeline(vertices, faces, camera, sun_position, config,
                           clusters=clusters, spheres=spheres)

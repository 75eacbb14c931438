"""The render pipeline (counterpart of ``ceres_tpu/render/renderer.py``:
``RenderConfig``, ``_scene_center``, ``_closest_primary``,
``_any_shadow``, ``_payload_cols``, ``prepare_winner_table``,
``render_wavefront_cols``, ``_wavefront_stats``, ``render_wavefront``,
``render_pipeline``, ``render``).

  1. Pinhole camera rays for every pixel.
  2. Closest hit: the cluster walk (``backend="megakernel"``, rays in 32 x
     32 pixel-block order, ``ops.megakernel``) or all pairs
     (``backend="bruteforce"``, the oracle, ``ops.intersect``).
  3. Miss -> black. Hit -> hit point eye + t * dir, offset by
     -1e-5 * normalize(face normal) against self-intersection.
  4. Shadow segment from the hit point to the sun (on the cluster walk,
     one common-origin wavefront cast from the sun); any occluder ->
     black.
  5. Otherwise Gouraud smooth shading from the corner vertex normals
     (``mode="smooth"``), or |normal| (``"flat"``; ``"normal"`` also
     ignores shadows).

``reference_compat=True`` reproduces the C++ reference exactly where the
default corrects it: the hit point u*p0 + v*p1 + (1-u-v)*p2 (off the
ray), Gouraud weights (u, v, 1-u-v), and shadow rays from the hit point
toward the sun with no upper bound, so geometry beyond the sun occludes
(generic-origin rays, ``megakernel.any_hit``).

Spheres (``spheres=(centers, radii)``) merge into the scene by closest
t: the hit point is offset along the sphere's outward normal, smooth
shading sees that normal on all three corners, and spheres occlude the
shadow segments (the whole ray under ``reference_compat``).

Precision follows the input dtype: float64 vertices render in float64,
the search in float32 with every observed value recomputed in float64
at the winners, or with ``f64_exact`` the search in float64 too.

Stats: "rays" counts traversals (one per pixel plus one shadow ray per
primary hit), "hits" counts primary hits plus occluded shadow rays, the
reference renderer's counting.

``render_graph`` captures a static scene's frame as a CUDA graph
(``FrameGraph``), the counterpart of the JAX package's ``_render_jit``
(``jax.jit`` over ``render_pipeline``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ceres_tpu_torch.models import shading as shading_mod
from ceres_tpu_torch.models.camera import (Camera, camera_ray_columns,
                                           camera_rays)
from ceres_tpu_torch.models.mesh import TriangleSoup, triangle_soup
from ceres_tpu_torch.ops import intersect as mt
from ceres_tpu_torch.ops import megakernel
from ceres_tpu_torch.ops import sphere as sphere_ops
from ceres_tpu_torch.utils import spans, tiling

SELF_INTERSECT_OFFSET = -1e-5
MODES = ("smooth", "flat", "normal")
BACKENDS = ("bruteforce", "megakernel")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings, field for field the JAX package's."""

    width: int = 1920
    height: int = 1080
    mode: str = "smooth"          # "smooth" | "flat" | "normal"
    backend: str = "bruteforce"   # "megakernel" | "bruteforce"
    shadows: bool = True
    # Also report the measured traversal counters (executed cluster
    # visits and Möller-Trumbore pairs of both wavefronts).
    traversal_stats: bool = False
    # The C++ reference's exact hit point, Gouraud weights and unbounded
    # shadow rays (module docstring).
    reference_compat: bool = False
    # The megakernel backend's search in float64 too (float64 inputs;
    # ``ops.walk_f64``), for scenes finer than float32 resolution.
    f64_exact: bool = False


def _check_config(config: RenderConfig) -> None:
    if config.backend not in BACKENDS:
        raise ValueError(f"unknown backend: {config.backend}")
    if config.mode not in MODES:
        raise ValueError(f"unknown shading mode: {config.mode}")


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _scene_center(soup: TriangleSoup) -> torch.Tensor:
    """The point generic shadow rays are taken relative to, keeping |o|
    small in their d x o terms (the result does not depend on it beyond
    rounding)."""
    return soup.p0.detach().mean(dim=0)


def _closest_primary(soup: TriangleSoup, camera: Camera, dirs, backend: str,
                     clusters=None) -> mt.Hit:
    """Closest hit of the common-origin primary wavefront, (R, 3) dirs."""
    if backend == "bruteforce":
        w = mt.triangle_weights_common_origin(soup, camera.eye)
        return mt.closest_hit_bruteforce(mt.ray_features_common_origin(dirs),
                                         w)
    return megakernel.closest_hit_common_origin(soup, camera.eye, dirs,
                                                clusters=clusters)


def _any_shadow(soup: TriangleSoup, origins, dirs, backend: str, skip=None,
                clusters=None):
    """Occlusion of the generic-origin shadow rays, (R, 3) origins and
    dirs."""
    center = _scene_center(soup)
    if backend == "bruteforce":
        w = mt.triangle_weights(soup, origin_shift=center)
        return mt.any_hit_bruteforce(mt.ray_features(origins - center, dirs),
                                     w)
    return megakernel.any_hit(soup, center, origins, dirs, skip=skip,
                              clusters=clusters)


def _payload_cols(soup: TriangleSoup, config: RenderConfig):
    """The per-triangle payload columns riding the winner gather, and
    n_pay, the index of the first compat-vertex column in the returned
    payload (the face normal's 3 columns come first): the nine
    corner-normal columns [n0 | n1 | n2] for smooth shading, then with
    ``reference_compat`` the winner's p0, e1, e2 for the compat hit
    point."""
    payload = []
    if config.mode == "smooth":
        if soup.corner_normals is None:
            raise ValueError("smooth shading requires corner_normals")
        cn = soup.corner_normals
        payload += [cn[:, k, a] for k in range(3) for a in range(3)]
    n_pay = len(payload) + 3
    if config.reference_compat:
        payload += [arr[:, a] for arr in (soup.p0, soup.e1, soup.e2)
                    for a in range(3)]
    return payload, n_pay


def prepare_winner_table(soup: TriangleSoup, clusters,
                         config: RenderConfig):
    """Loop-invariant winner table for static-geometry frame loops; pass
    it to render_pipeline(..., table_cols=...)."""
    _check_config(config)
    return megakernel.winner_table(soup, clusters,
                                   _payload_cols(soup, config)[0])


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


def _compat_points(hit, pay, n_pay):
    """The reference's hit point u*p0 + v*p1 + (1-u-v)*p2 from the
    winner's gathered p0, e1, e2 (p1 = p0 - e1, p2 = e2 + p0), pushed off
    the surface like ``_hit_points``. It does not lie on the ray."""
    n = pay[0:3]
    nsq = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    n_inv = torch.rsqrt(torch.where(hit.mask, nsq, 1.0))
    w_bar = 1.0 - hit.u - hit.v
    p0, e1, e2 = (pay[n_pay + 3 * k:n_pay + 3 * k + 3] for k in range(3))
    return tuple(hit.u * p0[a] + hit.v * (p0[a] - e1[a])
                 + w_bar * (e2[a] + p0[a])
                 + SELF_INTERSECT_OFFSET * n[a] * n_inv for a in range(3))


def render_wavefront_cols(soup: TriangleSoup, camera: Camera, sun_position,
                          dir_cols, config: RenderConfig, clusters=None,
                          spheres=None, table_cols=None):
    """Column-form wavefront render on the cluster walk -> (3-tuple of
    (R,) colours, stats).

    ``dir_cols`` is a 3-tuple of (R,) normalised primary directions from
    ``camera.eye``; ``clusters`` the prebuilt ClusterSet of ``soup`` (None:
    the treelet cut is built once for both wavefronts); ``spheres`` an
    optional pair (centers (S, 3), radii (S,)) merged by closest t.
    """
    _check_config(config)
    clusters = megakernel._treelet(soup, clusters)
    want_counts = config.traversal_stats
    payload, n_pay = _payload_cols(soup, config)
    res = megakernel.closest_hit_common_origin(
        soup, camera.eye, dir_cols, clusters=clusters, payload=payload,
        with_counts=want_counts, normal_cols=True,
        exact_f64=config.f64_exact, table_cols=table_cols)
    (hit, pay), counts1 = (res[:2], res[2]) if want_counts else (res, None)
    with spans.span("shade"):
        mask = hit.mask
        if config.reference_compat:
            point = _compat_points(hit, pay, n_pay)
        else:
            point = _hit_points(camera.eye, dir_cols, hit, pay[0:3])
        n, u_eff, v_eff = pay[0:3], hit.u, hit.v
        corner_cols = pay[3:12] if config.mode == "smooth" else None
        if spheres is not None:
            centers, radii = spheres
            s_t, s_mask, _, s_nrm = sphere_ops.closest_hit_common_origin_cols(
                camera.eye, dir_cols, centers, radii)
            sph_win = s_mask & (s_t < hit.t)    # hit.t is inf at misses
            mask = mask | s_mask
            st_safe = torch.where(sph_win, s_t, 0.0)
            # Offset along the outward normal: the triangles' -1e-5 * n
            # runs along their left-handed normal, into the surface.
            point = tuple(torch.where(
                sph_win, camera.eye[a] + st_safe * dir_cols[a]
                - SELF_INTERSECT_OFFSET * s_nrm[a], point[a])
                for a in range(3))
            n = tuple(torch.where(sph_win, s_nrm[a], n[a]) for a in range(3))
            u_eff = torch.where(sph_win, 0.0, u_eff)
            v_eff = torch.where(sph_win, 0.0, v_eff)
            if corner_cols is not None:
                corner_cols = [torch.where(sph_win, s_nrm[j % 3],
                                           corner_cols[j]) for j in range(9)]
        sl = tuple(sun_position[a] - point[a] for a in range(3))
        sl_inv = torch.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
        sun_line = tuple(c * sl_inv for c in sl)

    counts2 = None
    if config.shadows:
        if config.reference_compat:
            # The reference's query: an unbounded ray from the hit point
            # toward the sun, so occluders beyond the sun darken too.
            res2 = megakernel.any_hit(
                soup, _scene_center(soup), point, sun_line, skip=~mask,
                clusters=clusters, with_counts=want_counts,
                exact_f64=config.f64_exact)
        else:
            res2 = megakernel.any_hit_to_point(
                soup, sun_position, point, skip=~mask, clusters=clusters,
                with_counts=want_counts, exact_f64=config.f64_exact)
        occluded, counts2 = res2 if want_counts else (res2, None)
        if spheres is not None:
            # The segment test ends short of the sun.
            tmax_s = (torch.inf if config.reference_compat
                      else (1.0 / sl_inv) * (1.0 - 1e-4))
            occluded = occluded | (sphere_ops.any_hit_cols(
                point, sun_line, centers, radii, tmax=tmax_s) & mask)
    else:
        occluded = torch.zeros_like(mask)

    with spans.span("shade"):
        if config.mode == "smooth":
            shade = shading_mod.smooth_shading_cols(
                sun_line, corner_cols, dir_cols, u_eff, v_eff,
                reference_compat=config.reference_compat)
        else:
            shade = shading_mod.flat_shading_cols(n, guard=mask)
            if config.mode == "normal":   # no lighting, no shadows
                occluded = torch.zeros_like(occluded)
        lit = mask & ~occluded
        color = tuple(torch.where(lit, s, 0.0) for s in shade)
        stats = _wavefront_stats(mask, occluded, dir_cols[0].shape[0], soup,
                                 config, counts1, counts2)
    return color, stats


def _wavefront_stats(mask, occluded, R, soup, config, counts1, counts2):
    """rays/hits counts, and the traversal counters when
    ``config.traversal_stats`` is set: measured by the walk (``counts1``,
    ``counts2``), or for brute force no steps and R x T pair tests per
    wavefront. Values are 0-dim int64 tensors."""
    primary_hits = mask.sum()
    shadow_hits = (mask & occluded).sum()
    stats = {
        "rays": R + primary_hits,
        "hits": primary_hits + shadow_hits,
        "primary_hits": primary_hits,
        "shadow_hits": shadow_hits,
    }
    if config.traversal_stats:
        if counts1 is not None:
            c2 = counts2 or {k: 0 for k in counts1}
            stats["traversal_steps"] = (counts1["traversal_steps"]
                                        + c2["traversal_steps"])
            stats["intersections"] = counts1["mt_pairs"] + c2["mt_pairs"]
            stats["mt_block_visits"] = (counts1["mt_block_visits"]
                                        + c2["mt_block_visits"])
        else:
            zero = torch.zeros((), dtype=torch.int64, device=mask.device)
            stats["traversal_steps"] = zero
            stats["intersections"] = zero + (
                R * soup.num_triangles * (2 if config.shadows else 1))
    return stats


def render_wavefront(soup: TriangleSoup, camera: Camera, sun_position,
                     dirs: torch.Tensor, config: RenderConfig, clusters=None,
                     spheres=None, table_cols=None):
    """Render a flat wavefront of (R, 3) primary directions -> ((R, 3)
    colours, stats). The megakernel backend runs
    :func:`render_wavefront_cols`; brute force keeps the dense (R, 3)
    form: it is the oracle, not a performance path."""
    _check_config(config)
    if config.backend == "megakernel":
        cols, stats = render_wavefront_cols(
            soup, camera, sun_position, tuple(dirs.unbind(-1)), config,
            clusters=clusters, spheres=spheres, table_cols=table_cols)
        return torch.stack(cols, dim=-1), stats

    hit = _closest_primary(soup, camera, dirs, config.backend)
    mask = hit.mask
    prim = torch.where(mask, hit.prim_id, 0)
    u, v = hit.u, hit.v
    # One row gather of every per-triangle value the rays need
    # (``megakernel._gather_rows``: its backward adds with atomics).
    table = [soup.n]
    if config.mode == "smooth":
        if soup.corner_normals is None:
            raise ValueError("smooth shading requires corner_normals")
        table.append(soup.corner_normals.reshape(-1, 9))
    if config.reference_compat:
        table += [soup.p0, soup.e1, soup.e2]
    rec = megakernel._gather_rows(torch.cat(table, dim=-1), prim)
    n, rest = rec[:, :3], rec[:, 3:]
    corners = None
    if config.mode == "smooth":
        corners, rest = rest[:, :9].reshape(-1, 3, 3), rest[:, 9:]
    if config.reference_compat:
        p0 = rest[:, 0:3]
        p1 = p0 - rest[:, 3:6]
        p2 = rest[:, 6:9] + p0
        point = (u[:, None] * p0 + v[:, None] * p1
                 + (1.0 - u - v)[:, None] * p2)
    else:
        t_safe = torch.where(mask, hit.t, 0.0)
        point = camera.eye + t_safe[:, None] * dirs
    point = point + SELF_INTERSECT_OFFSET * _normalize(n)

    if spheres is not None:
        # The dense form of render_wavefront_cols' sphere merge.
        centers, radii = spheres
        sph = sphere_ops.closest_hit(camera.eye.expand(dirs.shape), dirs,
                                     centers, radii)
        sph_win = sph.mask & (sph.t < torch.where(mask, hit.t, torch.inf))
        mask = mask | sph.mask
        st_safe = torch.where(sph_win, sph.t, 0.0)
        s_point = camera.eye + st_safe[:, None] * dirs
        s_nrm = sphere_ops.normal_at(s_point, centers, sph.sphere_id)
        point = torch.where(sph_win[:, None],
                            s_point - SELF_INTERSECT_OFFSET * s_nrm, point)
        n = torch.where(sph_win[:, None], s_nrm, n)
        u = torch.where(sph_win, 0.0, u)
        v = torch.where(sph_win, 0.0, v)
        if corners is not None:
            corners = torch.where(sph_win[:, None, None], s_nrm[:, None, :],
                                  corners)
    sun_line = _normalize(sun_position[None, :] - point)

    if config.shadows:
        occluded = _any_shadow(soup, point, sun_line, config.backend,
                               skip=~mask)
        if spheres is not None:
            if config.reference_compat:
                tmax_s = torch.inf
            else:
                dist = torch.linalg.vector_norm(sun_position[None, :] - point,
                                                dim=-1)
                tmax_s = (dist * (1.0 - 1e-4))[:, None]
            occluded = occluded | (sphere_ops.any_hit(
                point, sun_line, centers, radii, tmax=tmax_s) & mask)
    else:
        occluded = torch.zeros_like(mask)
    if config.mode == "smooth":
        shade = shading_mod.smooth_shading(
            sun_line, corners, dirs, u, v,
            reference_compat=config.reference_compat)
    else:
        shade = shading_mod.flat_shading(n)
        if config.mode == "normal":
            occluded = torch.zeros_like(occluded)
    lit = mask & ~occluded
    color = torch.where(lit[:, None], shade, 0.0)
    stats = _wavefront_stats(mask, occluded, dirs.shape[0], soup, config,
                             None, None)
    return color, stats


def render_pipeline(vertices: torch.Tensor, faces: torch.Tensor,
                    camera: Camera, sun_position: torch.Tensor,
                    config: RenderConfig, clusters=None, spheres=None,
                    table_cols=None):
    """Full pipeline from an indexed mesh -> ((H, W, 3) image, stats).

    ``clusters`` is the prebuilt ClusterSet of this mesh (built once
    before a frame loop, like the reference's BVH); ``table_cols`` the
    prebuilt winner table (prepare_winner_table); ``spheres`` an optional
    pair (centers (S, 3), radii (S,)). Runs on the device and in the
    dtype of ``vertices``.
    """
    if faces.shape[0] == 0:
        raise ValueError("scene has no triangles")
    _check_config(config)
    with spans.recording(vertices.device), spans.span("frame"):
        soup = triangle_soup(vertices, faces,
                             with_normals=config.mode == "smooth")
        if config.backend == "bruteforce":
            dirs = camera_rays(camera, config.width,
                               config.height).reshape(-1, 3)
            color, stats = render_wavefront(soup, camera, sun_position, dirs,
                                            config, spheres=spheres)
            return color.reshape(config.height, config.width, 3), stats
        with spans.span("primary"):
            planes = camera_ray_columns(camera, config.width, config.height)
            dir_cols = tuple(tiling.swizzle_plane(p) for p in planes)
        color, stats = render_wavefront_cols(
            soup, camera, sun_position, dir_cols, config, clusters=clusters,
            spheres=spheres, table_cols=table_cols)
        with spans.span("shade"):
            image = torch.stack([tiling.unswizzle_plane(c, config.height,
                                                        config.width)
                                 for c in color], dim=-1)
            # Padding rays are inert; drop them from the ray count.
            stats["rays"] = stats["rays"] - (dir_cols[0].shape[0]
                                             - config.height * config.width)
    return image, stats


def resolve_device(vertices, device, caller: str) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    device of ``vertices`` if it is a tensor, else the card; without one
    it raises (``device="cpu"`` runs on the CPU)."""
    if device is not None:
        return torch.device(device)
    if isinstance(vertices, torch.Tensor):
        return vertices.device
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(f"{caller}: no CUDA card for numpy inputs; pass "
                       "device='cpu' to run on the CPU")


def render(vertices, faces, camera: Camera, sun_position,
           config: Optional[RenderConfig] = None, spheres=None, clusters=None,
           device=None, **kwargs):
    """User-facing render call; kwargs override RenderConfig fields.

    Inputs may be numpy arrays or tensors; everything runs on ``device``
    (default: the device of ``vertices`` if it is a tensor, else the
    card; without one it raises: pass ``device="cpu"`` to render on the
    CPU). Precision follows the vertices' dtype: the camera, the sun and
    ``spheres`` (centers reshaped to (S, 3), radii to (S,)) are taken in
    it. Without ``clusters`` the LBVH treelet cut is built on the device
    first, as the JAX package's ``render`` does. For frame loops, build
    the structure once (accel.clusters.build_clusters_treelet, or the
    host quality cut accel.cuts.build_clusters_quality) and call
    render_pipeline.
    """
    config = dataclasses.replace(config or RenderConfig(), **kwargs)
    device = resolve_device(vertices, device, "render")
    vertices = torch.as_tensor(vertices, device=device)
    faces = torch.as_tensor(faces, device=device)
    dtype = vertices.dtype
    sun_position = torch.as_tensor(sun_position, dtype=dtype, device=device)
    camera = Camera.make(camera.eye, camera.dir, camera.up, camera.fov,
                         dtype=dtype, device=device)
    return render_pipeline(vertices, faces, camera, sun_position, config,
                           clusters=clusters,
                           spheres=_as_spheres(spheres, dtype, device))


class FrameGraph:
    """A frame captured once as a CUDA graph and replayed (the
    counterpart of the JAX package's jitted ``render_pipeline``). Made by
    :func:`render_graph`.

    ``frame(sun_position=None, camera=None, vertices=None)`` copies a new
    sun, the camera's eye, dir, up and fov, and/or moved vertices (same
    shape and dtype) into the graph's buffers, replays the frame and
    returns ``(image, stats)``: the graph's own output tensors, which the
    next call overwrites (clone what must outlive it). Moved vertices
    need a graph that builds its cut: one captured with a prebuilt
    ``clusters`` or ``table_cols`` refuses them, as that cut would be
    stale. Pass inputs as tensors on the card: a host array costs a copy
    that waits on the device. On the CPU (only when asked for, by CPU
    tensors or ``device="cpu"``) each call runs ``render_pipeline``
    eagerly on the same buffers and returns fresh tensors.

    ``span_ms()`` gives the last call's span milliseconds by name (see
    ``utils.spans``) when spans were on at the capture (on the CPU: at
    that call), else None; ``record`` is the span record behind it (the
    capture's; on the CPU the last call's made with spans on), or None.
    """

    def __init__(self, vertices, faces, camera: Camera, sun_position,
                 config: RenderConfig, clusters, table_cols, spheres):
        self._vertices = vertices
        self._faces = faces
        self._camera = camera
        self._sun = sun_position
        self._config = config
        self._clusters = clusters
        self._table = table_cols
        self._spheres = spheres
        self._graph = None
        self.record = None
        if vertices.device.type != "cpu":
            from ceres_tpu_torch.utils import graphs

            self._graph = graphs.capture(
                self._frame, (vertices, faces, camera, sun_position,
                              clusters, table_cols, spheres))
            self.record = self._graph.record

    @property
    def launches(self) -> dict:
        """Walk launches a replay makes, by variant (empty on the CPU)."""
        return dict(self._graph.launches) if self._graph else {}

    def span_ms(self):
        """The last call's span milliseconds by name, or None (spans were
        off); on the card this waits for the device."""
        return None if self.record is None else self.record.span_ms()

    def _frame(self):
        with torch.no_grad():
            return render_pipeline(self._vertices, self._faces, self._camera,
                                   self._sun, self._config,
                                   clusters=self._clusters,
                                   spheres=self._spheres,
                                   table_cols=self._table)

    def __call__(self, sun_position=None, camera: Optional[Camera] = None,
                 vertices=None):
        with spans.host("frame.inputs"):
            self._inputs(sun_position, camera, vertices)
        if self._graph is not None:
            with spans.host("frame.replay"):
                return self._graph.replay()
        with spans.recording(self._vertices.device) as record:
            out = self._frame()
        if record is not None:
            self.record = record
        return out

    def _inputs(self, sun_position, camera, vertices):
        """Copy the call's inputs into the graph's buffers."""
        if vertices is not None:
            if self._clusters is not None or self._table is not None:
                raise ValueError("FrameGraph: moved vertices need a frame "
                                 "that builds its cut; this one was "
                                 "captured with a prebuilt clusters or "
                                 "table_cols, which would be stale")
            vertices = torch.as_tensor(vertices)
            if (vertices.shape != self._vertices.shape
                    or vertices.dtype != self._vertices.dtype):
                raise ValueError(
                    f"FrameGraph: vertices {tuple(vertices.shape)} "
                    f"{vertices.dtype}, the graph's "
                    f"{tuple(self._vertices.shape)} {self._vertices.dtype}")
            self._vertices.copy_(vertices)
        if sun_position is not None:
            self._sun.copy_(torch.as_tensor(sun_position))
        if camera is not None:
            for name in ("eye", "dir", "up", "fov"):
                getattr(self._camera, name).copy_(
                    torch.as_tensor(getattr(camera, name)))


def render_graph(vertices, faces, camera: Camera, sun_position,
                 config: RenderConfig, clusters=None, table_cols=None,
                 spheres=None, device=None) -> FrameGraph:
    """Capture a frame as a CUDA graph: a :class:`FrameGraph`, called
    once a frame with the moved sun, camera or vertices.

    With ``clusters`` (the scene's prebuilt cut) and ``table_cols``
    (``prepare_winner_table``), on the device, the graph replays a
    static scene's frame. Without them it builds the LBVH treelet cut
    and the winner table inside the graph, as the JAX package's jitted
    ``render()`` does: the frame of a deforming scene, called with its
    moved vertices. Inputs may be numpy arrays or tensors; the mesh,
    camera, sun and ``spheres`` are copied into the graph's buffers in
    the vertices' dtype. Runs on ``device`` as ``render()`` resolves it
    (the card unless CPU tensors or ``device="cpu"`` are given). Only the
    cluster walk is captured: ``backend="bruteforce"`` (the oracle)
    raises. ``f64_exact`` (the float64 search, ``ops.walk_f64``: its
    kernel on the card) is captured too, and needs float64 vertices, as
    a frame of it does (it raises otherwise).
    """
    _check_config(config)
    if config.backend != "megakernel":
        raise ValueError("render_graph captures the cluster walk "
                         "(backend='megakernel'); backend='bruteforce' is "
                         "the all-pairs oracle, run it through "
                         "render_pipeline")
    device = resolve_device(vertices, device, "render_graph")
    vertices = torch.as_tensor(vertices, device=device).detach().clone()
    if config.f64_exact and vertices.dtype != torch.float64:
        raise ValueError(f"render_graph: f64_exact searches in float64 and "
                         f"needs float64 vertices, not {vertices.dtype}")
    faces = torch.as_tensor(faces, device=device).clone()
    dtype = vertices.dtype
    camera = Camera(*(torch.as_tensor(getattr(camera, k), dtype=dtype,
                                      device=device).detach().clone()
                      for k in ("eye", "dir", "up", "fov")))
    sun_position = torch.as_tensor(sun_position, dtype=dtype,
                                   device=device).detach().clone()
    spheres = _as_spheres(spheres, dtype, device)
    if spheres is not None:
        spheres = tuple(x.clone() for x in spheres)
    for name, x in (("clusters", None if clusters is None else clusters.lo),
                    ("table_cols", table_cols)):
        if x is not None and x.device != vertices.device:
            raise ValueError(f"render_graph: {name} is on {x.device}, the "
                             f"frame on {vertices.device}")
    return FrameGraph(vertices, faces, camera, sun_position, config,
                      clusters, table_cols, spheres)


def _as_spheres(spheres, dtype, device):
    """An optional (centers, radii) pair as tensors: (S, 3) and (S,)."""
    if spheres is None:
        return None
    centers, radii = spheres
    centers = torch.as_tensor(centers, dtype=dtype, device=device)
    radii = torch.as_tensor(radii, dtype=dtype, device=device)
    return centers.reshape(-1, 3), radii.reshape(-1)

"""The plain float64 reference renderer that decides ``correct`` for the
float64-exact cells (``bunny4x-1080p-f64.static``).

Plain PyTorch, importing nothing of the port (nor ``jax`` or the JAX
package). It renders ``reference.py``'s frame (smooth shading, sun
shadows; the same steps, constants and conservative binning, its
``_bins``, ``_pairs``, ``_mt``, ``occluded``, ``vertex_normals`` and
``_pow24``) with every quantity in float64 (``dtype``), the camera's
ray directions included, which ``reference.camera_dirs`` takes in
float32 (and with math.pi for the camera model's PI). The closest hit
is exact in that precision: the smallest t over every pair the binning
keeps, ties to the lower triangle id, in two passes over the pairs
(``reference.closest`` orders the pairs by t rounded to float32, which
would decide a float64 winner in float32). The pairs are evaluated in
chunks of at most PAIRS_PER_CHUNK, so that a 1080p frame of 1.27M
triangles fits on the card.

Departures from the upstream renderer (``include/anim.cpp`` built with
``-d``, ``Scalar = double``), all shared with the port's default frame
(``RenderConfig(reference_compat=False)``):

  * the hit point is eye + t dir pushed off the surface by 1e-5 along
    the unit face normal; upstream interpolates u p0 + v p1 + (1 - u - v)
    p2 (off the ray);
  * Gouraud weights (1 - u - v, u, v) on the corners (p0, p1, p2);
    upstream weights (u, v, 1 - u - v);
  * the shadow test is the segment from the sun (t = 0) to the hit point
    (t = 1), occluded by a triangle at 0 <= t <= 1 - 4e-6; upstream casts
    an unbounded ray from the hit point toward the sun, so geometry past
    the sun occludes too;
  * the vertex normals are area-weighted sums of the face normals, made
    here; upstream reads them from the OBJ file's normals.

``dtype=torch.float32`` runs the same arithmetic in float32, camera
directions and closest hit included (the control); the binning, which
decides no answer, stays in float64.

The card's float32 matrix products would run in TF32 where allowed: this
module turns ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` off (it multiplies no matrices).
"""

from __future__ import annotations

import math

import torch

from raybench import reference

PAIRS_PER_CHUNK = 1 << 23
# Degrees to radians of the camera's fov: the camera model's constant (the
# port's and the JAX package's ``_PI``), which float32 does not tell from
# math.pi (``reference.camera_dirs``) and float64 does.
PI = 3.14159265

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def camera_dirs(cam: dict, width: int, height: int, dtype, device):
    """(H * W, 3) unit ray directions in ``dtype``, row-major over pixel
    rows: ``reference.camera_dirs``'s formula, every step in ``dtype``,
    the fov taken to radians with PI."""
    def vec(x):
        return torch.as_tensor(x, device=device).to(dtype)

    d = reference._unit(vec(cam["dir"]))
    up = vec(cam["up"])
    tan = math.tan(float(cam["fov"]) * (PI / 180.0 * 0.5))
    side = reference._cross(d, up)
    iu = reference._unit(side) * tan
    iv = reference._unit(reference._cross(side, d)) * tan * (height / width)
    i = torch.arange(width, dtype=dtype, device=device)
    j = torch.arange(height, dtype=dtype, device=device)
    u = (2.0 * (i + 0.5) / width - 1.0)[None, :, None]
    v = (2.0 * (j + 0.5) / height - 1.0)[:, None, None]
    return reference._unit(u * iu + v * iv + d).reshape(-1, 3)


def _chunks(pairs):
    """``reference._pairs``' chunks cut to at most PAIRS_PER_CHUNK."""
    for ray, t_id in pairs:
        for a in range(0, ray.numel(), PAIRS_PER_CHUNK):
            yield ray[a:a + PAIRS_PER_CHUNK], t_id[a:a + PAIRS_PER_CHUNK]


def closest(origin, dirs, vertices, faces):
    """(R,) winning triangle ids, -1 where a ray hits nothing: the
    smallest t >= 0 from the common ``origin`` in the inputs' precision,
    ties to the lower id. Detached."""
    with torch.no_grad():
        p0, e1, e2 = reference._records(vertices, faces)
        R = dirs.shape[0]
        live = torch.ones(R, dtype=torch.bool, device=dirs.device)
        tri = torch.stack([p0, p0 - e1, p0 + e2], 1)
        bins = reference._bins(origin, dirs, live, tri)
        inf = torch.tensor(float("inf"), dtype=dirs.dtype, device=dirs.device)
        best = torch.full((R,), float("inf"), dtype=dirs.dtype,
                          device=dirs.device)

        def tested():
            for ray, t_id in _chunks(reference._pairs(*bins)):
                t, _, _, ok = reference._mt(origin, dirs[ray], p0[t_id],
                                            e1[t_id], e2[t_id])
                yield ray, t_id, torch.where(ok & (t >= 0), t, inf)

        for ray, _, t in tested():
            best.scatter_reduce_(0, ray, t, reduce="amin")
        none = torch.iinfo(torch.int64).max
        win = torch.full((R,), none, dtype=torch.int64, device=dirs.device)
        for ray, t_id, t in tested():
            key = torch.where((t == best[ray]) & (t < inf), t_id, none)
            win.scatter_reduce_(0, ray, key, reduce="amin")
        return torch.where(win != none, win, -1)


def frame(vertices, faces, eye, cam: dict, sun, width: int, height: int,
          dtype=torch.float64):
    """((H, W, 3) image, {"rays", "hits"} ints) of one frame in
    ``dtype``; ``faces`` is (F, 3) int64 on the vertices' device."""
    dev = vertices.device
    with torch.no_grad():
        v = vertices.to(dtype)
        eye = torch.as_tensor(eye, device=dev).to(dtype)
        sun = torch.as_tensor(sun, device=dev).to(dtype)
        dirs = camera_dirs(cam, width, height, dtype, dev)
        win = closest(eye, dirs, v, faces)
        hit = torch.nonzero(win >= 0).squeeze(1)
        f = faces[win[hit]]
        p0, e1 = v[f[:, 0]], v[f[:, 0]] - v[f[:, 1]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        d = dirs[hit]
        t, u, w2, _ = reference._mt(eye, d, p0, e1, e2)
        n = reference._cross(e1, e2)
        point = eye + t[:, None] * d + reference.OFFSET * reference._unit(n)
        shadow = reference.occluded(sun, point, torch.ones_like(
            t, dtype=torch.bool), v, faces)
        sun_line = reference._unit(sun - point)
        half = reference._unit(sun_line - d)
        normals = reference.vertex_normals(v, faces)[f]
        tint = torch.as_tensor(reference.TINT, dtype=dtype, device=dev)
        colour = 0.0
        for k, weight in enumerate((1.0 - u - w2, u, w2)):
            nk = normals[:, k]
            base = (reference.AMBIENT
                    + reference.DIFFUSE * reference._dot(sun_line, nk).abs())
            spec = reference.SPECULAR * reference._pow24(
                reference._dot(nk, half))
            corner = (base[:, None] * tint + spec[:, None]).clamp(0.0, 1.0)
            colour = colour + weight[:, None] * corner
        lit = (~shadow).to(dtype)[:, None]
        image = torch.zeros((height * width, 3), dtype=dtype, device=dev)
        image = image.index_put((hit,), colour * lit)
        n_hit = hit.numel()
        stats = {"rays": width * height + n_hit,
                 "hits": n_hit + int(shadow.sum())}
    return image.reshape(height, width, 3), stats

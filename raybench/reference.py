"""The plain reference renderer that decides ``correct``.

Plain PyTorch, written from the renderer's documented semantics and
importing nothing of the port (nor ``jax`` or the JAX package). It takes
only what the benchmark hands to both sides (mesh, camera, sun, moved
vertices, target image) and builds nothing the port built: no cut, no
winner table, no walk inputs.

The frame (default mode of ``RenderConfig``: smooth shading, shadows):

  1. Pinhole rays: dir = normalize(u * iu + v * iv + d), d = normalize
     (camera dir), iu = normalize(d x up) tan(fov / 2), iv = normalize
     ((d x up) x d) tan(fov / 2) H / W, u = 2 (i + .5) / W - 1, v =
     2 (j + .5) / H - 1 for pixel column i and row j.
  2. The closest triangle at t >= 0 by Moller-Trumbore on the records
     p0, e1 = p0 - p1, e2 = p2 - p0, n = e1 x e2: c = p0 - o, r = d x c,
     det = n.d, u = r.e2 / det, v = r.e1 / det, t = n.c / det, accepted
     where u, v, 1 - u - v >= 0 and det != 0; ties to the lower
     triangle id.
  3. The hit point eye + t dir - 1e-5 normalize(n).
  4. Shadow: the segment from the sun (t = 0) to the hit point (t = 1)
     is occluded by a triangle hit at 0 <= t <= 1 - 4e-6.
  5. Gouraud shading of the corner normals (area-weighted vertex normals)
     with weights (1 - u - v, u, v): per corner ambient 0.2 + 0.5 |sun.n|
     times the tint (0.5, 0, 0.8), plus 0.8 (n.normalize(sun - dir))^24,
     clamped to [0, 1]; black where missed or occluded.
  6. Stats: rays = pixels + primary hits, hits = primary hits + occluded
     shadow rays.

The search is exhaustive over the pairs that a conservative binning can
not rule out: rays from a common origin (the eye, or the sun for the
shadow segments) are binned by their central projection about that
origin, each triangle by the box of its projected corners, and every
ray is tested against every triangle of its bin. A triangle with a
corner behind the origin's plane goes into every bin.

``dtype`` runs the same arithmetic in another precision (the control:
``torch.bfloat16``); the binning, which decides no answer, is taken in
float64 on the rounded inputs.
"""

from __future__ import annotations

import math

import torch

AMBIENT, DIFFUSE, SPECULAR = 0.2, 0.5, 0.8
TINT = (0.5, 0.0, 0.8)
OFFSET = -1e-5          # along normalize(n), against self-intersection
SEGMENT_END = 1.0 - 4e-6  # the shadow segment stops short of the receiver
RAYS_PER_BIN = 32       # live rays per occupied bin, about
PAIRS_PER_CHUNK = 1 << 24


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(a):
    return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)


def camera_dirs(cam: dict, width: int, height: int, dtype, device):
    """(H * W, 3) unit ray directions, row-major over pixel rows."""
    d = _unit(torch.as_tensor(cam["dir"], dtype=torch.float32, device=device))
    up = torch.as_tensor(cam["up"], dtype=torch.float32, device=device)
    tan = math.tan(float(cam["fov"]) * math.pi / 360.0)
    side = _cross(d, up)
    iu = _unit(side) * tan
    iv = _unit(_cross(side, d)) * tan * (height / width)
    i = torch.arange(width, dtype=torch.float32, device=device)
    j = torch.arange(height, dtype=torch.float32, device=device)
    u = (2.0 * (i + 0.5) / width - 1.0)[None, :, None]
    v = (2.0 * (j + 0.5) / height - 1.0)[:, None, None]
    return _unit(u * iu + v * iv + d).reshape(-1, 3).to(dtype)


def _frame_of(axis):
    """Two unit vectors orthogonal to ``axis`` and to each other."""
    helper = torch.zeros_like(axis)
    helper[int(torch.argmin(axis.abs()))] = 1.0
    b1 = _unit(_cross(axis, helper))
    return b1, _cross(axis, b1)


def _bins(origin, dirs, live, tri):
    """Conservative binning of rays and triangles about a common origin.

    Returns (ray order by bin, rays per bin, bin starts, entry triangle,
    entry bin): every (triangle, bin) pair the triangle's padded
    projected box touches, for occupied bins only. The projections are
    taken in float64, so that they decide nothing that the float32 test
    would decide otherwise; each box is padded by a quarter of its size
    and a twentieth of a bin."""
    o = origin.double()
    d = dirs.double()
    axis = _unit(d[live].mean(0))
    b1, b2 = _frame_of(axis)
    z = _dot(d, axis)
    if bool((z[live] <= 0).any()):
        raise ValueError("reference: a live ray points away from the bins' "
                         "axis")
    x, y = _dot(d, b1) / z, _dot(d, b2) / z
    lx, ly = x[live], y[live]
    x0, x1, y0, y1 = (float(lx.min()), float(lx.max()), float(ly.min()),
                      float(ly.max()))
    n_live = int(live.sum())
    span = max(x1 - x0, y1 - y0, 1e-300)
    cw = max(span / max(1.0, math.sqrt(n_live / RAYS_PER_BIN)), span / 4096)
    gx = int((x1 - x0) / cw) + 1
    gy = int((y1 - y0) / cw) + 1
    cx = ((x - x0) / cw).floor().clamp(0, gx - 1).long()
    cy = ((y - y0) / cw).floor().clamp(0, gy - 1).long()
    cell = torch.where(live, cy * gx + cx, gx * gy)
    order = torch.argsort(cell, stable=True)
    count = torch.bincount(cell, minlength=gx * gy + 1)[:gx * gy]
    start = torch.cumsum(count, 0) - count

    q = tri.double() - o                                  # (T, 3, 3)
    qz = _dot(q, axis)
    behind = (qz <= 1e-9 * q.norm(dim=-1)).any(1)
    qz = torch.where(qz > 0, qz, 1.0)
    px, py = _dot(q, b1) / qz, _dot(q, b2) / qz
    lo_x, hi_x, lo_y, hi_y = px.amin(1), px.amax(1), py.amin(1), py.amax(1)
    pad = 0.25 * torch.maximum(hi_x - lo_x, hi_y - lo_y) + 0.05 * cw
    tx0 = ((lo_x - pad - x0) / cw).floor()
    tx1 = ((hi_x + pad - x0) / cw).floor()
    ty0 = ((lo_y - pad - y0) / cw).floor()
    ty1 = ((hi_y + pad - y0) / cw).floor()
    inside = (tx1 >= 0) & (tx0 <= gx - 1) & (ty1 >= 0) & (ty0 <= gy - 1)
    tx0 = torch.where(behind, 0, tx0.clamp(0, gx - 1)).long()
    tx1 = torch.where(behind, gx - 1, tx1.clamp(0, gx - 1)).long()
    ty0 = torch.where(behind, 0, ty0.clamp(0, gy - 1)).long()
    ty1 = torch.where(behind, gy - 1, ty1.clamp(0, gy - 1)).long()
    nx, ny = tx1 - tx0 + 1, ty1 - ty0 + 1
    per = torch.where(inside | behind, nx * ny, 0)
    ids = torch.arange(tri.shape[0], device=tri.device)
    e_tri = torch.repeat_interleave(ids, per)
    local = (torch.arange(e_tri.numel(), device=tri.device)
             - torch.repeat_interleave(torch.cumsum(per, 0) - per, per))
    e_cell = ((ty0[e_tri] + local // nx[e_tri]) * gx
              + tx0[e_tri] + local % nx[e_tri])
    keep = count[e_cell] > 0
    return order, count, start, e_tri[keep], e_cell[keep]


def _pairs(order, count, start, e_tri, e_cell):
    """(ray, triangle) index chunks of at most PAIRS_PER_CHUNK pairs
    (one entry's rays are never split)."""
    per = count[e_cell]
    ends = torch.cumsum(per, 0)
    bounds = [0]
    total = int(ends[-1]) if ends.numel() else 0
    cuts = torch.tensor(range(PAIRS_PER_CHUNK, total, PAIRS_PER_CHUNK),
                        dtype=ends.dtype, device=ends.device)
    bounds += torch.searchsorted(ends, cuts, right=True).tolist()
    bounds.append(e_tri.numel())
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b <= a:
            continue
        n = per[a:b]
        entry = torch.repeat_interleave(torch.arange(a, b, device=n.device),
                                        n)
        first = torch.cumsum(n, 0) - n
        off = (torch.arange(entry.numel(), device=n.device)
               - torch.repeat_interleave(first, n))
        yield order[start[e_cell[entry]] + off], e_tri[entry]


def _mt(o, d, p0, e1, e2):
    """Moller-Trumbore t, u, v and the barycentric accept mask, pairwise;
    det == 0 rejects."""
    n = _cross(e1, e2)
    c = p0 - o
    r = _cross(d, c)
    det = _dot(n, d)
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    u, v, t = _dot(r, e2) * inv, _dot(r, e1) * inv, _dot(n, c) * inv
    ok = ok & (u >= 0) & (v >= 0) & (1.0 - u - v >= 0)
    return t, u, v, ok


def _records(vertices, faces):
    p0, p1, p2 = (vertices[faces[:, k]] for k in range(3))
    return p0, p0 - p1, p2 - p0


def closest(origin, dirs, vertices, faces):
    """(R,) winning triangle ids, -1 where a ray hits nothing: the
    closest hit at t >= 0 from the common ``origin``, ties to the lower
    id. Detached."""
    with torch.no_grad():
        p0, e1, e2 = _records(vertices, faces)
        R = dirs.shape[0]
        live = torch.ones(R, dtype=torch.bool, device=dirs.device)
        tri = torch.stack([p0, p0 - e1, p0 + e2], 1)
        best = torch.full((R,), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=dirs.device)
        for ray, t_id in _pairs(*_bins(origin, dirs, live, tri)):
            t, _, _, ok = _mt(origin, dirs[ray], p0[t_id], e1[t_id],
                              e2[t_id])
            ok = ok & (t >= 0)
            bits = (t.float() + 0.0).view(torch.int32).long()
            key = torch.where(ok, (bits << 32) | t_id,
                              torch.iinfo(torch.int64).max)
            best.scatter_reduce_(0, ray, key, reduce="amin")
        hit = best != torch.iinfo(torch.int64).max
        return torch.where(hit, best & 0xFFFFFFFF, -1)


def occluded(sun, points, live, vertices, faces):
    """(R,) bool: the segment from ``sun`` to ``points[i]`` meets a
    triangle at 0 <= t <= SEGMENT_END; rays not ``live`` are False.
    Detached."""
    with torch.no_grad():
        p0, e1, e2 = _records(vertices, faces)
        R = points.shape[0]
        occ = torch.zeros(R, dtype=torch.int32, device=points.device)
        if not bool(live.any()):
            return occ > 0
        dirs = points - sun
        tri = torch.stack([p0, p0 - e1, p0 + e2], 1)
        for ray, t_id in _pairs(*_bins(sun, dirs, live, tri)):
            t, _, _, ok = _mt(sun, dirs[ray], p0[t_id], e1[t_id], e2[t_id])
            ok = ok & (t >= 0) & (t <= SEGMENT_END)
            occ.index_add_(0, ray, ok.to(torch.int32))
        return (occ > 0) & live


def vertex_normals(vertices, faces):
    """Area-weighted vertex normals: each face's n = e1 x e2 added to its
    three corners, then normalised (zero where no face touches)."""
    p0, e1, e2 = _records(vertices, faces)
    n = _cross(e1, e2)
    acc = torch.zeros_like(vertices)
    for k in range(3):
        acc = acc.index_add(0, faces[:, k], n)
    length = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.where(length > 0, length, torch.ones_like(length))


def _pow24(x):
    """x ** 24, the specular exponent."""
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return x8 * (x8 * x8)


def frame(vertices, faces, eye, cam: dict, sun, width: int, height: int,
          dtype=torch.float32):
    """((H, W, 3) image, {"rays", "hits"} ints) of one frame; the image
    is differentiable with respect to ``vertices`` and ``eye``.
    ``faces`` is (F, 3) int64 on the vertices' device."""
    dev = vertices.device
    v = vertices.to(dtype)
    eye = eye.to(dtype)
    sun = torch.as_tensor(sun, device=dev).to(dtype)
    dirs = camera_dirs(cam, width, height, dtype, dev)
    win = closest(eye.detach(), dirs, v.detach(), faces)
    hit = torch.nonzero(win >= 0).squeeze(1)
    tri = win[hit]
    f = faces[tri]
    p0, e1, e2 = v[f[:, 0]], v[f[:, 0]] - v[f[:, 1]], v[f[:, 2]] - v[f[:, 0]]
    d = dirs[hit]
    t, u, w2, _ = _mt(eye, d, p0, e1, e2)
    n = _cross(e1, e2)
    point = eye + t[:, None] * d + OFFSET * _unit(n)
    shadow = occluded(sun.detach(), point.detach(),
                      torch.ones_like(t, dtype=torch.bool), v.detach(),
                      faces)
    sun_line = _unit(sun - point)
    half = _unit(sun_line - d)
    normals = vertex_normals(v, faces)[f]                 # (h, 3, 3)
    colour = 0.0
    for k, weight in enumerate((1.0 - u - w2, u, w2)):
        nk = normals[:, k]
        base = AMBIENT + DIFFUSE * _dot(sun_line, nk).abs()
        spec = SPECULAR * _pow24(_dot(nk, half))
        tint = torch.as_tensor(TINT, dtype=dtype, device=dev)
        corner = (base[:, None] * tint + spec[:, None]).clamp(0.0, 1.0)
        colour = colour + weight[:, None] * corner
    lit = (~shadow).to(dtype)[:, None]
    image = torch.zeros((height * width, 3), dtype=dtype, device=dev)
    image = image.index_put((hit,), colour * lit)
    n_hit = hit.numel()
    n_shadow = int(shadow.sum())
    stats = {"rays": width * height + n_hit, "hits": n_hit + n_shadow}
    return image.reshape(height, width, 3), stats


def loss(image, target):
    """The photometric loss of the fit: mean squared error."""
    return torch.mean((image - target.to(image.dtype)) ** 2)


def adam_steps(start: dict, grad_of, steps: int, lr: float,
               betas=(0.9, 0.999), eps=1e-8):
    """Plain Adam from ``start`` (name -> tensor): ``grad_of(params)``
    gives (loss, name -> gradient). Returns (losses, first gradients,
    parameters after ``steps``, last gradients)."""
    params = {k: x.detach().clone() for k, x in start.items()}
    m = {k: torch.zeros_like(x) for k, x in params.items()}
    s = {k: torch.zeros_like(x) for k, x in params.items()}
    losses, first = [], None
    for i in range(1, steps + 1):
        value, grads = grad_of(params)
        losses.append(value)
        if first is None:
            first = grads
        last = grads
        for k in params:
            g = grads[k]
            m[k] = betas[0] * m[k] + (1 - betas[0]) * g
            s[k] = betas[1] * s[k] + (1 - betas[1]) * g * g
            m_hat = m[k] / (1 - betas[0] ** i)
            s_hat = s[k] / (1 - betas[1] ** i)
            params[k] = params[k] - lr * m_hat / (s_hat.sqrt() + eps)
    return losses, first, params, last

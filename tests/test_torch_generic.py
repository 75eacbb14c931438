"""The generic-origin shadow walk and the ray window against the JAX
package.

Generic rays (``any_hit``): each ray has its own origin, and occludes at
any t >= 0. The port's weight planes hold the JAX package's packed
generic weights by value, and its prepass (keys, counts, ray rows, caps,
hull rows) is bit-equal when both get the same scene centre (the centre
is a mean, which torch and XLA sum in different orders). Occlusion flags
come from the plain walk on the CPU and from the Pallas walk in
interpret mode; the JAX walk takes its numerators from an XLA dot with
16 terms, so a decision within f32 rounding of its boundary can go
either way. Tolerances:
  * flags agree on >= 99.9% of rays, and at every disagreement the most
    nearly accepted triangle is a boundary case: its sign-test margins,
    recomputed in float64, are within 1e-5 of the magnitude of the terms
    that make them (a relative margin, since u = d.cu - (d x o).e2
    cancels);
  * executed visits agree within 1%.

The window (``closest_hit_common_origin(tmin=, tmax=)``): the JAX
package's exact two-plane cases; the port's windowed walk against its own
brute force and the JAX package's (winner ids agree where both hit, t
within 1e-5 relative; masks on >= 99.5% of rays, the JAX package's own
rule for window-edge rounding), and flat == two-level.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.camera import camera_ray_columns as jax_ray_columns
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import intersect as jmt
from ceres_tpu.ops import megakernel as jmk
from ceres_tpu.utils import tiling as jtiling

from ceres_tpu_torch.accel import clusters as pcl
from ceres_tpu_torch.models.mesh import triangle_soup as port_soup
from ceres_tpu_torch.ops import intersect as pmt
from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.ops import prepass, walk
from ceres_tpu_torch.utils import convert

from test_torch_walk import _slot_t

torch.set_num_threads(1)

SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)
EYE = np.asarray([0.0, 0.1, -0.3], np.float32)
TILE = jmk.TILE


def _port(x):
    if isinstance(x, tuple):
        return tuple(convert.tensor(c) for c in x)
    return convert.tensor(x)


def _treelet(verts, faces):
    return jax.jit(jcl.build_clusters_treelet)(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False))


def _bunny_rays(verts, faces):
    """Shadow rays of the bunny frame at 64 x 64: from each hit point (a
    hair in front of the surface) toward the sun; misses skipped."""
    cs = _treelet(verts, faces)
    cam = JaxCamera.make(eye=EYE, dir=verts.mean(axis=0) - EYE, up=(0, 1, 0),
                         fov=60.0)
    dirs = tuple(jtiling.swizzle_plane(p) for p in jax_ray_columns(cam, 64, 64))
    soup = jax_soup(jnp.asarray(verts), jnp.asarray(faces))
    hit = jmk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs)
    t = jnp.where(hit.mask, hit.t, 0.0)
    o = tuple(cam.eye[a] + t * (1.0 - 1e-4) * dirs[a] for a in range(3))
    sl = tuple(SUN[a] - o[a] for a in range(3))
    inv = jax.lax.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
    d = tuple(c * inv for c in sl)
    return cs, jnp.mean(soup.p0, axis=0), o, d, ~hit.mask


def _random_rays():
    rng = np.random.default_rng(21)
    verts = rng.standard_normal((200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, (400, 3)).astype(np.int32)
    cs = _treelet(verts, faces)
    R = 1500
    o = (rng.standard_normal((3, R)) * 0.3
         + np.asarray([[0.0], [0.0], [-3.0]])).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    skip = rng.random(R) < 0.3
    center = jnp.mean(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                               with_normals=False).p0, axis=0)
    return (cs, center, tuple(jnp.asarray(c) for c in o),
            tuple(jnp.asarray(c) for c in d), jnp.asarray(skip))


@pytest.fixture(scope="module", params=["random", "bunny"])
def rays(request, bunny):
    if request.param == "random":
        return _random_rays()
    return _bunny_rays(*bunny)


def _jax_inputs(cs, shift, o_cols, d_cols, skip):
    """The JAX package's generic walk inputs, as ``any_hit`` builds them."""
    o = tuple(o_cols[a] - shift[a] for a in range(3))
    dp = tuple(jmk._pad_rays(c) for c in d_cols)
    op = tuple(jmk._pad_rays(c) for c in o)
    dt = tuple(c.reshape(-1, TILE) for c in dp)
    ot = tuple(c.reshape(-1, TILE) for c in op)
    alive = ~jmk._pad_rays(skip).reshape(-1, TILE) & (
        (dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]) > 0.0)
    dxo = (dp[1] * op[2] - dp[2] * op[1], dp[2] * op[0] - dp[0] * op[2],
           dp[0] * op[1] - dp[1] * op[0])
    root_lo, root_hi = jmk._scene_root(cs)
    tcap = jmk._ray_tcap(root_lo - shift, root_hi - shift, op, dp)
    w = jcl.cluster_weights_generic_packed(cs, shift)
    S, hull, bbox, first, cull_lo, cull_hi, w = jmk._hier_setup(
        cs.lo - shift, cs.hi - shift, dt, alive, ot, w, cs=cs)
    keys, counts = jmk._tile_candidate_keys(cull_lo, cull_hi, dt, ot, alive)
    return dict(keys=keys, counts=counts, rows=(*dp, *dxo, *op, tcap), S=S,
                hull=hull, bbox=bbox, first=first, w=w)


def _port_inputs(cs, shift, o_cols, d_cols, skip):
    return pmk._any_inputs(convert.cluster_set(cs), _port(shift),
                           _port(o_cols), _port(d_cols), _port(skip))


def _bits(x):
    return np.asarray(x).view(np.int32)


def _margin(cs, shift, o_cols, d_cols, ray):
    """float64 margin of the triangle closest to occluding ray ``ray``
    (t >= 0, no upper bound): its smallest sign-test term over the
    magnitude of the terms that make it. Positive: occluded."""
    p0, e1, e2 = (np.asarray(x, np.float64).reshape(-1, 3)
                  for x in (cs.p0, cs.e1, cs.e2))
    n = np.cross(e1, e2)
    shift = np.asarray(shift, np.float64)
    o = np.asarray([float(o_cols[a][ray]) for a in range(3)]) - shift
    d = np.asarray([float(d_cols[a][ray]) for a in range(3)])
    ps = p0 - shift
    c = np.cross(d, o)
    cu, cv = np.cross(ps, e2), np.cross(ps, e1)
    nu = cu @ d - e2 @ c
    nv = cv @ d - e1 @ c
    nd = n @ d
    nt = (n * ps).sum(1) - n @ o
    su = np.abs(cu) @ np.abs(d) + np.abs(e2) @ np.abs(c)
    sv = np.abs(cv) @ np.abs(d) + np.abs(e1) @ np.abs(c)
    sd = np.abs(n) @ np.abs(d)
    st = np.abs(n * ps).sum(1) + np.abs(n) @ np.abs(o)
    real = sd > 0
    s = np.where(nd >= 0, 1.0, -1.0)
    m = np.minimum.reduce([nu * s / su, nv * s / sv,
                           (nd - nu - nv) * s / (sd + su + sv),
                           nt * s / st, np.abs(nd) / sd])
    return float(m[real].max())


def _check_flags(rays, ref, ref_steps, got, steps):
    cs, shift, o, d, skip = rays
    assert (ref & ~np.asarray(skip)).sum() > 0
    differ = np.nonzero(got != ref)[0]
    assert len(differ) <= 0.001 * len(ref), len(differ)
    for ray in differ:   # boundary cases only
        assert abs(_margin(cs, shift, o, d, ray)) <= 1e-5, ray
    assert abs(steps - ref_steps) <= 0.01 * ref_steps, (steps, ref_steps)


def test_generic_weights_match_jax(rays):
    cs, shift = rays[0], rays[1]
    packed = np.asarray(jcl.cluster_weights_generic_packed(cs, shift))
    got = pcl.cluster_weights_generic(convert.cluster_set(cs),
                                      _port(shift)).numpy()
    C = cs.cluster_size
    assert got.shape == (cs.num_clusters, pcl.GENERIC_PLANES, C)
    # Products and sums: as the common-origin planes, to f32 rounding.
    for rows, cols in (((0, 3), (0, C)), ((3, 6), (C, 2 * C)),
                       ((6, 9), (2 * C, 3 * C))):
        np.testing.assert_allclose(got[:, rows[0]:rows[1]],
                                   packed[:, 0:3, cols[0]:cols[1]],
                                   rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got[:, 9], packed[:, 9, 3 * C:], rtol=1e-6,
                               atol=1e-12)
    # The edges and the normal's negation are copies: exact.
    np.testing.assert_array_equal(got[:, 10:13], -packed[:, 3:6, 0:C])
    np.testing.assert_array_equal(got[:, 13:16], -packed[:, 3:6, C:2 * C])
    np.testing.assert_array_equal(got[:, 6:9], -packed[:, 6:9, 3 * C:])


@pytest.mark.parametrize("form", ["flat", "two_level"])
def test_generic_prepass_is_bit_identical(rays, form, monkeypatch):
    if form == "two_level":
        monkeypatch.setattr(jmk, "_HIER_MIN_CLUSTERS", 1)
        monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    ref = _jax_inputs(*rays)
    (counts, keys, rows, w, occ0), opts = _port_inputs(*rays)
    assert opts["S"] == ref["S"] and (opts["S"] > 1) == (form == "two_level")
    np.testing.assert_array_equal(keys.numpy(), np.asarray(ref["keys"]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref["counts"]))
    assert int(counts.max()) > 0
    for a in range(10):   # d, d x o, o, cap
        np.testing.assert_array_equal(rows[a].numpy().view(np.int32),
                                      _bits(ref["rows"][a]))
    np.testing.assert_array_equal(occ0.numpy(), np.asarray(
        jmk._pad_rays(rays[4])).astype(np.int32))
    if form == "two_level":
        for name in ("hull", "bbox", "first"):
            np.testing.assert_array_equal(opts[name].numpy().view(np.int32),
                                          _bits(ref[name]))
        # The origin hull is real now: columns 9-14 are not all zero.
        assert opts["hull"][:, 9:15].abs().sum() > 0
    assert w.shape[0] == ref["w"].shape[0]


def test_stream_rule_follows_the_packed_rows():
    # The JAX package streams when its packed weights pass 8 MiB: 16 KiB
    # a block for common-origin rays, 32 KiB for generic rays.
    for n in (61, 256, 257, 268, 512, 513, 4968):
        for rows in (prepass.COMMON_ROWS, prepass.GENERIC_ROWS):
            packed = jax.ShapeDtypeStruct((n, rows, 4 * pcl.CLUSTER_SIZE),
                                          jnp.float32)
            assert prepass._use_stream(n, rows) == jmk._use_stream(packed)
    # Bunny (61 SweepSAH blocks) stays resident on both forms; dragon
    # (268) streams its generic weights and keeps the common-origin ones.
    assert not prepass._use_stream(61, prepass.GENERIC_ROWS)
    assert not prepass._use_stream(61, prepass.COMMON_ROWS)
    assert prepass._use_stream(268, prepass.GENERIC_ROWS)
    assert not prepass._use_stream(268, prepass.COMMON_ROWS)


def test_generic_walk_picks_the_generic_stream_rule(rays, monkeypatch):
    # 1,500 random rays over a 400-triangle treelet cut: with the budget
    # set to the size of its common-origin weights, the generic walk
    # (twice the bytes a block) streams and the common-origin walks stay
    # resident.
    cs = convert.cluster_set(rays[0])
    budget = cs.num_clusters * prepass.COMMON_ROWS * 4 * pcl.CLUSTER_SIZE * 4
    monkeypatch.setattr(prepass, "_RESIDENT_W_BYTES", budget)
    _, opts = _port_inputs(*rays)
    assert opts["stream"]
    _, opts = pmk._closest_inputs(cs, _port(rays[1]), _port(rays[3]))
    assert not opts["stream"]


@pytest.mark.parametrize("form", ["flat", "two_level"])
def test_any_hit_matches_jax(rays, form, monkeypatch):
    if form == "two_level":
        monkeypatch.setattr(jmk, "_HIER_MIN_CLUSTERS", 1)
        monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    cs, shift, o, d, skip = rays
    ref, ref_c = jmk.any_hit(None, shift, o, d, skip=skip, clusters=cs,
                             with_counts=True)
    got, got_c = pmk.any_hit(None, _port(shift), _port(o), _port(d),
                             skip=_port(skip), clusters=convert.cluster_set(cs),
                             with_counts=True)
    _check_flags(rays, np.asarray(ref), int(ref_c["traversal_steps"]),
                 got.numpy(), int(got_c["traversal_steps"]))


def test_any_hit_two_level_agrees_with_flat(rays, monkeypatch):
    cs, shift, o, d, skip = rays
    args = (None, _port(shift), _port(o), _port(d))
    kw = dict(skip=_port(skip), clusters=convert.cluster_set(cs))
    flat = pmk.any_hit(*args, **kw)
    monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    hier = pmk.any_hit(*args, **kw)
    np.testing.assert_array_equal(hier.numpy(), flat.numpy())


def test_any_hit_sees_past_the_sun():
    # The reference's shadow ray has no upper bound: a triangle beyond
    # the light still occludes (any_hit), where the segment test
    # (any_hit_to_point) ignores it.
    tri = np.asarray([[-1, 0, -1], [1, 0, -1], [0, 0, 1]], np.float32)
    verts = torch.as_tensor(tri + np.asarray([0, 10, 0], np.float32))
    soup = port_soup(verts, torch.arange(3, dtype=torch.int32)[None],
                     with_normals=False)
    recv = torch.zeros((1, 3))
    light = torch.as_tensor([0.0, 5.0, 0.0])
    assert not bool(pmk.any_hit_to_point(soup, light, recv)[0])
    up = torch.as_tensor([[0.0, 1.0, 0.0]])
    assert bool(pmk.any_hit(soup, soup.p0.mean(0), recv, up)[0])
    assert not bool(pmk.any_hit(soup, soup.p0.mean(0), recv, -up)[0])


def test_plain_any_counts_no_launch(rays):
    walk.reset_launches()
    args, opts = _port_inputs(*rays)
    out, visits = walk.walk_any(*args, **opts)
    assert int(visits.sum()) > 0 and out.dtype == torch.int32
    assert "walk_any" in walk.launches and "walk_closest_window" in walk.launches
    assert not any(walk.launches.values())


def test_wrapper_checks_generic_rows(rays):
    (counts, keys, rows, w, occ0), _ = _port_inputs(*rays)
    with pytest.raises(ValueError, match="rays"):
        walk.walk_any(counts, keys, rows[:4].contiguous(), w, occ0)
    with pytest.raises(ValueError, match="w"):
        walk.walk_any(counts, keys, rows, w[:, :10].contiguous(), occ0)
    with pytest.raises(ValueError, match="w"):
        walk.walk_any_dest(counts, keys, rows[:4].contiguous(), w, occ0)


@pytest.mark.parametrize("fn", ["closest", "any"])
def test_exact_f64_names_its_roadmap_item(fn):
    # exact_f64 (ROADMAP item M14) is ported: a float32 soup is refused by
    # its dtype, a float64 one is searched in float64 (a ray through the
    # triangle x + y + z = 1 at t = 1/3).
    def run(dtype):
        soup = port_soup(torch.eye(3, dtype=dtype),
                         torch.arange(3, dtype=torch.int32)[None],
                         with_normals=False)
        d = torch.ones((1, 3), dtype=dtype) / 3.0 ** 0.5
        o = torch.zeros(3, dtype=dtype)
        if fn == "closest":
            return pmk.closest_hit_common_origin(soup, o, d, exact_f64=True)
        return pmk.any_hit(soup, o, o[None], d, exact_f64=True)

    with pytest.raises(ValueError, match="float64 soup"):
        run(torch.float32)
    out = run(torch.float64)
    if fn == "closest":
        assert bool(out.mask[0]) and int(out.prim_id[0]) == 0
        assert abs(float(out.t[0]) - 3.0 ** -0.5) < 1e-15
    else:
        assert bool(out[0])


# ---------------------------------------------------------------------------
# The ray window
# ---------------------------------------------------------------------------

def _two_planes():
    tri = np.asarray([[-2, -2, 0], [2, -2, 0], [0, 2, 0]], np.float32)
    verts = np.concatenate([tri + np.asarray([0, 0, 2], np.float32),
                            tri + np.asarray([0, 0, 5], np.float32)])
    return port_soup(torch.as_tensor(verts),
                     torch.as_tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32),
                     with_normals=False)


@pytest.mark.parametrize("form", ["flat", "two_level"])
def test_window_two_planes(form, monkeypatch):
    # The JAX package's exact cases (tests/test_megakernel.py TestTWindow).
    if form == "two_level":
        monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 0)
    soup, eye = _two_planes(), torch.zeros(3)
    d = torch.as_tensor([[0.0, 0.0, 1.0]])
    h0 = pmk.closest_hit_common_origin(soup, eye, d)
    assert bool(h0.mask[0]) and int(h0.prim_id[0]) == 0
    h1 = pmk.closest_hit_common_origin(soup, eye, d, tmin=3.0)
    assert bool(h1.mask[0]) and int(h1.prim_id[0]) == 1
    np.testing.assert_allclose(float(h1.t[0]), 5.0, rtol=1e-5)
    assert not bool(pmk.closest_hit_common_origin(soup, eye, d,
                                                  tmax=1.0).mask[0])
    assert not bool(pmk.closest_hit_common_origin(soup, eye, d, tmin=3.0,
                                                  tmax=4.0).mask[0])
    _, opts = pmk._closest_inputs(pmk._treelet(soup, None), eye, d.unbind(-1),
                                  tmin=3.0)
    assert opts["window"] and (opts["S"] > 1) == (form == "two_level")


def _window_scene():
    rng = np.random.default_rng(31)
    verts = rng.standard_normal((200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, (400, 3)).astype(np.int32)
    d = rng.standard_normal((512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = rng.uniform(0.0, 3.0, 512).astype(np.float32)
    tmax = tmin + rng.uniform(0.5, 4.0, 512).astype(np.float32)
    return verts, faces, np.asarray([0.0, 0.0, -4.0], np.float32), d, tmin, tmax


def test_per_ray_window_matches_bruteforce():
    verts, faces, eye, d, tmin, tmax = _window_scene()
    soup = port_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                     with_normals=False)
    hit = pmk.closest_hit_common_origin(soup, torch.as_tensor(eye),
                                        torch.as_tensor(d),
                                        tmin=torch.as_tensor(tmin),
                                        tmax=torch.as_tensor(tmax))
    bf = pmt.closest_hit_bruteforce(
        pmt.ray_features_common_origin(torch.as_tensor(d)),
        pmt.triangle_weights_common_origin(soup, torch.as_tensor(eye)),
        tmin=torch.as_tensor(tmin), tmax=torch.as_tensor(tmax))
    jsoup = jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                     with_normals=False)
    jbf = jmt.closest_hit_bruteforce(
        jmt.ray_features_common_origin(jnp.asarray(d)),
        jmt.triangle_weights_common_origin(jsoup, jnp.asarray(eye)),
        tmin=jnp.asarray(tmin)[:, None], tmax=jnp.asarray(tmax)[:, None])
    assert hit.mask.numpy().sum() > 20
    for ref in (bf, jbf):
        rmask = np.asarray(ref.mask)
        assert (rmask == hit.mask.numpy()).mean() >= 0.995
        both = rmask & hit.mask.numpy()
        assert (np.asarray(ref.prim_id)[both]
                == hit.prim_id.numpy()[both]).mean() >= 0.99
        np.testing.assert_allclose(np.asarray(ref.t)[both],
                                   hit.t.numpy()[both], rtol=1e-5, atol=1e-6)
    assert (bf.mask.numpy() == hit.mask.numpy()).all()


def test_window_matches_jax_walk():
    # The windowed walk itself, port (plain) vs JAX (Pallas interpret), on
    # the same cluster cut: winner slots agree except near ties.
    verts, faces, eye, d, tmin, tmax = _window_scene()
    cs = _treelet(verts, faces)
    dirs = tuple(jnp.asarray(c) for c in d.T)
    ref, ref_c = jmk._closest_search(cs, jnp.asarray(eye), dirs,
                                     tmin=jnp.asarray(tmin),
                                     tmax=jnp.asarray(tmax))
    got, got_c = pmk._closest_search(convert.cluster_set(cs), _port(eye),
                                     _port(dirs), _port(tmin), _port(tmax))
    ref, got = np.asarray(ref), got.numpy()
    assert (ref >= 0).sum() > 0
    differ = np.nonzero(got != ref)[0]
    assert len(differ) <= 0.002 * len(ref), len(differ)
    for ray in differ:   # near ties only
        assert got[ray] >= 0 and ref[ray] >= 0
        ta = _slot_t(cs, eye, dirs, got[ray], ray)
        tb = _slot_t(cs, eye, dirs, ref[ray], ray)
        assert abs(ta - tb) <= 1e-5 * max(abs(ta), abs(tb))
    steps, ref_steps = int(got_c["traversal_steps"]), int(ref_c["traversal_steps"])
    assert abs(steps - ref_steps) <= 0.01 * ref_steps


def test_window_two_level_matches_flat(monkeypatch):
    verts, faces, eye, d, _, _ = _window_scene()
    soup = port_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                     with_normals=False)
    args = (soup, torch.as_tensor(eye), torch.as_tensor(d[:400]))
    flat = pmk.closest_hit_common_origin(*args, tmin=0.5, tmax=6.0)
    monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    hier = pmk.closest_hit_common_origin(*args, tmin=0.5, tmax=6.0)
    np.testing.assert_array_equal(flat.mask.numpy(), hier.mask.numpy())
    m = flat.mask.numpy()
    assert m.sum() > 0
    np.testing.assert_allclose(flat.t.numpy()[m], hier.t.numpy()[m],
                               rtol=1e-5)
    assert (flat.t.numpy()[m] >= 0.5).all() and (flat.t.numpy()[m] <= 6.0).all()


def test_window_cap_keeps_dead_rays_dead():
    verts, faces, eye, d, _, _ = _window_scene()
    cs = pcl.build_clusters_treelet(port_soup(torch.as_tensor(verts),
                                              torch.as_tensor(faces),
                                              with_normals=False))
    d = np.concatenate([d[:10], np.zeros((5, 3), np.float32)])
    args, opts = pmk._closest_inputs(cs, torch.as_tensor(eye),
                                     torch.as_tensor(d).unbind(-1),
                                     tmin=0.1, tmax=2.0)
    rays = args[2]
    assert rays.shape[0] == walk.RAY_ROWS["closest_window"] and opts["window"]
    cap = rays[3]
    assert (cap[10:] == -1).all()           # zero and padding rays
    live = cap[:10] >= 0
    assert (cap[:10][live] <= np.float32(2.0 * (1 + 4e-6))).all()
    assert (rays[4, :10] == np.float32(0.1)).all()
    assert (rays[5, :10] == np.float32(2.0)).all()

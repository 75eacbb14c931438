"""The plain versions of the walk kernels against the JAX package's Pallas
walk (``_walk_pallas`` in interpret mode), and on a card the kernels
against their plain versions.

Inputs are made once on the JAX side (cluster cut, candidate keys,
features, packed weights) and converted, so both walks see the same
numbers. The JAX walk takes its Möller-Trumbore numerators from an XLA
dot, whose summation order and FMA use differ from the port's separate
f32 products, so a decision that sits within f32 rounding of its
boundary can go either way. Tolerances:
  * occlusion flags on >= 99.9% of rays, and every disagreement a
    boundary case: the most nearly accepted triangle's sign-test and
    window margin, recomputed in float64, within 1e-6 of |det|;
  * winner slot ids on >= 99.9% of rays, and every disagreement a near
    tie: both triangles' t, recomputed in float64, within 1e-5 relative;
  * executed visits within 1%.
The kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py``, which needs no JAX.

Also the two-level kernel's combination rule: its K threads of a ray
split each visit's 128 lanes into K slices (thread g takes lanes
i K + g), each takes its slice's smallest hit key (or occlusion flag),
and they combine the K results by min (or OR) before the strict < on the
best key. That must give the unsliced plain visit's result exactly, ties
across slices included.

And the resident shadow walk's handover: at every visit thread u takes
the u-th live ray of the list the threads walked before (their ballots
and rays). A Python model of that rule must give the plain walk's flags
and visits tile by tile.

And the two fixtures that the card tests of the cluster walk rest on
(``tests/test_torch_cuda.py``), each held to the JAX walk, outputs and
the visits of single tiles, and to the property it is for: the 3x
subdivided bunny at 256 x 256, a streamed flat walk where one tile makes
many times the mean visits; and key rows cut so that a walk ends right
after the visit that lowers its prune, with the next entry inside the old
prune and outside the new one (the visit the cluster walk makes ahead
and must drop).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.accel.cuts import build_clusters_quality as jax_quality
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.camera import camera_ray_columns as jax_ray_columns
from ceres_tpu.models.mesh import subdivide as jax_subdivide
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import megakernel as jmk
from ceres_tpu.utils import tiling as jtiling

from ceres_tpu_torch.ops import walk
from ceres_tpu_torch.ops.prepass import _cid_bits
from ceres_tpu_torch.utils import convert

from test_torch_cuda import dropped_speculation, with_dropped_speculation

torch.set_num_threads(1)

SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)
EYES = {"bunny": (0.0, 0.1, -0.3), "dragon": (0.0, 2.5, -12.0)}


def _mesh_scene(verts, faces, eye):
    cs = jax_quality(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                              with_normals=False))
    eye = np.asarray(eye, np.float32)
    cam = JaxCamera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0)
    dirs = tuple(jtiling.swizzle_plane(p) for p in jax_ray_columns(cam, 64, 64))
    hit = jmk.closest_hit_common_origin(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces)), cam.eye, dirs,
        clusters=cs)
    t = jnp.where(hit.mask, hit.t, 0.0)
    # Receivers a hair in front of the surface, as the renderer offsets them.
    points = tuple(cam.eye[a] + t * (1.0 - 1e-4) * dirs[a] for a in range(3))
    return cs, jnp.asarray(eye), dirs, jnp.asarray(SUN), points, ~hit.mask


def _random_scene():
    rng = np.random.default_rng(11)
    verts = rng.standard_normal((90, 3)).astype(np.float32)
    faces = rng.integers(0, 90, (400, 3)).astype(np.int32)
    cs = jax_quality(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                              with_normals=False))
    d = rng.standard_normal((3, 1000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    points = rng.standard_normal((3, 1000)).astype(np.float32)
    skip = rng.random(1000) < 0.3
    return (cs, jnp.asarray([0.0, 0.0, -4.0], jnp.float32),
            tuple(jnp.asarray(c) for c in d), jnp.asarray([0.3, 6.0, -5.0]),
            tuple(jnp.asarray(c) for c in points), jnp.asarray(skip))


@pytest.fixture(scope="module", params=["random", "bunny", "dragon"])
def scene(request, bunny, dragon):
    if request.param == "random":
        return _random_scene()
    verts, faces = bunny if request.param == "bunny" else dragon
    return _mesh_scene(verts, faces, EYES[request.param])


def _planes(cs, origin):
    """JAX packed weights (N_c, 8, 4C) re-indexed to the port's planes."""
    packed = np.asarray(jcl.cluster_weights_common_origin_packed(cs, origin))
    C = cs.cluster_size
    return packed, np.concatenate(
        [packed[:, 0:3, 0:C], packed[:, 0:3, C:2 * C],
         packed[:, 0:3, 2 * C:3 * C], packed[:, 3:4, 3 * C:4 * C]], axis=1)


def _inputs(cs, origin, d, skip, mode):
    """JAX walk inputs as _closest_search / any_hit_to_point build them,
    and the same numbers converted for the port."""
    dp = tuple(jmk._pad_rays(c) for c in d)
    dt = tuple(c.reshape(-1, jmk.TILE) for c in dp)
    skip_p = jmk._pad_rays(skip)
    alive = ~skip_p.reshape(-1, jmk.TILE) & (
        (dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]) > 0.0)
    keys, counts = jmk._tile_candidate_keys(cs.lo - origin, cs.hi - origin,
                                            dt, alive=alive)
    root_lo, root_hi = jmk._scene_root(cs)
    tcap = jmk._ray_tcap(root_lo - origin, root_hi - origin, None, dp)
    if mode == "any_dest":
        tcap = jnp.minimum(tcap, 1.0 + jmk._ULP_PAD)
    packed, planes = _planes(cs, origin)
    feats = jmk._feats_from_cols(dp, packed.shape[1], tcap=tcap)
    occ0 = skip_p.astype(jnp.int32)
    jax_args = (counts, keys, feats, jnp.asarray(packed),
                occ0 if mode == "any_dest" else None)
    port_args = (convert.tensor(counts), convert.tensor(keys),
                 convert.tensor(jnp.stack([*dp, tcap])), convert.tensor(planes))
    if mode == "any_dest":
        port_args += (convert.tensor(occ0),)
    return jax_args, port_args


def _jax_walk(args, mode):
    out, steps = jmk._walk_pallas(*args, tcap_col=4, mode=mode, stream=False,
                                  interpret=True)
    return np.asarray(out), int(steps[0, 0])


def _closest_args(scene):
    cs, eye, dirs, _, _, _ = scene
    return _inputs(cs, eye, dirs, jnp.zeros(dirs[0].shape, bool), "closest")


def _shadow_args(scene):
    cs, _, _, sun, points, skip = scene
    d = tuple(points[a] - sun[a] for a in range(3))
    return _inputs(cs, sun, d, skip, "any_dest")


def _slot_t(cs, origin, d, slot, ray):
    """float64 Möller-Trumbore t of ray ``ray`` against cluster slot
    ``slot`` (packed id cid * C + lane)."""
    p0 = np.asarray(cs.p0, np.float64).reshape(-1, 3)[slot]
    e1 = np.asarray(cs.e1, np.float64).reshape(-1, 3)[slot]
    e2 = np.asarray(cs.e2, np.float64).reshape(-1, 3)[slot]
    n = np.cross(e1, e2)
    dv = np.asarray([float(d[a][ray]) for a in range(3)])
    c = p0 - np.asarray(origin, np.float64)
    return float(n @ c / (n @ dv))


def _shadow_margin(cs, dest, d, ray):
    """float64 margin of the triangle closest to occluding the segment
    from ``dest`` along ``d[:, ray]`` (t in [0, 1 - _DEST_EPS]), in units
    of |det|: positive means occluded, negative unoccluded."""
    p0, e1, e2 = (np.asarray(x, np.float64).reshape(-1, 3)
                  for x in (cs.p0, cs.e1, cs.e2))
    n = np.cross(e1, e2)
    dv = np.asarray([float(d[a][ray]) for a in range(3)])
    c = p0 - np.asarray(dest, np.float64)
    nd = n @ dv
    real = nd != 0
    s = np.sign(nd[real])
    nu, nv = np.cross(c, e2)[real] @ dv, np.cross(c, e1)[real] @ dv
    nt, nd = (n * c).sum(1)[real], nd[real]
    m = np.minimum.reduce([nu * s, nv * s, (nd - nu - nv) * s, nt * s,
                           -(nt - (1.0 - jmk._DEST_EPS) * nd) * s])
    return float((m / np.abs(nd)).max())


def _winners_match(scene, ref, got):
    """Winner slot ids equal but for near ties. Returns the rays that
    differ."""
    cs, eye, dirs = scene[:3]
    R = dirs[0].shape[0]
    ref, got = ref[:R], got[:R]
    assert (ref >= 0).sum() > 0
    differ = np.nonzero(got != ref)[0]
    assert len(differ) <= 0.001 * R, len(differ)
    for ray in differ:   # near ties only
        assert got[ray] >= 0 and ref[ray] >= 0
        ta = _slot_t(cs, eye, dirs, got[ray], ray)
        tb = _slot_t(cs, eye, dirs, ref[ray], ray)
        assert abs(ta - tb) <= 1e-5 * max(abs(ta), abs(tb))
    return differ


def _flags_match(scene, ref, got, occ0):
    """Occlusion flags equal but for boundary cases. Returns the rays
    that differ."""
    assert ((ref == 1) & (occ0 == 0)).sum() > 0
    differ = np.nonzero(got != ref)[0]
    assert len(differ) <= 0.001 * len(ref), len(differ)
    cs, sun, points = scene[0], scene[3], scene[4]
    d = tuple(np.asarray(points[a] - sun[a]) for a in range(3))
    for ray in differ:   # boundary cases only
        assert abs(_shadow_margin(cs, sun, d, ray)) <= 1e-6
    return differ


def test_closest_plain_matches_pallas(scene):
    jax_args, port_args = _closest_args(scene)
    ref, ref_steps = _jax_walk(jax_args, "closest")
    got, visits = walk.walk_closest(*port_args)
    _winners_match(scene, ref, got.numpy())
    assert abs(int(visits.sum()) - ref_steps) <= 0.01 * ref_steps


def test_any_dest_plain_matches_pallas(scene):
    jax_args, port_args = _shadow_args(scene)
    ref, ref_steps = _jax_walk(jax_args, "any_dest")
    got, visits = walk.walk_any_dest(*port_args)
    _flags_match(scene, ref, got.numpy(), port_args[4].numpy())
    assert abs(int(visits.sum()) - ref_steps) <= 0.01 * ref_steps


def _tile_visits_match(jax_args, mode, tiles, visits, differ):
    """Each of ``tiles`` alone through the JAX walk (which skips a tile
    with no candidate and reports only the sum of visits): the port's
    executed visits of that tile, exactly, or within 1% if one of its
    rays is among ``differ`` (another near-tie winner or boundary flag
    moves the prune)."""
    counts = jax_args[0]
    for tile in tiles:
        only = jnp.zeros_like(counts).at[tile].set(counts[tile])
        _, steps = _jax_walk((only, *jax_args[1:]), mode)
        got = int(visits[tile])
        if not np.any(differ // walk.TILE == tile):
            assert got == steps, (tile, got, steps)
        else:
            assert abs(got - steps) <= 0.01 * steps + 1, (tile, got, steps)


@pytest.fixture(scope="module")
def heavy_flat(bunny):
    """The closest walk's inputs on the 3x subdivided bunny (317,952
    triangles; the treelet cut's 4,968 blocks take the streamed flat
    walk) for 256 x 256 primary rays."""
    verts, faces = jax_subdivide(*bunny, 3)
    cs = jax.jit(jcl.build_clusters_treelet)(
        jax_soup(jnp.asarray(verts), jnp.asarray(faces), with_normals=False))
    eye = np.asarray(EYES["bunny"], np.float32)
    cam = JaxCamera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0)
    dirs = tuple(jtiling.swizzle_plane(p)
                 for p in jax_ray_columns(cam, 256, 256))
    scene = (cs, jnp.asarray(eye), dirs)
    return scene, _inputs(cs, scene[1], dirs,
                          jnp.zeros(dirs[0].shape, bool), "closest")


def test_heavy_flat_tile_matches_pallas(heavy_flat):
    scene, (jax_args, port_args) = heavy_flat
    assert port_args[1].shape == (128, 4968)
    got, visits = walk.walk_closest(*port_args)
    # What the fixture is for: one tile far above the mean (1,146 visits
    # of 8,619 over 128 tiles, 17 times the mean), most tiles with none.
    heaviest = int(visits.argmax())
    assert int(visits[heaviest]) >= 10 * float(visits.float().mean())
    assert int((visits == 0).sum()) > visits.numel() // 2
    ref, ref_steps = _jax_walk(jax_args, "closest")
    differ = _winners_match(scene, ref, got.numpy())
    assert abs(int(visits.sum()) - ref_steps) <= 0.01 * ref_steps
    if len(differ) == 0:
        assert int(visits.sum()) == ref_steps
    busy = visits.argsort(descending=True)[:3].tolist()
    idle = int((visits == 0).nonzero()[0])
    _tile_visits_match(jax_args, "closest", [*busy, idle], visits, differ)


@pytest.fixture(scope="module")
def bunny_scene(bunny):
    return _mesh_scene(*bunny, EYES["bunny"])


@pytest.mark.parametrize("mode", ["closest", "any_dest"])
def test_dropped_speculation_matches_pallas(bunny_scene, mode):
    scene = bunny_scene
    jax_args, port_args = (_closest_args(scene) if mode == "closest"
                           else _shadow_args(scene))
    wrapper = walk.walk_closest if mode == "closest" else walk.walk_any_dest
    port_args, cut = with_dropped_speculation(mode, port_args, {})
    assert cut, "no visit of these inputs lowers its tile's prune"
    got, visits = wrapper(*port_args)
    # What the fixture is for: each cut walk ends with a candidate left
    # whose entry is inside the last visit's prune and outside the new one.
    assert dropped_speculation(mode, port_args, {}, visits, cut) == cut
    assert all(int(visits[t]) == int(port_args[0][t]) - 1 for t in cut)
    jax_args = (jnp.asarray(port_args[0].numpy()),
                jnp.asarray(port_args[1].numpy()), *jax_args[2:4],
                None if mode == "closest" else jnp.asarray(port_args[4].numpy()))
    ref, ref_steps = _jax_walk(jax_args, mode)
    if mode == "closest":
        differ = _winners_match(scene, ref, got.numpy())
    else:
        differ = _flags_match(scene, ref, got.numpy(), port_args[4].numpy())
    assert abs(int(visits.sum()) - ref_steps) <= 0.01 * ref_steps
    _tile_visits_match(jax_args, mode, cut, visits, differ)


def test_plain_versions_do_not_count_launches(scene):
    _, port_args = _closest_args(scene)
    walk.reset_launches()
    walk.walk_closest(*port_args)
    assert "walk_closest" in walk.launches
    assert not any(walk.launches.values())


def test_wrapper_rejects_bad_inputs(scene):
    _, (counts, keys, rays, w) = _closest_args(scene)
    with pytest.raises(ValueError, match="rays"):
        walk.walk_closest(counts, keys, rays[:3], w)
    with pytest.raises(ValueError, match="keys"):
        walk.walk_closest(counts, keys.to(torch.int64), rays, w)
    with pytest.raises(ValueError, match="w"):
        walk.walk_closest(counts, keys, rays, w[:, :8])


def test_occlusion_plain_counts_the_pairs_it_tests(scene):
    # The pairs a shadow walk has to test (what the kernels' bound
    # counts): in each visit, each ray not yet occluded, up to its first
    # occluder. With zero weights nothing occludes, so that is every lane
    # of every visit for each ray live from the start; with the scene's
    # weights an occluded ray stops early and then drops out.
    _, (counts, keys, rays, w, occ0) = _shadow_args(scene)
    live = (occ0 == 0).reshape(-1, walk.TILE).sum(dim=1)

    def run(w):
        return walk._occlusion_plain("any_dest", counts, keys, rays, w, occ0,
                                     None, None, None, 1)

    _, visits, pairs = run(torch.zeros_like(w))
    every = int((visits * live).sum()) * walk.CLUSTER_SIZE
    assert int(pairs) == every > 0
    occ, visits, pairs = run(w)
    assert 0 < int(pairs) < int((visits * live).sum()) * walk.CLUSTER_SIZE
    out, tiles = walk.walk_any_dest(counts, keys, rays, w, occ0)
    assert torch.equal(occ, out) and torch.equal(visits, tiles)


@pytest.fixture(scope="module")
def visits(scene):
    """One visit per live tile, its first candidate block: (ray rows
    (rows, t, R), block weights (t, planes, C), block ids) for each mode,
    as the plain walk's visit sees them. The window rows and the generic
    rays' origins (seeded, near the common origin) are made up here: the
    rule under test is the combination, whatever the geometry."""
    rng = np.random.default_rng(3)
    out = {}
    for mode, (_, args) in (("closest", _closest_args(scene)),
                            ("any_dest", _shadow_args(scene))):
        counts, keys, rays, w = args[:4]
        live = counts > 0
        cmask = (1 << _cid_bits(keys.shape[1])) - 1
        bid = (keys[live, 0] & cmask).long()
        r = rays.reshape(rays.shape[0], -1, walk.TILE)[:, live]
        out[mode] = (r, w[bid], bid)
    r, wj, bid = out["closest"]
    shape = r.shape[1:]
    window = torch.as_tensor(np.stack([rng.uniform(0.0, 0.2, shape),
                                       rng.uniform(0.2, 16.0, shape)]),
                             dtype=torch.float32)
    out["closest_window"] = (torch.cat([r, window]), wj, bid)
    o = torch.as_tensor(rng.normal(0.0, 0.05, (3, *shape)),
                        dtype=torch.float32)
    c = torch.linalg.cross(r[:3], o, dim=0)
    edges = [np.asarray(x).reshape(-1, walk.CLUSTER_SIZE, 3)[bid.numpy()]
             for x in (scene[0].e2, scene[0].e1)]
    e = torch.as_tensor(np.concatenate(edges, -1).transpose(0, 2, 1),
                        dtype=torch.float32)
    out["any"] = (torch.cat([r[:3], c, o, r[3:4]]), torch.cat([wj, e], 1),
                  bid)
    return out


def _slice_parts(pairs, K, occlusion):
    """Each of a ray's K threads' result for its lanes j = i K + g (last
    axis: g), as walk.cu's ``visit_result`` forms it: the OR of the hit
    flags, or the min of the hit keys with INT_MAX where it has no hit (a
    miss key's t bits are _BIG_CLEAN's, and the kernel drops it)."""
    sliced = pairs.reshape(*pairs.shape[:2], -1, K)
    if occlusion:
        return sliced.any(dim=2)
    hit = (sliced & ~walk._IMASK) != walk._BIG_CLEAN_I
    big = torch.iinfo(torch.int32).max
    return torch.where(hit, sliced, big).amin(dim=2)


def _combine(parts, occlusion):
    """The K parts combined as the kernel's xor shuffles combine them:
    steps 1, 2, 4, ..., after which every thread holds the same result."""
    K = parts.shape[-1]
    g = torch.arange(K)
    off = 1
    while off < K:
        y = parts[..., g ^ off]
        parts = parts | y if occlusion else torch.minimum(parts, y)
        off *= 2
    assert bool((parts == parts[..., :1]).all())
    return parts[..., 0]


def _take(kmin, best, pid, bid):
    """The strict < on the best key (``take_key`` in walk.cu)."""
    t_new = kmin & ~walk._IMASK
    better = t_new < best
    return (torch.where(better, t_new, best),
            torch.where(better, bid[:, None] * walk.CLUSTER_SIZE
                        + (kmin & walk._IMASK), pid))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mode", ["closest", "closest_window", "any_dest",
                                  "any"])
def test_sliced_visit_combines_to_the_plain_visit(visits, mode, ties):
    r, wj, bid = visits[mode]
    if ties:   # odd lanes repeat the even ones: equal t in other threads
        wj = wj.clone()
        wj[..., 1::2] = wj[..., 0::2]
    occlusion = mode.startswith("any")
    if occlusion:
        pairs = walk._pair_hits(r, wj, mode)
        full = pairs.any(dim=2)
        assert int(full.sum()) > 0
    else:
        pairs = walk._pair_keys(r, wj, window=mode == "closest_window")
        full = pairs.amin(dim=2)
        hit = (full & ~walk._IMASK) != walk._BIG_CLEAN_I
        assert int(hit.sum()) > 0
        if ties:   # the lower lane wins a tie across threads
            assert bool(((full & walk._IMASK)[hit] % 2 == 0).all())
    for K in (1, 2, 4, 8):
        got = _combine(_slice_parts(pairs, K, occlusion), occlusion)
        if occlusion:
            assert torch.equal(got, full), K
            continue
        # The same winner key on every ray with a hit, and the same best
        # and winner after the strict <, from no hit yet and again on a
        # second visit of the same keys (another block id), which keeps
        # the first visit's winner.
        assert torch.equal(got[hit], full[hit]), K
        start = torch.full_like(full, walk._BIG_CLEAN_I)
        best, pid = _take(got, start, torch.full_like(full, -1), bid)
        ref = _take(full, start, torch.full_like(full, -1), bid)
        assert torch.equal(best, ref[0]) and torch.equal(pid, ref[1]), K
        again = _take(got, best, pid, bid + 1)
        assert torch.equal(again[0], best) and torch.equal(again[1], pid)


def _nth_bit(m, k):
    """walk.cu's nth_bit: the position of the k-th set bit (from 0) of m,
    by halving."""
    pos = 0
    for w in (16, 8, 4, 2, 1):
        c = bin(m & ((1 << w) - 1)).count("1")
        if k >= c:
            k -= c
            m >>= w
            pos += w
    return pos


def _live_entry(ballots, u):
    """walk.cu's live_entry: the u-th set bit of the 16 warps' ballots in
    order, as a thread index, or -1 past the last."""
    before = 0
    for v, m in enumerate(ballots):
        c = bin(m).count("1")
        if before <= u < before + c:
            return 32 * v + _nth_bit(m, u - before)
        before += c
    return -1


def _ballots(flags):
    """The 16 warps' ballots of per-thread flags (a (512,) bool list)."""
    return [sum(1 << lane for lane in range(32) if flags[32 * v + lane])
            for v in range(walk.TILE // 32)]


def _solo_shadow_model(mode, counts, keys, rays, w, occ0):
    """A Python model of walk.cu's resident shadow walk (walk_solo): at
    every prune max thread u takes the u-th live ray of the list the
    threads walked (their ballots and rays), visits it alone, and an
    occluded ray leaves the list. Returns (flags, visits per tile), and
    checks that the handover keeps exactly the live rays, in ray order, on
    the leading threads."""
    n_tiles = counts.numel()
    cmask = (1 << _cid_bits(keys.shape[1])) - 1
    r = rays.reshape(rays.shape[0], n_tiles, walk.TILE)
    tcap = rays[-1].view(torch.int32).reshape(n_tiles, walk.TILE)
    occ = occ0.reshape(n_tiles, walk.TILE)
    out = occ.clone()
    visits = torch.zeros(n_tiles, dtype=torch.int32)
    for tile in range(n_tiles):
        occluded = torch.zeros(walk.TILE, dtype=torch.bool)
        rid = list(range(walk.TILE))       # each thread's ray
        live = (occ[tile] == 0).tolist()   # per thread

        def prune_max():
            parts = [int(tcap[tile, rid[u]]) if live[u] else walk._NEG_I
                     for u in range(walk.TILE)]
            ballots = _ballots(live)
            new = [_live_entry(ballots, u) for u in range(walk.TILE)]
            rid[:] = [rid[at] if at >= 0 else -1 for at in new]
            return max(parts) + walk._PRUNE_PAD

        prune = prune_max()
        for k in range(int(counts[tile])):
            if int(keys[tile, k]) & ~cmask > prune:
                break
            # The handover: the live rays, ascending, on threads 0, 1, ...
            alive = (~occluded & (occ[tile] == 0)).nonzero().flatten().tolist()
            assert rid == alive + [-1] * (walk.TILE - len(alive))
            bid = int(keys[tile, k]) & cmask
            held = torch.as_tensor(alive, dtype=torch.long)
            hit = walk._pair_hits(r[:, tile:tile + 1, held], w[bid][None],
                                  mode).any(dim=2)[0]
            occluded[held[hit]] = True
            live = [u < len(alive) and not bool(hit[u])
                    for u in range(walk.TILE)]
            prune = prune_max()
            visits[tile] += 1
        out[tile] |= occluded.to(torch.int32)
    return out.reshape(-1), visits


def test_nth_bit_and_live_entry():
    rng = np.random.default_rng(12)
    for m in [1, 0x80000000, 0xFFFFFFFF, *rng.integers(1, 1 << 32, 50)]:
        bits = [i for i in range(32) if (int(m) >> i) & 1]
        assert [_nth_bit(int(m), k) for k in range(len(bits))] == bits
    flags = list(rng.random(walk.TILE) < 0.3)
    flags[:32] = [False] * 32    # an empty warp
    order = [t for t in range(walk.TILE) if flags[t]]
    ballots = _ballots(flags)
    assert [_live_entry(ballots, u) for u in range(walk.TILE)] == (
        order + [-1] * (walk.TILE - len(order)))


def test_solo_shadow_handover_gives_the_plain_walk(scene):
    # The shadow walk hands the live rays to the leading threads at every
    # prune max: the same flags and visits per tile as the plain walk,
    # and rays that start occluded or go occluded drop out of the list.
    _, (counts, keys, rays, w, occ0) = _shadow_args(scene)
    flags, visits = _solo_shadow_model("any_dest", counts, keys, rays, w, occ0)
    ref, ref_visits = walk._walk_any_dest_plain(counts, keys, rays, w, occ0)
    assert int(((ref == 1) & (occ0 == 0)).sum()) > 0
    assert torch.equal(flags, ref) and torch.equal(visits, ref_visits)
    assert int(ref_visits.max()) > 1

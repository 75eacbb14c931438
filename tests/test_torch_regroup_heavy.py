"""Heavy regrouped shadow tiles against the JAX package, on the CPU, and
the split walk's schedule against the plain walk.

The shadow wavefront regrouped by receiver (``any_hit_to_point(regroup=
True)``) walks tiles of 128 rays. Its heaviest tiles on the card hold a
receiver that no block occludes, which keeps the tile prune at t = 1 so
the tile walks its whole key row, and receivers from two distant patches
where the morton order jumps. A seeded scene of about 1,700 triangles
makes one tile of each kind the receivers' morton order puts together:

  * tile 0: 127 receivers under a roof and one under a hole in it, lit:
    the tile walks every candidate within its first prune;
  * tile 1: 128 receivers under the solid roof, all occluded by its
    first visits: the prune falls and the walk stops with candidates
    left;
  * tile 2: 64 receivers near (0.9, 0, 0) and 64 near (-0.9, 0, 0), on
    either side of z = 0, where the morton code's top bit flips;
  * tile 3: skipped rays only.

The port's plain walk (``_walk_any_dest_plain``) on the port's regrouped
inputs is held to the JAX package's regrouped walk (``_walk_pallas`` in
interpret mode on its own inputs, as its ``any_hit_to_point`` builds
them; where the weights sit moves no result), flat with streamed weights
and two-level (both packages' ``_HIER_MIN_CLUSTERS`` set to 1): flags
equal but for f32 boundary cases,
each checked in float64 (``tests/test_torch_walk.py``'s rule), and the
executed visits of each tile equal to the JAX walk's on that tile alone.

The split walk (the card's kernels for those two forms: ray groups of a
tile walk segments of its key row apart, and a replay recounts the
sequential walk's visits from each ray's first occluding position) has
a plain model, ``walk._split_walk_plain``: on these tiles and on the
bunny's regrouped 64 x 64 wavefront, with segments of 1, 3, 7 and 256
block visits and 1, 2 or 8 ray groups a tile, its flags and visits must
equal the plain walk's exactly.

The dragon's regrouped 64 x 64 wavefront (268 blocks: key rows longer
than a segment) is the resident flat form, K2-128's: its flags equal the
JAX package's ``regroup=True`` (boundary cases checked in float64), its
visits the JAX walk's tile by tile, and the split walk's schedule, in
segments of 64 and of the default 256, the plain walk's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.accel import morton as jmorton
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import megakernel as jmk

from ceres_tpu_torch.accel import morton
from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.ops import prepass, walk
from ceres_tpu_torch.utils import convert

from test_torch_walk import EYES, _mesh_scene, _shadow_margin

torch.set_num_threads(1)

LIT, FALLS, STRADDLE, SKIPPED = 0, 1, 2, 3   # the scene's tiles
FORMS = ["stream", "hier"]


def _quads(x0, x1, z0, z1, n, m, y, drop=()):
    """An n x m grid of quads (two triangles each) at height y over
    [x0, x1] x [z0, z1], without the cells in ``drop``."""
    xs, zs = np.linspace(x0, x1, n + 1), np.linspace(z0, z1, m + 1)
    v, f = [], []
    for i in range(n):
        for j in range(m):
            if (i, j) in drop:
                continue
            b = len(v)
            v += [(xs[i], y, zs[j]), (xs[i + 1], y, zs[j]),
                  (xs[i + 1], y, zs[j + 1]), (xs[i], y, zs[j + 1])]
            f += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    return np.asarray(v, np.float32), np.asarray(f, np.int32)


def _patch(rng, cx, cz, half, n, hole=None):
    """n receiving points just above the ground in a square of half-width
    ``half`` about (cx, cz), none within ``hole`` of its centre."""
    out = []
    while len(out) < n:
        p = rng.uniform(-half, half, 2)
        if hole is None or not np.all(np.abs(p) < hole):
            out.append((cx + p[0], 0.005, cz + p[1]))
    return np.asarray(out, np.float32)


def _scene():
    """(JAX cut, sun, receiving point columns, skip) of the module's
    scene: a ground grid, a roof over z < -0.5 with a hole above
    (-0.55, -0.75), small triangles scattered between them, and the
    receivers of the four tiles (in another order than the regrouped
    one)."""
    rng = np.random.default_rng(12)
    gv, gf = _quads(-1, 1, -1, 1, 20, 20, 0.0)
    rv, rf = _quads(-0.8, 0.8, -1.0, -0.5, 16, 5, 0.4, drop={(2, 2)})
    c = np.stack([rng.uniform(-1, 1, 900), rng.uniform(0.05, 0.35, 900),
                  rng.uniform(-1, 1, 900)], 1)
    clear = (np.abs(c[:, 0] + 0.55) < 0.1) & (np.abs(c[:, 2] + 0.75) < 0.1)
    c = c[~clear][:700]
    sv = (c[:, None, :] + rng.normal(0, 0.03, (len(c), 3, 3))).reshape(
        -1, 3).astype(np.float32)
    sf = np.arange(len(sv), dtype=np.int32).reshape(-1, 3)
    verts = np.concatenate([gv, rv, sv])
    faces = np.concatenate([gf, rf + len(gv), sf + len(gv) + len(rv)])
    lit = np.concatenate([_patch(rng, -0.55, -0.75, 0.2, 127, hole=0.08),
                          np.asarray([(-0.55, 0.005, -0.75)], np.float32)])
    falls = _patch(rng, 0.55, -0.75, 0.2, 128)
    right = _patch(rng, 0.9, -0.06, 0.05, 64)
    left = _patch(rng, -0.9, 0.06, 0.05, 64)
    skipped = np.stack([rng.uniform(-1, 1, 90), np.full(90, 0.005),
                        rng.uniform(-1, 1, 90)], 1).astype(np.float32)
    points = np.concatenate([left, lit, skipped, falls, right])
    skip = np.zeros(len(points), bool)
    skip[192:282] = True
    cs = jcl.build_clusters_treelet(jax_soup(jnp.asarray(verts),
                                             jnp.asarray(faces),
                                             with_normals=False))
    return (cs, jnp.asarray([0.1, 50.0, 0.1], jnp.float32),
            tuple(jnp.asarray(points[:, a]) for a in range(3)),
            jnp.asarray(skip))


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(params=FORMS)
def form(request, monkeypatch):
    if request.param == "stream":
        monkeypatch.setattr(jmk, "_RESIDENT_W_BYTES", 0)
        monkeypatch.setattr(prepass, "_RESIDENT_W_BYTES", 0)
    else:
        monkeypatch.setattr(jmk, "_HIER_MIN_CLUSTERS", 1)
        monkeypatch.setattr(prepass, "_HIER_MIN_CLUSTERS", 1)
    return request.param


def _port(x):
    if isinstance(x, tuple):
        return tuple(_port(c) for c in x)
    return convert.tensor(x)


def _port_inputs(cs, sun, points, skip):
    """The port's regrouped walk inputs (args, opts), its ray order and
    its receivers in that order."""
    pcs = convert.cluster_set(cs)
    pts, sk = _port(points), _port(skip)
    perm = pmk._receiver_order(pcs, pts, sk)
    ordered = tuple(c[perm] for c in pts)
    args, opts = pmk._any_dest_inputs(pcs, _port(sun), ordered, sk[perm],
                                      tile=pmk._REGROUP_TILE)
    return args, opts, perm, ordered


def _jax_inputs(cs, dest, points, skip):
    """The JAX package's regrouped walk inputs, as its
    ``any_hit_to_point(regroup=True)`` builds them: (args of
    ``_walk_pallas``, its keyword arguments, the ray order)."""
    cs = jmk._detach_f32(cs)
    root_lo, root_hi = jmk._scene_root(cs)
    code = jmorton.morton_codes(jnp.stack(points, axis=-1), root_lo,
                                root_hi)
    perm = jnp.argsort(jnp.where(skip, jnp.int32(0x7FFFFFFF), code))
    tile = jmk._REGROUP_TILE
    dp = tuple(jmk._pad_rays(points[a][perm] - dest[a], tile)
               for a in range(3))
    dirs = tuple(c.reshape(-1, tile) for c in dp)
    skip_p = jmk._pad_rays(skip[perm], tile)
    alive = ~skip_p.reshape(-1, tile) & (
        (dirs[0] * dirs[0] + dirs[1] * dirs[1] + dirs[2] * dirs[2]) > 0.0)
    tcap = jnp.minimum(jmk._ray_tcap(root_lo - dest, root_hi - dest, None,
                                     dp), 1.0 + jmk._ULP_PAD)
    w = jcl.cluster_weights_common_origin_packed(cs, dest)
    feats = jmk._feats_from_cols(dp, w.shape[1], tcap=tcap)
    S, hull, bbox, first, cull_lo, cull_hi, w = jmk._hier_setup(
        cs.lo - dest, cs.hi - dest, dirs, alive, None, w, cs=cs)
    keys, counts = jmk._tile_candidate_keys(cull_lo, cull_hi, dirs,
                                            alive=alive)
    kw = dict(hull=hull, bbox=bbox, first=first, S=S)
    return (counts, keys, feats, w, skip_p.astype(jnp.int32)), kw, perm


def _jax_tile_visits(args, kw, tile):
    """The JAX walk's executed visits of ``tile`` alone (it reports only
    the sum over tiles)."""
    only = jnp.zeros_like(args[0]).at[tile].set(args[0][tile])
    _, steps = jmk._walk_pallas(only, *args[1:], tcap_col=4,
                                  mode="any_dest", stream=False,
                                  interpret=True, **kw)
    return int(steps[0, 0])


@pytest.fixture(scope="module")
def bunny_regrouped(bunny):
    """The bunny's 64 x 64 shadow wavefront (``test_torch_walk.py``'s
    receivers): (cut, sun, points, skip), JAX arrays."""
    cs, _, _, sun, points, skip = _mesh_scene(*bunny, EYES["bunny"])
    return cs, sun, points, skip


def test_scene_tiles_are_what_they_claim(scene, form):
    cs, sun, points, skip = scene
    args, opts, perm, ordered = _port_inputs(cs, sun, points, skip)
    assert (opts["S"] > 1) == (form == "hier") and opts["stream"] == (
        form == "stream")
    counts, keys, rays, w, occ0 = args
    assert counts.numel() == 4 and int(counts[SKIPPED]) == 0
    out, visits = walk._walk_any_dest_plain(*args, **opts)
    live = (occ0 == 0) & (torch.arange(occ0.numel()) < perm.numel())
    live = live.reshape(4, 128)   # padding rays are not live
    lit = (out == 0).reshape(4, 128) & live
    # With no triangle able to occlude, the prune never falls: each
    # tile's walk of its whole row under its first prune.
    whole = walk._walk_any_dest_plain(counts, keys, rays, w * 0, occ0,
                                      **opts)[1]
    assert int(live[LIT].sum()) == 128 and int(lit[LIT].sum()) == 1
    assert int(visits[LIT]) == int(whole[LIT]) > 1
    assert int(live[FALLS].sum()) == 128 and int(lit[FALLS].sum()) == 0
    assert 0 < int(visits[FALLS]) < int(whole[FALLS])
    assert int(visits[STRADDLE]) > int(visits[LIT]) + int(visits[FALLS])
    assert int(visits[SKIPPED]) == 0 and not bool(live[SKIPPED].any())
    # The straddling tile: its codes' top bit differs, and its receivers
    # span most of the scene.
    pcs = convert.cluster_set(cs)
    lo, hi = prepass._scene_root(pcs)
    pts = torch.stack(ordered, -1)[STRADDLE * 128:(STRADDLE + 1) * 128]
    code = morton.morton_codes(pts, lo, hi)
    assert (int(code[0]) ^ int(code[-1])).bit_length() == 30
    assert float((pts.amax(0) - pts.amin(0)).norm()) > 0.5 * float(
        (hi - lo).norm())


def test_heavy_tiles_match_jax(scene, form):
    # Flags against the JAX package's walk ray for ray (f32 boundary
    # cases each checked in float64), executed visits tile by tile.
    cs, sun, points, skip = scene
    args, opts, perm, _ = _port_inputs(cs, sun, points, skip)
    jargs, kw, jperm = _jax_inputs(cs, sun, points, skip)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert (kw["S"] > 1) == (form == "hier")
    got, visits = walk._walk_any_dest_plain(*args, **opts)
    ref = np.asarray(jmk._walk_pallas(*jargs, tcap_col=4, mode="any_dest",
                                      stream=False, interpret=True,
                                      **kw)[0]).reshape(-1)
    got = got.numpy()
    assert ((ref == 1) & (args[4].numpy() == 0)).sum() > 0
    differ = np.nonzero(got != ref)[0]
    d = tuple(np.asarray(points[a] - sun[a])[np.asarray(jperm)]
              for a in range(3))
    for ray in differ:   # boundary cases only
        assert abs(_shadow_margin(cs, sun, d, ray)) <= 1e-6
    for tile in (LIT, FALLS, STRADDLE, SKIPPED):
        steps = _jax_tile_visits(jargs, kw, tile)
        if not np.any(differ // 128 == tile):
            assert int(visits[tile]) == steps, (tile, int(visits[tile]),
                                                steps)


@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("seg", [1, 3, 7, 256])
def test_split_schedule_matches_plain(scene, form, seg, groups):
    cs, sun, points, skip = scene
    args, opts, _, _ = _port_inputs(cs, sun, points, skip)
    opts = dict(opts)
    del opts["stream"]
    ref, ref_visits = walk._walk_any_dest_plain(*args, **opts)
    got, visits = walk._split_walk_plain(*args, **opts, seg=seg,
                                         groups=groups)
    assert torch.equal(got, ref)
    assert torch.equal(visits, ref_visits)


@pytest.mark.parametrize("seg", [1, 5])
def test_split_schedule_on_the_bunny(bunny_regrouped, form, seg):
    # The bunny's regrouped wavefront: 8 groups a tile, as on the card.
    args, opts, _, _ = _port_inputs(*bunny_regrouped)
    opts = dict(opts)
    del opts["stream"]
    ref, ref_visits = walk._walk_any_dest_plain(*args, **opts)
    assert int(ref_visits.max()) > 5 * seg
    got, visits = walk._split_walk_plain(*args, **opts, seg=seg)
    assert torch.equal(got, ref)
    assert torch.equal(visits, ref_visits)


@pytest.fixture(scope="module")
def dragon_regrouped(dragon):
    """The dragon's 64 x 64 shadow wavefront (``test_torch_walk.py``'s
    receivers): (cut, sun, points, skip), JAX arrays. Its SweepSAH cut
    has 268 blocks, so a key row is longer than a segment of the split
    walk (walk.cu's kSeg128, 256 block visits), and flat with resident
    weights: the form of K2-128."""
    cs, _, _, sun, points, skip = _mesh_scene(*dragon, EYES["dragon"])
    return cs, sun, points, skip


def test_dragon_regrouped_matches_jax(dragon_regrouped):
    # Flags against the JAX package's regroup=True ray for ray (f32
    # boundary cases each checked in float64), and the executed visits of
    # every tile against its walk's on that tile alone; two tiles walk
    # past the first segment.
    cs, sun, points, skip = dragon_regrouped
    args, opts, perm, _ = _port_inputs(cs, sun, points, skip)
    assert opts["S"] == 1 and not opts["stream"]
    assert args[1].shape[1] == 268
    jargs, kw, jperm = _jax_inputs(cs, sun, points, skip)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    ref = np.asarray(jmk.any_hit_to_point(None, sun, points, skip=skip,
                                          clusters=cs, regroup=True))
    got = pmk.any_hit_to_point(None, _port(sun), _port(points),
                               skip=_port(skip),
                               clusters=convert.cluster_set(cs),
                               regroup=True).numpy()
    assert ref.sum() > 0
    d = tuple(np.asarray(points[a] - sun[a]) for a in range(3))
    for ray in np.nonzero(got != ref)[0]:   # boundary cases only
        assert abs(_shadow_margin(cs, sun, d, ray)) <= 1e-6
    flags, visits = walk._walk_any_dest_plain(*args, **opts)
    differ = np.nonzero(flags.numpy() != np.asarray(jmk._walk_pallas(
        *jargs, tcap_col=4, mode="any_dest", stream=False, interpret=True,
        **kw)[0]).reshape(-1))[0]
    assert int((visits > 256).sum()) >= 2
    for tile in range(args[0].numel()):
        if args[0][tile] > 0 and not np.any(differ // 128 == tile):
            assert int(visits[tile]) == _jax_tile_visits(jargs, kw, tile)


@pytest.mark.parametrize("seg", [64, 256])
def test_dragon_split_schedule_matches_plain(dragon_regrouped, seg):
    # K2-128's schedule on rows longer than a segment: at the default of
    # 256 block visits the tiles that walk past it take a later segment.
    args, opts, _, _ = _port_inputs(*dragon_regrouped)
    opts = dict(opts)
    del opts["stream"]
    ref, ref_visits = walk._walk_any_dest_plain(*args, **opts)
    assert int(ref_visits.max()) > 256
    got, visits = walk._split_walk_plain(*args, **opts, seg=seg)
    assert torch.equal(got, ref)
    assert torch.equal(visits, ref_visits)

"""The walk kernels against their plain versions, on an NVIDIA card.

Needs no JAX, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX). Without a card the
``cuda`` tests skip. Kernel and plain version must agree exactly (slot
ids, occlusion flags, executed visits): the kernels are built with
``--fmad=false`` and written in the plain versions' operation order.
Inputs come from the port's own paths at small sizes: bunny (61
clusters), dragon (268 clusters: cluster-id masking past 256) and a
random soup with rays in every direction. Every variant is held there:
each mode (closest, closest with a per-ray window, the shadow segments
from the sun, and the reference-exact generic shadow rays), flat and
two-level (forced by a threshold of 1 block, as the CPU tests force it),
each with weights staged per visit and streamed.

The two-level walk and the streamed flat walk run each tile on a cluster
of CTAs that split its rays and exchange the prune, with every block's
lanes split over the threads of a ray, and visit the next block ahead of
the exchange, so they are held again tile by tile (executed visits per
tile, not only their sum): with equal-t triangles in neighbouring lanes
of one block (ties across the threads of a ray), on the 3x bunny at
256 x 256, where one tile makes over 1,000 visits while most make none,
and, two-level, with S = 2, 7 and 32 member slots; flat, on key rows cut
to 0 and 1 candidates and on tiles whose walk ends by dropping the
visit made ahead (``dropped_speculation``).

The shadow walk regrouped by receiver (``any_hit_to_point(regroup=True)``)
runs on tiles of 128 rays: its three forms (resident flat, streamed flat,
two-level resident and streamed) are held to the plain version tile by
tile on the same inputs, on the 3x bunny too, and the regrouped entry
point gives the unregrouped flags on the card. Every form is the split
walk (ray groups walk segments of a tile's key row apart; a replay
recounts the visits): held also on the 3x bunny's 1080p heaviest
regrouped tile (over 2,000 visits, its receivers across a top-level
jump of the morton order) with segments of the default length and of 1,
7 and 64 block visits, in each form; on the bunny's 1080p heaviest
regrouped tile (resident flat, over 40 visits) in the same segments; on
the dragon's 64 x 64 wavefront, whose rows of 268 blocks are longer than
a segment (resident flat); on supers of 2, 7 and 32 blocks in segments
of 1 and 5; and on tiles whose prune falls after a later visit, walked
in segments of 1 and 2 (flat, resident and streamed), where segments
past the fall visit under a stale prune uncounted.

The resident flat walk runs each tile on one CTA, copies the next block
while it visits one, and in the shadow modes hands the tile's live rays
to the leading threads at every visit. It is held on tiles whose walk
ends by dropping the copied block, right after the first visit or a
later one, and on tiles where each warp keeps one live ray after the
first visit.

The training path on the card: the bunny's gradients w.r.t. the
vertices and the eye equal the CPU's (rtol 1e-4, atol 1e-5 max|g|: the
card sums the backward's repeated indices in another order), a 5-step
``fit_vertices`` lowers the loss, and a checkpointed fit resumes to the
uninterrupted one.

The frame and the train step as CUDA graphs
(``render.renderer.render_graph``, ``diff.make_train_step`` on the
card): every frame config (smooth, flat, normal; default and
reference-exact; shadows on and off) replayed against the eager frame
(stats exact, images within one level), the eager frame and step under
``torch.cuda.set_sync_debug_mode("error")`` (no host sync on the path a
graph captures), and the captured step against the eager one over 3
steps, refitted and rebuilt. The LBVH treelet build and its cuts, the
morton runs and the refit under the same sync check; the build captured
and replayed, bit-equal to the eager build; the frame of a deforming
scene (``render_graph`` without a prebuilt cut, called with moved
vertices) against the eager frame that builds its cut. The spans
(``utils.spans``): a frame graph captured with them off holds the plain
capture's nodes and with them on those and its stamp kernels alone; the
1080p frame's ``walk`` spans within 10% of CUDA events around the same
walks; the captured train step's five ``step.*`` spans.

The LBVH build's kernels (``accel/csrc/lbvh.cu``: the hierarchy, one
thread an internal node, and the boxes, one thread a leaf climbing by
arrival counters) against the plain version run on the same card
tensors, every ``Lbvh`` array bit-equal (floats as bit patterns, dtype
included), on the bunny, the 4x bunny (1.27M triangles, many tied morton
codes), a seeded random soup, the comb and super-comb soups, soups of 2
and 3 triangles, a soup on the coordinate planes (zeros of both signs in
the boxes) and the bunny in float64; a refit without gradients (the
boxes kernel) against the plain boxes; the treelet ``ClusterSet`` built
on either; a refit with gradients on the card keeps the plain passes;
``lbvh.launches`` rises by one a kernel a build, eager or replayed.

The float64 walk kernel (``ops/csrc/walk_f64.cu``) against the plain
frontier loop (``ops.walk_f64._walk_plain``) on the same card
tensors, the inputs of the three entry points' prepasses: on the bunny and the dragon
decimation from the bench camera, a seeded random soup, and
``lbvh_soups``' super comb and coordinate planes, in every mode (closest,
with a per-ray and a scalar window; shadow segments with and without
skipped rays; generic shadow rays): winner slots and flags bit-equal,
executed visits equal, one launch a call counted in
``walk_f64.launches`` and ``walk_f64.clustered``. The kernel walks each
tile on a cluster of kK CTAs in rounds of kK candidates, dropping the
outcomes past the plain stop, so it is held also tile by tile (visits
per tile) on crafted rows of the bunny's rays (``tests/f64_rows.py``):
the stop right after each position of the first two rounds, where the
next candidate holds a hit for a ray that nothing visited hits; a row
shorter than a round and a row of none; a cluster and its twin (equal
t) in one round and across two, in both orders; and on the 4x bunny's
heaviest 1080p closest tile (over 10,000 candidates). The float64
prepass kernel against its plain
passes (``ops.walk_f64._prepass_plain``) on the arguments each entry
point gives it, on those scenes and on constructed ones (tiles past the
kernel's shared-memory sort, boxes tied in pairs, empty boxes, a tile of
dead rays): counts equal, rows bit-equal up to them, the rest of each
row entries of at least ``_VALID_CUT`` and ids that make the row a
permutation of the clusters, one launch a call counted in
``prepass_f64.launches``, the walk the same from either. The
float64-exact frame as a CUDA graph against the eager frame, with the
cut and winner table built before it (image bit-equal) and in it (moved
vertices; stats exact), no float32 walk launched, each float64 kernel
once a walk a replay, and the eager frame free of host syncs.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel.clusters import build_clusters_treelet
from ceres_tpu_torch.accel.cuts import build_clusters_quality
from ceres_tpu_torch.models.camera import camera_ray_columns
from ceres_tpu_torch.models.mesh import subdivide
from ceres_tpu_torch.ops import megakernel as mk
from ceres_tpu_torch.ops import prepass, walk
from ceres_tpu_torch.render.renderer import _hit_points
from ceres_tpu_torch.utils import tiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUN = (-50.0, 100.0, 0.0)
EYES = {"bunny": (0.0, 0.1, -0.3), "dragon": (0.0, 2.5, -12.0)}


def _uniform_supers(cs, S):
    """``cs`` with supers of S consecutive blocks."""
    n_c = cs.num_clusters
    first = torch.clamp(torch.arange(-(-n_c // S), dtype=torch.int32,
                                     device=cs.lo.device) * S, max=n_c)
    return dataclasses.replace(cs, super_first=first, super_S=S)


def _inputs(name, dev, S=None, size=(256, 160)):
    """Each mode's walk inputs, flat and two-level, as the main path
    builds them. ``bunny3`` is the 3x subdivided bunny on its treelet
    cut; ``S`` replaces the supers by runs of S blocks."""
    if name == "random":
        rng = np.random.default_rng(5)
        verts = rng.standard_normal((90, 3)).astype(np.float32)
        faces = rng.integers(0, 90, (400, 3)).astype(np.int32)
        eye = np.asarray([0.0, 0.0, -4.0], np.float32)
        d = rng.standard_normal((3, 3000)).astype(np.float32)
        dirs = tuple(torch.as_tensor(c / np.linalg.norm(d, axis=0),
                                     device=dev) for c in d)
    else:
        mesh = "bunny" if name == "bunny3" else name
        verts, faces = ct.load_obj(os.path.join(ROOT, "data", f"{mesh}.obj"))
        if name == "bunny3":
            verts, faces = subdivide(verts, faces, 3)
        eye = np.asarray(EYES[mesh], np.float32)
        cam = ct.Camera.make(eye=eye, dir=verts.mean(axis=0) - eye,
                             up=(0, 1, 0), fov=60.0, device=dev)
        dirs = tuple(tiling.swizzle_plane(p)
                     for p in camera_ray_columns(cam, *size))
    vt = torch.as_tensor(verts, device=dev)
    ft = torch.as_tensor(faces, device=dev)
    eye = torch.as_tensor(eye, device=dev)
    soup = ct.triangle_soup(vt, ft)
    bare = ct.triangle_soup(vt, ft, with_normals=False)
    cs = (build_clusters_treelet(bare) if name == "bunny3"
          else build_clusters_quality(bare))
    if S is not None:
        cs = _uniform_supers(cs, S)
    hit, pay = mk.closest_hit_common_origin(soup, eye, dirs, clusters=cs,
                                            normal_cols=True)
    points = _hit_points(eye, dirs, hit, pay)
    sun = torch.as_tensor(SUN, device=dev)
    sl = tuple(sun[a] - points[a] for a in range(3))
    inv = torch.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
    sun_line = tuple(c * inv for c in sl)
    # Windows: the second surface behind each first hit (depth peeling),
    # and a near/far clip for the rays that missed.
    tmin = torch.where(hit.mask, hit.t * 1.0001, 0.05)
    tmax = torch.where(hit.mask, 1e30, 8.0)
    out = {}
    for walk_form, threshold in (("flat", prepass._HIER_MIN_CLUSTERS),
                                 ("hier", 1)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(prepass, "_HIER_MIN_CLUSTERS", threshold)
            out[walk_form] = {
                "closest": mk._closest_inputs(cs, eye, dirs),
                "closest_window": mk._closest_inputs(cs, eye, dirs, tmin,
                                                     tmax),
                "any_dest": mk._any_dest_inputs(cs, sun, points, ~hit.mask),
                "any_dest_t128": regrouped_inputs(cs, sun, points,
                                                  ~hit.mask),
                "any": mk._any_inputs(cs, soup.p0.mean(0), points, sun_line,
                                      ~hit.mask)}
    return out


def regrouped_inputs(cs, sun, points, skip):
    """The shadow walk's inputs regrouped by receiver, as
    ``any_hit_to_point(regroup=True)`` builds them: 128-ray tiles."""
    perm = mk._receiver_order(cs, points, skip)
    return mk._any_dest_inputs(cs, sun, tuple(c[perm] for c in points),
                               skip[perm], tile=mk._REGROUP_TILE)


KERNELS = {"closest": (walk.walk_closest, walk._walk_closest_plain),
           "closest_window": (walk.walk_closest, walk._walk_closest_plain),
           "any_dest": (walk.walk_any_dest, walk._walk_any_dest_plain),
           "any": (walk.walk_any, walk._walk_any_plain)}


@pytest.fixture(scope="module", params=["random", "bunny", "dragon"])
def card_inputs(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    return _inputs(request.param, torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("walk_form", ["flat", "hier"])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_kernel_equals_plain(card_inputs, mode, walk_form, stream):
    args, opts = card_inputs[walk_form][mode]
    opts = dict(opts, stream=stream)
    assert (opts["S"] > 1) == (walk_form == "hier")
    assert opts.get("window", False) == (mode == "closest_window")
    kernel, plain = KERNELS[mode]
    name = walk._variant(mode, opts["S"], stream)
    before = dict(walk.launches)
    out_k, visits_k = kernel(*args, **opts)
    out_p, visits_p = plain(*args, **opts)
    torch.cuda.synchronize()
    assert walk.launches[name] == before[name] + 1
    positive = (out_p >= 0 if mode.startswith("closest")
                else (out_p == 1) & (args[4] == 0))
    assert int(positive.sum()) > 0
    assert torch.equal(out_k, out_p)
    assert torch.equal(visits_k, visits_p) and int(visits_p.sum()) > 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=[2, 7, 32])
def supers(request):
    return request.param, _inputs("bunny", _card(), S=request.param)["hier"]


@pytest.fixture(scope="module")
def heavy():
    return _inputs("bunny3", _card(), size=(256, 256))


def _same_per_tile(mode, args, opts):
    """A kernel against its plain version, outputs and executed visits
    tile by tile. Returns the plain per-tile visits."""
    kernel, plain = KERNELS[mode]
    out_k, tiles_k = kernel(*args, **opts)
    out_p, tiles_p = plain(*args, **opts)
    torch.cuda.synchronize()
    positive = (out_p >= 0 if mode.startswith("closest")
                else (out_p == 1) & (args[4] == 0))
    assert int(positive.sum()) > 0
    assert torch.equal(out_k, out_p)
    assert torch.equal(tiles_k, tiles_p) and int(tiles_p.sum()) > 0
    return tiles_p


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_cluster_walk_equals_plain_per_tile(supers, mode, stream, ties):
    S, inputs = supers
    args, opts = inputs[mode]
    assert opts["S"] == S
    if ties:
        args = with_ties(args)
    _same_per_tile(mode, args, dict(opts, stream=stream))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_cluster_walk_heavy_tile(heavy, mode, stream):
    args, opts = heavy["hier"][mode]
    assert opts["S"] > 1
    tiles = _same_per_tile(mode, args, dict(opts, stream=stream))
    if mode == "closest":
        assert int(tiles.max()) > 1000


def with_ties(args):
    """``args`` with each block's odd lanes repeating its even ones: equal
    t in neighbouring lanes, which other threads of a ray hold."""
    w = args[3].clone()
    w[..., 1::2] = w[..., 0::2]
    return (*args[:3], w, *args[4:])


def with_short_rows(args):
    """``args`` with every third tile's key row cut to no candidate and
    every third to one."""
    counts = args[0]
    tile = torch.arange(counts.numel(), device=counts.device)
    cut = torch.where(tile % 3 == 0, 0, torch.where(tile % 3 == 1, 1, 1 << 30))
    return (torch.minimum(counts, cut.to(torch.int32)), *args[1:])


def prune_trace(mode, args, opts, tile):
    """One tile's plain walk alone: (the tile prune before visit 0 and
    after each executed visit, the executed visits)."""
    width = args[2].shape[1] // args[0].numel()
    rays = slice(tile * width, (tile + 1) * width)
    one = (args[0][tile:tile + 1], args[1][tile:tile + 1],
           args[2][:, rays].contiguous(), args[3], *(a[rays] for a in args[4:]))
    trace = []
    plain_walk = walk._walk

    def traced(counts, keys, rays, tcap_row, state, prune_of, visit, hier=None):
        def recorded(*a):
            prune = prune_of(*a)
            trace.append(int(prune[0]))
            return prune
        return plain_walk(counts, keys, rays, tcap_row, state, recorded, visit,
                          hier)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(walk, "_walk", traced)
        _, visits = KERNELS[mode][1](*one, **opts)
    assert len(trace) == int(visits[0]) + 1
    return trace, int(visits[0])


def _cmask(keys):
    return (1 << prepass._cid_bits(keys.shape[1])) - 1


def with_dropped_speculation(mode, args, opts, limit=3, later=False):
    """(``args`` with up to ``limit`` tiles changed, those tiles): in each,
    some visit j lowers the tile prune (the first such visit, or with
    ``later`` the first after visit 0), and the key row is cut to j + 2
    candidates with candidate j + 1's entry set just inside the prune in
    force during visit j, so outside the prune that visit leaves. The
    cluster walk visits candidate j + 1 ahead of the prune exchange and
    must then drop that visit, uncounted; the resident walk copies its
    block during visit j and must drop it. A shadow walk's prune falls
    only with its tile's last unoccluded ray, so there the rays that no
    block occludes start as skipped."""
    out, visits = KERNELS[mode][1](*args, **opts)
    counts, keys = args[0].clone(), args[1].clone()
    args = (counts, keys, *args[2:])
    if len(args) > 4:
        occ0 = args[4] | (out == 0).to(torch.int32)
        args = (*args[:4], occ0)
    cmask = _cmask(keys)
    cut = []
    for tile in ((visits > 0) & (counts > 1)).nonzero().flatten().tolist():
        trace, v = prune_trace(mode, args, opts, tile)
        falls = [j for j in range(int(later), min(v, int(counts[tile]) - 1))
                 if (trace[j] & ~cmask) > trace[j + 1]]
        if falls:
            j = falls[0]
            keys[tile, j + 1] = (trace[j] & ~cmask) | (keys[tile, j + 1] & cmask)
            counts[tile] = j + 2
            cut.append(tile)
            if len(cut) == limit:
                break
    return args, cut


def dropped_speculation(mode, args, opts, visits, tiles):
    """Those of ``tiles`` whose flat walk ends with candidates left and
    the next entry within the prune in force during the last visit, but
    outside the prune it left."""
    counts, keys = args[0], args[1]
    found = []
    for tile in tiles:
        trace, v = prune_trace(mode, args, opts, tile)
        assert v == int(visits[tile])
        if 0 < v < int(counts[tile]):
            entry = int(keys[tile, v]) & ~_cmask(keys)
            assert entry > trace[v]
            if entry <= trace[v - 1]:
                found.append(tile)
    return found


@pytest.fixture(scope="module")
def flat_bunny():
    return _inputs("bunny", _card())["flat"]


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_flat_walk_ties_across_threads(card_inputs, mode, stream):
    args, opts = card_inputs["flat"][mode]
    assert opts["S"] == 1
    _same_per_tile(mode, with_ties(args), dict(opts, stream=stream))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_flat_walk_short_rows(card_inputs, mode, stream):
    args, opts = card_inputs["flat"][mode]
    args = with_short_rows(args)
    assert int((args[0] == 0).sum()) > 0 and int((args[0] == 1).sum()) > 0
    tiles = _same_per_tile(mode, args, dict(opts, stream=stream))
    assert bool((tiles <= args[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_flat_walk_heavy_tile(heavy, mode, stream):
    # 4,968 blocks (not a power of two), a streamed flat walk. On the CPU
    # the plain closest walk of these inputs makes 8,619 visits over 128
    # tiles, 1,146 of them in one tile (17 times the mean of 67.3) and
    # none in 93; the shadow walk 23,171 with 2,065 in one tile.
    args, opts = heavy["flat"][mode]
    assert opts["S"] == 1 and opts["stream"] and args[1].shape[1] == 4968
    tiles = _same_per_tile(mode, args, dict(opts, stream=stream))
    if mode == "closest":
        assert int(tiles.max()) >= 10 * float(tiles.float().mean())
        assert int((tiles == 0).sum()) > tiles.numel() // 2


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_flat_walk_drops_speculative_visit(flat_bunny, mode, stream):
    args, opts = flat_bunny[mode]
    opts = dict(opts, stream=stream)
    args, cut = with_dropped_speculation(mode, args, opts)
    assert cut, "no visit of these inputs lowers its tile's prune"
    tiles = _same_per_tile(mode, args, opts)
    assert dropped_speculation(mode, args, opts, tiles, cut) == cut


@pytest.mark.cuda
@pytest.mark.parametrize("later", [False, True])
@pytest.mark.parametrize("mode", list(KERNELS))
def test_solo_walk_drops_prefetched_block(card_inputs, mode, later):
    # The resident walk copies block j + 1 while it visits block j (before
    # the loop for j = 0, in it after); here the prune falls below block
    # j + 1's entry right after visit j, so the copy is dropped uncounted.
    args, opts = card_inputs["flat"][mode]
    opts = dict(opts, stream=False)
    args, cut = with_dropped_speculation(mode, args, opts, limit=8,
                                         later=later)
    assert cut, "no visit of these inputs lowers its tile's prune"
    tiles = _same_per_tile(mode, args, opts)
    assert dropped_speculation(mode, args, opts, tiles, cut) == cut


def with_one_live_ray_a_warp(mode, args):
    """Shadow-walk ``args`` where each warp of a tile keeps one live ray
    past the tile's first candidate block: the rays that block occludes,
    and the warp's first other live ray, start live; every other ray of
    the warp starts as skipped."""
    counts, keys, rays, w, occ0 = args
    n_tiles = counts.numel()
    cmask = _cmask(keys)
    first = (keys[:, 0] & cmask).long()
    r = rays.reshape(rays.shape[0], n_tiles, walk.TILE)
    hit = walk._pair_hits(r, w[first], mode).any(dim=2)    # (tiles, 512)
    other = (occ0.reshape(n_tiles, walk.TILE) == 0) & ~hit
    warp = other.reshape(n_tiles, -1, 32)
    keep = warp & (warp.to(torch.int32).cumsum(dim=2) == 1)
    start = hit | keep.reshape(n_tiles, walk.TILE)
    start &= (counts > 0)[:, None]
    occ = torch.where(start, 0, 1).to(torch.int32).reshape(-1)
    return (counts, keys, rays, w, occ | occ0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["any_dest", "any"])
def test_solo_shadow_walk_one_live_ray_a_warp(card_inputs, mode):
    # After its first visit each warp of a tile holds one live ray: the
    # resident shadow walk hands those rays to the leading threads, so the
    # warps behind them walk nothing, with outputs and visits unchanged.
    args, opts = card_inputs["flat"][mode]
    args = with_one_live_ray_a_warp(mode, args)
    opts = dict(opts, stream=False)
    tiles = _same_per_tile(mode, args, opts)
    assert int((tiles > 1).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("walk_form", ["flat", "hier"])
def test_regrouped_kernel_equals_plain_per_tile(card_inputs, walk_form,
                                                stream):
    args, opts = card_inputs[walk_form]["any_dest_t128"]
    assert args[2].shape[1] == 128 * args[0].numel()
    assert (opts["S"] > 1) == (walk_form == "hier")
    name = walk._variant("any_dest", opts["S"], stream, 128)
    assert name.endswith("_t128")
    before = dict(walk.launches)
    _same_per_tile("any_dest", args, dict(opts, stream=stream))
    assert {k: n - before[k] for k, n in walk.launches.items()
            if n != before[k]} == {name: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("walk_form", ["flat", "hier"])
def test_regrouped_kernel_heavy(heavy, walk_form, stream):
    # The 3x bunny's treelet cut (4,968 blocks, weights streamed): the
    # streamed flat form is the one its regrouped wavefront takes.
    args, opts = heavy[walk_form]["any_dest_t128"]
    assert opts["stream"] and (opts["S"] > 1) == (walk_form == "hier")
    _same_per_tile("any_dest", args, dict(opts, stream=stream))


def _tiles_of(args, opts, tiles):
    """The walk inputs of ``tiles`` alone (in that order)."""
    counts, keys, rays, w, occ0 = args
    width = rays.shape[1] // counts.numel()
    sel = torch.as_tensor(tiles, device=counts.device)
    ids = (sel[:, None] * width + torch.arange(width, device=sel.device)
           ).reshape(-1)
    out = (counts[sel].contiguous(), keys[sel].contiguous(),
           rays[:, ids].contiguous(), w, occ0[ids].contiguous())
    if opts["S"] > 1:
        opts = dict(opts, hull=opts["hull"][sel].contiguous())
    return out, opts


@pytest.fixture(scope="module")
def straddle():
    """The regrouped shadow walk of the 3x bunny's 1920 x 1080 frame, flat
    and two-level (all its 4,968 blocks in supers), cut to its heaviest
    tile and three others (the next heaviest, a light one, an empty one):
    the heaviest walks over 2,000 visits, its 128 receivers straddling a
    jump of the morton curve (first and last codes apart in bit 27 or
    higher)."""
    from ceres_tpu_torch.accel import morton

    dev = _card()
    verts, faces = subdivide(*ct.load_obj(os.path.join(ROOT, "data",
                                                       "bunny.obj")), 3)
    vt, ft = torch.as_tensor(verts, device=dev), torch.as_tensor(faces,
                                                                 device=dev)
    soup = ct.triangle_soup(vt, ft)
    cs = build_clusters_treelet(ct.triangle_soup(vt, ft, with_normals=False))
    eye = np.asarray(EYES["bunny"], np.float32)
    cam = ct.Camera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0, device=dev)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, 1920, 1080))
    hit, pay = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                            normal_cols=True)
    points = _hit_points(cam.eye, dirs, hit, pay)
    sun = torch.as_tensor(SUN, device=dev)
    perm = mk._receiver_order(cs, points, ~hit.mask)
    code = morton.morton_codes(torch.stack([c[perm] for c in points], -1),
                               *prepass._scene_root(cs))
    out = {}
    for walk_form, threshold in (("flat", prepass._HIER_MIN_CLUSTERS),
                                 ("hier", 1)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(prepass, "_HIER_MIN_CLUSTERS", threshold)
            args, opts = regrouped_inputs(cs, sun, points, ~hit.mask)
        visits = walk._walk_any_dest_plain(*args, **opts)[1]
        order = visits.argsort(descending=True).tolist()
        heavy = order[0]
        assert int(visits[heavy]) >= 2000
        first, last = int(code[heavy * 128]), int(code[heavy * 128 + 127])
        assert (first ^ last).bit_length() - 1 >= 27
        light = next(t for t in order if 0 < int(visits[t]) < 20)
        empty = int((visits == 0).nonzero()[0])
        out[walk_form] = _tiles_of(args, opts, [heavy, order[1], light,
                                                empty])
    return out


# The forms of the split walk: (walk form, streamed weights); every
# 128-ray form is the split walk.
SPLIT_FORMS = [("flat", True), ("hier", False), ("hier", True),
               ("flat", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [0, 1, 7, 64])
@pytest.mark.parametrize("walk_form,stream", SPLIT_FORMS)
def test_split_walk_straddling_tile(straddle, walk_form, stream, seg,
                                    monkeypatch):
    # The two cluster walks of 128-ray tiles (the streamed flat form,
    # K5-128, and the two-level forms, K7a-128) split each tile's key row
    # into segments walked apart: the default kSeg128, and segments of 1,
    # 7 and 64 block visits.
    args, opts = straddle[walk_form]
    monkeypatch.setattr(walk, "_SPLIT_SEG", seg)
    tiles = _same_per_tile("any_dest", args, dict(opts, stream=stream))
    assert int(tiles[0]) >= 2000 and int(tiles[3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [1, 2])
def test_split_walk_drops_stale_visits(card_inputs, seg, monkeypatch):
    # Tiles whose prune falls at a visit after the first, with the next
    # candidate inside the prune before it: in segments of one or two
    # visits the groups' later segments run at once, each with the rays
    # that no earlier segment had found occluded when it started, so a
    # segment past the fall may visit under a stale prune. The replay
    # counts only the sequential walk's visits.
    args, opts = card_inputs["flat"]["any_dest_t128"]
    args, cut = with_dropped_speculation("any_dest", args, opts, later=True)
    assert cut, "no visit after the first lowers a tile's prune"
    monkeypatch.setattr(walk, "_SPLIT_SEG", seg)
    for stream in (False, True):
        tiles = _same_per_tile("any_dest", args, dict(opts, stream=stream))
        assert all(int(tiles[t]) == int(args[0][t]) - 1 for t in cut)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_regrouped_cluster_walk_supers(supers, ties):
    S, inputs = supers
    args, opts = inputs["any_dest_t128"]
    assert opts["S"] == S
    if ties:
        args = with_ties(args)
    for stream in (False, True):
        _same_per_tile("any_dest", args, dict(opts, stream=stream))


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [1, 5])
def test_split_walk_supers(supers, seg, monkeypatch):
    # Supers of 2, 7 and 32 blocks in segments of a few block visits (one
    # super a segment but for S = 2 at seg 5: two).
    S, inputs = supers
    args, opts = inputs["any_dest_t128"]
    monkeypatch.setattr(walk, "_SPLIT_SEG", seg)
    for stream in (False, True):
        _same_per_tile("any_dest", args, dict(opts, stream=stream))


def _seg128():
    """walk.cu's kSeg128: block visits a segment of the split walk."""
    src = open(os.path.join(os.path.dirname(walk.__file__), "csrc",
                            "walk.cu")).read()
    return int(re.search(r"constexpr int kSeg128 = (\d+);", src).group(1))


@pytest.fixture(scope="module")
def resident_rows():
    """The regrouped shadow walk on resident weights, flat: the bunny's
    1920 x 1080 frame (61 blocks) cut to its heaviest tile (over 40
    visits, with receivers no block occludes), the next heaviest, a
    light one and an empty one; and the dragon's 64 x 64 frame (268
    blocks, more than a segment), whose heaviest tiles walk past the
    first segment."""
    dev = _card()
    verts, faces = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    vt, ft = torch.as_tensor(verts, device=dev), torch.as_tensor(faces,
                                                                 device=dev)
    soup = ct.triangle_soup(vt, ft)
    cs = build_clusters_quality(ct.triangle_soup(vt, ft, with_normals=False))
    eye = np.asarray(EYES["bunny"], np.float32)
    cam = ct.Camera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0, device=dev)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, 1920, 1080))
    hit, pay = mk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                            normal_cols=True)
    points = _hit_points(cam.eye, dirs, hit, pay)
    args, opts = regrouped_inputs(cs, torch.as_tensor(SUN, device=dev),
                                  points, ~hit.mask)
    visits = walk._walk_any_dest_plain(*args, **opts)[1]
    order = visits.argsort(descending=True).tolist()
    light = next(t for t in order if 0 < int(visits[t]) < 4)
    empty = int((visits == 0).nonzero()[0])
    bunny = _tiles_of(args, opts, [order[0], order[1], light, empty])
    dragon = _inputs("dragon", dev, size=(64, 64))["flat"]["any_dest_t128"]
    return {"bunny": bunny, "dragon": dragon}


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [0, 1, 7, 64])
def test_split_walk_resident_heaviest_tile(resident_rows, seg, monkeypatch):
    # The resident flat 128-ray walk (K2-128) on the bunny's heaviest
    # regrouped 1080p tile: its lit receivers keep the prune up, so its
    # ray groups walk most of the key row; in one segment (the default)
    # and in segments of 1, 7 and 64 block visits.
    args, opts = resident_rows["bunny"]
    assert opts["S"] == 1 and not opts["stream"]
    monkeypatch.setattr(walk, "_SPLIT_SEG", seg)
    tiles = _same_per_tile("any_dest", args, opts)
    assert int(tiles[0]) >= 40 and int(tiles[3]) == 0


@pytest.mark.cuda
def test_split_walk_resident_rows_past_a_segment(resident_rows):
    # The dragon's key rows of 268 blocks, longer than a segment of
    # kSeg128: tiles that walk past the first segment take the later
    # ones on resident weights, and the replay counts their visits.
    args, opts = resident_rows["dragon"]
    assert opts["S"] == 1 and not opts["stream"]
    assert args[1].shape[1] > _seg128()
    tiles = _same_per_tile("any_dest", args, opts)
    assert int(tiles.max()) > _seg128()


@pytest.mark.cuda
def test_regrouped_entry_point_on_card():
    # any_hit_to_point(regroup=True) on the card: the 128-ray variant
    # alone is launched, and the flags are the unregrouped ones.
    dev = _card()
    verts, faces = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    soup = ct.triangle_soup(torch.as_tensor(verts, device=dev),
                            torch.as_tensor(faces, device=dev),
                            with_normals=False)
    cs = build_clusters_quality(soup)
    rng = np.random.default_rng(8)
    pick = torch.as_tensor(rng.integers(0, faces.shape[0], 20000), device=dev)
    uv = torch.as_tensor(rng.uniform(0.0, 0.5, (2, 20000)).astype(np.float32),
                         device=dev)
    points = (soup.p0[pick] - uv[0, :, None] * soup.e1[pick]
              + uv[1, :, None] * soup.e2[pick])
    skip = torch.as_tensor(rng.random(20000) < 0.3, device=dev)
    sun = torch.as_tensor(SUN, device=dev)
    walk.reset_launches()
    base = mk.any_hit_to_point(soup, sun, points, skip=skip, clusters=cs)
    torch.cuda.synchronize()
    assert {k: n for k, n in walk.launches.items() if n} == {
        "walk_any_dest": 1}
    walk.reset_launches()
    got = mk.any_hit_to_point(soup, sun, points, skip=skip, clusters=cs,
                              regroup=True)
    torch.cuda.synchronize()
    assert {k: n for k, n in walk.launches.items() if n} == {
        "walk_any_dest_t128": 1}
    assert int(base.sum()) > 0 and torch.equal(got, base)
    cs_cpu = dataclasses.replace(cs, **{
        f.name: getattr(cs, f.name).cpu() for f in dataclasses.fields(cs)
        if torch.is_tensor(getattr(cs, f.name))})
    cpu = mk.any_hit_to_point(None, sun.cpu(), points.cpu(), skip=skip.cpu(),
                              clusters=cs_cpu, regroup=True)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(card_inputs):
    (counts, keys, rays, w), _ = card_inputs["flat"]["closest"]
    with pytest.raises(ValueError, match="counts"):
        walk.walk_closest(counts.cpu(), keys, rays, w)


@pytest.mark.cuda
def test_render_on_card_matches_cpu():
    # The user entry point end to end on the card (device treelet cut,
    # kernels, torch column math) against the same call on the CPU (plain
    # walks).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    verts, faces = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    eye = np.asarray(EYES["bunny"], np.float32)
    cam = ct.Camera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0)
    out = {dev: ct.render(verts, faces, cam, SUN, width=96, height=64,
                          backend="megakernel", device=dev)
           for dev in ("cpu", "cuda")}
    (img_c, st_c), (img_g, st_g) = out["cpu"], out["cuda"]
    assert img_g.device.type == "cuda"
    assert int(st_g["rays"]) == 96 * 64 + int(st_g["primary_hits"])
    for k in ("primary_hits", "shadow_hits"):
        # rsqrt and index_add round differently on the card: a silhouette
        # or shadow-edge ray may flip (0.1% of the pixels).
        assert abs(int(st_g[k]) - int(st_c[k])) <= 0.001 * 96 * 64
    off = (img_g.cpu() - img_c).abs().amax(-1) > 1e-4
    assert off.float().mean() < 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["megakernel", "bruteforce"])
def test_compat_render_on_card_matches_cpp(backend):
    # The reference-exact path on the card (generic shadow walk, or the
    # brute-force oracle's full-float32 products) against the rays/hits
    # the C++ reference printed for its bunny fixture.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    from ceres_tpu_torch.render import scenes

    sc = scenes.bunny_scene()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")   # TF32 allowed globally
    try:
        img, st = ct.render(sc.vertices, sc.faces, sc.camera, sc.sun,
                            width=64, height=64, backend=backend,
                            reference_compat=True, device="cuda")
    finally:
        torch.set_float32_matmul_precision(prev)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert (int(st["rays"]), int(st["hits"])) == (4645, 804)


def _bunny_grads(dev, weights, size):
    """Image and gradients (vertices, eye) of sum(weights * image) for the
    bunny preset at size x size on the megakernel backend."""
    from ceres_tpu_torch.render import scenes

    sc = scenes.bunny_scene()
    cam = ct.Camera.make(sc.camera.eye, sc.camera.dir, sc.camera.up,
                         sc.camera.fov, device=dev)
    v = torch.tensor(sc.vertices, device=dev, requires_grad=True)
    eye = cam.eye.clone().requires_grad_()
    image, _ = ct.render_pipeline(
        v, torch.as_tensor(sc.faces, device=dev),
        ct.Camera(eye=eye, dir=cam.dir, up=cam.up, fov=cam.fov),
        torch.as_tensor(sc.sun, device=dev),
        ct.RenderConfig(width=size, height=size, backend="megakernel"))
    if weights is None:
        return image.detach().cpu(), None
    (image * torch.as_tensor(weights, device=dev)).sum().backward()
    return image.detach().cpu(), (v.grad.cpu(), eye.grad.cpu())


@pytest.mark.cuda
def test_bunny_gradient_on_card_matches_cpu():
    # The card's sums of the gathers' backward run on atomics in another
    # order, and its rsqrt rounds otherwise: a pixel whose colour differs
    # leaves the loss (at most 0.5% may), and the gradients then agree
    # within rtol 1e-4 and atol 1e-5 max|g|.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    size = 64
    images = [_bunny_grads(dev, None, size)[0] for dev in ("cpu", "cuda")]
    agree = ((images[0] - images[1]).abs().amax(-1) <= 1e-4).numpy()
    assert (~agree).sum() <= 0.005 * size * size
    weights = (np.random.default_rng(4).uniform(size=(size, size, 1))
               * agree[..., None]).astype(np.float32)
    want = _bunny_grads("cpu", weights, size)[1]
    got = _bunny_grads("cuda", weights, size)[1]
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        torch.testing.assert_close(g, w, rtol=1e-4,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.cuda
def test_fit_on_card_lowers_the_loss():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    from ceres_tpu_torch.diff import fit_vertices
    from ceres_tpu_torch.render import scenes

    sc = scenes.bunny_scene()
    config = ct.RenderConfig(width=64, height=64, backend="megakernel")
    target, _ = ct.render(sc.vertices, sc.faces, sc.camera, sc.sun,
                          config=config, device="cuda")
    v0 = sc.vertices
    scale = float(np.abs(v0 - v0.mean(0)).max())
    noisy = (v0 + 0.02 * scale * np.random.default_rng(3).standard_normal(
        v0.shape)).astype(np.float32)
    params, history = fit_vertices(noisy, sc.faces, sc.camera, sc.sun,
                                   target, config=config, steps=5,
                                   learning_rate=2e-4)
    assert params["vertices"].device.type == "cuda"
    assert np.isfinite(history).all() and history[-1] < history[0]


@pytest.mark.cuda
def test_checkpoint_and_resume_on_card(tmp_path):
    # Two triangles facing the camera (tests/test_checkpoint.py), walked
    # by the kernels: every coordinate's gradient is far from zero, so
    # Adam's normalised steps do not magnify the card's atomics, which
    # sum in no fixed order.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk kernels have no CPU mode")
    from ceres_tpu_torch.diff import fit_vertices

    vertices = np.asarray([
        [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.0, 0.5, 1.0],
        [-0.6, 0.2, 1.5], [0.4, 0.6, 1.5], [0.0, -0.6, 1.5],
    ], np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    camera = ct.Camera.make(eye=(0, 0, -1), dir=(0, 0, 1), up=(0, 1, 0),
                            fov=60)
    sun = np.asarray([2.0, 3.0, -2.0], np.float32)
    config = ct.RenderConfig(width=24, height=24, mode="flat",
                             backend="megakernel")
    target, _ = ct.render(vertices, faces, camera, sun, config=config,
                          device="cuda")
    kw = dict(config=config, learning_rate=1e-2, device="cuda")
    ckpt = str(tmp_path / "ckpt")
    _, hist1 = fit_vertices(vertices + 0.05, faces, camera, sun, target,
                            steps=4, checkpoint_dir=ckpt, checkpoint_every=2,
                            **kw)
    params, hist2 = fit_vertices(vertices + 0.05, faces, camera, sun, target,
                                 steps=7, checkpoint_dir=ckpt,
                                 checkpoint_every=2, **kw)
    assert (len(hist1), len(hist2)) == (4, 3)
    assert sorted(os.listdir(ckpt)) == ["6.pt", "7.pt"]
    assert params["vertices"].device.type == "cuda"
    ref, hist_ref = fit_vertices(vertices + 0.05, faces, camera, sun, target,
                                 steps=7, **kw)
    np.testing.assert_allclose(hist1 + hist2, hist_ref, rtol=1e-5)
    torch.testing.assert_close(params["vertices"], ref["vertices"],
                               rtol=1e-6, atol=1e-7)
    _, none_left = fit_vertices(vertices + 0.05, faces, camera, sun, target,
                                steps=7, checkpoint_dir=ckpt, **kw)
    assert none_left == []


def _graph_scene(size):
    """The bunny on the card with its SweepSAH cut, the bench camera and
    a config at size x size."""
    dev = _card()
    verts, faces = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    eye = np.asarray(EYES["bunny"], np.float32)
    cam = ct.Camera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0, device=dev)
    vt, ft = torch.as_tensor(verts, device=dev), torch.as_tensor(faces,
                                                                 device=dev)
    cs = build_clusters_quality(ct.triangle_soup(vt, ft, with_normals=False))
    return vt, ft, cam, cs, torch.as_tensor(SUN, device=dev)


def _levels_apart(a, b):
    from ceres_tpu_torch.utils.image import to_uint8

    return int(np.abs(to_uint8(a.cpu()).astype(int)
                      - to_uint8(b.cpu()).astype(int)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shadows", [True, False])
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("mode", ["smooth", "flat", "normal"])
def test_graph_frame_equals_eager_on_card(mode, compat, shadows):
    # The replayed frame against render_pipeline on the same inputs, for
    # three suns: stats exact, images within one level (corner normals
    # are summed with index_add_ atomics), one launch a walk a replay.
    from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                 render_graph)

    size = 256
    vt, ft, cam, cs, sun = _graph_scene(size)
    config = ct.RenderConfig(width=size, height=size, mode=mode,
                             backend="megakernel", shadows=shadows,
                             reference_compat=compat, traversal_stats=True)
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    fg = render_graph(vt, ft, cam, sun, config, cs, table)
    want = {"walk_closest": 1}
    if shadows:
        want["walk_any" if compat else "walk_any_dest"] = 1
    assert fg.launches == want
    for i in range(3):
        walk.reset_launches()
        img, st = fg(sun_position=sun + i * 1e-3)
        torch.cuda.synchronize()
        assert {k: n for k, n in walk.launches.items() if n} == want
        img_e, st_e = ct.render_pipeline(vt, ft, cam, sun + i * 1e-3, config,
                                         clusters=cs, table_cols=table)
        assert {k: int(x) for k, x in st.items()} == {
            k: int(x) for k, x in st_e.items()}
        assert _levels_apart(img, img_e) <= 1
        assert img.device.type == "cuda" and float(img.max()) > 0


@pytest.mark.cuda
def test_frame_and_step_make_no_host_sync():
    # The frame path and the refitted step wait on the device nowhere:
    # what a CUDA graph needs, held on the eager calls.
    from ceres_tpu_torch.diff import TrainState, inverse
    from ceres_tpu_torch.render.renderer import prepare_winner_table

    size = 128
    vt, ft, cam, cs, sun = _graph_scene(size)
    config = ct.RenderConfig(width=size, height=size, backend="megakernel")
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    target = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs)[0]
    params = {"vertices": (vt + 1e-4).requires_grad_(),
              "eye": cam.eye.clone().requires_grad_()}
    opt = torch.optim.Adam(params.values(), lr=1e-5, capturable=True)
    step = inverse._make_eager_step(ft, cam, sun, config, opt, clusters0=cs)
    state = TrainState(params, {k: {} for k in params})
    state, _ = step(state, target)      # Adam's state exists
    moved = sun + 1e-3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ct.render_pipeline(vt, ft, cam, moved, config, clusters=cs,
                           table_cols=table)
        step(state, target)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _held_steps(refit):
    # make_train_step's captured step (its first call eager, then
    # replays) against the eager step over 3 steps, each taken by both
    # from the eager step's state (the captured step is handed Adam's
    # state as a carried opt_state): loss, gradients and parameters
    # within rtol 1e-4, atol 1e-5 max|x| (the backward's atomics sum in
    # no fixed order). Chained runs are not compared: one silhouette
    # pixel flipped by the last bits moves the next steps. Refitted: the
    # SweepSAH cut refitted in each step; else each step builds its cut.
    from ceres_tpu_torch.diff import TrainState, inverse

    size = 128
    vt, ft, cam, cs, sun = _graph_scene(size)
    config = ct.RenderConfig(width=size, height=size, backend="megakernel")
    target = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs)[0]
    noise = np.random.default_rng(7).standard_normal(tuple(vt.shape))
    start = vt + torch.as_tensor(2e-4 * noise, dtype=vt.dtype,
                                 device=vt.device)
    runs = {}
    for name, make in (("eager", inverse._make_eager_step),
                       ("graph", inverse.make_train_step)):
        params = {"vertices": start.clone().requires_grad_(),
                  "eye": cam.eye.clone().requires_grad_()}
        opt = torch.optim.Adam(params.values(), lr=1e-5, capturable=True)
        runs[name] = [make(ft, cam, sun, config, opt,
                           clusters0=cs if refit else None),
                      TrainState(params, {k: {} for k in params})]
    for _ in range(3):
        state = runs["eager"][1]
        params = {k: x.detach().clone() for k, x in state.params.items()}
        opt = {k: {kk: x.clone() for kk, x in st.items()}
               for k, st in state.opt_state.items()}
        out = {}
        for name, run in runs.items():
            if name == "graph":
                with torch.no_grad():
                    for k, x in run[1].params.items():
                        x.copy_(params[k])
                run[1] = TrainState(run[1].params, opt)
            walk.reset_launches()
            run[1], loss = run[0](run[1], target)
            torch.cuda.synchronize()
            assert {k: n for k, n in walk.launches.items() if n} == {
                "walk_closest": 1, "walk_any_dest": 1}
            out[name] = (float(loss), *({k: f(x) for k, x in
                                         run[1].params.items()}
                                        for f in (lambda x: x.grad.clone(),
                                                  lambda x: x.detach())))
        (le, ge, pe), (lg, gg, pg) = out["eager"], out["graph"]
        assert abs(lg - le) <= 1e-4 * abs(le)
        for k in pe:
            for got, want in ((gg[k], ge[k]), (pg[k], pe[k])):
                torch.testing.assert_close(
                    got, want, rtol=1e-4,
                    atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_captured_step_equals_eager_on_card():
    _held_steps(refit=True)


@pytest.mark.cuda
def test_captured_rebuilt_step_equals_eager_on_card():
    _held_steps(refit=False)


@pytest.mark.cuda
def test_build_makes_no_host_sync():
    # The LBVH build, both cuts, the treelet ClusterSet, the morton runs,
    # the refit and a frame and a train step that build their cut wait
    # on the device nowhere: what a CUDA graph of them needs.
    from ceres_tpu_torch.accel import clusters, lbvh
    from ceres_tpu_torch.diff import TrainState, inverse

    size = 64
    vt, ft, cam, _, sun = _graph_scene(size)
    soup = ct.triangle_soup(vt, ft, with_normals=False)
    config = ct.RenderConfig(width=size, height=size, backend="megakernel")
    target = ct.render_pipeline(vt, ft, cam, sun, config)[0]
    params = {"vertices": (vt + 1e-4).requires_grad_()}
    opt = torch.optim.Adam(params.values(), lr=1e-5, capturable=True)
    step = inverse._make_eager_step(ft, cam, sun, config, opt)
    state, _ = step(TrainState(params, {"vertices": {}}), target)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bvh = lbvh.build_lbvh(soup)
        starts, _ = lbvh.cluster_cut(bvh, clusters.CLUSTER_SIZE)
        lbvh.super_cut(bvh, starts, 8)
        cs = clusters.build_clusters_treelet(soup)
        clusters.build_clusters(soup)
        clusters.refit_clusters(cs, soup)
        lbvh.refit(bvh, soup)
        ct.render_pipeline(vt + 1e-4, ft, cam, sun, config)
        step(state, target)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_captured_build_equals_eager_on_card():
    # The treelet build and the LBVH captured and replayed on moved
    # vertices: every array bit-equal to an eager build of those. Both
    # builds launch each LBVH kernel once, eager or replayed.
    from ceres_tpu_torch.accel import lbvh
    from ceres_tpu_torch.utils import graphs

    vt, ft, _, _, _ = _graph_scene(8)
    buf = vt.clone()

    def build():
        soup = ct.triangle_soup(buf, ft, with_normals=False)
        return lbvh.build_lbvh(soup), build_clusters_treelet(soup)

    lbvh.reset_launches()
    g = graphs.capture(build, (buf,))
    both = {"hierarchy": 2, "boxes": 2}
    assert lbvh.launches == both                   # the warm-up call's
    assert g.counts["lbvh.launches"] == both
    noise = np.random.default_rng(9).standard_normal(tuple(vt.shape))
    buf.copy_(vt + torch.as_tensor(1e-3 * noise, dtype=vt.dtype,
                                   device=vt.device))
    got = g.replay()
    assert lbvh.launches == {"hierarchy": 4, "boxes": 4}
    want = build()
    assert lbvh.launches == {"hierarchy": 6, "boxes": 6}
    torch.cuda.synchronize()
    for a, b in zip(graphs.tensors(got), graphs.tensors(want)):
        assert _same_bits(a, b)
    assert got[1].super_S == want[1].super_S


LBVH_SOUPS = ("bunny", "bunny4x", "random", "comb", "super_comb", "two",
              "three", "planes", "float64")


def _same_bits(a, b):
    """Equal dtype, shape and values, floats as bit patterns (the sign
    of a zero included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def _lbvh_mesh(name):
    """(vertices, faces) of an LBVH test soup: the bunny (float32 or
    float64), the 4x bunny (the benchmark's 1.27M triangles, rich in
    tied morton codes), a seeded random soup, and ``lbvh_soups``'."""
    import lbvh_soups as soups

    if name in ("bunny", "bunny4x", "float64"):
        verts, faces = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
        if name == "bunny4x":
            verts, faces = subdivide(verts, faces, 4)
        return verts.astype(np.float64 if name == "float64" else np.float32), \
            faces
    if name == "random":
        rng = np.random.default_rng(3)
        verts = rng.standard_normal((450, 3)).astype(np.float32)
        return verts, rng.integers(0, 450, (900, 3)).astype(np.int32)
    if name in ("two", "three"):
        return soups.tiny({"two": 2, "three": 3}[name])
    return getattr(soups, name)()


@pytest.mark.cuda
@pytest.mark.parametrize("name", LBVH_SOUPS)
def test_lbvh_kernels_equal_plain(name, monkeypatch):
    # The LBVH kernels against the plain version run on the same card
    # tensors: every Lbvh array bit-equal, dtype included, one launch of
    # each kernel a build; a refit (no gradients: the boxes kernel)
    # against the plain boxes; the treelet ClusterSet built on either.
    from ceres_tpu_torch.accel import lbvh

    dev = _card()
    verts, faces = _lbvh_mesh(name)
    vt = torch.as_tensor(verts, device=dev)
    ft = torch.as_tensor(faces, device=dev)
    soup = ct.triangle_soup(vt, ft, with_normals=False)
    lbvh.reset_launches()
    got = lbvh.build_lbvh(soup)
    assert lbvh.launches == {"hierarchy": 1, "boxes": 1}
    want = lbvh._build_lbvh_plain(soup)
    assert lbvh.launches == {"hierarchy": 1, "boxes": 1}
    assert got.node_lo.dtype == vt.dtype
    for field in dataclasses.fields(got):
        assert _same_bits(getattr(got, field.name),
                          getattr(want, field.name)), field.name

    scale = float((vt - vt.mean(0)).abs().max())
    noise = np.random.default_rng(21).standard_normal(verts.shape)
    moved = ct.triangle_soup(
        vt + torch.as_tensor(2e-3 * scale * noise, dtype=vt.dtype,
                             device=dev), ft, with_normals=False)
    refit = lbvh.refit(got, moved)
    assert lbvh.launches == {"hierarchy": 1, "boxes": 2}
    plain = lbvh._boxes_plain(got.order, got.left, got.right, moved.p0,
                              moved.e1, moved.e2)
    for a, b in zip((refit.node_lo, refit.node_hi, refit.leaf_lo,
                     refit.leaf_hi), plain):
        assert _same_bits(a, b)

    cs = build_clusters_treelet(soup)
    monkeypatch.setattr(lbvh, "build_lbvh", lbvh._build_lbvh_plain)
    cs_plain = build_clusters_treelet(soup)
    from ceres_tpu_torch.utils.graphs import tensors

    for a, b in zip(tensors(cs), tensors(cs_plain)):
        assert _same_bits(a, b)
    assert cs.super_S == cs_plain.super_S


@pytest.mark.cuda
def test_refit_with_grad_takes_the_plain_passes_on_card():
    # Leaf boxes that carry gradients keep the fmin/fmax passes on the
    # card (no kernel launch): the same boxes as the kernel's, and the
    # gradients of the CPU's (rtol 1e-4, atol 1e-5 max|g|: the card sums
    # the gathers' backward in another order).
    from ceres_tpu_torch.accel import lbvh

    dev = _card()
    verts, faces = _lbvh_mesh("bunny")
    rng = np.random.default_rng(22)
    moved = verts + 1e-3 * rng.standard_normal(verts.shape).astype(np.float32)
    T = faces.shape[0]
    weights = [rng.standard_normal((n, 3)).astype(np.float32)
               for n in (T - 1, T - 1, T, T)]
    grads = []
    for device in ("cpu", dev):
        ft = torch.as_tensor(faces, device=device)
        bvh = lbvh.build_lbvh(ct.triangle_soup(
            torch.as_tensor(verts, device=device), ft, with_normals=False))
        v = torch.tensor(moved, device=device, requires_grad=True)
        soup = ct.triangle_soup(v, ft, with_normals=False)
        lbvh.reset_launches()
        refit = lbvh.refit(bvh, soup)
        assert lbvh.launches == {"hierarchy": 0, "boxes": 0}
        boxes = (refit.node_lo, refit.node_hi, refit.leaf_lo, refit.leaf_hi)
        sum((x * torch.as_tensor(w, device=device)).sum()
            for x, w in zip(boxes, weights)).backward()
        grads.append(v.grad.cpu().numpy())
        if device != "cpu":
            with torch.no_grad():
                kernel = lbvh.refit(bvh, soup)
            assert lbvh.launches == {"hierarchy": 0, "boxes": 1}
            for a, b in zip(boxes, (kernel.node_lo, kernel.node_hi,
                                    kernel.leaf_lo, kernel.leaf_hi)):
                assert _same_bits(a.detach(), b)
    cpu, card = grads
    assert np.abs(cpu).max() > 0
    np.testing.assert_allclose(card, cpu, rtol=1e-4,
                               atol=1e-5 * np.abs(cpu).max())


@pytest.mark.cuda
def test_deforming_graph_frame_equals_eager_on_card():
    # render_graph without a prebuilt cut or table, replayed with the
    # vertices moved by seeded noise: stats exact, images within one
    # level, one launch a walk and an LBVH kernel a replay.
    from ceres_tpu_torch.accel import lbvh
    from ceres_tpu_torch.render.renderer import render_graph

    size = 256
    vt, ft, cam, cs, sun = _graph_scene(size)
    config = ct.RenderConfig(width=size, height=size, backend="megakernel",
                             traversal_stats=True)
    fg = render_graph(vt, ft, cam, sun, config)
    want = {"walk_closest": 1, "walk_any_dest": 1}
    assert fg.launches == want
    with pytest.raises(ValueError, match="stale"):
        render_graph(vt, ft, cam, sun, config, clusters=cs)(vertices=vt)
    scale = float((vt - vt.mean(0)).abs().max())
    for i in range(3):
        noise = np.random.default_rng(40 + i).standard_normal(tuple(vt.shape))
        moved = vt + torch.as_tensor(2e-3 * scale * noise, dtype=vt.dtype,
                                     device=vt.device)
        walk.reset_launches()
        lbvh.reset_launches()
        img, st = fg(vertices=moved)
        torch.cuda.synchronize()
        assert {k: n for k, n in walk.launches.items() if n} == want
        assert lbvh.launches == {"hierarchy": 1, "boxes": 1}
        img_e, st_e = ct.render_pipeline(moved, ft, cam, sun, config)
        assert {k: int(x) for k, x in st.items()} == {
            k: int(x) for k, x in st_e.items()}
        assert _levels_apart(img, img_e) <= 1
        assert float(img.max()) > 0


@pytest.fixture
def spans_on():
    from ceres_tpu_torch.utils import spans

    spans.enable(True)
    try:
        yield spans
    finally:
        spans.enable(False)


def _static_graph(width, height):
    """The bunny's static frame (SweepSAH cut, winner table) captured by
    ``render_graph``: (the FrameGraph, sun, frame inputs)."""
    from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                 render_graph)

    vt, ft, cam, cs, sun = _graph_scene(width)
    config = ct.RenderConfig(width=width, height=height, backend="megakernel")
    table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    fg = render_graph(vt, ft, cam, sun, config, cs, table)
    return fg, sun, (vt, ft, cam, config, cs, table)


@pytest.mark.cuda
def test_spans_add_only_their_stamps_to_the_frame_graph():
    # Captured with spans off, the frame's graph is the plain capture of
    # the frame (torch.cuda.graph around the same call, counted here with
    # the graph kept); with spans on it holds those nodes and its stamp
    # kernels, which graph.nodes leaves out and each replay adds.
    from ceres_tpu_torch.utils import spans

    fg, sun, _ = _static_graph(256, 256)
    assert fg._graph.record is None and "graph.nodes" not in fg._graph.counts
    plain = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(plain):
        fg._frame()
    off = spans.graph_nodes(plain.raw_cuda_graph(), 0)
    assert off["kernel"] > 100
    spans.enable(True)
    try:
        on_fg, _, _ = _static_graph(256, 256)
    finally:
        spans.enable(False)
    graph = on_fg._graph
    assert graph.counts["graph.nodes"] == off
    raw = spans.graph_nodes(graph._graph.raw_cuda_graph(), 0)
    assert raw["kernel"] == off["kernel"] + graph.record.stamps
    assert graph.record.stamps == 2 * len(graph.record.spans) >= 20
    before = dict(spans.counters["graph.nodes"])
    on_fg(sun_position=sun)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in
            spans.counters["graph.nodes"].items()} == off


@pytest.mark.cuda
def test_walk_spans_time_the_walks(spans_on):
    # The replayed 1080p frame's walk spans against CUDA events around
    # the same walks (their inputs recorded from the eager frame, each
    # launched 20 times between its two events, so that the host's
    # launch hides behind the kernels), within 10%: medians of 5.
    import statistics

    fg, sun, (vt, ft, cam, config, cs, table) = _static_graph(1920, 1080)
    seen = []
    saved = {n: getattr(walk, n) for n in ("walk_closest", "walk_any_dest")}

    def recorder(fn):
        def call(*args, **opts):
            seen.append((fn, args, opts))
            return fn(*args, **opts)
        return call

    try:
        for name, fn in saved.items():
            setattr(walk, name, recorder(fn))
        ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs,
                           table_cols=table)
    finally:
        for name, fn in saved.items():
            setattr(walk, name, fn)
    assert len(seen) == 2
    events = 0.0
    for fn, args, opts in seen:
        times = []
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn(*args, **opts)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 20)
        events += statistics.median(times[1:])
    walks = []
    for i in range(6):
        fg(sun_position=sun)
        torch.cuda.synchronize()
        walks.append(fg.span_ms()["walk"]["total"])
    span = statistics.median(walks[1:])
    assert abs(span - events) <= 0.1 * events, (span, events)


@pytest.mark.cuda
def test_captured_step_spans(spans_on):
    # The refitted step captured with spans on: its replays time the five
    # step spans, the frame inside step.forward.
    from ceres_tpu_torch.diff import TrainState, inverse

    size = 128
    vt, ft, cam, cs, sun = _graph_scene(size)
    config = ct.RenderConfig(width=size, height=size, backend="megakernel")
    target = ct.render_pipeline(vt, ft, cam, sun, config, clusters=cs)[0]
    params = {"vertices": (vt + 1e-4).requires_grad_(),
              "eye": cam.eye.clone().requires_grad_()}
    opt = torch.optim.Adam(params.values(), lr=1e-5, capturable=True)
    step = inverse.make_train_step(ft, cam, sun, config, opt, clusters0=cs)
    state = TrainState(params, {k: {} for k in params})
    assert step.span_ms() is None
    for _ in range(3):
        state, loss = step(state, target)
    torch.cuda.synchronize()
    ms = step.span_ms()
    for name in ("step.refit", "step.forward", "step.loss", "step.backward",
                 "step.optim", "frame", "walk"):
        assert ms[name]["total"] > 0, name
    assert ms["step.forward"]["total"] >= ms["frame"]["total"]
    assert float(loss) > 0


def test_kernel_source_constants_match_python():
    src = open(os.path.join(os.path.dirname(walk.__file__), "csrc",
                            "walk.cu")).read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert int(const("kC")) == walk.CLUSTER_SIZE
    assert int(const("kR")) == walk.TILE
    assert int(const("kR128")) == walk.REGROUP_TILE == mk._REGROUP_TILE
    assert int(const("kSeg128")) > 0 and walk._SPLIT_SEG == 0
    assert int(const("kPlanes")) == walk.WEIGHT_PLANES
    assert int(const("kPlanesGeneric")) == walk.GENERIC_PLANES
    assert int(const("kPrunePad")) == walk._PRUNE_PAD
    assert int(const("kBigCleanI"), 16) == walk._BIG_CLEAN_I
    assert int(const("kBigI"), 16) == int(np.float32(walk._BIG).view(np.int32))
    assert int(const("kSuperMax")) == walk._SUPER_MAX
    assert int(const("kNegI")) == walk._NEG_I
    scale = const("kDestScale")
    assert float(scale[len("(float)(1.0 - "):-1]) == walk._DEST_EPS


F64_SCENES = ("bunny", "dragon", "random", "super_comb", "planes")


def _f64_inputs(name, dev):
    """A float64 scene on the card with its float64 treelet cut and the
    inputs of every float64 walk mode: (cs, eye, dirs, (per-ray tmin,
    tmax, a scalar window), points, skip, sun, centre, sun_line). The
    bunny and the dragon decimation are seen from the bench camera at
    256 x 160; the random soup and ``lbvh_soups``' from a point outside
    their box, mostly toward their triangles; the wide soup (prepass
    cases only) from the origin."""
    if name in ("bunny", "dragon"):
        verts, faces = ct.load_obj(os.path.join(ROOT, "data", f"{name}.obj"))
        verts = verts.astype(np.float64)
        eye = np.asarray(EYES[name])
        cam = ct.Camera.make(eye=eye, dir=verts.mean(0) - eye, up=(0, 1, 0),
                             fov=60.0, dtype=torch.float64, device=dev)
        dirs = tuple(tiling.swizzle_plane(p)
                     for p in camera_ray_columns(cam, 256, 160))
    elif name == "wide":
        # 240,000 small triangles in the slab |x|, |y| < 1, 1 < z < 3, seen
        # from the origin by rays all over the half-space z > 0: each
        # tile's hull straddles zero on x and y, so every box survives
        # (over 2,048 a tile), each at its own entry bound.
        rng = np.random.default_rng(7)
        centres = rng.uniform((-1.0, -1.0, 1.0), (1.0, 1.0, 3.0),
                              (240_000, 1, 3))
        verts = (centres + 0.01 * rng.standard_normal((240_000, 3, 3))
                 ).reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
        eye = np.zeros(3)
        d = rng.standard_normal((3, 16 * 512))
        d[2] = np.abs(d[2]) + 0.05
        d /= np.linalg.norm(d, axis=0)
        dirs = tuple(torch.as_tensor(c, device=dev) for c in d)
    else:
        if name == "random":
            rng = np.random.default_rng(5)
            verts = rng.standard_normal((90, 3))
            faces = rng.integers(0, 90, (400, 3)).astype(np.int32)
        else:
            import lbvh_soups as soups

            verts, faces = getattr(soups, name)()
        verts = verts.astype(np.float64)
        lo, hi = verts.min(0), verts.max(0)
        eye = 0.5 * (lo + hi) - np.asarray([0.3, 0.4, 1.5]) * (hi - lo).max()
        # Two rays in three toward seeded points in or near seeded
        # triangles (barycentric weights, jittered), the rest in any
        # direction.
        rng = np.random.default_rng(6)
        tri = verts[faces[rng.integers(0, len(faces), 2000)]]
        bary = rng.dirichlet([1.0, 1.0, 1.0], 2000)
        bary += 0.1 * rng.standard_normal(bary.shape)
        aim = (bary[:, :, None] * tri).sum(1)
        d = np.concatenate([aim - eye, rng.standard_normal((1000, 3))]).T
        d /= np.linalg.norm(d, axis=0)
        dirs = tuple(torch.as_tensor(c, device=dev) for c in d)
    vt = torch.as_tensor(verts, device=dev)
    ft = torch.as_tensor(faces, device=dev)
    eye = torch.as_tensor(eye, dtype=torch.float64, device=dev)
    soup = ct.triangle_soup(vt, ft, with_normals=False)
    cs = build_clusters_treelet(soup)
    hit = mk.closest_hit_common_origin(soup, eye, dirs, clusters=cs,
                                       exact_f64=True)
    t = torch.where(hit.mask, hit.t, 0.0)
    points = tuple(eye[a] + 0.999 * t * dirs[a] for a in range(3))
    sun = torch.as_tensor(SUN, dtype=torch.float64, device=dev)
    sl = tuple(sun[a] - points[a] for a in range(3))
    inv = torch.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
    # Windows: the second surface behind each first hit, and a near/far
    # clip for the rays that missed.
    tmin = torch.where(hit.mask, hit.t * 1.0001, 0.05)
    tmax = torch.where(hit.mask, 1e30, 8.0)
    # A scalar window: the middle half of the first hits' distances.
    window = tuple(float(torch.quantile(hit.t[hit.mask], q))
                   for q in (0.25, 0.75))
    return (cs, eye, dirs, (tmin, tmax, window), points, ~hit.mask, sun,
            soup.p0.mean(0), tuple(c * inv for c in sl))


def _f64_walk_inputs(inputs):
    """Each float64 walk case's ``_walk`` inputs, from the entry points'
    own prepasses."""
    from ceres_tpu_torch.ops import walk_f64

    cs, eye, dirs, (tmin, tmax, window), points, skip, sun, centre, sl = inputs
    return {
        "closest": walk_f64._closest_inputs(cs, eye, dirs),
        "closest_window": walk_f64._closest_inputs(cs, eye, dirs, tmin,
                                                   tmax),
        "closest_scalar_window": walk_f64._closest_inputs(cs, eye, dirs,
                                                          *window),
        "any_dest": walk_f64._any_dest_inputs(cs, sun, points, skip),
        "any_dest_no_skip": walk_f64._any_dest_inputs(cs, sun, points),
        "any": walk_f64._any_inputs(cs, centre, points, sl, skip)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", F64_SCENES)
def test_f64_kernel_equals_plain(name):
    # The float64 walk kernel against the plain frontier loop on the same
    # card tensors, every mode (closest, with per-ray and scalar windows;
    # shadow segments with and without skipped rays; generic shadow
    # rays): winner slots and flags bit-equal, executed visits equal, one
    # launch of the mode's kernel a call and none by the plain loop.
    from ceres_tpu_torch.ops import walk_f64

    dev = _card()
    for case, w in _f64_walk_inputs(_f64_inputs(name, dev)).items():
        before = dict(walk_f64.launches)
        before_clustered = dict(walk_f64.clustered)
        got, steps = walk_f64._walk(**w)
        after = dict(walk_f64.launches)
        want, ref_steps = walk_f64._walk_plain(**w)
        assert walk_f64.launches == after, case
        assert got.dtype == want.dtype and torch.equal(got, want), case
        assert int(steps) == int(ref_steps) > 0, case
        assert {k: n - before[k] for k, n in after.items()
                if n != before[k]} == {w["mode"]: 1}, case
        assert {k: n - before_clustered[k]
                for k, n in walk_f64.clustered.items()
                if n != before_clustered[k]} == (
            {w["mode"]: 1} if w["ent"].shape[1] > walk_f64._SOLO_ROW
            else {}), case
        live = w["alive"] if w.get("occ0") is None else (
            w["alive"] & (w["occ0"] == 0))
        if case == "closest":
            assert int(((got >= 0) & live).sum()) > 50
        elif case in ("any_dest", "any") and name != "super_comb":
            # super_comb's runs of triangles shadow nothing
            assert int(((got > 0) & live).sum()) > 0, case


# The float64 walk kernel on crafted rows (tests/f64_rows.py) of the
# bunny's rays, in both forms (rows padded past walk_f64._SOLO_ROW for the
# cluster form), and on the 4x bunny's heaviest closest tile.
F64_ROUND_CASES = ("closest", "closest_window", "any_dest", "any")
F64_FORMS = ("solo", "cluster")


def _f64_width(form):
    """The row width that takes ``form``."""
    from ceres_tpu_torch.ops import walk_f64

    return 1 if form == "solo" else walk_f64._SOLO_ROW + 1


def _f64_round():
    """kK of walk_f64.cu: the CTAs of a tile's cluster, candidates a
    round."""
    return int(_f64_source_const("kK"))


@pytest.fixture(scope="module")
def f64_bunny():
    """``_f64_walk_inputs`` of the float64 bunny."""
    return _f64_walk_inputs(_f64_inputs("bunny", _card()))


def _f64_card_walk(w):
    """The float64 walk kernel on ``w``: (out, each tile's visits, what
    the launch added to walk_f64.launches and to walk_f64.clustered)."""
    from ceres_tpu_torch.ops import walk_f64

    counters = (walk_f64.launches, walk_f64.clustered)
    before = [dict(c) for c in counters]
    out, visits = walk_f64._walk_card(
        w["cs"], w["weights"], w["order"], w["ent"], w["counts"], w["d3"],
        w["o3"], w["alive"], w["tcap"], w.get("tmin"), w.get("tmax"),
        w.get("occ0"), w["mode"])
    rose = [{k: n - b[k] for k, n in c.items() if n != b[k]}
            for c, b in zip(counters, before)]
    return out, visits, rose


@pytest.mark.cuda
@pytest.mark.parametrize("form", F64_FORMS)
@pytest.mark.parametrize("case", F64_ROUND_CASES)
def test_f64_cluster_walk_stops_inside_a_round(f64_bunny, case, form):
    # The plain stop right after each position of the cluster form's
    # first two rounds, where the next candidate holds a hit for a ray
    # that nothing visited hits (visited and dropped unless it opens the
    # next round); a row shorter than a round; a row of none: slots or
    # flags bit-equal, each tile's visits the plain loop's, the launch
    # counted once, and as clustered in the cluster form alone.
    import f64_rows
    from ceres_tpu_torch.ops import walk_f64

    K = _f64_round()
    w = f64_rows.craft(f64_bunny[case],
                       f64_rows.stop_specs(f64_bunny[case], range(2 * K)),
                       _f64_width(form))
    got, visits, rose = _f64_card_walk(w)
    want, _ = walk_f64._walk_plain(**w)
    assert torch.equal(got, want)
    assert visits.tolist() == [p + 1 for p in range(2 * K)] + [1, 0]
    assert torch.equal(visits, f64_rows.tile_visits(w))
    assert bool((want[:, 1] == (-1 if case.startswith("closest")
                                else 0)).all())
    assert rose == [{w["mode"]: 1}, {w["mode"]: 1} if form == "cluster"
                    else {}]


@pytest.mark.cuda
@pytest.mark.parametrize("form", F64_FORMS)
@pytest.mark.parametrize("case", ("closest", "closest_window"))
def test_f64_cluster_walk_keeps_the_earlier_of_equal_t(f64_bunny, case,
                                                        form):
    # A cluster and its twin (equal t for the ray) next to each other in
    # one round and across two, in both orders: the earlier one's slot
    # wins, as in the plain loop; visits equal.
    import f64_rows
    from ceres_tpu_torch.ops import walk_f64

    K = _f64_round()
    positions = [(p, first) for p in (0, 3, K - 1, K + 2)
                 for first in (0, 1)]
    w, specs = f64_rows.twin_specs(f64_bunny[case], positions)
    w = f64_rows.craft(w, specs, _f64_width(form))
    got, visits, _ = _f64_card_walk(w)
    want, _ = walk_f64._walk_plain(**w)
    assert torch.equal(got, want)
    assert torch.equal(visits, f64_rows.tile_visits(w))
    twin = w["cs"].num_clusters - 1
    assert ((want[:, 0] // w["cs"].cluster_size) == twin).tolist() == [
        bool(f) for _, f in positions]


@pytest.mark.cuda
def test_f64_cluster_walk_on_the_4x_bunnys_heaviest_tile():
    # The 4x bunny's float64 closest walk at 1920 x 1080 (the benchmark's
    # float64 frame: 19,872 clusters) cut to its tile with the most
    # candidates, whose ray hull straddles an axis: thousands of visits
    # in hundreds of rounds, slots bit-equal, visits equal.
    import f64_rows
    from ceres_tpu_torch.ops import walk_f64

    dev = _card()
    verts, faces = subdivide(*ct.load_obj(os.path.join(ROOT, "data",
                                                       "bunny.obj")), 4)
    v64 = verts.astype(np.float64)
    eye = np.asarray(EYES["bunny"])
    cam = ct.Camera.make(eye=eye, dir=v64.mean(0) - eye, up=(0, 1, 0),
                         fov=60.0, dtype=torch.float64, device=dev)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, 1920, 1080))
    cs = build_clusters_treelet(ct.triangle_soup(
        torch.as_tensor(v64, device=dev), torch.as_tensor(faces, device=dev),
        with_normals=False))
    w = walk_f64._closest_inputs(cs, cam.eye, dirs)
    tile = int(w["counts"].argmax())
    one = f64_rows.tile_of(w, tile)
    got, visits, rose = _f64_card_walk(one)
    want, steps = walk_f64._walk_plain(**one)
    assert int(w["counts"][tile]) > 10_000
    assert torch.equal(got, want)
    assert int(visits[0]) == int(steps) > 100 * _f64_round()
    assert rose == [{"closest": 1}] * 2


# The float64 prepass kernel's cases: the walk kernel's scenes, the wide
# scene (tiles beyond the kernel's shared-memory sort), and the dragon's
# inputs with boxes tied in pairs, with empty boxes, and with the first
# tile's rays all dead.
F64_PREPASS_CASES = F64_SCENES + ("wide", "tied_boxes", "empty_boxes",
                                  "dead_tile")


def _f64_prepass_inputs(name, dev):
    """``_f64_inputs`` of a prepass case."""
    if name not in ("tied_boxes", "empty_boxes", "dead_tile"):
        return _f64_inputs(name, dev)
    cs, eye, dirs, windows, points, skip, sun, centre, sl = _f64_inputs(
        "dragon", dev)
    lo, hi = cs.lo.clone(), cs.hi.clone()
    if name == "tied_boxes":
        m = lo.shape[0] // 2
        lo[1:2 * m:2], hi[1:2 * m:2] = lo[0:2 * m:2], hi[0:2 * m:2]
    elif name == "empty_boxes":
        lo[0::3], hi[0::3] = torch.inf, -torch.inf
        hi[1::3, 1] = lo[1::3, 1] - 1e-3
    else:
        dirs = tuple(torch.cat([torch.zeros_like(c[:prepass.TILE]),
                                c[prepass.TILE:]]) for c in dirs)
        skip = skip.clone()
        skip[:prepass.TILE] = True
    cs = dataclasses.replace(cs, lo=lo, hi=hi)
    return cs, eye, dirs, windows, points, skip, sun, centre, sl


def _f64_prepass_calls(inputs):
    """Each float64 walk case's ``_walk`` inputs with the arguments its
    entry point gave ``_prepass``: {case: (inputs, args, keywords)}."""
    from ceres_tpu_torch.ops import walk_f64

    real, calls = walk_f64._prepass, []

    def recorder(*args, **opts):
        calls.append((args, opts))
        return real(*args, **opts)

    walk_f64._prepass = recorder
    try:
        cases = _f64_walk_inputs(inputs)
    finally:
        walk_f64._prepass = real
    assert len(calls) == len(cases)
    return {case: (w, *call) for (case, w), call in zip(cases.items(),
                                                         calls)}


def _f64_source_const(name):
    src = open(os.path.join(os.path.dirname(walk.__file__), "csrc",
                            "walk_f64.cu")).read()
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", F64_PREPASS_CASES)
def test_f64_prepass_kernel_equals_plain(name):
    # The float64 prepass kernel against the plain passes on the same card
    # tensors, the arguments of every entry point's prepass: counts equal;
    # order and ent_sorted bit-equal up to each count, past it entries of
    # at least _VALID_CUT, each row of order a permutation of the
    # clusters; the rays' tiles equal; a second launch the same, counted
    # once under its mode; the float64 walk the same from either.
    from ceres_tpu_torch.ops import walk_f64

    dev = _card()
    widest, tied, dead = 0, False, True
    for case, (w, args, opts) in _f64_prepass_calls(
            _f64_prepass_inputs(name, dev)).items():
        before = dict(walk_f64.prepass_launches)
        got = walk_f64._prepass(*args, **opts)
        assert {k: n - before[k] for k, n in walk_f64.prepass_launches.items()
                if n != before[k]} == {opts["mode"]: 1}, case
        want = walk_f64._prepass_plain(*args)
        order, ent, counts = got[:3]
        assert torch.equal(order, w["order"]), case
        assert _same_bits(ent, w["ent"]) and torch.equal(counts, w["counts"])
        assert counts.dtype == want[2].dtype and torch.equal(counts, want[2])
        n_c = ent.shape[1]
        ids = torch.arange(n_c, device=dev)
        head = ids[None, :] < counts[:, None]
        assert order.dtype == want[0].dtype, case
        assert torch.equal(order[head], want[0][head]), case
        assert torch.equal(ent.view(torch.int64)[head],
                           want[1].view(torch.int64)[head]), case
        assert bool((ent[~head] >= prepass._VALID_CUT).all()), case
        assert torch.equal(order.sort(dim=1).values,
                           ids.expand_as(order)), case
        for a, b in zip(got[3:], want[3:]):
            assert (a is None and b is None) or _same_bits(a, b), case
        out, visits = walk_f64._walk(**w)
        plain_out, plain_visits = walk_f64._walk(**dict(
            w, order=want[0], ent=want[1], counts=want[2]))
        assert torch.equal(out, plain_out), case
        assert int(visits) == int(plain_visits), case
        widest = max(widest, int(counts.max()))
        tied = tied or bool(((ent[:, 1:] == ent[:, :-1]) & head[:, 1:]).any())
        dead = dead and int(counts[0]) == 0
        if name == "empty_boxes":
            assert not bool((order[head] % 3 < 2).any()), case
    assert widest > 0
    if name == "wide":
        assert widest > int(_f64_source_const("kSortCap")), widest
    if name == "tied_boxes":
        assert tied
    if name == "dead_tile":
        assert dead


@pytest.mark.cuda
@pytest.mark.parametrize("prebuilt", [True, False])
def test_f64_graph_frame_equals_eager_on_card(prebuilt):
    # The float64-exact frame replayed as a CUDA graph against the eager
    # frame on the same inputs, three suns (and with the cut built in the
    # frame, moved vertices): image bit-equal where the winner table is
    # the graph's (stats exact either way), no float32 walk, the float64
    # kernel once a walk a replay; the eager frame waits on the device
    # nowhere.
    from ceres_tpu_torch.ops import walk_f64
    from ceres_tpu_torch.render.renderer import (prepare_winner_table,
                                                 render_graph)

    dev = _card()
    size = 256
    verts, faces = ct.load_obj(os.path.join(ROOT, "data", "bunny.obj"))
    vt = torch.as_tensor(verts.astype(np.float64), device=dev)
    ft = torch.as_tensor(faces, device=dev)
    eye = np.asarray(EYES["bunny"])
    cam = ct.Camera.make(eye=eye, dir=verts.mean(0) - eye, up=(0, 1, 0),
                         fov=60.0, dtype=torch.float64, device=dev)
    sun = torch.as_tensor(SUN, dtype=torch.float64, device=dev)
    config = ct.RenderConfig(width=size, height=size, backend="megakernel",
                             f64_exact=True, traversal_stats=True)
    cs = table = None
    if prebuilt:
        cs = build_clusters_treelet(ct.triangle_soup(vt, ft,
                                                     with_normals=False))
        table = prepare_winner_table(ct.triangle_soup(vt, ft), cs, config)
    fg = render_graph(vt, ft, cam, sun, config, cs, table)
    assert fg.launches == {}
    assert fg._graph.counts["walk_f64.launches"] == {"closest": 1,
                                                     "any_dest": 1}
    assert fg._graph.counts["prepass_f64.launches"] == {"closest": 1,
                                                        "any_dest": 1}
    scale = float((vt - vt.mean(0)).abs().max())
    for i in range(3):
        kw = {"sun_position": sun + i * 1.5}
        moved = vt
        if not prebuilt:
            noise = np.random.default_rng(50 + i).standard_normal(
                tuple(vt.shape))
            moved = vt + torch.as_tensor(2e-3 * scale * noise, device=dev)
            kw["vertices"] = moved
        walk.reset_launches()
        walk_f64.reset_launches()
        img, st = fg(**kw)
        torch.cuda.synchronize()
        assert not any(walk.launches.values())
        assert walk_f64.launches == {"closest": 1, "any": 0, "any_dest": 1}
        assert walk_f64.prepass_launches == walk_f64.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            img_e, st_e = ct.render_pipeline(
                moved, ft, cam, kw["sun_position"], config, clusters=cs,
                table_cols=table)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert {k: int(x) for k, x in st.items()} == {
            k: int(x) for k, x in st_e.items()}
        assert int(st["shadow_hits"]) > 0
        if prebuilt:
            assert _same_bits(img, img_e)
        else:
            # Corner normals are summed with index_add_ atomics.
            assert float((img - img_e).abs().max()) < 1e-12


def test_f64_kernel_source_constants_match_python():
    from ceres_tpu_torch.ops import walk_f64

    const = _f64_source_const
    src = open(os.path.join(os.path.dirname(walk.__file__), "csrc",
                            "walk_f64.cu")).read()
    assert const("kR") == "512" and int(const("kR")) == prepass.TILE
    assert int(const("kMaxC")) >= walk.CLUSTER_SIZE
    assert int(const("kCommonPlanes")) == 10
    assert int(const("kGenericPlanes")) == 16
    assert float(const("kDestScale")[len("1.0 - "):]) == walk_f64._DEST_EPS
    enum = re.search(r"enum Mode \{([^}]+)\}", src).group(1)
    assert [int(x.split("=")[1]) for x in enum.split(",")] == [0, 1, 2]
    assert walk_f64.MODES == ("closest", "any", "any_dest")


def test_f64_prepass_source_constants_match_python():
    # The prepass kernel's sentinels and pads are ops.prepass's; its
    # shared-memory sort takes a power of two, its CTA whole warps.
    assert float(_f64_source_const("kBig")) == prepass._BIG
    assert float(_f64_source_const("kValidCut")) == prepass._VALID_CUT
    assert float(_f64_source_const("kInvClamp")) == prepass._INV_CLAMP
    assert float(_f64_source_const("kUlpPad")) == prepass._ULP_PAD
    cap = int(_f64_source_const("kSortCap"))
    assert cap > 0 and cap & (cap - 1) == 0
    assert int(_f64_source_const("kPrepassThreads")) % 32 == 0

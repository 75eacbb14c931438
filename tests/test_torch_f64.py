"""Float64 in the port against the JAX package under ``jax.enable_x64()``,
on the CPU.

  * the LBVH treelet cut of the float64 bunny soup: perm, super table and
    records exactly, boxes bit-equal (float64);
  * the all-float64 walk (``ops.walk_f64``) on the JAX package's cut:
    winner slots, occlusion flags and executed visits exactly, for the
    closest search and both occlusion forms, at two chunk sizes; and on
    the two sheets closer than a float32 ulp of ``tests/test_f64_walk.py``
    (the exact search finds the near sheet, the float32 search the far
    one, as in the JAX package);
  * ``render()`` of float64 vertices on both backends, with and without
    ``f64_exact``: images within 1e-9 and every count exactly;
  * ``exact_f64`` against a float64 brute-force oracle on a seeded soup:
    the same hits, ids equal except at exact float64 ties, t within
    rtol 1e-12;
  * the dtype refusals, the card wrappers' refusals of ill-formed
    inputs before any library load, and the float64 boxes of the
    quality cut;
  * on CPU tensors the prepass is the plain passes (``_prepass_plain``)
    and launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.camera import camera_ray_columns as jax_ray_columns
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import megakernel as jmk
from ceres_tpu.ops import walk_f64 as jwalk
from ceres_tpu.render.renderer import render as jax_render
from ceres_tpu.utils import tiling as jtiling

import ceres_tpu_torch as ct
from ceres_tpu_torch.accel.clusters import (ClusterSet,
                                            build_clusters_treelet)
from ceres_tpu_torch.accel.cuts import build_clusters_quality
from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.ops import walk_f64 as pwalk
from ceres_tpu_torch.utils import convert

import f64_rows

torch.set_num_threads(1)
SUN = np.asarray([-50.0, 100.0, 0.0])
EYE = np.asarray([0.0, 0.1, -0.3])


@pytest.fixture(scope="module")
def f64_scene(bunny):
    """The float64 bunny: JAX soup and jitted treelet cut, camera, and the
    64 x 64 swizzled primary rays, all float64."""
    verts, faces = bunny
    v64 = verts.astype(np.float64)
    with jax.enable_x64():
        soup = jax_soup(jnp.asarray(v64), jnp.asarray(faces),
                        with_normals=False)
        cs = jax.jit(jcl.build_clusters_treelet)(soup)
        cam = JaxCamera.make(eye=EYE, dir=v64.mean(0) - EYE, up=(0, 1, 0),
                             fov=60.0, dtype=jnp.float64)
        dirs = tuple(jtiling.swizzle_plane(p)
                     for p in jax_ray_columns(cam, 64, 64))
        jax.block_until_ready((cs, dirs))
    return v64, faces, soup, cs, cam, dirs


def _t(x):
    return convert.tensor(x)


def test_f64_treelet_cut_equals_jax(f64_scene):
    v64, faces, jsoup, jcs, _, _ = f64_scene
    cs = build_clusters_treelet(ct.triangle_soup(
        torch.as_tensor(v64), torch.as_tensor(faces), with_normals=False))
    assert cs.lo.dtype == torch.float64 and cs.p0.dtype == torch.float64
    np.testing.assert_array_equal(cs.perm.numpy(), np.asarray(jcs.perm))
    np.testing.assert_array_equal(cs.super_first.numpy(),
                                  np.asarray(jcs.super_first))
    for name in ("lo", "hi", "p0", "e1", "e2", "n"):
        np.testing.assert_array_equal(getattr(cs, name).numpy(),
                                      np.asarray(getattr(jcs, name)), name)


@pytest.fixture(scope="module")
def jax_walks(f64_scene):
    """The JAX package's float64 walks on the bunny's 64 x 64 rays:
    closest slots, then shadow segments from points along the rays to the
    sun and generic rays from them toward it, skipping the misses."""
    _, _, jsoup, jcs, cam, dirs = f64_scene
    with jax.enable_x64():
        slot, cnt = jwalk.closest_search_f64(jcs, cam.eye, dirs)
        skip = jnp.asarray(np.asarray(slot) < 0)
        pts = tuple(cam.eye[a] + 0.25 * dirs[a] for a in range(3))
        sun = jnp.asarray(SUN)
        dest, dcnt = jwalk.any_hit_to_point_f64(jcs, sun, pts, skip=skip)
        sl = tuple(sun[a] - pts[a] for a in range(3))
        inv = 1.0 / jnp.sqrt(sl[0] ** 2 + sl[1] ** 2 + sl[2] ** 2)
        sl = tuple(c * inv for c in sl)
        center = jnp.mean(jsoup.p0, axis=0)
        gen, gcnt = jwalk.any_hit_f64(jcs, center, pts, sl, skip=skip)
    return {"closest": (slot, cnt), "any_dest": (dest, dcnt),
            "any": (gen, gcnt), "skip": skip, "pts": pts, "sl": sl,
            "center": center}


@pytest.mark.parametrize("mode", pwalk.MODES)
def test_f64_prepass_on_the_cpu_is_the_plain_passes(f64_scene, jax_walks,
                                                    mode):
    # On CPU tensors _prepass is _prepass_plain, and launches nothing: the
    # arguments each entry point gives it, recorded, and run both ways.
    _, _, _, jcs, cam, dirs = f64_scene
    cs = convert.cluster_set(jcs)
    d = tuple(map(_t, dirs))
    skip, pts = _t(jax_walks["skip"]), tuple(map(_t, jax_walks["pts"]))
    real, calls = pwalk._prepass, []

    def recorder(*args, **opts):
        calls.append((args, opts))
        return real(*args, **opts)

    pwalk.reset_launches()
    pwalk._prepass = recorder
    try:
        if mode == "closest":
            pwalk._closest_inputs(cs, _t(cam.eye), d)
        elif mode == "any_dest":
            pwalk._any_dest_inputs(cs, _t(SUN), pts, skip)
        else:
            pwalk._any_inputs(cs, _t(jax_walks["center"]), pts,
                              tuple(map(_t, jax_walks["sl"])), skip)
    finally:
        pwalk._prepass = real
    [(args, opts)] = calls
    assert opts == {"mode": mode}
    got, want = pwalk._prepass(*args, **opts), pwalk._prepass_plain(*args)
    assert int(got[2].sum()) > 0
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert not any(pwalk.prepass_launches.values())
    assert not any(pwalk.launches.values())


@pytest.mark.parametrize("chunk", [None, 7])
def test_f64_walk_equals_jax(f64_scene, jax_walks, chunk, monkeypatch):
    # A tile's visits do not depend on its chunk: 7 tiles a chunk of the
    # plain loop gives the same slots, flags and visits as the JAX
    # package's 64.
    if chunk is not None:
        monkeypatch.setattr(pwalk, "_CHUNK", chunk)
    _, _, _, jcs, cam, dirs = f64_scene
    cs = convert.cluster_set(jcs)
    d = tuple(map(_t, dirs))
    slot, cnt = pwalk.closest_search_f64(cs, _t(cam.eye), d)
    jslot, jcnt = jax_walks["closest"]
    assert int((np.asarray(jslot) >= 0).sum()) > 100
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert int(cnt["traversal_steps"]) == int(jcnt["traversal_steps"])

    skip, pts = _t(jax_walks["skip"]), tuple(map(_t, jax_walks["pts"]))
    occ, cnt = pwalk.any_hit_to_point_f64(cs, _t(SUN), pts, skip=skip)
    jocc, jcnt = jax_walks["any_dest"]
    assert 0 < int(np.asarray(jocc).sum())
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert int(cnt["traversal_steps"]) == int(jcnt["traversal_steps"])

    occ, cnt = pwalk.any_hit_f64(cs, _t(jax_walks["center"]), pts,
                                 tuple(map(_t, jax_walks["sl"])), skip=skip)
    jocc, jcnt = jax_walks["any"]
    assert 0 < int(np.asarray(jocc).sum())
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert int(cnt["traversal_steps"]) == int(jcnt["traversal_steps"])


def test_f64_windowed_search_equals_jax(f64_scene):
    _, _, _, jcs, cam, dirs = f64_scene
    tmin, tmax = 0.1, 0.35
    with jax.enable_x64():
        jslot, jcnt = jwalk.closest_search_f64(jcs, cam.eye, dirs, tmin=tmin,
                                               tmax=tmax)
    slot, cnt = pwalk.closest_search_f64(convert.cluster_set(jcs),
                                         _t(cam.eye), tuple(map(_t, dirs)),
                                         tmin=tmin, tmax=tmax)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert int(cnt["traversal_steps"]) == int(jcnt["traversal_steps"])


# The card's float64 walk goes in rounds of K candidates, one a CTA of the
# tile's cluster, each visited against the round's opening prune and then
# replayed in order (ops/csrc/walk_f64.cu). The model below is that rule
# in plain torch, held to the plain frontier loop on the CPU: the
# exactness argument, since the CPU cannot launch the kernel.
ROUND_CASES = ("closest", "closest_window", "any_dest", "any")


def _round_inputs(f64_scene, case):
    """``_walk``'s inputs of a case on the bunny's 64 x 64 rays: the
    closest search (with a window), then the shadow segments from the sun
    to points just short of the hits (misses skipped) and generic shadow
    rays from them toward it."""
    _, _, _, jcs, cam, dirs = f64_scene
    cs = convert.cluster_set(jcs)
    d, eye = tuple(map(_t, dirs)), _t(cam.eye)
    if case == "closest_window":
        return pwalk._closest_inputs(cs, eye, d, 0.1, 0.35)
    w = pwalk._closest_inputs(cs, eye, d)
    if case == "closest":
        return w
    slot = pwalk._walk_plain(**w)[0].reshape(-1)[:d[0].shape[0]]
    hit, idx = slot >= 0, slot.clamp(min=0).long()
    p0, n = cs.p0.reshape(-1, 3)[idx], cs.n.reshape(-1, 3)[idx]
    t = (n * (p0 - eye)).sum(-1) / (n * torch.stack(d, -1)).sum(-1)
    t = torch.where(hit, t, 0.0)
    pts = tuple(eye[a] + 0.999 * t * d[a] for a in range(3))
    sun = _t(SUN)
    if case == "any_dest":
        return pwalk._any_dest_inputs(cs, sun, pts, ~hit)
    sl = tuple(sun[a] - pts[a] for a in range(3))
    inv = torch.rsqrt(sl[0] * sl[0] + sl[1] * sl[1] + sl[2] * sl[2])
    return pwalk._any_inputs(cs, cs.p0.mean((0, 1)), pts,
                             tuple(c * inv for c in sl), ~hit)


def _round_walk(w, K):
    """The kernel's round rule, tile by tile: (out (n_t, TILE) int32, each
    tile's visits, outcomes dropped, dropped outcomes that would have
    changed a ray). In the round from k0, candidate k0 + c is visited
    where it is within the count and the round's opening prune admits
    it; the outcomes are merged in order (strict <, or OR), bit j + 1 is
    "some ray's part of the prune after candidates k0 .. k0 + j admits
    candidate k0 + j + 1", and the walk ends at the first candidate not
    admitted, its outcome and the later ones dropped."""
    ent, order, counts = w["ent"], w["order"], w["counts"]
    occl = w["mode"] != "closest"
    out = torch.empty(ent.shape, dtype=torch.int32)[:, :1].expand(
        -1, pwalk.TILE).clone()
    visits = torch.zeros(ent.shape[0], dtype=torch.int64)
    dropped = changed = 0
    for tile in range(ent.shape[0]):
        alive = w["alive"][tile]
        cap = torch.where(alive, w["tcap"][tile], -1.0)
        state = (torch.full((pwalk.TILE,), torch.inf, dtype=torch.float64),
                 torch.full((pwalk.TILE,), -1, dtype=torch.int64),
                 w["occ0"][tile] > 0 if occl else None)

        def part(state):
            best, _, occ = state
            return (torch.where(occ, -1.0, cap) if occl
                    else torch.minimum(best, cap))

        def merge(state, res, c):
            best, slot, occ = state
            if occl:
                return best, slot, occ | (res[0][c] & alive)
            better = alive & (res[0][c] < best)
            return (torch.where(better, res[0][c], best),
                    torch.where(better, res[1][c], slot), occ)

        count, k0 = int(counts[tile]), 0
        prune = part(state).max()
        while k0 < count and ent[tile, k0] <= prune:
            go = [k0 + c < count and bool(ent[tile, k0 + c] <= prune)
                  for c in range(K)]
            seen = [c for c in range(K) if go[c]]
            res = f64_rows.outcome(w, tile, order[tile, k0 + seen[0]:
                                                  k0 + seen[-1] + 1])
            states, admit = [], [True] + [False] * (K - 1)
            s = state
            for j in range(K):
                if go[j]:
                    s = merge(s, res, j - seen[0])
                states.append(s)
                if j + 1 < K and k0 + j + 1 < count:
                    admit[j + 1] = bool((part(s)
                                         >= ent[tile, k0 + j + 1]).any())
            n = next((j for j in range(1, K) if not admit[j]), K)
            state = states[n - 1]
            for j in range(n, K):
                if go[j]:
                    dropped += 1
                    after = merge(state, res, j - seen[0])
                    changed += any(a is not None and not torch.equal(a, b)
                                   for a, b in zip(after, state))
            visits[tile] += n
            if n < K:
                break
            prune = part(state).max()
            k0 += K
        out[tile] = (state[2] if occl else state[1]).to(torch.int32)
    return out, visits, dropped, changed


@pytest.fixture(scope="module")
def round_inputs(f64_scene):
    """``_round_inputs`` of each case, made once."""
    made = {}

    def inputs(case):
        if case not in made:
            made[case] = _round_inputs(f64_scene, case)
        return made[case]

    return inputs


@pytest.mark.parametrize("K", [1, 8, 16])
@pytest.mark.parametrize("case", ROUND_CASES)
def test_f64_round_rule_equals_plain(round_inputs, case, K):
    # The round rule of the cluster kernel gives the plain loop's winner
    # slots or flags and each tile's visits on the bunny's rays.
    w = round_inputs(case)
    got, visits, _, _ = _round_walk(w, K)
    want, steps = pwalk._walk_plain(**w)
    assert torch.equal(got, want)
    assert torch.equal(visits, f64_rows.tile_visits(w))
    assert int(steps) == int(visits.sum()) > 0
    live = w["alive"] if case.startswith("closest") else (
        w["alive"] & (w["occ0"] == 0))
    found = (got >= 0) if case.startswith("closest") else (got > 0)
    assert int((found & live).sum()) > 0


@pytest.mark.parametrize("case", ROUND_CASES)
def test_f64_round_rule_drops_outcomes_past_the_stop(round_inputs, case):
    # Crafted rows: the plain stop right after each of the first 32
    # positions, where the next candidate (visited in the same round
    # unless it opens the next) holds a hit for a ray that nothing
    # visited hits: merged, it would change that ray; a row shorter than
    # K; a row of none. At K = 8 and 16 the round rule drops those
    # outcomes and gives the plain loop's results and visits.
    positions = range(32)
    w = f64_rows.craft(round_inputs(case),
                       f64_rows.stop_specs(round_inputs(case), positions))
    want, _ = pwalk._walk_plain(**w)
    assert torch.equal(f64_rows.tile_visits(w), torch.tensor(
        [p + 1 for p in positions] + [1, 0]))
    assert bool((want[:, 1] == (-1 if case.startswith("closest")
                                else 0)).all())
    for K in (8, 16):
        got, visits, dropped, changed = _round_walk(w, K)
        assert torch.equal(got, want), K
        assert visits.tolist() == [p + 1 for p in positions] + [1, 0], K
        # Candidate p + 1 shares a round with p but where it opens the
        # next; the row of 3 stops inside its only round.
        assert changed == sum((p + 1) % K != 0 for p in positions) + 1, K
        assert dropped >= changed, K


@pytest.mark.parametrize("K", [8, 16])
def test_f64_round_rule_keeps_the_earlier_of_equal_t(round_inputs, K):
    # A cluster and its twin (equal t for the ray) next to each other in
    # one round and across two, in both orders: the earlier one's slot
    # wins, as in the plain loop.
    positions = [(p, first) for p in (0, 3, K - 1) for first in (0, 1)]
    for case in ("closest", "closest_window"):
        w, specs = f64_rows.twin_specs(round_inputs(case), positions)
        w = f64_rows.craft(w, specs)
        got, visits, _, _ = _round_walk(w, K)
        want, _ = pwalk._walk_plain(**w)
        assert torch.equal(got, want), case
        assert torch.equal(visits, f64_rows.tile_visits(w)), case
        twin = w["cs"].num_clusters - 1
        twin_won = (want[:, 0] // w["cs"].cluster_size) == twin
        assert twin_won.tolist() == [bool(f) for _, f in positions], case

def _sheets():
    """Two sheets 0.0004 apart at z ~ 10000, below a float32 ulp there;
    the far one packed in slot 0. (vertices, faces, ClusterSet fields)."""
    z_far, z_near = 10000.0004, 10000.0
    assert np.float32(z_far) == np.float32(z_near)
    verts = np.asarray([[-9000.0, -9000.0, z_far], [9000.0, -9000.0, z_far],
                        [0.0, 9000.0, z_far], [-9000.0, -9000.0, z_near],
                        [9000.0, -9000.0, z_near], [0.0, 9000.0, z_near]])
    return verts, np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)


def test_sub_f32_ulp_sheets_equal_jax():
    verts, faces = _sheets()
    C = 128

    def packed(soup, xp, cat, full):
        def pk(a):
            return cat([a, xp.zeros((C - 2, 3), dtype=a.dtype)])[None]
        pts = verts.reshape(-1, 3)
        return dict(p0=pk(soup.p0), e1=pk(soup.e1), e2=pk(soup.e2),
                    n=pk(soup.n), lo=full(pts.min(0))[None],
                    hi=full(pts.max(0))[None])

    dirs = np.asarray([[0.0, 0.0, 1.0]])
    with jax.enable_x64():
        jsoup = jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                         with_normals=False)
        jcs = jcl.ClusterSet(**packed(jsoup, jnp, jnp.concatenate,
                                      jnp.asarray),
                             perm=jnp.asarray([0, 1] + [-1] * (C - 2),
                                              jnp.int32))
        jhit = jmk.closest_hit_common_origin(jsoup, jnp.zeros(3),
                                             jnp.asarray(dirs), clusters=jcs,
                                             exact_f64=True)
    soup = ct.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                            with_normals=False)
    cs = ClusterSet(**packed(soup, torch, torch.cat, torch.as_tensor),
                    perm=torch.as_tensor([0, 1] + [-1] * (C - 2),
                                         dtype=torch.int32))
    eye, d = torch.zeros(3, dtype=torch.float64), torch.as_tensor(dirs)
    acc = pmk.closest_hit_common_origin(soup, eye, d, clusters=cs)
    exact = pmk.closest_hit_common_origin(soup, eye, d, clusters=cs,
                                          exact_f64=True)
    assert int(acc.prim_id[0]) == 0                  # the far sheet
    assert int(exact.prim_id[0]) == 1 == int(np.asarray(jhit.prim_id)[0])
    assert float(exact.t[0]) == 10000.0 == float(np.asarray(jhit.t)[0])
    np.testing.assert_allclose(float(acc.t[0]) - float(exact.t[0]), 0.0004,
                               rtol=1e-6)


@pytest.mark.parametrize("backend, exact", [("bruteforce", False),
                                            ("megakernel", False),
                                            ("megakernel", True)])
def test_f64_render_equals_jax(f64_scene, backend, exact):
    v64, faces, _, _, cam, _ = f64_scene
    opts = dict(width=48, height=48, backend=backend, f64_exact=exact,
                traversal_stats=True)
    with jax.enable_x64():
        jimg, jst = jax_render(v64, faces, cam, SUN, **opts)
        jimg, jst = np.asarray(jimg), {k: int(v) for k, v in jst.items()}
    img, st = ct.render(v64, faces, convert.camera(cam), SUN, device="cpu",
                        **opts)
    st = {k: int(v) for k, v in st.items()}
    assert img.dtype == torch.float64
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-9)
    assert jst["primary_hits"] > 100
    if backend == "megakernel" and not exact:
        # The float32 search of float64 inputs: the JAX package compiles
        # the whole render under jit, and its shadow walk visits other
        # blocks (212 against 197 here) for the same flags. The port's
        # visits are those of its float32 render of the same scene.
        walked = ("traversal_steps", "mt_block_visits", "intersections")
        _, st32 = ct.render(v64.astype(np.float32), faces, convert.camera(cam),
                            SUN.astype(np.float32), device="cpu", **opts)
        assert {k: st[k] for k in walked} == {k: int(st32[k])
                                              for k in walked}
        st = {k: v for k, v in st.items() if k not in walked}
        jst = {k: v for k, v in jst.items() if k not in walked}
    assert st == jst


def _np_closest_f64(p0, e1, e2, n, eye, d):
    """NumPy float64 brute-force closest hit: (prim ids, -1 for a miss;
    every pair's t)."""
    c = p0 - eye
    det = d @ n.T
    r = np.cross(d[:, None, :], c[None, :, :])
    u = np.einsum("rfa,fa->rf", r, e2)
    v = np.einsum("rfa,fa->rf", r, e1)
    tn = np.einsum("fa,fa->f", n, c)[None, :]
    s = np.where(det >= 0, 1.0, -1.0)
    uvw = np.minimum(np.minimum(u * s, v * s), (det - u - v) * s)
    ok = (np.minimum(uvw, tn * s) >= 0) & (det != 0)
    t = np.where(ok, tn / np.where(det != 0, det, 1.0), np.inf)
    best = t.min(axis=1)
    return np.where(np.isfinite(best), t.argmin(axis=1), -1), t


def test_exact_f64_matches_the_f64_oracle():
    rng = np.random.default_rng(5)
    verts = rng.standard_normal((80, 3))
    faces = rng.integers(0, 80, (200, 3)).astype(np.int32)
    d = rng.standard_normal((600, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    eye = np.asarray([0.0, 0.0, -4.0])
    soup = ct.triangle_soup(torch.as_tensor(verts), torch.as_tensor(faces),
                            with_normals=False)
    hit = pmk.closest_hit_common_origin(soup, torch.as_tensor(eye),
                                        torch.as_tensor(d), exact_f64=True)
    ref, t_all = _np_closest_f64(*(x.numpy() for x in (
        soup.p0, soup.e1, soup.e2, soup.n)), eye, d)
    prim = torch.where(hit.mask, hit.prim_id, -1).numpy()
    assert ((prim >= 0) == (ref >= 0)).all() and (ref >= 0).sum() > 20
    for i in np.nonzero(prim != ref)[0]:      # exact float64 ties only
        assert t_all[i, prim[i]] == t_all[i, ref[i]]
    m = (prim == ref) & (prim >= 0)
    t_ref = t_all[np.arange(600), np.clip(prim, 0, None)]
    np.testing.assert_allclose(hit.t.numpy()[m], t_ref[m], rtol=1e-12)


@pytest.mark.parametrize("fn", ["closest", "any", "any_dest"])
def test_exact_f64_dtype_refusals(bunny, fn):
    # A float32 soup, and a float32 ClusterSet under a float64 soup (which
    # the JAX package does not check), are refused by name.
    verts, faces = bunny
    soups = {dt: ct.triangle_soup(torch.as_tensor(verts, dtype=dt),
                                  torch.as_tensor(faces), with_normals=False)
             for dt in (torch.float32, torch.float64)}
    cs32 = build_clusters_treelet(soups[torch.float32])
    pts = soups[torch.float64].p0[:8] + 0.1
    dirs = torch.nn.functional.normalize(pts - 1.0, dim=-1)

    def call(soup, clusters):
        o = torch.zeros(3, dtype=soup.p0.dtype)
        p, d = pts.to(soup.p0.dtype), dirs.to(soup.p0.dtype)
        if fn == "closest":
            return pmk.closest_hit_common_origin(soup, o, d, clusters=clusters,
                                                 exact_f64=True)
        if fn == "any":
            return pmk.any_hit(soup, o, p, d, clusters=clusters,
                               exact_f64=True)
        return pmk.any_hit_to_point(soup, o + 5.0, p, clusters=clusters,
                                    exact_f64=True)

    with pytest.raises(ValueError, match="float64 soup"):
        call(soups[torch.float32], None)
    with pytest.raises(ValueError, match="float64 ClusterSet"):
        call(soups[torch.float64], cs32)
    call(soups[torch.float64], None)


def _strided(x):
    """x's values in a tensor of x's shape that is not contiguous."""
    return torch.stack([x, x], dim=-1)[..., 0]


def _kernel_calls():
    """The card wrappers of the float64 walk and prepass on CPU tensors
    of the sheets' cut, and the changes to their inputs that each must
    refuse: {case: (wrapper, its inputs, the change)}."""
    verts, faces = _sheets()
    cs = build_clusters_treelet(ct.triangle_soup(
        torch.as_tensor(verts), torch.as_tensor(faces), with_normals=False))
    eye = torch.zeros(3, dtype=torch.float64)
    d = torch.nn.functional.normalize(torch.as_tensor(
        [[0.0, 0.0, 1.0], [0.1, 0.0, 1.0], [0.0, -0.1, 1.0]],
        dtype=torch.float64), dim=-1)
    skip = torch.zeros(3, dtype=torch.bool)
    walk = {"occ0": None, **pwalk._closest_inputs(cs, eye, tuple(d.t()))}
    dest = {"tmin": None, "tmax": None, **pwalk._any_dest_inputs(
        cs, eye + 5.0, tuple((d * 9e3).t()), skip)}
    lo, hi = cs.lo - eye, cs.hi - eye
    dlo, dhi = d.amin(0)[None], d.amax(0)[None]
    prepass = dict(lo=lo, hi=hi, dlo=dlo, dhi=dhi, olo=None, ohi=None,
                   live=torch.ones(1, dtype=torch.bool), mode="closest")
    w, p = pwalk._walk_card, pwalk._prepass_kernel
    return {
        "walk float32 ent": (w, walk, {"ent": walk["ent"].float()}),
        "walk short counts": (w, walk, {"counts": walk["counts"][:0]}),
        "walk strided tcap": (w, walk, {"tcap": _strided(walk["tcap"])}),
        "walk strided dirs": (w, walk, {"d3": _strided(walk["d3"])}),
        "walk int64 occ0": (w, dest, {"occ0": dest["occ0"].long()}),
        "walk short tmin": (w, walk, {"tmin": walk["tcap"][:, :256],
                                      "tmax": walk["tcap"]}),
        "prepass float32 lo": (p, prepass, {"lo": lo.float()}),
        "prepass int live": (p, prepass, {"live": prepass["live"].int()}),
        "prepass short dhi": (p, prepass, {"dhi": dhi[:0]}),
        "prepass strided dlo": (p, prepass, {"dlo": _strided(dlo)}),
    }


@pytest.mark.parametrize("case", list(_kernel_calls()))
def test_f64_kernel_wrappers_refuse_before_loading(case, monkeypatch):
    # The float64 walk's and prepass's card wrappers refuse a wrong
    # dtype, a wrong shape or a non-contiguous input in the launcher's
    # check, before it loads the library; the same inputs unchanged get
    # as far as the load.
    from ceres_tpu_torch.utils import native

    def no_library(name):
        raise AssertionError(f"the launcher loaded the {name} library")

    monkeypatch.setattr(native, "load", no_library)
    wrapper, inputs, change = _kernel_calls()[case]
    with pytest.raises(AssertionError, match="walk_f64 library"):
        wrapper(**inputs)
    with pytest.raises(ValueError, match="walk_f64 kernels"):
        wrapper(**{**inputs, **change})




@pytest.mark.parametrize("wide", [False, True])
def test_f64_walk_takes_the_cluster_form_past_the_solo_row(wide,
                                                          monkeypatch):
    # The card wrapper asks for the cluster form, and counts it as
    # clustered, only where the rows hold more than _SOLO_ROW candidates.
    from ceres_tpu_torch.utils import native

    seen = []

    def launch(library, entry, tensors, ints, counter=None, key=None):
        seen.append((entry, ints, counter, key))

    monkeypatch.setattr(native, "launch", launch)
    w = dict(_kernel_calls()["walk float32 ent"][1])
    if wide:
        pad = pwalk._SOLO_ROW + 1 - w["ent"].shape[1]
        w["ent"] = torch.nn.functional.pad(w["ent"], (0, pad),
                                           value=pwalk._BIG)
        w["order"] = torch.nn.functional.pad(w["order"], (0, pad))
    pwalk._walk_card(**w)
    [(entry, ints, counter, key)] = seen
    assert entry == "ceres_walk_f64" and key == "closest"
    assert ints[-1] == int(wide) and ints[1] == w["ent"].shape[1]
    if wide:
        assert counter[0] is pwalk.launches and counter[1] is pwalk.clustered
    else:
        assert counter is pwalk.launches

@pytest.mark.parametrize("err", [0, 3])
def test_launch_counts_each_counter_it_is_given(err, monkeypatch):
    # The launcher adds one to counter[key] of every counter it is given
    # (the float64 walk counts walk_f64.launches and walk_f64.clustered),
    # after the entry returns success, and none where it fails.
    from ceres_tpu_torch.utils import native

    calls = []

    class Library:
        def ceres_walk_f64(self, *args):
            calls.append(args)
            return err

        def ceres_error_string(self, code):
            return b"a fake failure"

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(native, "load", lambda name: Library())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    first, second = dict.fromkeys(pwalk.MODES, 0), dict.fromkeys(
        pwalk.MODES, 0)
    x = torch.zeros(3, dtype=torch.float64)

    def launch():
        native.launch("walk_f64", "ceres_walk_f64",
                      [("x", x, torch.float64, (3,)), ("y", None, None, ())],
                      [5], (first, second), "any")

    if err:
        with pytest.raises(RuntimeError, match="a fake failure"):
            launch()
    else:
        launch()
    assert calls == [(x.data_ptr(), 0, 5, None, 7)]
    want = {"closest": 0, "any": 0 if err else 1, "any_dest": 0}
    assert first == second == want

def test_quality_cut_boxes_follow_the_soup_dtype(bunny):
    # float32 soups keep the host tree's float32 boxes; a float64 soup
    # gets each cluster's exact float64 bound over the same cut.
    verts, faces = bunny
    cuts = {dt: build_clusters_quality(ct.triangle_soup(
        torch.as_tensor(verts, dtype=dt), torch.as_tensor(faces),
        with_normals=False)) for dt in (torch.float32, torch.float64)}
    c32, c64 = cuts[torch.float32], cuts[torch.float64]
    assert c32.lo.dtype == torch.float32 and c64.lo.dtype == torch.float64
    assert torch.equal(c32.perm, c64.perm)
    assert torch.equal(c32.super_first, c64.super_first)
    corners = torch.stack([c64.p0, c64.p0 - c64.e1, c64.p0 + c64.e2], 2)
    valid = (c64.perm >= 0).reshape(c64.lo.shape[0], -1, 1, 1)
    assert bool((torch.where(valid, corners, torch.inf) >= c64.lo[:, None,
                                                             None]).all())
    assert bool((torch.where(valid, corners, -torch.inf) <= c64.hi[:, None,
                                                              None]).all())
    torch.testing.assert_close(c64.lo.float(), c32.lo, rtol=0, atol=1e-6)

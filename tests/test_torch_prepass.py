"""The port's culling prepass against the JAX package's, bit for bit.

Keys are int32 packings of f32 entry bounds and tcap rides the walk as
int bits, so keys, counts and tcap bits must be exactly equal. Both
sides get the same direction columns, taken from the JAX side:
``camera_ray_columns`` normalises with rsqrt, whose XLA and torch
roundings differ by an ulp, and fresh directions would make keys differ
for a reason that has nothing to do with the prepass. Bunny (61
clusters) and dragon (268 clusters: cid bits past 8) on SweepSAH cuts.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_tpu.accel import clusters as jcl
from ceres_tpu.accel.cuts import build_clusters_quality as jax_quality
from ceres_tpu.models.camera import Camera as JaxCamera
from ceres_tpu.models.camera import camera_ray_columns as jax_ray_columns
from ceres_tpu.models.mesh import triangle_soup as jax_soup
from ceres_tpu.ops import megakernel as jmk
from ceres_tpu.utils import tiling as jtiling

from ceres_tpu_torch.ops import megakernel as pmk
from ceres_tpu_torch.ops import prepass
from ceres_tpu_torch.utils import convert

torch.set_num_threads(1)

SUN = np.asarray([-50.0, 100.0, 0.0], np.float32)
EYES = {"bunny": (0.0, 0.1, -0.3), "dragon": (0.0, 2.5, -12.0)}


@pytest.fixture(scope="module", params=["bunny", "dragon"])
def scene(request, bunny, dragon):
    verts, faces = bunny if request.param == "bunny" else dragon
    cs = jax_quality(jax_soup(jnp.asarray(verts), jnp.asarray(faces),
                              with_normals=False))
    eye = np.asarray(EYES[request.param], np.float32)
    cam = JaxCamera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                         fov=60.0)
    dirs = tuple(jtiling.swizzle_plane(p)
                 for p in jax_ray_columns(cam, 96, 72))
    soup = jax_soup(jnp.asarray(verts), jnp.asarray(faces))
    hit, pay = jmk.closest_hit_common_origin(soup, cam.eye, dirs, clusters=cs,
                                             normal_cols=True)
    # The renderer's shadow-ray origins (hit point pushed off the surface).
    n = pay[:3]
    n_inv = jnp.reciprocal(jnp.sqrt(jnp.where(
        hit.mask, n[0] * n[0] + n[1] * n[1] + n[2] * n[2], 1.0)))
    t = jnp.where(hit.mask, hit.t, 0.0)
    points = tuple(cam.eye[a] + t * dirs[a] - 1e-5 * n[a] * n_inv
                   for a in range(3))
    return cs, cam.eye, dirs, points, ~hit.mask


def _bits(x):
    return np.asarray(x).view(np.int32)


def _jax_keys(cs, origin, d, alive):
    """The JAX package's prepass for rays from ``origin`` (its own steps,
    as _closest_search and any_hit_to_point run them)."""
    dp = tuple(jmk._pad_rays(c) for c in d)
    dt = tuple(c.reshape(-1, jmk.TILE) for c in dp)
    alive = alive & ((dt[0] * dt[0] + dt[1] * dt[1] + dt[2] * dt[2]) > 0.0)
    keys, counts = jmk._tile_candidate_keys(cs.lo - origin, cs.hi - origin,
                                            dt, alive=alive)
    root_lo, root_hi = jmk._scene_root(cs)
    tcap = jmk._ray_tcap(root_lo - origin, root_hi - origin, None, dp)
    return keys, counts, tcap, dp


def test_closest_prepass_is_bit_identical(scene):
    cs, eye, dirs, _, _ = scene
    keys, counts, tcap, dp = _jax_keys(cs, eye, dirs, True)
    (p_counts, p_keys, rays, w), opts = pmk._closest_inputs(
        convert.cluster_set(cs), convert.tensor(eye),
        tuple(convert.tensor(d) for d in dirs))
    assert opts == {"hull": None, "bbox": None, "first": None, "S": 1,
                    "stream": False}      # flat, resident
    np.testing.assert_array_equal(p_keys.numpy(), np.asarray(keys))
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(rays[3].numpy().view(np.int32), _bits(tcap))
    for a in range(3):
        np.testing.assert_array_equal(rays[a].numpy(), np.asarray(dp[a]))
    assert int(counts.max()) > 0
    packed = np.asarray(jcl.cluster_weights_common_origin_packed(cs, eye))
    np.testing.assert_allclose(w[:, 9].numpy(), packed[:, 3, 384:],
                               rtol=1e-6, atol=0)


def test_shadow_prepass_is_bit_identical(scene):
    cs, _, _, points, skip = scene
    sun = jnp.asarray(SUN)
    d = tuple(points[a] - sun[a] for a in range(3))
    skip_p = jmk._pad_rays(skip)
    keys, counts, tcap, _ = _jax_keys(cs, sun, d,
                                      ~skip_p.reshape(-1, jmk.TILE))
    tcap = jnp.minimum(tcap, 1.0 + jmk._ULP_PAD)
    (p_counts, p_keys, rays, _, occ0), opts = pmk._any_dest_inputs(
        convert.cluster_set(cs), torch.as_tensor(SUN),
        tuple(convert.tensor(p) for p in points), convert.tensor(skip))
    np.testing.assert_array_equal(p_keys.numpy(), np.asarray(keys))
    np.testing.assert_array_equal(p_counts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(rays[3].numpy().view(np.int32), _bits(tcap))
    np.testing.assert_array_equal(occ0.numpy(),
                                  np.asarray(skip_p).astype(np.int32))
    assert int(counts.max()) > 0


def test_tile_keys_mask_cluster_ids(scene):
    cs, eye, dirs, _, _ = scene
    keys, _, _, _ = _jax_keys(cs, eye, dirs, True)
    n_c = cs.num_clusters
    cmask = (1 << prepass._cid_bits(n_c)) - 1
    assert prepass._cid_bits(n_c) == jmk._cid_bits(n_c)
    ids = np.sort(np.asarray(keys) & cmask, axis=1)
    np.testing.assert_array_equal(ids, np.broadcast_to(np.arange(n_c),
                                                       ids.shape))


@pytest.mark.parametrize("op", ["max", "min"])
def test_signed_zero_min_max_follow_xla(op):
    vals = np.asarray([0.0, -0.0, 1.0, -1.0, 3e37, -3e37], np.float32)
    a, b = (x.ravel() for x in np.meshgrid(vals, vals))
    jfn = jnp.maximum if op == "max" else jnp.minimum
    pfn = prepass._fmax if op == "max" else prepass._fmin
    ref = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
    got = pfn(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_safe_inverse_and_pad():
    d = np.asarray([0.0, -0.0, 1e-31, -1e-31, 0.5, -4.0], np.float32)
    ref = np.asarray(jmk._safe_inverse(jnp.asarray(d)))
    got = prepass._safe_inverse(torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    x = torch.arange(700, dtype=torch.float32)
    padded = prepass._pad_rays(x)
    assert padded.shape[0] == 1024 and not padded[700:].any()

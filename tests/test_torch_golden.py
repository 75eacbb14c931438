"""The port's golden oracle (``ceres_tpu_torch/utils/golden.py``) against
the JAX package's (``ceres_tpu/utils/golden.py``), and the port's renders
against it.

Both oracles are NumPy float64 code on the same inputs, so their outputs
must be bit-equal: ``intersect_all`` and ``any_hit`` on a seeded random
soup (rays chunked and not), ``render_golden`` on the bunny preset in
smooth and flat mode, default and ``reference_compat=True``. The port's
``render()`` is then held to the port's oracle under
``tests/test_render_golden.py``'s rule: at 64 x 64 on the bunny preset,
smooth and flat, on the brute-force and the megakernel backend, at most
1% of pixels off by more than 2e-3, and primary hits within 1% of W x H.
"""

import numpy as np
import pytest
import torch

from ceres_tpu.render import scenes as jscenes
from ceres_tpu.utils import golden as jgolden

import ceres_tpu_torch as ct
from ceres_tpu_torch.render import scenes
from ceres_tpu_torch.utils import golden

torch.set_num_threads(1)

W = H = 64


def _random_case(seed=3, R=1500, T=200):
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal((T, 3))
    e1 = 0.5 * rng.standard_normal((T, 3))
    e2 = 0.5 * rng.standard_normal((T, 3))
    n = np.cross(e1, e2)
    origins = 0.3 * rng.standard_normal((R, 3)) + [0.0, 0.0, -4.0]
    dirs = golden.normalize(rng.standard_normal((R, 3)) + [0.0, 0.0, 3.0])
    return origins, dirs, p0, e1, e2, n


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int64 if a.itemsize == 8
                                             else np.int32),
                                      b.view(np.int64 if b.itemsize == 8
                                             else np.int32))
    else:
        np.testing.assert_array_equal(a, b)


def test_normalize_bit_equal():
    v = np.random.default_rng(1).standard_normal((50, 3))
    _bits_equal(golden.normalize(v), jgolden.normalize(v))


@pytest.mark.parametrize("chunk", [1024, 256])
@pytest.mark.parametrize("window", [(0.0, np.inf), (3.5, 5.0)])
def test_intersect_all_bit_equal(chunk, window):
    origins, dirs, p0, e1, e2, n = _random_case()
    got = golden.intersect_all(origins, dirs, p0, e1, e2, n, *window,
                               chunk=chunk)
    ref = jgolden.intersect_all(origins, dirs, p0, e1, e2, n, *window,
                                chunk=chunk)
    assert int(got[4].sum()) > 0
    for a, b in zip(got, ref):
        _bits_equal(a, b)


def test_any_hit_bit_equal():
    origins, dirs, p0, e1, e2, n = _random_case(seed=4)
    got = golden.any_hit(origins, dirs, p0, e1, e2, n, tmax=5.0)
    ref = jgolden.any_hit(origins, dirs, p0, e1, e2, n, tmax=5.0)
    assert 0 < int(got.sum()) < len(got)
    _bits_equal(got, ref)


def _golden_args(sc):
    return (sc.vertices, sc.faces, np.asarray(sc.camera.eye, np.float64),
            np.asarray(sc.camera.dir, np.float64),
            np.asarray(sc.camera.up, np.float64), float(sc.camera.fov),
            np.asarray(sc.sun, np.float64), W, H)


@pytest.mark.parametrize("mode, compat", [("smooth", False), ("flat", False),
                                          ("smooth", True)])
def test_render_golden_bit_equal(mode, compat):
    # The same NumPy inputs to both: the JAX package's preset (its camera
    # normalised by XLA, whose last bits may differ from torch's).
    args = _golden_args(jscenes.bunny_scene())
    got, gst = golden.render_golden(*args, mode=mode, reference_compat=compat)
    ref, rst = jgolden.render_golden(*args, mode=mode, reference_compat=compat)
    assert gst == rst and gst["hits"] > 0 and gst["occluded"] > 0
    _bits_equal(got, ref)
    assert got.max() > 0.1


@pytest.fixture(scope="module")
def oracle():
    sc = scenes.bunny_scene()
    return {mode: golden.render_golden(*_golden_args(sc), mode=mode)
            for mode in ("smooth", "flat")}


@pytest.mark.parametrize("backend", ["bruteforce", "megakernel"])
@pytest.mark.parametrize("mode", ["smooth", "flat"])
def test_port_render_matches_oracle(oracle, mode, backend):
    sc = scenes.bunny_scene()
    img, st = ct.render(sc.vertices, sc.faces, sc.camera, sc.sun, width=W,
                        height=H, mode=mode, backend=backend, device="cpu")
    img = img.numpy()
    gold, gst = oracle[mode]
    assert img.shape == (H, W, 3)
    bad = (np.abs(img - gold).max(axis=-1) > 2e-3).mean()
    assert bad <= 0.01, f"{bad:.4%} pixels differ by more than 2e-3"
    assert abs(int(st["primary_hits"]) - gst["hits"]) <= 0.01 * W * H
    assert gold.max() > 0.1 and img.max() > 0.1

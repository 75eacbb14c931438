"""ctypes bridge to the native C++ binned-SAH builder (counterpart of
``ceres_tpu/accel/native.py``: ``available``, ``build_binned_sah_native``,
``build_binned_sah_fast``).

The port's copy of the source, ``accel/csrc/bvh_build.cpp``, is compiled
with g++ at first use into ``ceres_tpu_torch/_build/``
(``utils/cxx.py``). It emits node for node the tree of
``golden_builders.BinnedSahBuilder`` (both score in double), so callers
treat the two as one builder with two speeds. The one fallback is the
JAX package's: ``build_binned_sah_fast`` takes the NumPy builder only
where no g++ exists. A build or load that fails while g++ exists raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ceres_tpu_torch.accel import golden_builders as gb
from ceres_tpu_torch.utils import cxx

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "bvh_build.cpp")

_u32p = ctypes.POINTER(ctypes.c_uint32)
_f32p = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def _load():
    lib = cxx.load(SOURCE, "ceres_bvh")
    if lib is None:
        return None
    lib.ceres_bvh_build_binned.restype = ctypes.c_int
    lib.ceres_bvh_build_binned.argtypes = [
        _f32p, _f32p, _f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_f32p), ctypes.POINTER(_u32p),
        ctypes.POINTER(_u32p), ctypes.POINTER(_u32p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.ceres_bvh_free.restype = None
    lib.ceres_bvh_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True when the library is built and loaded (building it now if
    needed); False only without g++."""
    return _load() is not None


def build_binned_sah_native(tri_lo, tri_hi, centers, bin_count: int = 16,
                            max_leaf_size: int = 16) -> gb.FlatBvh:
    """Native binned-SAH build -> FlatBvh. Raises ImportError without
    g++. The boxes and centres are taken as float32, as the JAX
    package's bridge takes them."""
    lib = _load()
    if lib is None:
        raise ImportError("native BVH builder unavailable: no g++")
    lo = np.ascontiguousarray(tri_lo, np.float32)
    hi = np.ascontiguousarray(tri_hi, np.float32)
    c = np.ascontiguousarray(centers, np.float32)
    T = lo.shape[0]
    bounds_p = _f32p()
    pc_p = _u32p()
    fc_p = _u32p()
    pi_p = _u32p()
    n = ctypes.c_int()
    handle = ctypes.c_void_p()
    rc = lib.ceres_bvh_build_binned(
        lo.ctypes.data_as(_f32p), hi.ctypes.data_as(_f32p),
        c.ctypes.data_as(_f32p), T, bin_count, max_leaf_size,
        ctypes.byref(bounds_p), ctypes.byref(pc_p), ctypes.byref(fc_p),
        ctypes.byref(pi_p), ctypes.byref(n), ctypes.byref(handle))
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (rc={rc})")
    try:
        nc = n.value
        bvh = gb.FlatBvh(
            bounds=np.ctypeslib.as_array(bounds_p, shape=(nc, 6)).copy(),
            prim_count=np.ctypeslib.as_array(pc_p, shape=(nc,)).copy(),
            first_child=np.ctypeslib.as_array(fc_p, shape=(nc,)).copy(),
            prim_indices=np.ctypeslib.as_array(pi_p, shape=(T,)).copy(),
            node_count=nc)
    finally:
        lib.ceres_bvh_free(handle)
    return bvh


def build_binned_sah_fast(tri_lo, tri_hi, centers, **kw) -> gb.FlatBvh:
    """Binned-SAH build: native C++ where g++ exists, the NumPy builder
    otherwise (the same tree either way)."""
    if available():
        return build_binned_sah_native(tri_lo, tri_hi, centers, **kw)
    kw.setdefault("bin_count", 16)
    max_leaf = kw.pop("max_leaf_size", 16)
    return gb.build_binned_sah(tri_lo, tri_hi, centers,
                               max_leaf_size=max_leaf, **kw)

"""ctypes bridge to the native C++ OBJ parser (counterpart of
``ceres_tpu/io/native.py``: ``available``, ``parse_obj_file``).

The port's copy of the source, ``io/csrc/objparse.cpp``, is compiled with
g++ at first use into ``ceres_tpu_torch/_build/`` (``utils/cxx.py``).
``io.obj.load_obj`` uses it for paths where g++ exists, and the Python
parser otherwise and for streams; both give the same arrays. A build or
load that fails while g++ exists raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ceres_tpu_torch.utils import cxx

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "objparse.cpp")


@functools.lru_cache(maxsize=None)
def _load():
    lib = cxx.load(SOURCE, "ceres_objparse")
    if lib is None:
        return None
    lib.ceres_obj_parse.restype = ctypes.c_int
    lib.ceres_obj_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.ceres_obj_free.restype = None
    lib.ceres_obj_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True when the library is built and loaded (building it now if
    needed); False only without g++."""
    return _load() is not None


def parse_obj_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file natively -> ((V,3) float32, (F,3) int32).
    Raises ImportError without g++."""
    lib = _load()
    if lib is None:
        raise ImportError("native OBJ parser unavailable: no g++")
    verts_p = ctypes.POINTER(ctypes.c_float)()
    faces_p = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    handle = ctypes.c_void_p()
    rc = lib.ceres_obj_parse(os.fsencode(path), ctypes.byref(verts_p),
                             ctypes.byref(nv), ctypes.byref(faces_p),
                             ctypes.byref(nf), ctypes.byref(handle))
    if rc != 0:
        raise OSError(f"native OBJ parse failed (rc={rc}): {path}")
    try:
        v = (np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy()
             if nv.value else np.zeros((0, 3), np.float32))
        f = (np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy()
             if nf.value else np.zeros((0, 3), np.int32))
    finally:
        lib.ceres_obj_free(handle)
    return np.asarray(v, np.float32), np.asarray(f, np.int32)

"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles each source for ``sm_90a`` into a shared library with a
plain C interface, under ``ceres_tpu_torch/_build/`` (git-ignored), named
by the source's stem and a hash of the source and the flags: an edited
source is rebuilt, an unchanged one is reused. The sources (``SOURCES``):
``walk`` is ``ops/csrc/walk.cu`` (the walks, span stamps, graph node
counts), ``lbvh`` is ``accel/csrc/lbvh.cu`` (the LBVH hierarchy and
boxes), ``walk_f64`` is ``ops/csrc/walk_f64.cu`` (the float64 walk and
prepass). Each library is loaded with ``ctypes`` once per process. A
missing ``nvcc`` or a failed build raises; there is no fallback.

``--fmad=false`` keeps every multiply and add separately rounded, so the
kernels reproduce their plain PyTorch versions bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_PACKAGE = os.path.dirname(_HERE)
SOURCES = {"walk": os.path.join(_HERE, "csrc", "walk.cu"),
           "lbvh": os.path.join(_PACKAGE, "accel", "csrc", "lbvh.cu"),
           "walk_f64": os.path.join(_HERE, "csrc", "walk_f64.cu")}
BUILD_DIR = os.path.join(_PACKAGE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_char_p
# Closest modes: counts, keys, rays, w, out, visits, n_tiles, n_c, cmask,
# stream_w, device, stream. Occlusion modes add occ0 after w. The
# two-level forms add hull, bbox, first after those pointers and S after
# cmask. The ``_t128`` forms walk tiles of 128 rays (regrouped shadows)
# and add scratch after visits and seg after cmask (and S).
_FLAT = (_P,) * 6 + (_I,) * 5 + (_P,)
_FLAT_OCC = (_P,) * 7 + (_I,) * 5 + (_P,)
_HIER = (_P,) * 9 + (_I,) * 6 + (_P,)
_HIER_OCC = (_P,) * 10 + (_I,) * 6 + (_P,)
_FLAT_T128 = (_P,) * 8 + (_I,) * 6 + (_P,)
_HIER_T128 = (_P,) * 11 + (_I,) * 7 + (_P,)
# Each library's C entry points: name -> (argument types, return type),
# every pointer and the stream as ``c_void_p``.
SIGNATURES = {
    "walk": {
        **{name: (args, _I) for name, args in (
            ("ceres_walk_closest", _FLAT),
            ("ceres_walk_closest_window", _FLAT),
            ("ceres_walk_any_dest", _FLAT_OCC),
            ("ceres_walk_any_dest_t128", _FLAT_T128),
            ("ceres_walk_any", _FLAT_OCC),
            ("ceres_walk_closest_hier", _HIER),
            ("ceres_walk_closest_window_hier", _HIER),
            ("ceres_walk_any_dest_hier", _HIER_OCC),
            ("ceres_walk_any_dest_hier_t128", _HIER_T128),
            ("ceres_walk_any_hier", _HIER_OCC))},
        "ceres_walk_resident_clusters": ((_I,) * 5, _I),
        "ceres_span_stamp": ((_P, _I, _I, _P), _I),
        "ceres_graph_nodes": ((_P, _P), _I),
        "ceres_error_string": ((_I,), _S),
    },
    "lbvh": {
        # keys, left, right, range_lo, range_hi, parent, leaf_parent, n,
        # device, stream
        "ceres_lbvh_hierarchy": ((_P,) * 7 + (_I,) * 2 + (_P,), _I),
        # order, left, right, parent, leaf_parent, p0, e1, e2, arrivals,
        # leaf_lo, leaf_hi, node_lo, node_hi, n, f64, device, stream
        "ceres_lbvh_boxes": ((_P,) * 13 + (_I,) * 3 + (_P,), _I),
        "ceres_lbvh_error_string": ((_I,), _S),
    },
    "walk_f64": {
        # ent, order, counts, dirs, origins, alive, tcap, tmin, tmax,
        # occ0, w, out, visits, n_tiles, n_c, C, mode, device, stream
        "ceres_walk_f64": ((_P,) * 13 + (_I,) * 5 + (_P,), _I),
        # lo, hi, dlo, dhi, olo, ohi, live, ent, order, counts, n_tiles,
        # n_c, device, stream
        "ceres_prepass_f64": ((_P,) * 10 + (_I,) * 3 + (_P,), _I),
        "ceres_walk_f64_error_string": ((_I,), _S),
    },
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from its csrc/ sources at first "
                       "use")


def library_path(name: str = "walk") -> str:
    """Where the library of source ``name`` at the current flags lives."""
    with open(SOURCES[name], "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


def build(name: str = "walk") -> str:
    """Compile source ``name`` unless its library exists. Returns its
    path; the compiler's report (registers, shared memory, spills) is
    kept beside it as ``.log``."""
    path = library_path(name)
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(path[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def load(name: str = "walk") -> ctypes.CDLL:
    """The library of source ``name``, built if needed, loaded once per
    process, with its C signatures declared (``SIGNATURES``)."""
    return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(build(name))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib

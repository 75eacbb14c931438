"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles ``csrc/walk.cu`` for ``sm_90a`` into a shared library
with a plain C interface, under ``ceres_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags: an edited source is rebuilt,
an unchanged one is reused. The library is loaded with ``ctypes``. A
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
_SOURCE = os.path.join(_HERE, "csrc", "walk.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
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
_SIGNATURES = {
    "ceres_walk_closest": _FLAT,
    "ceres_walk_closest_window": _FLAT,
    "ceres_walk_any_dest": _FLAT_OCC,
    "ceres_walk_any_dest_t128": _FLAT_T128,
    "ceres_walk_any": _FLAT_OCC,
    "ceres_walk_closest_hier": _HIER,
    "ceres_walk_closest_window_hier": _HIER,
    "ceres_walk_any_dest_hier": _HIER_OCC,
    "ceres_walk_any_dest_hier_t128": _HIER_T128,
    "ceres_walk_any_hier": _HIER_OCC,
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the walk kernels "
                       "are built from ceres_tpu_torch/ops/csrc at first use")


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"walk_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for this source exists.
    Returns its path; the compiler's report (registers, shared memory,
    spills) is kept beside it as ``.log``."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(path[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    signatures (every pointer and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.ceres_walk_resident_clusters.argtypes = [_I] * 5
    lib.ceres_walk_resident_clusters.restype = _I
    lib.ceres_span_stamp.argtypes = [_P, _I, _I, _P]
    lib.ceres_span_stamp.restype = _I
    lib.ceres_graph_nodes.argtypes = [_P, _P]
    lib.ceres_graph_nodes.restype = _I
    lib.ceres_error_string.argtypes = [ctypes.c_int]
    lib.ceres_error_string.restype = ctypes.c_char_p
    return lib

"""The port's native code: build each source at first use, bind it with
ctypes, and launch its hand-written kernels.

Build. ``nvcc`` compiles a CUDA source (``.cu``) for ``sm_90a`` and
``g++`` a host C++ source (``.cpp``), each into a shared library with a
plain C interface under ``ceres_tpu_torch/_build/`` (git-ignored), named
by the source's stem and a hash of the source and the flags: an edited
source is rebuilt, an unchanged one is reused, and nothing is written
beside the source. The compiler's report (registers, shared memory,
spills for nvcc) is kept beside the library as ``.log``. A missing
compiler raises in ``build``; ``load_host`` gives None without g++ (and
no library built before), so the host C++ callers take their NumPy or
Python path. A build that fails raises with the compiler's output.

``--fmad=false`` keeps every multiply and add of the kernels separately
rounded, so they reproduce their plain PyTorch versions bit for bit.

Kernels. The CUDA libraries (``SOURCES``): ``walk`` (``ops/csrc/walk.cu``:
the walks, span stamps, graph node counts), ``lbvh``
(``accel/csrc/lbvh.cu``: the LBVH hierarchy and boxes) and ``walk_f64``
(``ops/csrc/walk_f64.cu``: the float64 walk and prepass). ``load`` loads
one once per process with its C signatures declared (``SIGNATURES``).
Each library exports its error text as ``ceres_error_string``; loaded
apart, the libraries do not clash. A launch entry takes its tensors'
pointers, then its ints, then the device index and the stream, and
returns a ``cudaError_t``; ``launch`` checks the tensors (``check``),
makes the call, raises where it fails and counts it where it succeeds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PACKAGE, "_build")
SOURCES = {"walk": os.path.join(_PACKAGE, "ops", "csrc", "walk.cu"),
           "lbvh": os.path.join(_PACKAGE, "accel", "csrc", "lbvh.cu"),
           "walk_f64": os.path.join(_PACKAGE, "ops", "csrc", "walk_f64.cu")}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _launch_entry(pointers: int, ints: int):
    """(argument types, return type) of a launch entry: its pointers,
    its ints, the device and the stream."""
    return (_P,) * pointers + (_I,) * (ints + 1) + (_P,), _I


_ERROR = {"ceres_error_string": ((_I,), ctypes.c_char_p)}
# Each CUDA library's C entry points: name -> (argument types, return
# type), every pointer and the stream as ``c_void_p``.
SIGNATURES = {
    "walk": {
        # counts, keys, rays, w, occ0, hull, bbox, first, out, visits,
        # scratch; mode, tile, stream_w, n_tiles, n_k, cmask, S, seg
        "ceres_walk": _launch_entry(11, 8),
        "ceres_walk_resident_clusters": ((_I,) * 5, _I),
        "ceres_span_stamp": _launch_entry(1, 1),   # slots; k
        "ceres_graph_nodes": ((_P, _P), _I),
        **_ERROR,
    },
    "lbvh": {
        # keys, left, right, range_lo, range_hi, parent, leaf_parent; n
        "ceres_lbvh_hierarchy": _launch_entry(7, 1),
        # order, left, right, parent, leaf_parent, p0, e1, e2, arrivals,
        # leaf_lo, leaf_hi, node_lo, node_hi; n, f64
        "ceres_lbvh_boxes": _launch_entry(13, 2),
        **_ERROR,
    },
    "walk_f64": {
        # ent, order, counts, dirs, origins, alive, tcap, tmin, tmax,
        # occ0, w, out, visits; n_tiles, n_c, C, mode, cluster
        "ceres_walk_f64": _launch_entry(13, 5),
        # lo, hi, dlo, dhi, olo, ohi, live, ent, order, counts; n_tiles,
        # n_c
        "ceres_prepass_f64": _launch_entry(10, 2),
        **_ERROR,
    },
}


def compiler(source: str) -> Optional[str]:
    """The compiler of ``source``: nvcc (``CUDA_HOME``, the ``PATH`` or
    ``/usr/local/cuda``) for a ``.cu`` source, else the g++ on the
    ``PATH``; None where it is missing."""
    if not source.endswith(".cu"):
        return shutil.which("g++")
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    return next((p for p in candidates if p and os.path.isfile(p)), None)


def _flags(source: str) -> tuple:
    return NVCC_FLAGS if source.endswith(".cu") else GXX_FLAGS


def library_path(source: str) -> str:
    """Where the library of ``source`` at the current flags lives."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_flags(source)).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile ``source`` unless its library exists; returns its path.
    Raises when the compiler is missing or fails."""
    path = library_path(source)
    if os.path.isfile(path):
        return path
    cc = compiler(source)
    if cc is None:
        tool = "nvcc (set CUDA_HOME)" if source.endswith(".cu") else "g++"
        raise RuntimeError(f"{tool} not found: {source} is built at first "
                           "use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [cc, *_flags(source), "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cc)} failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    with open(path[:-3] + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The CUDA library ``name`` (``SOURCES``), built if needed, loaded
    once per process, with its C signatures declared."""
    lib = ctypes.CDLL(build(SOURCES[name]))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def load_host(source: str) -> Optional[ctypes.CDLL]:
    """The library of the host C++ ``source``, built if needed; None only
    where there is no g++ and no library built before."""
    if compiler(source) is None and not os.path.isfile(library_path(source)):
        return None
    return ctypes.CDLL(build(source))


def error_text(lib: ctypes.CDLL, err: int) -> str:
    """A library's text for its error code ``err``, with the code."""
    return f"{lib.ceres_error_string(err).decode()} ({err})"


def check(library: str, tensors) -> Optional[torch.device]:
    """Refuse a kernel's tensors unless each has its dtype and shape, is
    contiguous, lies on the device of the first and requires no grad.
    ``tensors`` holds (name, tensor or None, dtype, shape) rows, None
    where the entry takes null. Returns that device."""
    dev = first = None
    for name, x, dtype, shape in tensors:
        if x is None:
            continue
        if x.dtype != dtype or x.shape != shape:
            raise ValueError(f"{library} kernels: {name}: want {dtype} "
                             f"{tuple(shape)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if dev is None:
            dev, first = x.device, name
        elif x.device != dev:
            raise ValueError(f"{library} kernels: {name} is on {x.device}, "
                             f"{first} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{library} kernels: {name} must be contiguous")
        if x.requires_grad:
            raise ValueError(f"{library} kernels: {name} requires grad: a "
                             "kernel takes detached inputs")
    return dev


def launch(library: str, entry: str, tensors, ints, counter=None,
           key=None) -> None:
    """Launch ``entry`` of CUDA library ``library`` on the current stream
    of its tensors' card: ``check`` the tensors, then pass their pointers
    (0 for None) in order, the ``ints``, the device index and the stream.
    A failed launch raises with the library's error text; one that
    succeeds adds one to ``counter[key]`` (a ``utils.spans`` counter, or
    a tuple of them, each counted)."""
    dev = check(library, tensors)
    lib = load(library)
    err = getattr(lib, entry)(
        *(0 if x is None else x.data_ptr() for _, x, _, _ in tensors), *ints,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           f"{error_text(lib, err)}")
    for counts in (counter if isinstance(counter, tuple) else (counter,)):
        if counts is not None:
            counts[key] += 1

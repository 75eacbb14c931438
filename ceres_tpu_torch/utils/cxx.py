"""Build the port's host C++ sources with g++ at first use and load them
with ctypes.

``g++ -O2 -shared -fPIC -std=c++17`` compiles a source under
``ceres_tpu_torch/*/csrc/`` into ``ceres_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags: an edited source is rebuilt,
an unchanged one is reused, and nothing is written beside the source.
Without ``g++`` on the ``PATH``, ``load`` returns None and the caller
takes its NumPy or Python path. With ``g++``, a build or load that fails
raises with the compiler's output: it never falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def compiler() -> Optional[str]:
    """The g++ on the PATH, or None."""
    return shutil.which("g++")


def library_path(source: str, stem: str) -> str:
    """Where the library of ``source`` at the current flags lives."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str, stem: str) -> str:
    """Compile ``source`` unless its library exists; returns its path.
    Raises when g++ is missing or fails."""
    path = library_path(source, stem)
    if os.path.isfile(path):
        return path
    gxx = compiler()
    if gxx is None:
        raise RuntimeError(f"g++ not found: {source} is built at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [gxx, *FLAGS, source, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load(source: str, stem: str) -> Optional[ctypes.CDLL]:
    """The loaded library of ``source``, built if needed; None only when
    there is no g++ and no library built before."""
    if compiler() is None and not os.path.isfile(library_path(source, stem)):
        return None
    return ctypes.CDLL(build(source, stem))

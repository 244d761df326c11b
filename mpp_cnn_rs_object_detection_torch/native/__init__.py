"""Build and load the port's native code: hand-written CUDA kernels and
host C++.

Each source here has a plain ``extern "C"`` interface. A ``*.cu`` source is
compiled with ``nvcc`` for ``sm_90a``, a ``*.cpp`` source with ``g++``, into
a shared library under ``native/build/`` on first use, keyed by a hash of
the source and flags, and loaded with ``ctypes`` (no PyTorch headers, no
ninja: a build takes seconds). A failed build raises. Nothing is built or
imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Tuple

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(SRC_DIR, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _source(name: str) -> str:
    """``<name>.cu`` or ``<name>.cpp``, whichever exists."""
    for ext in (".cu", ".cpp"):
        path = os.path.join(SRC_DIR, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no native source {name}.cu or {name}.cpp")


def _flags(src: str) -> Tuple[str, ...]:
    return NVCC_FLAGS if src.endswith(".cu") else CXX_FLAGS


def _compiler(src: str) -> str:
    return nvcc_path() if src.endswith(".cu") else "g++"


def library_path(name: str) -> str:
    """Where ``<name>``'s source builds to, keyed by it and the flags."""
    src = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(src)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _build(name: str, out: str) -> None:
    """Compile ``<name>``'s source to ``out``; the compiler's output (for a
    kernel, the ptxas register and shared-memory report) goes to
    ``out + ".log"``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src = _source(name)
    proc = subprocess.run(
        [_compiler(src), *_flags(src), "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"build failed for {os.path.basename(src)}:\n{proc.stdout}")
    os.replace(tmp, out)
    with open(out + ".log", "w") as f:
        f.write(proc.stdout)


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> Tuple[ctypes.CDLL, str]:
    """The loaded library for ``<name>``'s source, building it if needed."""
    if name not in _LIBS:
        out = library_path(name)
        if not os.path.exists(out):
            _build(name, out)
        _LIBS[name] = ctypes.CDLL(out)
    return _LIBS[name], library_path(name)

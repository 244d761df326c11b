"""Build and load the port's hand-written CUDA kernels.

Each ``*.cu`` source here has a plain ``extern "C"`` interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``native/build/`` on first use, keyed by a hash of the source and flags, and
loaded with ``ctypes`` (no PyTorch headers, no ninja: a build takes seconds).
Nothing is built or imported when this module is imported.
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


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> str:
    """Where ``<name>.cu`` builds to, keyed by its source and the flags."""
    with open(os.path.join(SRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _build(name: str, out: str) -> None:
    """Compile ``<name>.cu`` to ``out``; nvcc's output (the ptxas register
    and shared-memory report) goes to ``out + ".log"``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
         os.path.join(SRC_DIR, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    with open(out + ".log", "w") as f:
        f.write(proc.stdout)


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> Tuple[ctypes.CDLL, str]:
    """The loaded library for ``<name>.cu``, building it if needed."""
    if name not in _LIBS:
        out = library_path(name)
        if not os.path.exists(out):
            _build(name, out)
        _LIBS[name] = ctypes.CDLL(out)
    return _LIBS[name], library_path(name)

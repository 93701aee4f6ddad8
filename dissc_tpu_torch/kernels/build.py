"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so a changed source is rebuilt and an unchanged one
is reused.  Nothing is built when a module is imported: a kernel's
wrapper calls :func:`load` at its first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels are built from source at first use")
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        target = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                                   f"{done.stdout.decode(errors='replace')}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
